"""Logging: a thin shim over the stdlib with the JAX package's surface
(set_level / set_log_file / log_debug..log_fatal)."""

from __future__ import annotations

import logging as _logging
import sys
from typing import Optional

_LOGGER_NAME = "turboinfer_tpu_torch"
_FMT = "[%(asctime)s.%(msecs)03d] [%(levelname)s] %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"

FATAL = _logging.CRITICAL
ERROR = _logging.ERROR
WARNING = _logging.WARNING
INFO = _logging.INFO
DEBUG = _logging.DEBUG


def get_logger() -> _logging.Logger:
    logger = _logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        h = _logging.StreamHandler(sys.stderr)
        h.setFormatter(_logging.Formatter(_FMT, datefmt=_DATEFMT))
        logger.addHandler(h)
        logger.setLevel(_logging.INFO)
        logger.propagate = False
    return logger


def set_level(level) -> None:
    if isinstance(level, str):
        level = getattr(_logging, level.upper())
    get_logger().setLevel(level)


def set_log_file(path: Optional[str]) -> None:
    """Attach (or with None, detach) an append-mode file sink."""
    logger = get_logger()
    for h in [h for h in logger.handlers
              if isinstance(h, _logging.FileHandler)]:
        logger.removeHandler(h)
        h.close()
    if path:
        fh = _logging.FileHandler(path, mode="a")
        fh.setFormatter(_logging.Formatter(_FMT, datefmt=_DATEFMT))
        logger.addHandler(fh)


def log_debug(msg, *a): get_logger().debug(msg, *a)
def log_info(msg, *a): get_logger().info(msg, *a)
def log_warning(msg, *a): get_logger().warning(msg, *a)
def log_error(msg, *a): get_logger().error(msg, *a)
def log_fatal(msg, *a): get_logger().critical(msg, *a)
