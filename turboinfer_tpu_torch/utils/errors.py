"""Error taxonomy, the same classes as turboinfer_tpu.utils.errors plus
DeviceError for a device the caller asked for and cannot have."""

from __future__ import annotations


class TurboInferError(Exception):
    """Base class for all turboinfer errors."""


class ModelFormatError(TurboInferError, ValueError):
    """Unreadable/unsupported model file."""


class ConfigError(TurboInferError, ValueError):
    """Inconsistent model/inference configuration."""


class TokenError(TurboInferError, ValueError):
    """Invalid token input (empty prompt, out-of-vocab id, prompt longer
    than max_seq_len)."""


class QuantizationError(TurboInferError, ValueError):
    """Invalid quantization request (odd K for int4, group size not
    dividing K, unsupported type)."""


class SchedulerFullError(TurboInferError, RuntimeError):
    """Admission control: the request queue is full."""


class DeviceError(TurboInferError, RuntimeError):
    """The requested device is not available (e.g. CUDA asked for on a
    machine without a GPU) or a tensor lies on the wrong device."""


class KernelError(TurboInferError, RuntimeError):
    """A CUDA kernel refused its inputs, failed to build, or reported a
    launch error."""
