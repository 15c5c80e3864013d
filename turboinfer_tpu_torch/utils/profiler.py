"""Profiler: per-op wall-clock stats and a torch.profiler trace hook
(counterpart of turboinfer_tpu/utils/profiler.py).

An opt-in singleton with start/stop or scoped timing, per-op {count,
total, min, max, avg} and text/JSON/CSV reports; MemoryProfiler tracks
bytes by tag. device_memory_stats() reads torch.cuda.memory_stats of
every visible GPU, and trace(log_dir) records host and CUDA activity
with torch.profiler into a Chrome trace: what a wall-clock timer of
asynchronous launches cannot see.
"""

from __future__ import annotations

import contextlib
import csv
import io
import json
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class OpStats:
    count: int = 0
    total_ms: float = 0.0
    min_ms: float = float("inf")
    max_ms: float = 0.0

    @property
    def avg_ms(self) -> float:
        return self.total_ms / max(self.count, 1)

    def record(self, ms: float):
        self.count += 1
        self.total_ms += ms
        self.min_ms = min(self.min_ms, ms)
        self.max_ms = max(self.max_ms, ms)


class Timer:
    """µs-resolution wall-clock timer."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def restart(self):
        self._t0 = time.perf_counter()

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3

    def elapsed_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6


class Profiler:
    """Singleton, disabled by default."""

    _instance: Optional["Profiler"] = None
    _lock = threading.Lock()

    def __init__(self):
        self.enabled = False
        self._stats: Dict[str, OpStats] = {}
        self._open: Dict[str, float] = {}
        self._mu = threading.Lock()

    @classmethod
    def instance(cls) -> "Profiler":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def set_enabled(self, on: bool):
        self.enabled = on

    def reset(self):
        with self._mu:
            self._stats.clear()
            self._open.clear()

    def start(self, name: str):
        if not self.enabled:
            return
        with self._mu:
            self._open[name] = time.perf_counter()

    def stop(self, name: str):
        if not self.enabled:
            return
        with self._mu:
            t0 = self._open.pop(name, None)
            if t0 is None:
                return
            ms = (time.perf_counter() - t0) * 1e3
            self._stats.setdefault(name, OpStats()).record(ms)

    def record(self, name: str, ms: float):
        if not self.enabled:
            return
        with self._mu:
            self._stats.setdefault(name, OpStats()).record(ms)

    @contextlib.contextmanager
    def scope(self, name: str):
        """Time the with-block under `name`."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.enabled:
                self.record(name, (time.perf_counter() - t0) * 1e3)

    # -- reports ---------------------------------------------------------

    def report(self) -> str:
        out = io.StringIO()
        out.write("=== TurboInfer Profiler Report ===\n")
        out.write(f"{'op':<40} {'count':>8} {'total ms':>12} "
                  f"{'avg ms':>10} {'min ms':>10} {'max ms':>10}\n")
        with self._mu:
            for name, s in sorted(self._stats.items(),
                                  key=lambda kv: -kv[1].total_ms):
                out.write(f"{name:<40} {s.count:>8} {s.total_ms:>12.3f} "
                          f"{s.avg_ms:>10.3f} {s.min_ms:>10.3f} "
                          f"{s.max_ms:>10.3f}\n")
        return out.getvalue()

    def save(self, path: str, fmt: str = "text"):
        if fmt == "text":
            data = self.report()
        elif fmt == "json":
            with self._mu:
                data = json.dumps(
                    {k: {"count": s.count, "total_ms": s.total_ms,
                         "avg_ms": s.avg_ms, "min_ms": s.min_ms,
                         "max_ms": s.max_ms}
                     for k, s in self._stats.items()}, indent=2)
        elif fmt == "csv":
            buf = io.StringIO()
            w = csv.writer(buf)
            w.writerow(["op", "count", "total_ms", "avg_ms", "min_ms",
                        "max_ms"])
            with self._mu:
                for k, s in self._stats.items():
                    w.writerow([k, s.count, s.total_ms, s.avg_ms, s.min_ms,
                                s.max_ms])
            data = buf.getvalue()
        else:
            raise ValueError(f"unknown format {fmt!r}")
        with open(path, "w") as f:
            f.write(data)

    def stats(self) -> Dict[str, OpStats]:
        with self._mu:
            return dict(self._stats)


class MemoryProfiler:
    """Tag-based current/peak byte tracking; the device's own counts come
    from device_memory_stats()."""

    _current: Dict[str, int] = {}
    _peak: Dict[str, int] = {}
    _mu = threading.Lock()

    @classmethod
    def record_alloc(cls, tag: str, nbytes: int):
        with cls._mu:
            cur = cls._current.get(tag, 0) + nbytes
            cls._current[tag] = cur
            cls._peak[tag] = max(cls._peak.get(tag, 0), cur)

    @classmethod
    def record_free(cls, tag: str, nbytes: int):
        with cls._mu:
            cls._current[tag] = max(cls._current.get(tag, 0) - nbytes, 0)

    @classmethod
    def current(cls, tag: str) -> int:
        with cls._mu:
            return cls._current.get(tag, 0)

    @classmethod
    def peak(cls, tag: str) -> int:
        with cls._mu:
            return cls._peak.get(tag, 0)

    @classmethod
    def reset(cls):
        with cls._mu:
            cls._current.clear()
            cls._peak.clear()


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per-GPU allocator stats (torch.cuda.memory_stats: bytes allocated,
    reserved, their peaks, ...) keyed by device name; empty without a
    GPU."""
    import torch
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        if ms:
            out[f"cuda:{i}"] = {k: v for k, v in ms.items()
                                if isinstance(v, int)}
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler scope recording CPU and (where a GPU is present)
    CUDA activity; the Chrome trace goes to log_dir/trace.json."""
    import os

    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
