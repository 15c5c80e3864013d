"""Builds the CUDA kernels in csrc/ and loads them with ctypes.

At first use, each csrc/*.cu is compiled by its own nvcc process (all
started together) for sm_90a, and the objects are linked into one
shared library with a plain C interface. The library lands in
turboinfer_tpu_torch/_build/<hash>/, keyed by a hash of the sources and
flags, so an unchanged tree never rebuilds. Nothing here runs at import
time: the CPU-only test machines have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from turboinfer_tpu_torch.utils.errors import KernelError

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libturboinfer_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_LLP = ctypes.POINTER(ctypes.c_longlong)
# C signatures of every exported function: (argtypes, restype).
SIGNATURES = {
    "ti_qmm_gemv_max_m": ([], _I),
    "ti_qmm_workspace": ([_I] * 4, _LL),
    "ti_qmm_grouped_workspace": ([_I] * 5, _LL),
    "ti_qmm_counters": ([_I], _I),
    "ti_qmm": ([_VP] * 7 + [_I] * 5 + [_VP], _I),
    "ti_qmm_grouped": ([_VP] * 8 + [_I] * 7 + [_VP], _I),
    "ti_a8_quantize_rows": ([_VP] * 3 + [_I] * 2 + [_VP], _I),
    "ti_qmm_a8": ([_VP] * 5 + [_I] * 4 + [_VP], _I),
    "ti_flash_prefill": ([_VP] * 8 + [_I] * 7 + [_LLP, _F, _I, _F, _VP],
                         _I),
    "ti_cache_write_fresh": ([_VP] * 4 + [_I] * 5 + [_LLP, _VP], _I),
    "ti_kv_encode_write": ([_VP] * 7 + [_I] * 4 + [_LL, _LL, _LLP, _VP], _I),
    "ti_decode_workspace": ([_I] * 6, _LL),
    "ti_decode_counters": ([_I] * 3, _LL),
    "ti_decode_attention": ([_VP] * 10 + [_I] * 7 + [_LLP, _F, _F, _VP],
                            _I),
    "ti_paged_workspace": ([_I] * 5, _LL),
    "ti_paged_attention": ([_VP] * 10 + [_I] * 10
                           + [_LLP, _F, _I, _F, _VP], _I),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# Filled by the build that produced the loaded library (empty when it
# was found already built): seconds and the ptxas resource report.
BUILD_INFO: Dict[str, object] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                      "are built on the machine with the GPU")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    tmp = out_dir / f"tmp-{os.getpid()}-{threading.get_ident()}"
    tmp.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in sources():
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports, objs, failed = {}, [], []
    for src, obj, p in procs:
        out, _ = p.communicate()
        reports[src.name] = out
        if p.returncode != 0:
            failed.append(f"{src.name} (rc={p.returncode}):\n{out}")
        objs.append(str(obj))
    if failed:
        raise KernelError("nvcc failed:\n" + "\n".join(failed))
    tmp_lib = tmp / LIB_NAME
    link = subprocess.run([nvcc, "-shared", *objs, "-o", str(tmp_lib)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise KernelError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp_lib, lib)
    shutil.rmtree(tmp, ignore_errors=True)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, ptxas=reports,
                      nvcc=nvcc)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


_counters: Dict[object, object] = {}
COUNTERS_MIN = 1 << 16


def counters(device, n: int):
    """A buffer of at least n int32 zeros on `device`, kept for the
    process: the arrival counters of the kernels that merge split results
    in their last block (decode attention, paged attention, the qmm
    GEMV). Every launch
    leaves the counters it used at 0 again, so kernels launched in order on
    one stream (CUDA-graph replays too) share it. It is made outside any
    graph capture: growing it inside one raises."""
    import torch
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise KernelError(f"{n} arrival counters needed while a CUDA "
                              "graph is being captured: run the call once "
                              "before capturing it")
        buf = torch.zeros((max(n, COUNTERS_MIN),), dtype=torch.int32,
                          device=device)
        _counters[device] = buf
    return buf


def longlongs(*vals) -> ctypes.Array:
    return (ctypes.c_longlong * len(vals))(*[int(v) for v in vals])


def check(status: int, name: str) -> None:
    if status != 0:
        raise KernelError(f"{name}: CUDA launch failed with error {status}")
