"""ctypes bindings for the native host library (native/turboio.cpp and
native/ggml_dequant.cpp): the GGUF index parse, the multithreaded GGML
block dequantization and the O(n log n) SentencePiece encoder, as the
JAX package's native.py binds them.

The sources are compiled at first use by g++ into
turboinfer_tpu_torch/_build/native-<hash>/libturboio.so (a hash of the
sources and flags; the build directory is not in git), never into
native/: with OpenMP (the dequantizer's block loop in parallel), or,
where g++ has no OpenMP runtime, without it (the same results, one
thread). When g++ or the build is missing, every entry point returns
None (NativeSPMEncoder raises ImportError) and the callers take their
numpy/Python forms, which give the same results; TURBOINFER_NO_NATIVE=1
forces those. `last_error()` says why the library is unavailable and
`openmp()` whether the loaded one is parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent
NATIVE_DIR = _ROOT / "native"
SOURCES = ("turboio.cpp", "ggml_dequant.cpp")
CXX_FLAGS = ["-O3", "-std=c++20", "-fPIC", "-shared"]
OPENMP = "-fopenmp"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"

_lib = None
_lock = threading.Lock()
_error: Optional[str] = None
_flags: List[str] = []


def _lib_path(flags: Sequence[str]) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / "libturboio.so"


def _build(path: Path, flags: Sequence[str]) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise OSError("no C++ compiler (g++) on PATH")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"tmp-{os.getpid()}-{threading.get_ident()}.so")
    r = subprocess.run([cxx, *flags, "-o", str(tmp)]
                       + [str(NATIVE_DIR / s) for s in SOURCES],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise OSError(f"g++ failed (rc={r.returncode}): {r.stderr[-2000:]}")
    os.replace(tmp, path)            # atomic: concurrent builds leave one file


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _error, _flags
    if _lib is not None:
        return _lib
    if os.environ.get("TURBOINFER_NO_NATIVE") == "1":
        _error = "TURBOINFER_NO_NATIVE=1"
        return None
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        errors = []
        for flags in ([*CXX_FLAGS, OPENMP], CXX_FLAGS):
            try:
                path = _lib_path(flags)
                if not path.exists():
                    _build(path, flags)
                lib = ctypes.CDLL(str(path))
                _flags = list(flags)
                break
            except (OSError, subprocess.SubprocessError) as e:
                errors.append(f"{' '.join(flags)}: {e}")
        else:
            _error = "; ".join(errors)
            return None
        lib.turboio_gguf_index_json.restype = ctypes.c_void_p
        lib.turboio_gguf_index_json.argtypes = [ctypes.c_char_p]
        lib.turboio_free.argtypes = [ctypes.c_void_p]
        lib.turboio_version.restype = ctypes.c_char_p
        lib.turboio_spm_new.restype = ctypes.c_void_p
        lib.turboio_spm_new.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32, ctypes.c_int32]
        lib.turboio_spm_delete.argtypes = [ctypes.c_void_p]
        lib.turboio_spm_encode.restype = ctypes.c_int32
        lib.turboio_spm_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.turboio_ggml_dequant.restype = ctypes.c_int32
        lib.turboio_ggml_dequant.argtypes = [
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def openmp() -> bool:
    """Whether the loaded library was built with OpenMP."""
    return _load() is not None and OPENMP in _flags


def last_error() -> Optional[str]:
    """Why the library is unavailable (None when it loaded)."""
    _load()
    return _error


def version() -> Optional[str]:
    lib = _load()
    return lib.turboio_version().decode() if lib else None


def gguf_index(path: str) -> Optional[dict]:
    """Parse GGUF header/metadata/tensor-index natively -> dict, or None."""
    lib = _load()
    if lib is None:
        return None
    ptr = lib.turboio_gguf_index_json(path.encode())
    if not ptr:
        return None
    try:
        raw = ctypes.string_at(ptr)
        return json.loads(raw.decode("utf-8", errors="replace"))
    finally:
        lib.turboio_free(ptr)


def ggml_dequant(raw, ggml_type: int, n_elems: int) -> Optional[np.ndarray]:
    """Native GGML block dequantization -> flat f32 numpy array, or None
    when the library or the block type is unavailable (the caller takes
    the numpy forms of loader/gguf.py)."""
    lib = _load()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    out = np.empty(n_elems, np.float32)
    rc = lib.turboio_ggml_dequant(
        int(ggml_type), raw.ctypes.data_as(ctypes.c_void_p),
        raw.size, int(n_elems), out.ctypes.data_as(ctypes.c_void_p))
    return out if rc == 0 else None


class NativeSPMEncoder:
    """Native agenda-merge SPM encoder (same semantics as
    tokenizer/bpe.SPMTokenizer.encode)."""

    def __init__(self, tokens: Sequence[str], scores: Sequence[float],
                 add_space_prefix: bool = True):
        lib = _load()
        if lib is None:
            raise ImportError(f"turboio native library unavailable: "
                              f"{_error}")
        self._lib = lib
        n = len(tokens)
        arr = (ctypes.c_char_p * n)(*[t.encode("utf-8") for t in tokens])
        sc = (ctypes.c_float * n)(*[float(s) for s in scores]) \
            if scores else None
        self._h = lib.turboio_spm_new(arr, sc, n,
                                      1 if add_space_prefix else 0)

    def encode(self, text: str, add_bos: bool = False, bos_id: int = 1,
               unk_id: int = 0) -> List[int]:
        data = text.encode("utf-8")
        cap = 4 * len(data) + 8
        out = (ctypes.c_int32 * cap)()
        n = self._lib.turboio_spm_encode(
            self._h, data, 1 if add_bos else 0, bos_id, unk_id, out, cap)
        return list(out[:min(n, cap)])

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.turboio_spm_delete(self._h)
        except Exception:
            pass
