"""SafeTensors reader/writer: the counterpart of
turboinfer_tpu/loader/safetensors.py, with the same header validation
(dtype known, offsets spanning exactly shape x itemsize, inside the
file) and the same bytes on write (JSON header padded with spaces to
8 bytes, tensors back to back in insertion order).

The reader maps the file and hands out numpy views (BF16 widened to f32
bit for bit, as the JAX package's reader does) or torch tensors in the
file's own dtype (BF16 stays bf16, no widening), which the loader moves
to the device. The writer takes numpy arrays or torch tensors; a torch
bf16 tensor is written as BF16.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch

_DTYPES: Dict[str, Any] = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
    # BF16 has no numpy dtype: read as uint16
    "BF16": np.uint16,
}
_TORCH = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
          "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
          "BOOL": torch.bool}
_NP_TO_ST = {np.dtype(np.float64): "F64", np.dtype(np.float32): "F32",
             np.dtype(np.float16): "F16", np.dtype(np.int64): "I64",
             np.dtype(np.int32): "I32", np.dtype(np.int16): "I16",
             np.dtype(np.int8): "I8", np.dtype(np.uint8): "U8",
             np.dtype(np.bool_): "BOOL"}
_TORCH_TO_ST = {v: k for k, v in _TORCH.items()}


class SafeTensorsFile:
    """mmap-backed lazy reader (a private copy-on-write mapping, so
    torch can view it; nothing is written back to the file)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        self._mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_COPY)
        (header_len,) = struct.unpack("<Q", self._mm[:8])
        if header_len > len(self._mm) - 8:
            raise ValueError("safetensors header length exceeds file size")
        header = json.loads(self._mm[8:8 + header_len].decode("utf-8"))
        self.metadata: Dict[str, str] = header.pop("__metadata__", {})
        self.entries: Dict[str, dict] = header
        self._data_start = 8 + header_len
        data_len = len(self._mm) - self._data_start
        for name, ent in self.entries.items():
            dt = ent["dtype"]
            if dt not in _DTYPES:
                raise ValueError(f"unsupported safetensors dtype {dt}")
            begin, end = ent["data_offsets"]
            n = int(np.prod(ent["shape"])) if ent["shape"] else 1
            expect = n * np.dtype(_DTYPES[dt]).itemsize
            if end - begin != expect:
                raise ValueError(
                    f"tensor '{name}': offsets span {end - begin} bytes, "
                    f"expected {expect}")
            if end > data_len:
                raise ValueError(f"tensor '{name}' extends past end of file")

    def keys(self):
        return self.entries.keys()

    def _raw(self, name: str) -> np.ndarray:
        ent = self.entries[name]
        begin, end = ent["data_offsets"]
        np_dt = _DTYPES[ent["dtype"]]
        arr = np.frombuffer(self._mm, np_dt,
                            count=(end - begin) // np.dtype(np_dt).itemsize,
                            offset=self._data_start + begin)
        return arr.reshape(ent["shape"])

    def tensor(self, name: str, dtype=None) -> np.ndarray:
        """numpy view of one tensor (BF16 widened to f32, bit for bit)."""
        arr = self._raw(name)
        if self.entries[name]["dtype"] == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        if dtype is not None:
            arr = arr.astype(dtype, copy=False)
        return arr

    def torch_tensor(self, name: str) -> torch.Tensor:
        """A CPU torch view of one tensor in the file's dtype, over the
        mapping (no copy)."""
        ent = self.entries[name]
        arr = self._raw(name)
        if ent["dtype"] == "BOOL":
            return torch.from_numpy(arr)
        t = torch.from_numpy(arr.reshape(-1).view(np.uint8))
        return t.view(_TORCH[ent["dtype"]]).reshape(ent["shape"])

    def close(self):
        try:
            self._mm.close()
        except BufferError:
            # views handed out by tensor()/torch_tensor() are still
            # alive; the mapping goes with the last of them
            pass
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_safetensors(path: str) -> SafeTensorsFile:
    return SafeTensorsFile(path)


def _host_bytes(arr) -> tuple:
    """(safetensors dtype, shape, numpy byte view) of a numpy array or a
    torch tensor (moved to the host); a 0-d one is written as shape [1],
    as numpy's ascontiguousarray makes it in the JAX package's writer."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().to("cpu").contiguous()
        if t.dim() == 0:
            t = t.reshape(1)
        st = _TORCH_TO_ST.get(t.dtype)
        if st is None:
            raise ValueError(f"cannot write dtype {t.dtype} to safetensors")
        if t.dtype == torch.bool:
            return st, list(t.shape), t.numpy()
        flat = t.reshape(-1).view(torch.uint8) if t.numel() else \
            torch.zeros(0, dtype=torch.uint8)
        return st, list(t.shape), flat.numpy()
    a = np.ascontiguousarray(arr)
    st = _NP_TO_ST.get(a.dtype)
    if st is None and a.dtype.name == "bfloat16":
        st = "BF16"
    if st is None:
        raise ValueError(f"cannot write dtype {a.dtype} to safetensors")
    return st, list(a.shape), a


def write_safetensors(path: str, tensors: Dict[str, Any],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write numpy arrays or torch tensors (bf16 as BF16) to `path`."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {k: str(v) for k, v in metadata.items()}
    offset = 0
    blobs = []
    for name, arr in tensors.items():
        st, shape, raw = _host_bytes(arr)
        header[name] = {"dtype": st, "shape": shape,
                        "data_offsets": [offset, offset + raw.nbytes]}
        offset += raw.nbytes
        blobs.append(raw)
    hbytes = json.dumps(header).encode("utf-8")
    pad = (8 - len(hbytes) % 8) % 8          # align data start
    hbytes += b" " * pad
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hbytes)))
        f.write(hbytes)
        for raw in blobs:
            f.write(np.ascontiguousarray(raw).reshape(-1).view(np.uint8).data)
