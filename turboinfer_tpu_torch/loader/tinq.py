"""TINQ v2 quantized checkpoints: the counterpart of
turboinfer_tpu/loader/tinq.py, byte-compatible with it, so a .tinq
written by either package loads in the other into identical QTensors.

Layout:
  bytes 0-3   magic b"TINQ"
  bytes 4-7   version (u32 LE) == 2
  bytes 8-15  header_len (u64 LE)
  header_len  JSON header: format, version, the model config
              (mapping.config_to_dict), the quantization config, user
              metadata and the tensor index (per dotted path: a plain
              array, or a qtensor / qembed with its blobs' dtype names
              "bfloat16", "float32", "uint8", "int8", shapes, offsets)
  pad to 64
  blobs       concatenated tensors, each padded to 64 bytes (bf16 as
              its raw 16-bit patterns)
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from turboinfer_tpu_torch.config import (ModelConfig, QuantizationConfig,
                                         QuantType)
from turboinfer_tpu_torch.core.qtensor import QEmbed, QTensor
from turboinfer_tpu_torch.loader import mapping
from turboinfer_tpu_torch.utils.device import resolve_device
from turboinfer_tpu_torch.utils.errors import ModelFormatError

MAGIC = b"TINQ"
VERSION = 2
_ALIGN = 64


def _flatten(params: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in params.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, path + "."))
        else:
            out[path] = v
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split(".")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def save(path: str, params: Dict[str, Any], config: ModelConfig,
         qconfig: Optional[QuantizationConfig] = None,
         extra_metadata: Optional[Dict[str, str]] = None) -> None:
    """Persist a (possibly quantized) parameter tree and its configs.
    Tensors come to the host one at a time as they are written."""
    flat = _flatten(params)
    index: Dict[str, Any] = {}
    blobs = []
    offset = 0

    def add(t: torch.Tensor) -> Dict[str, Any]:
        nonlocal offset
        ent = {"dtype": mapping.dtype_name(t.dtype), "shape": list(t.shape),
               "offset": offset, "nbytes": t.numel() * t.element_size()}
        blobs.append(t)
        offset += (ent["nbytes"] + _ALIGN - 1) // _ALIGN * _ALIGN
        return ent

    for name, leaf in flat.items():
        if isinstance(leaf, QTensor):
            ent = {"kind": "qtensor", "bits": leaf.bits,
                   "group_size": leaf.group_size, "shape": list(leaf.shape),
                   "data": add(leaf.data), "scales": add(leaf.scales)}
            if leaf.zero_points is not None:
                ent["zero_points"] = add(leaf.zero_points)
            index[name] = ent
        elif isinstance(leaf, QEmbed):
            index[name] = {"kind": "qembed", "data": add(leaf.data),
                           "scales": add(leaf.scales)}
        else:
            ent = add(leaf)
            index[name] = {"kind": "array", **ent}

    header = {
        "format": "tinq", "version": VERSION,
        "config": mapping.config_to_dict(config),
        "quantization": (None if qconfig is None else {
            "type": qconfig.type.value, "symmetric": qconfig.symmetric,
            "group_size": qconfig.group_size,
            "skip_embeddings": qconfig.skip_embeddings}),
        "metadata": dict(extra_metadata or {}),
        "tensors": index,
    }
    hbytes = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", VERSION))
        f.write(struct.pack("<Q", len(hbytes)))
        f.write(hbytes)
        pos = f.tell()
        f.write(b"\x00" * ((pos + _ALIGN - 1) // _ALIGN * _ALIGN - pos))
        for t in blobs:
            raw = t.detach().to("cpu").contiguous().reshape(-1)
            nbytes = raw.numel() * raw.element_size()
            if nbytes:
                f.write(raw.view(torch.uint8).numpy().data)
            f.write(b"\x00" * ((nbytes + _ALIGN - 1) // _ALIGN * _ALIGN
                               - nbytes))


def _read_blob(mm, data_start: int, ent: Dict[str, Any],
               device) -> torch.Tensor:
    dtype = mapping.dtype_from_name(ent["dtype"])
    raw = np.frombuffer(mm, np.uint8, count=ent["nbytes"],
                        offset=data_start + ent["offset"])
    t = torch.from_numpy(raw).view(dtype).reshape(ent["shape"])
    return t.to(device)


def load(path: str, device="cuda") -> Tuple[Dict[str, Any], ModelConfig,
                                            Optional[QuantizationConfig],
                                            Dict[str, str]]:
    """Load a TINQ checkpoint onto `device` -> (params, config, qconfig,
    metadata); magic, version and header validated."""
    dev = resolve_device(device)
    with open(path, "rb") as fh:
        mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY)
        try:
            if mm[:4] != MAGIC:
                raise ModelFormatError(
                    f"not a TINQ file: bad magic {mm[:4]!r}")
            (version,) = struct.unpack("<I", mm[4:8])
            if version != VERSION:
                raise ModelFormatError(f"unsupported TINQ version {version}")
            (hlen,) = struct.unpack("<Q", mm[8:16])
            header = json.loads(mm[16:16 + hlen].decode("utf-8"))
            data_start = (16 + hlen + _ALIGN - 1) // _ALIGN * _ALIGN

            def blob(ent):
                return _read_blob(mm, data_start, ent, dev)
            flat: Dict[str, Any] = {}
            for name, ent in header["tensors"].items():
                if ent["kind"] == "qtensor":
                    flat[name] = QTensor(
                        data=blob(ent["data"]), scales=blob(ent["scales"]),
                        zero_points=(blob(ent["zero_points"])
                                     if "zero_points" in ent else None),
                        bits=int(ent["bits"]),
                        group_size=int(ent["group_size"]),
                        shape=tuple(ent["shape"]))
                elif ent["kind"] == "qembed":
                    flat[name] = QEmbed(data=blob(ent["data"]),
                                        scales=blob(ent["scales"]))
                else:
                    flat[name] = blob(ent)
        finally:
            try:
                mm.close()
            except BufferError:
                # CPU tensors still view the mapping; it is released
                # with the last of them
                pass

    config = mapping.config_from_dict(header["config"])
    q = header.get("quantization")
    qconfig = None
    if q:
        qconfig = QuantizationConfig(
            type=QuantType(q["type"]), symmetric=q["symmetric"],
            group_size=q["group_size"],
            skip_embeddings=q.get("skip_embeddings", False))
    return (_unflatten(flat), config, qconfig,
            dict(header.get("metadata", {})))
