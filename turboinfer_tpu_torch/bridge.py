"""Numpy bridge: parameters and caches in and out of the port.

The input is a nested dict of numpy arrays with the JAX package's
parameter structure (see models/llama.py). A quantized weight is a dict
{"data", "scales", "zero_points", "bits", "group_size", "shape"}
(zero_points may be None); a per-row int8 embedding table is a dict
{"data", "row_scales"}. bfloat16 arrays (numpy dtype name "bfloat16")
are read bit for bit. The port imports no JAX, so turning a JAX tree
into numpy is the caller's half.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from turboinfer_tpu_torch.core.qtensor import QEmbed, QTensor
from turboinfer_tpu_torch.models.common import KVCache
from turboinfer_tpu_torch.utils.device import resolve_device

_QT_KEYS = {"data", "scales", "zero_points", "bits", "group_size", "shape"}


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(resolve_device(device))


def params_from_numpy(tree: Any, device="cuda") -> Any:
    if isinstance(tree, dict):
        if _QT_KEYS <= set(tree):
            zp = tree["zero_points"]
            return QTensor(
                data=tensor_from_numpy(tree["data"], device),
                scales=tensor_from_numpy(tree["scales"], device),
                zero_points=None if zp is None else tensor_from_numpy(zp, device),
                bits=int(tree["bits"]), group_size=int(tree["group_size"]),
                shape=tuple(int(d) for d in tree["shape"]))
        if set(tree) == {"data", "row_scales"}:
            return QEmbed(tensor_from_numpy(tree["data"], device),
                          tensor_from_numpy(tree["row_scales"], device))
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def cache_from_numpy(k, v, length, device="cuda") -> KVCache:
    """A head-major [L, B, Hkv, T, D] cache from numpy arrays."""
    return KVCache(k=tensor_from_numpy(k, device),
                   v=tensor_from_numpy(v, device),
                   length=tensor_from_numpy(np.asarray(length, np.int32),
                                            device))


def to_numpy(tree: Any) -> Any:
    """The reverse of params_from_numpy (bf16 comes back as float32)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return {"data": to_numpy(tree.data), "scales": to_numpy(tree.scales),
                "zero_points": None if tree.zero_points is None
                else to_numpy(tree.zero_points),
                "bits": tree.bits, "group_size": tree.group_size,
                "shape": tuple(tree.shape)}
    if isinstance(tree, QEmbed):
        return {"data": to_numpy(tree.data),
                "row_scales": to_numpy(tree.scales)}
    if isinstance(tree, KVCache):
        return {"k": to_numpy(tree.k), "v": to_numpy(tree.v),
                "length": to_numpy(tree.length)}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return tree
