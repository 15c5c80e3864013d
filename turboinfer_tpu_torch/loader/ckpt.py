"""Checkpoint directories: the counterpart of turboinfer_tpu/loader/ckpt.py,
with its manifest (model config, quantization layout, user metadata) and
a safetensors array store in place of Orbax, which the port does not
use.

A checkpoint is a directory holding
  turboinfer_manifest.json  {"format": "turboinfer-safetensors",
                             "version": 1, "config": {...}, "qtensors":
                             {path: {"kind": "qtensor", "bits",
                             "group_size", "shape"} | {"kind":
                             "qembed"}}, "metadata": {...}}
  params.safetensors        every array under its "/"-joined path
                            ("layers/wq/data", "layers/wq/scales", ...)
QTensors persist as their packed data, scales and zero points, so a
quantized model restores without a dequantize round trip. A checkpoint
the JAX package wrote (Orbax, format "turboinfer-orbax") raises
ModelFormatError. load_checkpoint(mesh=) restores this rank's slice of
every array (parallel/shardings.py) straight from the memory-mapped
file; where JAX's restore replicates an axis that does not divide, the
port refuses (ROADMAP §2).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import torch

from turboinfer_tpu_torch.config import ModelConfig, RopeMode
from turboinfer_tpu_torch.core.qtensor import QEmbed, QTensor
from turboinfer_tpu_torch.loader import mapping
from turboinfer_tpu_torch.loader import safetensors as st_mod
from turboinfer_tpu_torch.utils import logging as tlog
from turboinfer_tpu_torch.utils.device import resolve_device
from turboinfer_tpu_torch.utils.errors import ModelFormatError

_MANIFEST = "turboinfer_manifest.json"
_ARRAYS = "params.safetensors"
FORMAT = "turboinfer-safetensors"


def _split(params) -> tuple:
    """(flat {path: tensor}, qtensor meta {path: {...}}) of a tree."""
    flat: Dict[str, torch.Tensor] = {}
    meta: Dict[str, Any] = {}

    def walk(node, path):
        key = "/".join(path)
        if isinstance(node, QTensor):
            meta[key] = {"kind": "qtensor", "bits": node.bits,
                         "group_size": node.group_size,
                         "shape": list(node.shape)}
            flat[key + "/data"] = node.data
            flat[key + "/scales"] = node.scales
            if node.zero_points is not None:
                flat[key + "/zero_points"] = node.zero_points
        elif isinstance(node, QEmbed):
            meta[key] = {"kind": "qembed"}
            flat[key + "/data"] = node.data
            flat[key + "/scales"] = node.scales
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
        else:
            flat[key] = node

    walk(params, [])
    return flat, meta


def _join(flat: Dict[str, torch.Tensor], meta: Dict[str, Any]):
    tree: Dict[str, Any] = {}

    def put(path: str, value):
        parts = path.split("/")
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = value

    for key, m in meta.items():
        if m["kind"] == "qembed":
            put(key, QEmbed(data=flat.pop(key + "/data"),
                            scales=flat.pop(key + "/scales")))
        else:
            put(key, QTensor(data=flat.pop(key + "/data"),
                             scales=flat.pop(key + "/scales"),
                             zero_points=flat.pop(key + "/zero_points", None),
                             bits=m["bits"], group_size=m["group_size"],
                             shape=tuple(m["shape"])))
    for key, t in flat.items():
        put(key, t)
    return tree


def save_checkpoint(path: str, params, config: ModelConfig,
                    metadata: Optional[Dict[str, Any]] = None) -> None:
    """Write a checkpoint directory: the safetensors array store and the
    JSON manifest."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    flat, qt_meta = _split(params)
    st_mod.write_safetensors(os.path.join(path, _ARRAYS), flat)
    cfg = dataclasses.asdict(config)
    cfg["dtype"] = mapping.dtype_name(config.dtype)
    manifest = {"format": FORMAT, "version": 1, "config": cfg,
                "qtensors": qt_meta, "metadata": metadata or {}}
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1, default=str)
    tlog.log_info("saved checkpoint %s (%d quantized tensors)", path,
                  len(qt_meta))


def _config_from_manifest(cfg: Dict[str, Any]) -> ModelConfig:
    cfg = dict(cfg)
    dtype = mapping.dtype_from_name(cfg.pop("dtype", "bfloat16"))
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in cfg.items() if k in fields}
    # JSON gives lists where the frozen config holds tuples
    for k in ("rope_scaling", "extra"):
        if isinstance(kw.get(k), list):
            kw[k] = tuple(tuple(e) for e in kw[k])
    kw["rope_mode"] = RopeMode(kw.get("rope_mode", "half"))
    return ModelConfig(**kw, dtype=dtype)


def _to_device(tree, dev):
    """A tree of mapped arrays (or slices of them) on dev, every array a
    copy that owns its memory (the mapping closes)."""
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(data=_to_device(tree.data, dev),
                       scales=_to_device(tree.scales, dev),
                       zero_points=None if tree.zero_points is None else
                       _to_device(tree.zero_points, dev),
                       bits=tree.bits, group_size=tree.group_size,
                       shape=tree.shape)
    if isinstance(tree, QEmbed):
        return QEmbed(_to_device(tree.data, dev),
                      _to_device(tree.scales, dev))
    return tree.to(dev, copy=True)


def load_checkpoint(path: str, mesh=None, device="cuda"):
    """Restore (params, config, metadata) onto `device`. With `mesh` (a
    parallel.mesh.Mesh), onto mesh.device and only this rank's rows or
    columns of each split array under its family's spec set: the slices are cut from the memory-mapped
    file before anything moves to the device, so no replicated copy of a
    split array is made there. A split that would cut a quantization
    group, or an axis that does not divide, raises ValueError."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    path = os.path.abspath(path)
    mpath = os.path.join(path, _MANIFEST)
    if not os.path.exists(mpath):
        raise ModelFormatError(f"{path}: no {_MANIFEST}")
    with open(mpath) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ModelFormatError(
            f"{path}: checkpoint format {manifest.get('format')!r} is not "
            f"{FORMAT!r}; an Orbax checkpoint of the JAX package "
            "(turboinfer-orbax) cannot be read here: save it as TINQ "
            "(loader/tinq.py) and load that")
    config = _config_from_manifest(manifest["config"])
    with st_mod.read_safetensors(os.path.join(path, _ARRAYS)) as sf:
        if mesh is None:
            flat = {k: sf.torch_tensor(k).to(dev, copy=True)
                    for k in sf.keys()}
            params = _join(flat, manifest["qtensors"])
        else:
            from turboinfer_tpu_torch.parallel import shardings
            lazy = _join({k: sf.torch_tensor(k) for k in sf.keys()},
                         manifest["qtensors"])
            mine = shardings.rank_params(lazy, config, mesh)
            params = _to_device(mine, dev)
    tlog.log_info("restored checkpoint %s%s", path, "" if mesh is None
                  else f" onto rank {mesh.rank} of mesh {mesh.shape}")
    return params, config, manifest.get("metadata", {})
