"""Top-level model loading, format detection -> ModelData ->
InferenceEngine: the counterpart of turboinfer_tpu/loader/loader.py.

GGUF v3 (with its tokenizer from the metadata arrays), SafeTensors
(single files and model.safetensors.index.json shards), PyTorch
.bin/.pt/.pth state dicts (torch.load(weights_only=True)), TINQ and HF
checkpoint directories load into the port's parameter dict on the asked
device (cuda unless the caller asks for the CPU); ONNX raises. The
config comes from the caller, a config.json sidecar, the GGUF metadata,
or the tensor shapes, in that order. An HF directory's tokenizer.json
sidecar (with tokenizer_config.json's chat template) is attached as an
HFTokenizer; a corrupt sidecar is logged and skipped, as the JAX package
does, but a missing package (`regex`) raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from typing import Any, Dict, Optional

import torch

from turboinfer_tpu_torch.config import InferenceConfig, ModelConfig
from turboinfer_tpu_torch.loader import gguf as gguf_mod
from turboinfer_tpu_torch.loader import mapping
from turboinfer_tpu_torch.loader import safetensors as st_mod
from turboinfer_tpu_torch.loader import tinq as tinq_mod
from turboinfer_tpu_torch.tokenizer import bpe as tok_mod
from turboinfer_tpu_torch.tokenizer import hf as hf_tok
from turboinfer_tpu_torch.utils import logging as tlog
from turboinfer_tpu_torch.utils.errors import ModelFormatError


@dataclasses.dataclass
class ModelData:
    """A loaded model: the parameter dict, its config, a tokenizer when
    the file carries one, and where it came from."""
    params: Dict[str, Any]
    config: ModelConfig
    tokenizer: Optional[tok_mod.Tokenizer] = None
    source_format: str = "memory"

    def summary(self) -> str:
        """One line: name, architecture, widths, parameter count and
        bytes, source format (the JAX package's ModelData.summary)."""
        from turboinfer_tpu_torch.models.common import (param_bytes,
                                                        param_count)
        n = param_count(self.params)
        b = param_bytes(self.params)
        c = self.config
        return (f"{c.name} ({c.architecture}) — vocab {c.vocab_size}, "
                f"hidden {c.hidden_size}, layers {c.num_layers}, heads "
                f"{c.num_heads}/{c.kv_heads}kv, ffn {c.ffn_dim} | "
                f"{n / 1e6:.1f}M params, {b / 1e6:.1f} MB "
                f"[{self.source_format}]")


def detect_format(path: str) -> str:
    """By extension (a model.safetensors.index.json is safetensors)."""
    if path.endswith(".safetensors.index.json"):
        return "safetensors"
    ext = os.path.splitext(path)[1].lower()
    return {".gguf": "gguf", ".safetensors": "safetensors",
            ".tinq": "tinq", ".pt": "pytorch", ".pth": "pytorch",
            ".bin": "pytorch", ".onnx": "onnx"}.get(ext, "unknown")


def load_model_data(path: str, dtype=None, device="cuda") -> ModelData:
    if not os.path.exists(path):
        raise FileNotFoundError(f"model file not found: {path}")
    if os.path.isdir(path):
        return load_checkpoint_dir(path, dtype=dtype, device=device)
    fmt = detect_format(path)
    if fmt == "gguf":
        return load_gguf(path, dtype=dtype, device=device)
    if fmt == "safetensors":
        if path.endswith(".index.json"):
            return load_safetensors_sharded(path, dtype=dtype, device=device)
        return load_safetensors(path, dtype=dtype, device=device)
    if fmt == "tinq":
        return load_tinq(path, device=device)
    if fmt == "pytorch":
        return load_pytorch(path, dtype=dtype, device=device)
    if fmt == "onnx":
        raise ModelFormatError(
            "ONNX files are not supported: export the model to "
            "safetensors or GGUF first")
    raise ModelFormatError(f"unrecognized model format for '{path}'")


def load_gguf(path: str, dtype=None, device="cuda") -> ModelData:
    """GGUF v3 -> ModelData with the tokenizer of its metadata arrays."""
    with gguf_mod.read_gguf(path) as gf:
        config = mapping.config_from_gguf_metadata(
            gf.metadata, dtype=dtype or torch.bfloat16)
        tokenizer = tok_mod.from_gguf_metadata(gf.metadata)
        if config.vocab_size <= 0:
            emb = mapping.resolve_name(list(gf.tensors), "embed")
            if emb:
                config = config.replace(vocab_size=gf.tensors[emb].shape[0])
        get = gf.tensor
        if config.norm_offset:
            # llama.cpp's Gemma converter bakes the (1 + w) offset into
            # every *norm.weight (convert_hf_to_gguf.py GemmaModel:
            # data += 1); the model applies the offset itself
            # (config.norm_offset), so un-bake it here or every norm
            # would multiply by (2 + w).
            def get(name, _base=gf.tensor):
                t = _base(name)
                return t - 1.0 if name.endswith("norm.weight") else t
        params = mapping.assemble_for(config)(
            get, list(gf.tensors), config, dtype=dtype or config.dtype,
            device=device)
        tlog.log_info("loaded GGUF %s: %d tensors, arch=%s", path,
                      len(gf.tensors), config.architecture)
        return ModelData(params=params, config=config, tokenizer=tokenizer,
                         source_format="gguf")


def _finish_hf_load(get, names, shapes, dirname: str, config, dtype,
                    source_format: str, device) -> ModelData:
    """Shared tail of every HF-style load (single and sharded
    safetensors, PyTorch): the config (explicit argument > config.json
    sidecar > shape inference), then the assembled parameters."""
    if config is None:
        sidecar = os.path.join(dirname, "config.json")
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                config = mapping.config_from_hf_dict(json.load(f),
                                                     dtype=dtype)
            tlog.log_info("using HF config.json sidecar (%s)",
                          config.architecture)
        else:
            config = _infer_config_from_shapes(shapes, names, dtype)
    params = mapping.assemble_for(config)(get, names, config,
                                          dtype=dtype or config.dtype,
                                          device=device)
    tokenizer = None
    try:
        tokenizer = hf_tok.from_hf_dir(dirname)
        if tokenizer is not None:
            tlog.log_info("loaded tokenizer.json sidecar (%s, vocab %d)",
                          tokenizer.kind, tokenizer.vocab_size)
    except ImportError:
        # a missing package (`regex` for ByteLevel/Split patterns) is
        # not a corrupt sidecar: say so instead of loading without one
        raise
    except Exception as e:               # corrupt/unsupported sidecar
        tlog.log_warning("tokenizer.json sidecar ignored: %s", e)
    return ModelData(params=params, config=config, tokenizer=tokenizer,
                     source_format=source_format)


def load_safetensors(path: str, dtype=None,
                     config: Optional[ModelConfig] = None,
                     device="cuda") -> ModelData:
    """SafeTensors -> ModelData. Config: the `config` argument > a
    config.json sidecar in the same directory > shape inference."""
    with st_mod.read_safetensors(path) as sf:
        names = list(sf.keys())
        data = _finish_hf_load(
            sf.torch_tensor, names,
            {n: e["shape"] for n, e in sf.entries.items()},
            os.path.dirname(path) or ".", config, dtype, "safetensors",
            device)
    tlog.log_info("loaded SafeTensors %s: %d tensors", path, len(names))
    return data


def load_safetensors_sharded(index_path: str, dtype=None,
                             config: Optional[ModelConfig] = None,
                             device="cuda") -> ModelData:
    """A multi-file HF checkpoint through model.safetensors.index.json
    (weight_map: tensor name -> shard file)."""
    with open(index_path) as f:
        weight_map: Dict[str, str] = json.load(f)["weight_map"]
    dirname = os.path.dirname(index_path) or "."
    with contextlib.ExitStack() as stack:
        files: Dict[str, Any] = {}

        def shard(name: str):
            fname = weight_map[name]
            if fname not in files:
                files[fname] = stack.enter_context(
                    st_mod.read_safetensors(os.path.join(dirname, fname)))
            return files[fname]

        names = list(weight_map)
        shapes = {n: shard(n).entries[n]["shape"] for n in names}
        data = _finish_hf_load(
            lambda name: shard(name).torch_tensor(name), names, shapes,
            dirname, config, dtype, "safetensors", device)
    tlog.log_info("loaded sharded SafeTensors %s: %d tensors in %d shards",
                  index_path, len(names), len(set(weight_map.values())))
    return data


def _torch_load(path: str):
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        raise ModelFormatError(
            f"cannot read PyTorch checkpoint {path}: {e}") from e


def load_pytorch(path: str, dtype=None,
                 config: Optional[ModelConfig] = None,
                 device="cuda") -> ModelData:
    """PyTorch .bin/.pt/.pth state dict -> ModelData, through the same
    name mapping as safetensors. Takes a raw state dict or the common
    {"state_dict"|"model": ...} wrappers."""
    sd = _torch_load(path)
    for key in ("state_dict", "model"):
        if isinstance(sd, dict) and key in sd and isinstance(sd[key], dict):
            sd = sd[key]
    sd = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    if not sd:
        raise ModelFormatError(f"no tensors found in {path}")
    names = list(sd)
    data = _finish_hf_load(sd.__getitem__, names,
                           {n: list(t.shape) for n, t in sd.items()},
                           os.path.dirname(path) or ".", config, dtype,
                           "pytorch", device)
    tlog.log_info("loaded PyTorch %s: %d tensors", path, len(names))
    return data


def load_checkpoint_dir(path: str, dtype=None, device="cuda") -> ModelData:
    """An HF checkpoint directory: sharded safetensors index > a single
    safetensors file > PyTorch (sharded index or a single file) > a
    .gguf or .tinq inside."""
    def p(name):
        return os.path.join(path, name)

    if os.path.exists(p("model.safetensors.index.json")):
        return load_safetensors_sharded(p("model.safetensors.index.json"),
                                        dtype=dtype, device=device)
    st_files = sorted(f for f in os.listdir(path)
                      if f.endswith(".safetensors"))
    if len(st_files) == 1:
        return load_safetensors(p(st_files[0]), dtype=dtype, device=device)
    if len(st_files) > 1:
        raise ModelFormatError(
            f"{path} has {len(st_files)} .safetensors files but no "
            "model.safetensors.index.json to map them")
    if os.path.exists(p("pytorch_model.bin.index.json")):
        with open(p("pytorch_model.bin.index.json")) as f:
            weight_map = json.load(f)["weight_map"]
        shards: Dict[str, Dict[str, Any]] = {}

        def get(name: str) -> torch.Tensor:
            fname = weight_map[name]
            if fname not in shards:
                shards[fname] = _torch_load(p(fname))
            return shards[fname][name]

        names = list(weight_map)
        shapes = {n: list(get(n).shape) for n in names}
        data = _finish_hf_load(get, names, shapes, path, None, dtype,
                               "pytorch", device)
        tlog.log_info("loaded sharded PyTorch %s: %d tensors", path,
                      len(names))
        return data
    for f in sorted(os.listdir(path)):
        if detect_format(p(f)) == "pytorch":
            return load_pytorch(p(f), dtype=dtype, device=device)
        if f.endswith(".gguf"):
            return load_gguf(p(f), dtype=dtype, device=device)
        if f.endswith(".tinq"):
            return load_tinq(p(f), device=device)
    raise ModelFormatError(f"no loadable checkpoint found in {path}")


def _infer_config_from_shapes(shapes: Dict[str, Any], names,
                              dtype=None) -> ModelConfig:
    """A llama-shaped config from tensor shapes alone (`shapes`: tensor
    name -> shape list)."""
    emb_name = mapping.resolve_name(names, "embed")
    if emb_name is None:
        raise ValueError("cannot infer config: no embedding tensor found")
    V, H = shapes[emb_name]
    L = 0
    while mapping.resolve_name(names, "attn_norm", L) is not None:
        L += 1
    if L == 0:
        raise ValueError("cannot infer config: no decoder layers found")
    wk = mapping.resolve_name(names, "wk", 0)
    wq = mapping.resolve_name(names, "wq", 0)
    wup = mapping.resolve_name(names, "w_up", 0)
    if wk is None or wq is None or wup is None:
        raise ValueError(
            "cannot infer config from tensor shapes (fused qkv/gate_up "
            "layout?) — provide a config.json sidecar")
    kv_dim = shapes[wk][0]
    q_dim = shapes[wq][0]
    F = shapes[wup][0]
    # head_dim from a standard 128/64 split
    head_dim = 128 if q_dim % 128 == 0 and q_dim >= 1024 else \
        (q_dim // max(q_dim // 64, 1))
    return ModelConfig(
        vocab_size=V, hidden_size=H, num_layers=L,
        num_heads=q_dim // head_dim, num_kv_heads=kv_dim // head_dim,
        intermediate_size=F, head_dim=head_dim,
        dtype=dtype or torch.bfloat16, name="model", architecture="llama")


def load_tinq(path: str, device="cuda") -> ModelData:
    params, config, qconfig, meta = tinq_mod.load(path, device=device)
    tlog.log_info("loaded TINQ %s (quant=%s)", path,
                  qconfig.type.value if qconfig else "none")
    return ModelData(params=params, config=config, source_format="tinq")


def load_engine(path: str, config: Optional[InferenceConfig] = None,
                lora: Optional[str] = None, device="cuda", **engine_kw):
    """Load a model file into a ready InferenceEngine on `device`.
    lora: an optional PEFT adapter directory or file, attached through
    the runtime low-rank path (works on quantized bases). The engine's
    tokenizer is the file's, else the built-in one; without `config`,
    max_seq_len is the model's and eos the tokenizer's. With
    engine_kw["mesh"], the file is read to the host and the engine keeps
    this rank's slice on mesh.device."""
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    from turboinfer_tpu_torch.loader import lora as lora_mod
    host = "cpu" if engine_kw.get("mesh") is not None else device
    data = load_model_data(path, device=host)
    if lora is not None:
        data.params = lora_mod.apply_lora(
            data.params, lora_mod.load_lora(lora, data.config,
                                            device=host))
    tokenizer = data.tokenizer or tok_mod.BuiltinTokenizer(
        vocab_size=data.config.vocab_size)
    if config is None:
        config = InferenceConfig(
            max_seq_len=data.config.max_seq_len,
            eos_token_id=getattr(tokenizer, "eos_id", 2))
    return InferenceEngine(data.params, data.config, config,
                           tokenizer=tokenizer, device=device, **engine_kw)
