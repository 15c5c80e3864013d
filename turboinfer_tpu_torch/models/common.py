"""Shared model machinery: the KV cache container, projection fusion and
parameter accounting (counterpart of turboinfer_tpu/models/common.py).

The port keeps the head-major stacked cache [L, B, Hkv, T, D] for every
head size; the JAX package's fused-head layout exists for TPU lane
alignment and has no counterpart. Only model-dtype caches are ported so
far (int8 and fp8 caches come in a later slice).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from turboinfer_tpu_torch.config import ModelConfig
from turboinfer_tpu_torch.core.qtensor import QEmbed, QTensor, concat_n
from turboinfer_tpu_torch.utils.device import resolve_device
from turboinfer_tpu_torch.utils.errors import QuantizationError


class KVCache(NamedTuple):
    """Device-resident KV cache, head-major [L, B, Hkv, T, D].

    The forward writes k and v IN PLACE (JAX returns new arrays); the
    returned KVCache shares them and carries the new `length` [B] int32,
    the number of valid slots of each sequence."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]


def init_cache(config: ModelConfig, batch_size: int,
               max_seq: Optional[int] = None, dtype=None,
               device="cuda") -> KVCache:
    dev = resolve_device(device)
    T = max_seq or config.max_seq_len
    dtype = dtype or config.dtype
    if dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise NotImplementedError(
            f"KV cache dtype {dtype} is not ported yet (model dtype only)")
    shape = (config.num_layers, batch_size, config.kv_heads, T,
             config.head_dim_)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev),
                   length=torch.zeros((batch_size,), dtype=torch.int32,
                                      device=dev))


def encode_kv(x: torch.Tensor, cache_dtype) -> torch.Tensor:
    """K/V values -> cache storage (model dtype: a cast)."""
    if cache_dtype in (torch.int8, torch.uint8):
        raise NotImplementedError("int8/fp8 KV caches are not ported yet")
    return x.to(cache_dtype)


def decode_kv(x: torch.Tensor, out_dtype) -> torch.Tensor:
    """Cache storage -> values (model dtype: a cast)."""
    if x.dtype in (torch.int8, torch.uint8):
        raise NotImplementedError("int8/fp8 KV caches are not ported yet")
    return x.to(out_dtype)


def fuse_projections(params: Any) -> Any:
    """Fuse same-input projections along the output axis: wq/wk/wv ->
    "wqkv" (and the q/k/v biases -> "b_qkv" whenever the weights fused,
    as the JAX package does), w_gate/w_up -> "w_gateup" and quantized
    MoE experts' we_gate/we_up -> "we_gateup" (expert by expert).
    Numerically identical (every output column's K-reduction is
    unchanged); fewer kernel launches. fp expert stacks stay split, as
    the JAX package keeps every expert stack: fusing GPT-OSS-20B's bf16
    experts would concatenate 2 x 12.7 GB while the originals live."""
    if not isinstance(params, dict) or not isinstance(
            params.get("layers"), dict):
        return params
    layers = dict(params["layers"])

    def fuse(names, out, quantized_only=False):
        ws = [layers.get(n) for n in names]
        if any(w is None for w in ws):
            return
        if quantized_only and not all(isinstance(w, QTensor) for w in ws):
            return
        if all(isinstance(w, QTensor) for w in ws):
            try:
                fused = concat_n(ws)
            except QuantizationError:
                return
        elif any(isinstance(w, QTensor) for w in ws):
            return
        else:
            if len({(w.dtype, tuple(w.shape[:-1])) for w in ws}) != 1:
                return
            fused = torch.cat(ws, dim=-1)
        for n in names:
            del layers[n]
        layers[out] = fused

    fuse(("wq", "wk", "wv"), "wqkv")
    if "wqkv" in layers and "b_q" in layers:
        layers["b_qkv"] = torch.cat([layers.pop("b_q"), layers.pop("b_k"),
                                     layers.pop("b_v")], dim=-1)
    fuse(("w_gate", "w_up"), "w_gateup")
    fuse(("we_gate", "we_up"), "we_gateup", quantized_only=True)
    return {**params, "layers": layers}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (QTensor, QEmbed, torch.Tensor)):
        yield tree


def param_bytes(params: Any) -> int:
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QTensor):
            total += leaf.nbytes()
        elif isinstance(leaf, QEmbed):
            total += (leaf.data.numel() * leaf.data.element_size()
                      + leaf.scales.numel() * leaf.scales.element_size())
        else:
            total += leaf.numel() * leaf.element_size()
    return total


def params_to(params: Any, device) -> Any:
    """Move a parameter tree to `device` (tensors, QTensors, QEmbeds)."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, QTensor):
        return params.to(device)
    if isinstance(params, QEmbed):
        return QEmbed(params.data.to(device), params.scales.to(device))
    if isinstance(params, torch.Tensor):
        return params.to(device)
    return params
