"""Shared model machinery: the KV cache container and its storage codecs,
projection fusion, cache reset and parameter accounting (counterpart of
turboinfer_tpu/models/common.py).

The port keeps the head-major stacked cache [L, B, Hkv, T, D] for every
head size; the JAX package's fused-head layout exists for TPU lane
alignment and has no counterpart. A cache stores the model dtype, bf16,
scaled int8 (per-(token, head) f32 scale planes [L, B, Hkv, T]) or fp8
e4m3 as raw uint8 bits, with the JAX package's bytes.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from turboinfer_tpu_torch.config import ModelConfig
from turboinfer_tpu_torch.core.qtensor import QEmbed, QTensor, concat_n
from turboinfer_tpu_torch.utils.device import resolve_device
from turboinfer_tpu_torch.utils.errors import QuantizationError

# e4m3 codes 0x7F/0xFF: the JAX package writes them for |x| > 464 (where
# the round-to-nearest-even result would pass 448) and for inf/NaN;
# torch's saturating cast writes +-448 there instead.
E4M3_NAN_ABOVE = 464.0
COMPRESSED_KV = (torch.int8, torch.uint8)
# f32(1 / 127): int8 scales are absmax times it (see encode_kv_scaled)
INV_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))


class KVCache(NamedTuple):
    """Device-resident KV cache, head-major [L, B, Hkv, T, D].

    The forward writes k and v (and the scales) IN PLACE (JAX returns new
    arrays); the returned KVCache shares them and carries the new
    `length` [B] int32, the number of valid slots of each sequence.
    k_scale/v_scale: f32 [L, B, Hkv, T] for an int8 cache (value = code
    * scale), else None."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]


def resolve_kv_dtype(kv_cache_dtype: Optional[str], model_dtype):
    """InferenceConfig.kv_cache_dtype -> cache storage dtype: "fp8" ->
    torch.uint8 (raw e4m3 bits for the cache's whole life), "int8" ->
    torch.int8 (with scale planes), "bf16", or "model" (also "" and
    None) -> the model dtype."""
    if kv_cache_dtype == "fp8":
        return torch.uint8
    if kv_cache_dtype == "int8":
        return torch.int8
    if kv_cache_dtype == "bf16":
        return torch.bfloat16
    if kv_cache_dtype in ("model", "", None):
        return model_dtype
    raise ValueError(f"unknown kv_cache_dtype {kv_cache_dtype!r} "
                     "(expected 'model', 'fp8', 'int8', or 'bf16')")


def check_kv_dtype(model, architecture: str, kv_dtype,
                   paged: bool = False) -> None:
    """Raise for a compressed cache a family's forward does not thread,
    with the JAX package's two questions: int8 and fp8 caches run where
    the module sets SUPPORTS_INT8_KV (its forwards thread the scale
    planes and read fp8); a paged pool (paged=True) of int8 needs
    SUPPORTS_INT8_KV_PAGED too, which defaults to SUPPORTS_INT8_KV (JAX
    scheduler.py:1400-1408: GPT-OSS serves fp8 pools, not int8 ones)."""
    contiguous = getattr(model, "SUPPORTS_INT8_KV", False)
    if kv_dtype in COMPRESSED_KV and not contiguous:
        raise NotImplementedError(
            f"{architecture}: int8 and fp8 KV caches are not ported for this "
            "family yet")
    if paged and kv_dtype == torch.int8 and not getattr(
            model, "SUPPORTS_INT8_KV_PAGED", contiguous):
        raise NotImplementedError(
            f"{architecture} paged serving does not support "
            "kv_cache_dtype='int8'; use 'fp8' or 'bf16'")


def init_cache(config: ModelConfig, batch_size: int,
               max_seq: Optional[int] = None, dtype=None,
               device="cuda") -> KVCache:
    dev = resolve_device(device)
    T = max_seq or config.max_seq_len
    dtype = dtype or config.dtype
    if dtype not in (torch.float32, torch.bfloat16, torch.float16,
                     *COMPRESSED_KV):
        raise ValueError(f"KV cache dtype {dtype} is not a cache storage "
                         "dtype (see resolve_kv_dtype)")
    shape = (config.num_layers, batch_size, config.kv_heads, T,
             config.head_dim_)
    ks = vs = None
    if dtype == torch.int8:
        # two distinct scale planes, as the JAX package keeps them
        ks = torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
        vs = torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev),
                   length=torch.zeros((batch_size,), dtype=torch.int32,
                                      device=dev),
                   k_scale=ks, v_scale=vs)


def reset_cache(cache: KVCache) -> KVCache:
    """A zero-filled cache of the same shapes (JAX common.reset_cache):
    K, V, length and each scale plane from its own tensor, so the two
    planes never share storage."""
    def zeros(t):
        return None if t is None else torch.zeros_like(t)
    return KVCache(k=zeros(cache.k), v=zeros(cache.v),
                   length=zeros(cache.length), k_scale=zeros(cache.k_scale),
                   v_scale=zeros(cache.v_scale))


def _e4m3_bits(x: torch.Tensor) -> torch.Tensor:
    """float -> e4m3 bit patterns equal to the JAX package's
    x.astype(float8_e4m3fn): round to nearest even below the NaN bound,
    0x7F | sign beyond it and for inf/NaN (torch's cast saturates)."""
    bits = x.to(torch.float8_e4m3fn).view(torch.uint8)
    nan = (x.abs() > E4M3_NAN_ABOVE) | ~torch.isfinite(x)
    code = torch.where(torch.signbit(x), 0xFF, 0x7F).to(torch.uint8)
    return torch.where(nan, code, bits)


def encode_kv_scaled(x: torch.Tensor, cache_dtype):
    """K/V values [..., D] -> (stored, scale or None). int8: symmetric
    absmax per row over D in f32, scale = max(absmax, 1e-12) times the
    f32 reciprocal of 127, codes round-half-even(x / scale) (a true
    division) clipped to +-127: the bytes and scales the JAX package
    writes, whose compiled `/ 127.0` XLA turns into that multiply (an
    un-jitted call of its encode_kv_scaled divides, one ulp apart in
    some scales); uint8: e4m3 bits (see _e4m3_bits); else a cast."""
    if cache_dtype == torch.int8:
        xf = x.to(torch.float32)
        s = xf.abs().amax(dim=-1).clamp_min(1e-12) * INV_127
        q = torch.round(xf / s[..., None]).clamp(-127, 127).to(torch.int8)
        return q, s
    if cache_dtype == torch.uint8:
        return _e4m3_bits(x), None
    return x.to(cache_dtype), None


def decode_kv(x: torch.Tensor, out_dtype,
              scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cache storage -> values: e4m3 bits as the kernels decode them
    (ops.e4m3_to_float: 0x7F/0xFF are +-480, not NaN, so attention stays
    finite; the JAX package's own plain decode_kv gives NaN there), int8
    codes times the scale [..., T] in f32, else a cast."""
    if x.dtype == torch.uint8:
        from turboinfer_tpu_torch.kernels.ops import e4m3_to_float
        return e4m3_to_float(x, out_dtype)
    if x.dtype == torch.int8:
        if scale is None:
            raise ValueError("int8 KV decode requires its scale array")
        return (x.to(torch.float32)
                * scale[..., None].to(torch.float32)).to(out_dtype)
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


def param_count(params: Any) -> int:
    """Parameters, as the JAX package counts them (common.param_count): a
    QTensor is its logical K x N times every stacking dim of its data
    ([L, ...] layer stacks, [L, E, ...] expert stacks count L * E
    matrices), any other tensor its elements (a QEmbed's codes and
    scales, as JAX's pytree leaves)."""
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QTensor):
            n = leaf.shape[0] * leaf.shape[1]
            for d in leaf.data.shape[:-2]:
                n *= d
            total += n
        elif isinstance(leaf, QEmbed):
            total += leaf.data.numel() + leaf.scales.numel()
        else:
            total += leaf.numel()
    return total


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
