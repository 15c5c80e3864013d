"""LLaMA-class decoder in PyTorch: counterpart of
turboinfer_tpu/models/llama.py for the head-major stacked-cache path.

Parameters are a plain dict with the JAX package's structure: weights
[in, out], per-layer weights stacked on a leading layer axis, each
either a tensor or a QTensor:
  {"embed": [V, H] (or QEmbed),
   "layers": {"attn_norm", "ffn_norm": [L, H],
              "wq" [L, H, Hq*D], "wk"/"wv" [L, H, Hkv*D], "wo" [L, Hq*D, H],
              "w_gate"/"w_up" [L, H, F], "w_down" [L, F, H]
              (or the fused "wqkv" / "w_gateup")},
   "final_norm": [H], "lm_head": [H, V]}
A Python loop over layers replaces lax.scan; the kernels read layer li
of the stacked weights and cache through pointer offsets, never copies.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from turboinfer_tpu_torch.config import ModelConfig
from turboinfer_tpu_torch.kernels import cache_write, dispatch, ops
from turboinfer_tpu_torch.models.common import KVCache, encode_kv
from turboinfer_tpu_torch.models.common import init_cache as _init_cache
from turboinfer_tpu_torch.utils.device import resolve_device

# ModelConfig knobs whose layer features are not ported yet, with the
# value that means "off".
_UNPORTED = (("sliding_window", None), ("attn_logit_softcap", None),
             ("final_logit_softcap", None), ("norm_offset", False),
             ("scale_embeddings", False), ("embedding_multiplier", None),
             ("residual_multiplier", None), ("logits_scaling", None),
             ("attn_bias", False), ("qk_norm", False), ("post_norms", False),
             ("attn_scale", None), ("rope_local_theta", None),
             ("parallel_residual", False), ("alibi", False),
             ("rotary_pct", 1.0), ("num_experts", 0), ("kv_lora_rank", None))


def check_supported(config: ModelConfig) -> None:
    """Raise NotImplementedError for a config knob this slice lacks."""
    for name, off in _UNPORTED:
        if getattr(config, name) != off:
            raise NotImplementedError(
                f"ModelConfig.{name}={getattr(config, name)!r} is not ported "
                "to the PyTorch package yet")
    if config.architecture != "llama":
        raise NotImplementedError(
            f"architecture {config.architecture!r} is not ported yet")


def init_cache(config: ModelConfig, batch_size: int, max_seq=None,
               dtype=None, device="cuda") -> KVCache:
    """Head-major [L, B, Hkv, T, D] cache of zeros on `device`."""
    return _init_cache(config, batch_size, max_seq, dtype, device)


def init_params(config: ModelConfig, seed: int = 0, device="cuda",
                dtype=None) -> Dict[str, Any]:
    """Random fp parameters (N(0, 1/fan_in)), unit norms."""
    dev = resolve_device(device)
    dtype = dtype or config.dtype
    H, V, L = config.hidden_size, config.vocab_size, config.num_layers
    QD, KVD, F = config.q_dim, config.kv_dim, config.ffn_dim
    gen = torch.Generator(device=dev).manual_seed(seed)

    def w(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=dev)
                / fan_in ** 0.5).to(dtype)

    params = {
        "embed": w((V, H), H),
        "layers": {
            "attn_norm": torch.ones((L, H), dtype=dtype, device=dev),
            "ffn_norm": torch.ones((L, H), dtype=dtype, device=dev),
            "wq": w((L, H, QD), H), "wk": w((L, H, KVD), H),
            "wv": w((L, H, KVD), H), "wo": w((L, QD, H), QD),
            "w_gate": w((L, H, F), H), "w_up": w((L, H, F), H),
            "w_down": w((L, F, H), F),
        },
        "final_norm": torch.ones((H,), dtype=dtype, device=dev),
        "lm_head": w((H, V), H),
    }
    if config.tie_embeddings:
        params["lm_head"] = params["embed"].T
    return params


def qkv_proj(h, lw, li, B, S, Hq, Hkv, D):
    """q/k/v projections: one fused product when "wqkv" is present.
    Returns qk [B, S, Hq + Hkv, D] (q heads, then k heads; RoPE treats
    them in one pass) and v [B, S, Hkv, D], views of the product."""
    if "wqkv" in lw:
        qkv = ops.qmatmul(h, lw["wqkv"], li)
        qk = qkv[..., : (Hq + Hkv) * D]
        v = qkv[..., (Hq + Hkv) * D:]
    else:
        qk = torch.cat([ops.qmatmul(h, lw["wq"], li),
                        ops.qmatmul(h, lw["wk"], li)], dim=-1)
        v = ops.qmatmul(h, lw["wv"], li)
    return qk.reshape(B, S, Hq + Hkv, D), v.reshape(B, S, Hkv, D)


def gate_up_proj(h, lw, li):
    """SwiGLU gate/up: one fused product when "w_gateup" is present."""
    if "w_gateup" in lw:
        gu = ops.qmatmul(h, lw["w_gateup"], li)
        F = gu.shape[-1] // 2
        return gu[..., :F], gu[..., F:]
    return ops.qmatmul(h, lw["w_gate"], li), ops.qmatmul(h, lw["w_up"], li)


def _layer_forward(config: ModelConfig, x: torch.Tensor, lw: Dict[str, Any],
                   li: int, rope, cache: KVCache, start: torch.Tensor,
                   kv_len: torch.Tensor, fresh_prefill: bool,
                   decode_slots) -> torch.Tensor:
    """One decoder block (RMSNorm -> GQA attention -> residual -> RMSNorm
    -> SwiGLU -> residual) over the stacked cache, which it updates in
    place at layer li. rope: the forward's RoPE tables; decode_slots:
    (rows, positions) of the decode step's cache writes."""
    B, S, _ = x.shape
    Hq, Hkv, D = config.num_heads, config.kv_heads, config.head_dim_
    eps = config.rms_norm_eps
    T = cache.max_seq
    h = ops.rms_norm(x, lw["attn_norm"][li], eps)
    qk, v = qkv_proj(h, lw, li, B, S, Hq, Hkv, D)
    qk = ops.apply_rope(qk, None, mode=config.rope_mode, tables=rope)
    q, k = qk[:, :, :Hq], encode_kv(qk[:, :, Hq:], cache.k.dtype)
    v = encode_kv(v, cache.v.dtype)

    if S == 1:
        rows, pos = decode_slots
        cache.k[li, rows, :, pos] = k[:, 0]
        cache.v[li, rows, :, pos] = v[:, 0]
        attn = dispatch.attention_decode(q[:, 0], cache.k, cache.v, kv_len,
                                         layer_index=li)[:, None]
    elif fresh_prefill:
        # Cold prefill (cache.length == 0): write the slab at T offset 0
        # and attend the just-computed K/V, transposed by strides.
        cache_write.cache_write_fresh(cache.k, cache.v, k, v, li)
        attn = dispatch.attention_prefill(q, k.transpose(1, 2),
                                          v.transpose(1, 2), kv_len=kv_len,
                                          q_start=start)
    else:
        # Chunked prefill: per-row writes at start[b], then attend the
        # stacked cache's layer li in place.
        for b, s0 in enumerate(start.tolist()):
            n = min(S, T - s0)
            cache.k[li, b, :, s0:s0 + n] = k[b, :n].transpose(0, 1)
            cache.v[li, b, :, s0:s0 + n] = v[b, :n].transpose(0, 1)
        attn = dispatch.attention_prefill(q, cache.k, cache.v, kv_len=kv_len,
                                          q_start=start, layer_index=li)

    attn = attn.reshape(B, S, Hq * D).to(x.dtype)
    x = x + ops.qmatmul(attn, lw["wo"], li)
    h = ops.rms_norm(x, lw["ffn_norm"][li], eps)
    gate, up = gate_up_proj(h, lw, li)
    g = ops.glu(gate, up, config.hidden_act).to(x.dtype)
    return x + ops.qmatmul(g, lw["w_down"], li)


def forward(params: Dict[str, Any], config: ModelConfig, tokens: torch.Tensor,
            cache: KVCache, *, seq_lens: Optional[torch.Tensor] = None,
            logit_idx: Optional[torch.Tensor] = None,
            fresh_prefill: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """Forward over `tokens` [B, S] appending to `cache` (prefill S > 1 or
    decode S == 1). Queries sit at cache.length[b] + s.

    seq_lens: [B] new valid tokens per row (<= S, default S).
    logit_idx: [B] compute the head for that position only -> [B, 1, V].
    fresh_prefill: the caller guarantees cache.length == 0; attention
    then reads the just-computed K/V directly.
    Returns (logits [B, S or 1, V] f32, cache with the new length)."""
    check_supported(config)
    B, S = tokens.shape
    start = cache.length
    positions = start[:, None] + torch.arange(
        S, dtype=torch.int32, device=tokens.device)[None, :]
    if seq_lens is None:
        seq_lens = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    kv_len = (start + seq_lens).to(torch.int32)

    x = ops.embed_lookup(params["embed"], tokens, config.dtype)
    rope = ops.rope_tables(positions, config.head_dim_, config.rope_theta,
                           config.rope_mode, config.rope_scaling)
    # Decode writes one token per row at start[b]; JAX's
    # dynamic_update_slice clamps the offset into the cache, and so does
    # this indexed write.
    decode_slots = (torch.arange(B, device=tokens.device),
                    start.clamp(max=cache.max_seq - 1).long()) \
        if S == 1 else None
    layers = params["layers"]
    for li in range(config.num_layers):
        x = _layer_forward(config, x, layers, li, rope, cache, start, kv_len,
                           fresh_prefill, decode_slots)
    if logit_idx is not None:
        x = x[torch.arange(B, device=x.device), logit_idx.long()][:, None]
    x = ops.rms_norm(x, params["final_norm"], config.rms_norm_eps)
    logits = ops.qmatmul(x, params["lm_head"]).to(torch.float32)
    return logits, cache._replace(length=kv_len)
