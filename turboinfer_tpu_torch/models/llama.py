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
A LoRA adapter (loader/lora.py) rides in "layers" as "lora_<slot>_a"
[L, in, r] / "lora_<slot>_b" [L, r, out]; its f32 update adds to the
product's output (add_lora) on every path: q/k/v, gate/up, down and wo
in this family, q/k/v only in MoE and GPT-OSS, as in the JAX package's
forward of each family.
A Python loop over layers replaces lax.scan; the kernels read layer li
of the stacked weights and cache through pointer offsets, never copies.
The forwards take an `ffn_fn(config, h, layers, li)` hook, as the JAX
package's paged forwards do: the default is the dense GLU block
(dense_ffn), and models/moe.py passes its routed experts through the
same attention body.

The llama-family knobs of the JAX model, so Mistral, Qwen2/2.5, Qwen3,
Phi-3, Gemma, Gemma-2, Gemma-3 and Granite run through this body: q/k/v
biases ("b_q"/"b_k"/"b_v" [L, Hq*D | Hkv*D], attn_bias), q/k RMSNorm
before RoPE ("q_norm"/"k_norm" [L, D] per head, or [L, Hq*D] over the
whole projection; qk_norm), (1 + w) norms (norm_offset), embeddings
times sqrt(H) rounded to the model dtype (scale_embeddings), sandwich
norms ("post_attn_norm"/"post_ffn_norm" [L, H]; post_norms), Granite's
embedding, residual and logits multipliers, an attention scale folded
into q in f32 (attn_scale; the kernels keep 1/sqrt(D)), a sliding window
on every layer or, with sliding_window_pattern p, on every layer li with
(li + 1) % p != 0, a second RoPE base for those local layers
(rope_local_theta, without rope_scaling), and the attention and final
logit softcaps. Each layer's window and RoPE table are picked by a
Python `if` in the layer loop.

Caches and page pools store the model dtype, bf16, int8 (with f32 scale
planes) or fp8 (uint8 e4m3 bits). A compressed cache is written by the
encode-and-write kernel (cache_write.kv_encode_write) and read in place
by the attention kernels; a prefill into it, fresh or chunked, attends
the stacked cache's layer li, so it sees the quantized K/V, as the JAX
model's prefill does whenever the cache is compressed.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from turboinfer_tpu_torch.config import ModelConfig
from turboinfer_tpu_torch.kernels import cache_write, dispatch, ops
from turboinfer_tpu_torch.models.common import COMPRESSED_KV, KVCache
from turboinfer_tpu_torch.models.common import init_cache as _init_cache
# the model interface the JAX registry names (models/registry.py)
from turboinfer_tpu_torch.models.common import (  # noqa: F401
    param_bytes, param_count, reset_cache)
from turboinfer_tpu_torch.utils.device import resolve_device

# The forwards thread int8 scale planes and read fp8 caches (the engine
# and the schedulers check this flag, as the JAX package's do).
SUPPORTS_INT8_KV = True

# ModelConfig knobs of other families this body does not compute, with
# the value that means "off" (the NeoX/GPT-2 blocks, MoE, MLA).
_UNPORTED = (("parallel_residual", False), ("alibi", False),
             ("rotary_pct", 1.0), ("num_experts", 0), ("kv_lora_rank", None))
# the JAX registry's names for this body (turboinfer_tpu/models/registry.py)
ARCHITECTURES = ("llama", "mistral", "qwen2", "qwen3", "phi3", "gemma",
                 "gemma2", "gemma3", "granite")


def check_supported(config: ModelConfig) -> None:
    """Raise NotImplementedError for a config this body does not run."""
    for name, off in _UNPORTED:
        if getattr(config, name) != off:
            raise NotImplementedError(
                f"ModelConfig.{name}={getattr(config, name)!r} is not ported "
                "to the PyTorch package yet")
    if config.architecture not in ARCHITECTURES:
        raise NotImplementedError(
            f"architecture {config.architecture!r} is not ported yet")


def _alternating(config: ModelConfig) -> bool:
    p = config.sliding_window_pattern
    return bool(p and p > 1 and config.sliding_window)


def _is_global(config: ModelConfig, li: int) -> bool:
    """Layer li attends every key: no window, or the pattern's global
    layer ((li + 1) % sliding_window_pattern == 0)."""
    if not config.sliding_window:
        return True
    return _alternating(config) and (li + 1) % \
        config.sliding_window_pattern == 0


def layer_window(config: ModelConfig, li: int) -> Optional[int]:
    """The key window of layer li: sliding_window, but None on the
    global layers."""
    return None if _is_global(config, li) else config.sliding_window


class Rope(NamedTuple):
    """A forward's RoPE tables (ops.rope_tables): the global ones and,
    with rope_local_theta on an alternating config, the local layers'
    (rope_local_theta, no rope_scaling), else None."""
    glob: Tuple[torch.Tensor, torch.Tensor]
    local: Optional[Tuple[torch.Tensor, torch.Tensor]]


def rope_for(config: ModelConfig, positions: torch.Tensor) -> Rope:
    D = config.head_dim_
    glob = ops.rope_tables(positions, D, config.rope_theta, config.rope_mode,
                           config.rope_scaling)
    local = None
    if _alternating(config) and config.rope_local_theta is not None:
        local = ops.rope_tables(positions, D, config.rope_local_theta,
                                config.rope_mode)
    return Rope(glob, local)


def _as_dtype(v: float, dtype) -> float:
    """v rounded to dtype, as a Python float (what jnp.asarray(v, dtype)
    multiplies by; a bf16 product of two bf16 values is exact in f32)."""
    return torch.tensor(v, dtype=dtype).item()


def norm(config: ModelConfig, x: torch.Tensor, w: torch.Tensor
         ) -> torch.Tensor:
    """RMSNorm with the config's eps, and 1 + w under norm_offset."""
    return ops.rms_norm(x, w, config.rms_norm_eps,
                        1.0 if config.norm_offset else 0.0)


def embed(config: ModelConfig, params: Dict[str, Any],
          tokens: torch.Tensor) -> torch.Tensor:
    """The embedding, times sqrt(H) (scale_embeddings) and Granite's
    embedding_multiplier, each rounded to the model dtype first."""
    x = ops.embed_lookup(params["embed"], tokens, config.dtype)
    if config.scale_embeddings:
        x = x * _as_dtype(config.hidden_size ** 0.5, config.dtype)
    if config.embedding_multiplier:
        x = x * _as_dtype(config.embedding_multiplier, config.dtype)
    return x


def head(config: ModelConfig, params: Dict[str, Any],
         x: torch.Tensor) -> torch.Tensor:
    """Final norm, lm_head, f32 logits, the final softcap, then Granite's
    logits_scaling."""
    x = norm(config, x, params["final_norm"])
    logits = ops.apply_softcap(ops.qmatmul(x, params["lm_head"]).to(
        torch.float32), config.final_logit_softcap)
    if config.logits_scaling:
        logits = logits / config.logits_scaling
    return logits


def init_cache(config: ModelConfig, batch_size: int, max_seq=None,
               dtype=None, device="cuda") -> KVCache:
    """Head-major [L, B, Hkv, T, D] cache of zeros on `device`."""
    return _init_cache(config, batch_size, max_seq, dtype, device)


def init_params(config: ModelConfig, seed: int = 0, device="cuda",
                dtype=None) -> Dict[str, Any]:
    """Random fp parameters (N(0, 1/fan_in)), unit norms (zeros under
    norm_offset), and the slots of the config's knobs: q/k/v biases
    N(0, 0.02^2), q/k and post norms, as the JAX package's init_params."""
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
    layers = params["layers"]
    if config.attn_bias:
        for name, n in (("b_q", QD), ("b_k", KVD), ("b_v", KVD)):
            layers[name] = (0.02 * torch.randn((L, n), generator=gen,
                                               device=dev)).to(dtype)
    ones = dict(dtype=dtype, device=dev)
    if config.qk_norm:
        layers["q_norm"] = torch.ones((L, config.head_dim_), **ones)
        layers["k_norm"] = torch.ones((L, config.head_dim_), **ones)
    if config.post_norms:
        layers["post_attn_norm"] = torch.ones((L, H), **ones)
        layers["post_ffn_norm"] = torch.ones((L, H), **ones)
    if config.norm_offset:
        # Gemma stores norm weights as w - 1
        for name in ("attn_norm", "ffn_norm", "q_norm", "k_norm",
                     "post_attn_norm", "post_ffn_norm"):
            if name in layers:
                layers[name] = torch.zeros_like(layers[name])
        params["final_norm"] = torch.zeros_like(params["final_norm"])
    if config.tie_embeddings:
        params["lm_head"] = params["embed"].T
    return params


def add_lora(y: torch.Tensor, h: torch.Tensor, lw: Dict[str, Any],
             slot: str, li: int) -> torch.Tensor:
    """y plus the LoRA update of `slot` for input h, (h @ A) @ B in f32
    (the alpha/r scaling folded into B at load, loader/lora.py), when an
    adapter targets the slot ("lora_<slot>_a" [L, in, r], "_b" [L, r,
    out]); else y. It adds to the product's output, so it works on
    quantized bases, and after a fused product's split."""
    a = lw.get(f"lora_{slot}_a")
    if a is None:
        return y
    f32 = torch.float32
    d = (h.to(f32) @ a[li].to(f32)) @ lw[f"lora_{slot}_b"][li].to(f32)
    return y + d.to(y.dtype)


def qkv_proj(config: ModelConfig, h: torch.Tensor, lw: Dict[str, Any],
             li: int):
    """q/k/v projections of h [B, S, H]: one fused product when "wqkv"
    is present, plus the q/k/v biases when their slots ("b_qkv", or
    "b_q"/"b_k"/"b_v") are present and the q/k/v LoRA updates when an
    adapter targets them (add_lora), then under config.qk_norm the q/k
    RMSNorm: over the whole projection when "q_norm" is Hq*D wide
    (OLMoE), else per head. Returns qk [B, S, Hq + Hkv, D] (q heads,
    then k heads; RoPE treats them in one pass) and v [B, S, Hkv, D]."""
    B, S, _ = h.shape
    Hq, Hkv, D = config.num_heads, config.kv_heads, config.head_dim_
    if "wqkv" in lw:
        qkv = ops.qmatmul(h, lw["wqkv"], li)
        if "b_qkv" in lw:
            qkv = qkv + lw["b_qkv"][li].to(qkv.dtype)
        q, k = qkv[..., : Hq * D], qkv[..., Hq * D: (Hq + Hkv) * D]
        v = qkv[..., (Hq + Hkv) * D:]
    else:
        q = ops.qmatmul(h, lw["wq"], li)
        k = ops.qmatmul(h, lw["wk"], li)
        v = ops.qmatmul(h, lw["wv"], li)
        if "b_q" in lw:
            q = q + lw["b_q"][li].to(q.dtype)
            k = k + lw["b_k"][li].to(k.dtype)
            v = v + lw["b_v"][li].to(v.dtype)
    q = add_lora(q, h, lw, "wq", li)
    k = add_lora(k, h, lw, "wk", li)
    v = add_lora(v, h, lw, "wv", li)
    q, k = q.reshape(B, S, Hq, D), k.reshape(B, S, Hkv, D)
    if config.qk_norm and "q_norm" in lw:
        qw, kw = lw["q_norm"][li], lw["k_norm"][li]
        if qw.shape[-1] == Hq * D:
            q = norm(config, q.reshape(B, S, Hq * D), qw).reshape(q.shape)
            k = norm(config, k.reshape(B, S, Hkv * D), kw).reshape(k.shape)
        else:
            q, k = norm(config, q, qw), norm(config, k, kw)
    return torch.cat([q, k], dim=2), v.reshape(B, S, Hkv, D)


def gate_up_proj(h, lw, li):
    """SwiGLU gate/up: one fused product when "w_gateup" is present,
    plus their LoRA updates (add_lora)."""
    if "w_gateup" in lw:
        gu = ops.qmatmul(h, lw["w_gateup"], li)
        F = gu.shape[-1] // 2
        gate, up = gu[..., :F], gu[..., F:]
    else:
        gate = ops.qmatmul(h, lw["w_gate"], li)
        up = ops.qmatmul(h, lw["w_up"], li)
    return (add_lora(gate, h, lw, "w_gate", li),
            add_lora(up, h, lw, "w_up", li))


def _attn_inputs(config: ModelConfig, x: torch.Tensor, lw: Dict[str, Any],
                 li: int, rope: Rope):
    """RMSNorm, the q/k/v projections (with the q/k norms) and RoPE of
    layer li (its local table on a local layer), then attn_scale folded
    into q in f32 -> q [B, S, Hq, D] and k, v [B, S, Hkv, D] in the model
    dtype (the cache write encodes them)."""
    Hq, D = config.num_heads, config.head_dim_
    h = norm(config, x, lw["attn_norm"][li])
    qk, v = qkv_proj(config, h, lw, li)
    tables = rope.glob if rope.local is None or _is_global(config, li) \
        else rope.local
    qk = ops.apply_rope(qk, None, mode=config.rope_mode, tables=tables)
    q = qk[:, :, :Hq]
    if config.attn_scale is not None:
        # the kernels scale scores by D**-0.5: fold the override into q
        q = (q.to(torch.float32) * (config.attn_scale * float(D) ** 0.5)
             ).to(q.dtype)
    return q, qk[:, :, Hq:], v


def encode_write(k_store: torch.Tensor, v_store: torch.Tensor, k_scale,
                 v_scale, k: torch.Tensor, v: torch.Tensor,
                 rows: torch.Tensor, li: int) -> None:
    """Encode k/v [..., Hkv, D] into layer li of an int8 or fp8 cache
    [L, B, Hkv, T, D] or page pool [L, P, Hkv, page, D], in place: token
    n's head h lands in row rows[n] + h * T (or page) of the layer
    (rows[n] < 0: not written)."""
    L, n, Hkv, W, D = k_store.shape
    cache_write.kv_encode_write(k.reshape(-1, Hkv, D), v.reshape(-1, Hkv, D),
                                k_store, v_store, k_scale, v_scale, rows,
                                li * n * Hkv * W, W)


def dense_ffn(config: ModelConfig, h: torch.Tensor, lw: Dict[str, Any],
              li: int) -> torch.Tensor:
    """The dense GLU FFN block of layer li (the ffn_fn default), with
    the LoRA updates of gate, up and down."""
    gate, up = gate_up_proj(h, lw, li)
    g = ops.glu(gate, up, config.hidden_act).to(h.dtype)
    return add_lora(ops.qmatmul(g, lw["w_down"], li), g, lw, "w_down", li)


def _branch(config: ModelConfig, y: torch.Tensor, lw: Dict[str, Any],
            post: str, li: int) -> torch.Tensor:
    """A sublayer's output on its way into the residual: its post norm
    (post_norms) and Granite's residual_multiplier."""
    if config.post_norms:
        y = norm(config, y, lw[post][li])
    if config.residual_multiplier:
        y = y * _as_dtype(config.residual_multiplier, y.dtype)
    return y


def _attn_out_ffn(config: ModelConfig, x: torch.Tensor, attn: torch.Tensor,
                  lw: Dict[str, Any], li: int, ffn_fn) -> torch.Tensor:
    """Output projection and residual, then RMSNorm -> ffn_fn ->
    residual, of layer li (each branch through _branch). attn:
    [B, S, Hq, D]. The wo LoRA update is the llama family's (ffn_fn
    dense_ffn): the JAX package's MoE layer adds only q/k/v updates."""
    B, S, _ = x.shape
    attn = attn.reshape(B, S, -1).to(x.dtype)
    y = ops.qmatmul(attn, lw["wo"], li)
    if ffn_fn is dense_ffn:
        y = add_lora(y, attn, lw, "wo", li)
    x = x + _branch(config, y, lw, "post_attn_norm", li)
    h = norm(config, x, lw["ffn_norm"][li])
    return x + _branch(config, ffn_fn(config, h, lw, li), lw,
                       "post_ffn_norm", li)


def _layer_forward(config: ModelConfig, x: torch.Tensor, lw: Dict[str, Any],
                   li: int, rope, cache: KVCache, start: torch.Tensor,
                   kv_len: torch.Tensor, fresh_prefill: bool,
                   slots, ffn_fn) -> torch.Tensor:
    """One decoder block (RMSNorm -> GQA attention -> residual -> RMSNorm
    -> ffn_fn -> residual) over the stacked cache, which it updates in
    place at layer li. rope: the forward's Rope; slots: for a
    compressed cache, the layer-0 row of every new token (forward's
    cache_rows); else (rows, positions) of a decode step's cache writes,
    or the host list of a chunked prefill's row starts. The layer's
    window and the attention softcap go to every attention kernel."""
    S = x.shape[1]
    T = cache.max_seq
    q, k, v = _attn_inputs(config, x, lw, li, rope)
    mask = dict(window=layer_window(config, li),
                softcap=config.attn_logit_softcap)
    if cache.k.dtype in COMPRESSED_KV:
        encode_write(cache.k, cache.v, cache.k_scale, cache.v_scale, k, v,
                     slots, li)
        if S == 1:
            attn = dispatch.attention_decode(
                q[:, 0], cache.k, cache.v, kv_len, layer_index=li,
                k_scale=cache.k_scale, v_scale=cache.v_scale,
                **mask)[:, None]
        else:
            # fresh or chunked: attend the quantized K/V in the cache
            attn = dispatch.attention_prefill(
                q, cache.k, cache.v, kv_len=kv_len, q_start=start,
                layer_index=li, k_scale=cache.k_scale, v_scale=cache.v_scale,
                **mask)
        return _attn_out_ffn(config, x, attn, lw, li, ffn_fn)
    k, v = k.to(cache.k.dtype), v.to(cache.k.dtype)
    if S == 1:
        rows, pos = slots
        cache.k[li, rows, :, pos] = k[:, 0]
        cache.v[li, rows, :, pos] = v[:, 0]
        attn = dispatch.attention_decode(q[:, 0], cache.k, cache.v, kv_len,
                                         layer_index=li, **mask)[:, None]
    elif fresh_prefill:
        # Cold prefill (cache.length == 0): write the slab at T offset 0
        # and attend the just-computed K/V, transposed by strides.
        cache_write.cache_write_fresh(cache.k, cache.v, k, v, li)
        attn = dispatch.attention_prefill(q, k.transpose(1, 2),
                                          v.transpose(1, 2), kv_len=kv_len,
                                          q_start=start, **mask)
    else:
        # Chunked prefill: per-row writes at start[b], then attend the
        # stacked cache's layer li in place.
        for b, s0 in enumerate(slots):
            n = min(S, T - s0)
            cache.k[li, b, :, s0:s0 + n] = k[b, :n].transpose(0, 1)
            cache.v[li, b, :, s0:s0 + n] = v[b, :n].transpose(0, 1)
        attn = dispatch.attention_prefill(q, cache.k, cache.v, kv_len=kv_len,
                                          q_start=start, layer_index=li,
                                          **mask)
    return _attn_out_ffn(config, x, attn, lw, li, ffn_fn)


def cache_rows(cache: KVCache, start: torch.Tensor, S: int) -> torch.Tensor:
    """Layer-0 row (head 0) of every new token [B * S] of a forward over
    a compressed cache: ((b * Hkv) * T + start[b] + s); a decode
    position clamps into the cache as JAX's dynamic_update_slice does,
    a prefill token past T gets -1 (not written, as the chunked write of
    a model-dtype cache drops it)."""
    _, B, Hkv, T, _ = cache.k.shape
    dev = start.device
    pos = start.long()[:, None] + torch.arange(S, device=dev)[None, :]
    if S == 1:
        pos = pos.clamp(max=T - 1)
    rows = torch.arange(B, device=dev)[:, None] * (Hkv * T) + pos
    return torch.where(pos < T, rows, -1).reshape(-1)


def _resolve_ffn(config: ModelConfig, ffn_fn):
    """ffn_fn None is this family's dense FFN, and the config is checked
    here; a family that brings its own FFN has checked its config."""
    if ffn_fn is None:
        check_supported(config)
        return dense_ffn
    return ffn_fn


def forward(params: Dict[str, Any], config: ModelConfig, tokens: torch.Tensor,
            cache: KVCache, *, seq_lens: Optional[torch.Tensor] = None,
            logit_idx: Optional[torch.Tensor] = None,
            fresh_prefill: bool = False,
            ffn_fn=None, layer_fn=None) -> Tuple[torch.Tensor, KVCache]:
    """Forward over `tokens` [B, S] appending to `cache` (prefill S > 1 or
    decode S == 1). Queries sit at cache.length[b] + s.

    seq_lens: [B] new valid tokens per row (<= S, default S).
    logit_idx: [B] compute the head for that position only -> [B, 1, V].
    fresh_prefill: the caller guarantees cache.length == 0; attention
    then reads the just-computed K/V directly.
    ffn_fn: the FFN block of every layer (None: dense_ffn).
    layer_fn: a family's own decoder block, called as layer_fn(config, x,
    layers, li, rope, cache, start, kv_len, fresh_prefill, slots) (None:
    this family's block around ffn_fn).
    Returns (logits [B, S or 1, V] f32, cache with the new length)."""
    if layer_fn is None:
        ffn_fn = _resolve_ffn(config, ffn_fn)

        def layer_fn(*args):
            return _layer_forward(*args, ffn_fn)
    B, S = tokens.shape
    start = cache.length
    positions = start[:, None] + torch.arange(
        S, dtype=torch.int32, device=tokens.device)[None, :]
    if seq_lens is None:
        seq_lens = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    kv_len = (start + seq_lens).to(torch.int32)

    x = embed(config, params, tokens)
    rope = rope_for(config, positions)
    # Decode writes one token per row at start[b]; JAX's
    # dynamic_update_slice clamps the offset into the cache, and so does
    # this indexed write. A chunked prefill reads the row starts once.
    if cache.k.dtype in COMPRESSED_KV:
        slots = cache_rows(cache, start, S)
    elif S == 1:
        slots = (torch.arange(B, device=tokens.device),
                 start.clamp(max=cache.max_seq - 1).long())
    else:
        slots = None if fresh_prefill else start.tolist()
    layers = params["layers"]
    for li in range(config.num_layers):
        x = layer_fn(config, x, layers, li, rope, cache, start, kv_len,
                     fresh_prefill, slots)
    if logit_idx is not None:
        x = x[torch.arange(B, device=x.device), logit_idx.long()][:, None]
    return head(config, params, x), cache._replace(length=kv_len)


def forward_no_cache(params: Dict[str, Any], config: ModelConfig,
                     tokens: torch.Tensor,
                     seq_lens: Optional[torch.Tensor] = None, *,
                     ffn_fn=None, layer_fn=None) -> torch.Tensor:
    """Cacheless full-sequence forward (JAX llama.forward_no_cache): a
    model-dtype cache of exactly S positions and one fresh prefill over
    it (so the cache write and flash kernels run as in any prefill) ->
    logits [B, S, V] f32. ffn_fn, layer_fn: as forward's."""
    B, S = tokens.shape
    cache = init_cache(config, B, max_seq=S, device=tokens.device)
    logits, _ = forward(params, config, tokens, cache, seq_lens=seq_lens,
                        fresh_prefill=True, ffn_fn=ffn_fn, layer_fn=layer_fn)
    return logits


def forward_paged_decode(params: Dict[str, Any], config: ModelConfig,
                         tokens: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_table: torch.Tensor,
                         lengths: torch.Tensor, *, ffn_fn=None,
                         k_scale_pages: Optional[torch.Tensor] = None,
                         v_scale_pages: Optional[torch.Tensor] = None):
    """One decode step over the paged pool: tokens [B], the new token of
    row b written at position lengths[b]. The G=1 case of
    forward_paged_verify (one decoder body, as in the JAX package).
    Returns (logits [B, V] f32, k_pages, v_pages[, k_scale_pages,
    v_scale_pages])."""
    out = forward_paged_verify(params, config, tokens[:, None], k_pages,
                               v_pages, block_table, lengths, ffn_fn=ffn_fn,
                               k_scale_pages=k_scale_pages,
                               v_scale_pages=v_scale_pages)
    return (out[0][:, 0],) + out[1:]


def page_slots(block_table: torch.Tensor, positions: torch.Tensor, P: int,
               page: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Page id and in-page offset of every position [B, G] through the
    table [B, max_pages], flat over (b, g). Table ids clamp into [0, P-1]
    as in JAX, so an inactive slot's -1 row writes trash page 0: an
    unclamped -1 would wrap to page P-1 and corrupt a live sequence. A
    position past the table (JAX's gather fills it) lands in page 0 too."""
    max_pages = block_table.shape[1]
    pidx = (positions // page).long()
    table = block_table.to(device=positions.device).long()
    pid = table.gather(1, pidx.clamp(max=max_pages - 1))
    pid = torch.where(pidx < max_pages, pid, -1).clamp(0, P - 1).reshape(-1)
    return pid, (positions % page).long().reshape(-1)


def forward_paged_verify(params: Dict[str, Any], config: ModelConfig,
                         tokens: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_table: torch.Tensor,
                         lengths: torch.Tensor, *, ffn_fn=None,
                         k_scale_pages: Optional[torch.Tensor] = None,
                         v_scale_pages: Optional[torch.Tensor] = None):
    """G tokens per row in one pass over the paged pool [L, P, Hkv, page,
    D] (tokens [B, G]: the current token and G-1 drafts). Token g of row
    b is written at position lengths[b] + g, into page
    block_table[b, pos // page]; attention runs the paged kernel (decode
    at G=1, verify above), so each row's prefix is read once for all G
    queries. The pools (and an int8 pool's scale pages k_scale_pages/
    v_scale_pages [L, P, Hkv, page] f32) are written IN PLACE (JAX
    returns new ones) and returned. Rollback of rejected drafts is the
    caller's: their K/V lies past the row's length and is overwritten
    later.
    ffn_fn: as in forward.
    Returns (logits [B, G, V] f32, k_pages, v_pages[, k_scale_pages,
    v_scale_pages when given])."""
    ffn_fn = _resolve_ffn(config, ffn_fn)
    if (k_pages.dtype == torch.int8) != (k_scale_pages is not None):
        raise ValueError("an int8 page pool takes k_scale_pages and "
                         "v_scale_pages, another pool none")
    B, G = tokens.shape
    dev = tokens.device
    L, P, Hkv, page, D = k_pages.shape
    lengths = lengths.to(device=dev, dtype=torch.int32)
    positions = lengths[:, None] + torch.arange(G, dtype=torch.int32,
                                                device=dev)[None, :]
    kv_len = lengths + G
    pid, poff = page_slots(block_table, positions, P, page)
    compressed = k_pages.dtype in COMPRESSED_KV
    rows = pid * (Hkv * page) + poff if compressed else None

    x = embed(config, params, tokens)
    rope = rope_for(config, positions)
    layers = params["layers"]
    for li in range(config.num_layers):
        q, k, v = _attn_inputs(config, x, layers, li, rope)
        mask = dict(window=layer_window(config, li),
                    softcap=config.attn_logit_softcap)
        if compressed:
            encode_write(k_pages, v_pages, k_scale_pages, v_scale_pages, k,
                         v, rows, li)
        else:
            k_pages[li, pid, :, poff] = k.reshape(B * G, Hkv, D).to(
                k_pages.dtype)
            v_pages[li, pid, :, poff] = v.reshape(B * G, Hkv, D).to(
                v_pages.dtype)
        if G == 1:
            attn = dispatch.attention_paged_decode(
                q[:, 0], k_pages, v_pages, block_table, kv_len, li,
                k_scale_pages, v_scale_pages, **mask)[:, None]
        else:
            attn = dispatch.attention_paged_verify(
                q, k_pages, v_pages, block_table, kv_len, li, k_scale_pages,
                v_scale_pages, **mask)
        x = _attn_out_ffn(config, x, attn, layers, li, ffn_fn)
    logits = head(config, params, x)
    if k_scale_pages is not None:
        return logits, k_pages, v_pages, k_scale_pages, v_scale_pages
    return logits, k_pages, v_pages
