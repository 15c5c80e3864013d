"""GPT-NeoX / Pythia / Phi-1/2 / Falcon / BLOOM decoder in PyTorch:
counterpart of turboinfer_tpu/models/neox.py.

Parameters are a plain dict with the JAX package's structure: weights
[in, out], per-layer weights stacked on a leading layer axis, each
either a tensor or a QTensor:
  {"embed": [V, H] (or QEmbed),
   "layers": {"ln1_w", "ln1_b", "ln2_w", "ln2_b": [L, H],
              "w_qkv" [L, H, Hq*D + 2*Hkv*D], "b_qkv" [L, Hq*D + 2*Hkv*D],
              "wo" [L, Hq*D, H], "bo" [L, H],
              "w_fc" [L, H, F], "b_fc" [L, F], "w_proj" [L, F, H],
              "b_proj" [L, H]},
   "final_norm_w", "final_norm_b": [H], "lm_head": [H, V],
   and optionally "lm_head_b" [V] (Phi's biased head) and
   "embed_norm_w", "embed_norm_b" [H] (BLOOM's LayerNorm over the
   embeddings)}.
The fused w_qkv is q|k|v contiguous along its output axis (the loader
de-interleaves the checkpoints' per-head layouts), so it splits at q_dim
and q_dim + kv_dim for MHA, GQA and MQA (Falcon-7B: 71 query heads on one
kv head).

The block, in f32-statistics LayerNorms with biases, a GELU (tanh) MLP
and biased products:
  - parallel residual (config.parallel_residual): x + attn(ln1(x)) +
    mlp(ln2(x)), the MLP reading the block's input; else sequential
    pre-LN;
  - partial rotary: RoPE on the first rotary_pct * D dims of each q and k
    head (even), the tail unrotated (Pythia 0.25, Phi-2 0.4);
  - ALiBi (config.alibi; Falcon-RW, BLOOM): slope * key position added
    to the scaled scores, the slopes rounded to bf16 and back as HF's
    build_alibi_tensor does, and for "falcon" also scaled by D^-0.5 (HF
    Falcon adds the bias before the 1/sqrt(D) scale).
run_blocks is the body models/gpt2.py shares: learned positions there,
no rotary, no ALiBi, sequential.

Attention and caches go through llama.attend: the stacked head-major
cache [L, B, Hkv, T, D] of the model dtype, bf16, int8 (with f32 scale
planes) or fp8, written by the cache-write kernels and read by the flash
and decode kernels (any group up to the decode kernel's MAX_GROUP). An
ALiBi model's attention runs the torch reference attention with the
bias, chosen by its config through dispatch's alibi argument, as the JAX
package sends ALiBi to jnp: neither package's kernels carry a per-head
score bias. There is no paged forward, as in the JAX package, so the
paged scheduler refuses these families.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from turboinfer_tpu_torch.config import ModelConfig
from turboinfer_tpu_torch.kernels import ops
from turboinfer_tpu_torch.models import llama
from turboinfer_tpu_torch.models.common import KVCache
from turboinfer_tpu_torch.models.common import init_cache as _init_cache
from turboinfer_tpu_torch.models.common import (  # noqa: F401
    param_bytes, param_count, reset_cache)
from turboinfer_tpu_torch.utils.device import resolve_device

# The forwards thread int8 scale planes and read fp8 caches, as the JAX
# package's (SUPPORTS_INT8_KV there too).
SUPPORTS_INT8_KV = True

# the JAX registry's names for this body (turboinfer_tpu/models/registry.py)
ARCHITECTURES = ("gpt_neox", "phi", "falcon", "bloom")
# knobs of other families this body does not compute (MoE, MLA)
_UNPORTED = (("num_experts", 0), ("kv_lora_rank", None))


def check_supported(config: ModelConfig) -> None:
    """Raise NotImplementedError for a config this body does not run."""
    if config.architecture not in ARCHITECTURES:
        raise NotImplementedError(
            f"architecture {config.architecture!r} is not a NeoX-family "
            f"body ({', '.join(ARCHITECTURES)})")
    for name, off in _UNPORTED:
        if getattr(config, name) != off:
            raise NotImplementedError(
                f"ModelConfig.{name}={getattr(config, name)!r} is not ported "
                "to the PyTorch package yet")


def init_cache(config: ModelConfig, batch_size: int, max_seq=None,
               dtype=None, device="cuda") -> KVCache:
    """Head-major [L, B, Hkv, T, D] cache of zeros on `device` (the JAX
    package's fused-head layout is a TPU lane-alignment choice the port
    does not keep)."""
    return _init_cache(config, batch_size, max_seq, dtype, device)


def init_params(config: ModelConfig, seed: int = 0, device="cuda",
                dtype=None, matmul=None) -> Dict[str, Any]:
    """Random parameters with the JAX package's structure: weights N(0,
    1/fan_in), unit LayerNorm weights, zero biases; BLOOM's embedding
    LayerNorm and Phi's head bias too, as the loader assembles them.
    matmul(shape, fan_in), when given, makes the stacked products [L, K,
    N] and the head [H, V] instead (the synthetic fixture passes packed
    QTensor draws)."""
    check_supported(config)
    return draw_params(config, seed, device, dtype, matmul,
                       qkv=config.q_dim + 2 * config.kv_dim)


def draw_params(config: ModelConfig, seed: int, device, dtype, matmul,
                qkv: int, pos_embed: bool = False) -> Dict[str, Any]:
    """The NeoX / GPT-2 parameter tree (init_params): qkv columns of
    w_qkv; pos_embed: GPT-2's learned positions [max_seq_len, H] and a
    tied head."""
    dev = resolve_device(device)
    dtype = dtype or config.dtype
    H, V, L = config.hidden_size, config.vocab_size, config.num_layers
    F = config.intermediate_size or 4 * H
    QD = config.q_dim
    gen = torch.Generator(device=dev).manual_seed(seed)

    def w(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=dev)
                / fan_in ** 0.5).to(dtype)
    mm = matmul or w

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)
    params = {
        "embed": w((V, H), H),
        "layers": {
            "ln1_w": ones(L, H), "ln1_b": zeros(L, H),
            "ln2_w": ones(L, H), "ln2_b": zeros(L, H),
            "w_qkv": mm((L, H, qkv), H), "b_qkv": zeros(L, qkv),
            "wo": mm((L, QD, H), QD), "bo": zeros(L, H),
            "w_fc": mm((L, H, F), H), "b_fc": zeros(L, F),
            "w_proj": mm((L, F, H), F), "b_proj": zeros(L, H),
        },
        "final_norm_w": ones(H), "final_norm_b": zeros(H),
    }
    if pos_embed:
        params["pos_embed"] = w((config.max_seq_len, H), H)
        params["lm_head"] = params["embed"].T
    else:
        params["lm_head"] = mm((H, V), H)
    if config.architecture == "bloom":
        params["embed_norm_w"], params["embed_norm_b"] = ones(H), zeros(H)
    if config.architecture == "phi":
        params["lm_head_b"] = zeros(V)
    return params


def rotary_dims(config: ModelConfig) -> int:
    """Leading dims of a head that RoPE rotates: rotary_pct * D, even."""
    r = int(config.head_dim_ * config.rotary_pct)
    return r - r % 2


def alibi_slopes(config: ModelConfig, device) -> Optional[torch.Tensor]:
    """The score bias slopes [Hq] f32 of an ALiBi config, else None:
    rounded to bf16 and back, and for "falcon" times D^-0.5."""
    if not config.alibi:
        return None
    slopes = ops.alibi_slopes(config.num_heads).to(torch.bfloat16).to(
        torch.float32)
    if config.architecture == "falcon":
        slopes = slopes * float(config.head_dim_) ** -0.5
    return slopes.to(device)


def _partial_rope(config: ModelConfig, x: torch.Tensor, tables,
                  r: int) -> torch.Tensor:
    """RoPE on the first r dims of each head of x [B, S, H, D]."""
    rot = ops.apply_rope(x[..., :r], None, mode=config.rope_mode,
                         tables=tables)
    return rot if r == x.shape[-1] else torch.cat([rot, x[..., r:]], -1)


def _bias(lw: Dict[str, Any], name: str, li: int, dtype) -> torch.Tensor:
    return lw[name][li].to(dtype)


def _mlp(config: ModelConfig, x: torch.Tensor, lw: Dict[str, Any],
         li: int) -> torch.Tensor:
    """ln2 -> w_fc + b_fc -> GELU (tanh) -> w_proj + b_proj."""
    h = ops.layer_norm(x, lw["ln2_w"][li], lw["ln2_b"][li],
                       config.rms_norm_eps)
    h = ops.gelu(ops.qmatmul(h, lw["w_fc"], li)
                 + _bias(lw, "b_fc", li, x.dtype))
    return (ops.qmatmul(h.to(x.dtype), lw["w_proj"], li)
            + _bias(lw, "b_proj", li, x.dtype))


def _layer_forward(config: ModelConfig, x: torch.Tensor, lw: Dict[str, Any],
                   li: int, rope, alibi, parallel: bool, cache: KVCache,
                   start: torch.Tensor, kv_len: torch.Tensor,
                   fresh_prefill: bool, slots) -> torch.Tensor:
    """One block over the stacked cache, which it updates in place at
    layer li. rope: (tables, r) of the partial rotary, or None; alibi:
    the slopes or None; slots: llama.cache_slots of the forward."""
    B, S, _ = x.shape
    Hq, Hkv, D = config.num_heads, config.kv_heads, config.head_dim_
    QD, KVD = config.q_dim, config.kv_dim
    h = ops.layer_norm(x, lw["ln1_w"][li], lw["ln1_b"][li],
                       config.rms_norm_eps)
    qkv = ops.qmatmul(h, lw["w_qkv"], li) + _bias(lw, "b_qkv", li, x.dtype)
    v = qkv[..., QD + KVD:].reshape(B, S, Hkv, D)
    qk = qkv[..., :QD + KVD].reshape(B, S, Hq + Hkv, D)
    if rope is not None:
        # q and k heads in one pass; k stays a view with the head stride
        # below the position stride, as v (the flash kernel reads both
        # with one layout)
        qk = _partial_rope(config, qk, *rope)
    q, k = qk[:, :, :Hq], qk[:, :, Hq:]
    attn = llama.attend(q, k, v, li, cache, start, kv_len, fresh_prefill,
                        slots, alibi=alibi)
    y = (ops.qmatmul(attn.reshape(B, S, -1).to(x.dtype), lw["wo"], li)
         + _bias(lw, "bo", li, x.dtype))
    if parallel:
        # the MLP reads the block's input, not the attention's output
        return x + y + _mlp(config, x, lw, li)
    x = x + y
    return x + _mlp(config, x, lw, li)


def run_blocks(params: Dict[str, Any], config: ModelConfig, x: torch.Tensor,
               cache: KVCache, seq_lens: Optional[torch.Tensor],
               logit_idx: Optional[torch.Tensor], fresh_prefill: bool,
               rotary: bool, alibi: bool, parallel: bool
               ) -> Tuple[torch.Tensor, KVCache]:
    """The decoder over embedded x [B, S, H] at positions cache.length[b]
    + s, then the final LayerNorm and the head (plus lm_head_b when
    present) -> (logits [B, S or 1, V] f32, cache with the new length).
    rotary: partial RoPE per config.rotary_pct; alibi: the config's
    slopes; parallel: the parallel residual."""
    B, S, _ = x.shape
    dev = x.device
    start = cache.length
    if seq_lens is None:
        seq_lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    kv_len = (start + seq_lens).to(torch.int32)
    rope = None
    r = rotary_dims(config) if rotary else 0
    if r > 0:
        positions = start[:, None] + torch.arange(
            S, dtype=torch.int32, device=dev)[None, :]
        rope = (ops.rope_tables(positions, r, config.rope_theta,
                                config.rope_mode, config.rope_scaling), r)
    slopes = alibi_slopes(config, dev) if alibi else None
    slots = llama.cache_slots(cache, start, S, fresh_prefill)
    layers = params["layers"]
    for li in range(config.num_layers):
        x = _layer_forward(config, x, layers, li, rope, slopes, parallel,
                           cache, start, kv_len, fresh_prefill, slots)
    if logit_idx is not None:
        x = x[torch.arange(B, device=dev), logit_idx.long()][:, None]
    x = ops.layer_norm(x, params["final_norm_w"], params["final_norm_b"],
                       config.rms_norm_eps)
    logits = ops.qmatmul(x, params["lm_head"]).to(torch.float32)
    if "lm_head_b" in params:                           # Phi: biased head
        logits = logits + params["lm_head_b"].to(torch.float32)
    return logits, cache._replace(length=kv_len)


def forward(params: Dict[str, Any], config: ModelConfig, tokens: torch.Tensor,
            cache: KVCache, *, seq_lens: Optional[torch.Tensor] = None,
            logit_idx: Optional[torch.Tensor] = None,
            fresh_prefill: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """Forward over `tokens` [B, S] appending to `cache`, with the
    contract of llama.forward (seq_lens, logit_idx, fresh_prefill)."""
    check_supported(config)
    x = ops.embed_lookup(params["embed"], tokens, config.dtype)
    if "embed_norm_w" in params:
        # BLOOM: LayerNorm over the embeddings before the first block
        x = ops.layer_norm(x, params["embed_norm_w"], params["embed_norm_b"],
                           config.rms_norm_eps)
    return run_blocks(params, config, x, cache, seq_lens, logit_idx,
                      fresh_prefill, rotary=True, alibi=config.alibi,
                      parallel=config.parallel_residual)


def forward_no_cache(params: Dict[str, Any], config: ModelConfig,
                     tokens: torch.Tensor,
                     seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cacheless full-sequence forward (JAX neox.forward_no_cache): a
    model-dtype cache of exactly S positions and one fresh prefill ->
    logits [B, S, V] f32."""
    B, S = tokens.shape
    cache = init_cache(config, B, max_seq=S, device=tokens.device)
    logits, _ = forward(params, config, tokens, cache, seq_lens=seq_lens,
                        fresh_prefill=True)
    return logits
