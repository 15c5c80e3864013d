"""GPT-OSS (openai/gpt-oss-20b and -120b) in PyTorch: counterpart of
turboinfer_tpu/models/gptoss.py.

The llama attention inputs (models/llama.py: RMSNorm, the q/k/v
projections with their biases, RoPE, here YaRN) with GPT-OSS's own
attention and FFN:
- a learned per-head sink logit: the softmax runs over [scores, sink]
  and the sink adds no value, so it only soaks probability mass;
- alternating windows: layer li attends its last `sliding_window` keys
  unless (li + 1) % sliding_window_pattern == 0 (full attention);
- an output-projection bias;
- a MoE FFN on every layer: router logits plus router_bias in f32,
  top-k, a softmax over the k selected logits, and biased experts with
  the clamped GLU (up + 1) * gate * sigmoid(1.702 * gate), gate <= 7,
  |up| <= 7.
Parameters are the llama slots (wq/wk/wv/wo, norms, embed, lm_head) plus
  "b_q"/"b_k"/"b_v" (fused into "b_qkv" with wqkv), "b_o" [L, H],
  "sinks" [L, Hq], "router" [L, H, E], "router_bias" [L, E],
  "we_gate"/"we_up" [L, E, H, F] with "be_gate"/"be_up" [L, E, F], and
  "we_down" [L, E, F, H] with "be_down" [L, E, H].
The experts stay fp (quant/quantizer.py) and run as torch matmuls in
the model dtype, as the JAX package leaves them to XLA einsums: the k
routed experts' weights are gathered when B*S*k < E, else every expert
is applied to every token and masked by the dense [B, S, E] mix (in
expert groups that bound the temporaries).

Attention:
- contiguous decode (S == 1): the decode kernel with the layer's window
  and sinks (dispatch.attention_decode; in the JAX package
  decode_fused_pallas on its fused-head cache, a TPU lane-alignment
  layout the port does not keep: the cache stays head-major);
- prefill: a plain-torch port of the JAX package's _streaming_attention
  (online softmax over key chunks, started at m0 = sink, l0 = 1), which
  the reference computes in jnp outside any Pallas kernel;
- paged decode: the layer's pages gathered, then the same sink- and
  window-aware reference form (jnp in the JAX package too).
There is no forward_paged_verify, as in the JAX package, so the paged
scheduler refuses speculative serving for this family.

KV caches: the model dtype, bf16, int8 (with f32 scale planes) or fp8
(uint8 e4m3 bits), as in the JAX package (SUPPORTS_INT8_KV). A
compressed cache is written by the encode-and-write kernel
(cache_write.kv_encode_write); decode reads it through the decode
kernel's int8/fp8 path, and a prefill, fresh or not, streams over the
cache it just wrote, decoding each key chunk, so it sees the quantized
K/V as the JAX model's prefill does. The paged forward takes fp8 pages
but no int8 pool (SUPPORTS_INT8_KV_PAGED = False: it has no scale
pages, as in the JAX package), which the paged scheduler refuses.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from turboinfer_tpu_torch.config import ModelConfig
from turboinfer_tpu_torch.kernels import cache_write, dispatch, ops
from turboinfer_tpu_torch.models import llama, moe
from turboinfer_tpu_torch.models.common import (COMPRESSED_KV, KVCache,
                                                decode_kv)
from turboinfer_tpu_torch.models.common import (  # noqa: F401
    param_bytes, param_count, reset_cache)
from turboinfer_tpu_torch.models.llama import layer_window
from turboinfer_tpu_torch.models.moe import dense_mix
from turboinfer_tpu_torch.utils.device import resolve_device
from turboinfer_tpu_torch.utils.errors import ConfigError

# int8 and fp8 contiguous caches; fp8 page pools but no int8 ones (the
# paged scheduler asks SUPPORTS_INT8_KV_PAGED, as the JAX package's does).
SUPPORTS_INT8_KV = True
SUPPORTS_INT8_KV_PAGED = False

# The MoE family's refused knobs (models/moe.py), less the two GPT-OSS
# uses.
_UNPORTED = tuple((n, off) for n, off in moe._UNPORTED
                  if n not in ("sliding_window", "attn_bias"))
# f32 elements of one expert group's [n, B*S, F] temporaries in the
# dense regime (512 MiB each).
_DENSE_ELEMS = 1 << 27
# keys per chunk of the streaming prefill attention: its [B, Hkv, G, S,
# C] f32 score blocks stay bounded whatever the key length.
_KEY_CHUNK = 512


def check_supported(config: ModelConfig) -> None:
    """Raise for a config this family's port does not run."""
    if config.architecture != "gpt_oss":
        raise NotImplementedError(
            f"architecture {config.architecture!r} is not ported yet")
    if config.num_experts <= 0:
        raise ConfigError("gpt_oss model needs config.num_experts > 0")
    if not 0 < config.experts_per_token <= config.num_experts:
        raise ConfigError(f"experts_per_token={config.experts_per_token} "
                          f"must be in [1, {config.num_experts}]")
    if config.sliding_window is not None and config.sliding_window < 1:
        raise ConfigError(f"sliding_window={config.sliding_window} must be "
                          ">= 1 or None")
    for name, off in _UNPORTED:
        if getattr(config, name) != off:
            raise NotImplementedError(
                f"ModelConfig.{name}={getattr(config, name)!r} is not ported "
                "to the PyTorch package yet")


def init_cache(config: ModelConfig, batch_size: int, max_seq=None,
               dtype=None, device="cuda") -> KVCache:
    """Head-major [L, B, Hkv, T, D] cache of zeros on `device`: the model
    dtype, bf16, int8 (with scale planes) or fp8 (uint8)."""
    return llama.init_cache(config, batch_size, max_seq, dtype, device)


def init_params(config: ModelConfig, seed: int = 0, device="cuda",
                dtype=None) -> Dict[str, Any]:
    """Random fp parameters: weights N(0, 1/fan_in), biases and sinks
    N(0, 0.02^2), unit norms. Stacked weights are drawn one layer at a
    time, so the f32 temporary is one layer's (GPT-OSS-20B's expert
    stacks would otherwise need 25 GB of f32 each)."""
    check_supported(config)
    dev = resolve_device(device)
    dtype = dtype or config.dtype
    H, V, L = config.hidden_size, config.vocab_size, config.num_layers
    QD, KVD, E, F = (config.q_dim, config.kv_dim, config.num_experts,
                     config.ffn_dim)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def w(shape, fan_in):
        out = torch.empty(shape, dtype=dtype, device=dev)
        for part in (out if len(shape) > 2 else (out,)):
            part.copy_(torch.randn(part.shape, generator=gen, device=dev)
                       .mul_(fan_in ** -0.5))
        return out

    def b(shape):
        return (0.02 * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    ones = dict(dtype=dtype, device=dev)
    params = {
        "embed": w((V, H), H),
        "layers": {
            "attn_norm": torch.ones((L, H), **ones),
            "ffn_norm": torch.ones((L, H), **ones),
            "wq": w((L, H, QD), H), "b_q": b((L, QD)),
            "wk": w((L, H, KVD), H), "b_k": b((L, KVD)),
            "wv": w((L, H, KVD), H), "b_v": b((L, KVD)),
            "wo": w((L, QD, H), QD), "b_o": b((L, H)),
            "sinks": b((L, config.num_heads)),
            "router": w((L, H, E), H), "router_bias": b((L, E)),
            "we_gate": w((L, E, H, F), H), "be_gate": b((L, E, F)),
            "we_up": w((L, E, H, F), H), "be_up": b((L, E, F)),
            "we_down": w((L, E, F, H), F), "be_down": b((L, E, H)),
        },
        "final_norm": torch.ones((H,), **ones),
        "lm_head": w((H, V), H),
    }
    if config.tie_embeddings:
        params["lm_head"] = params["embed"].T
    return params


# -- FFN ----------------------------------------------------------------------

def _glu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """GPT-OSS clamped GLU: (up + 1) * gate * sigmoid(1.702 * gate)."""
    gate = gate.clamp(max=7.0)
    up = up.clamp(-7.0, 7.0)
    return (up + 1.0) * gate * torch.sigmoid(1.702 * gate)


def router_logits(h: torch.Tensor, lw: Dict[str, Any], li: int
                  ) -> torch.Tensor:
    """Router logits of layer li in f32, bias included: [B, S, E]."""
    return (torch.matmul(h.to(torch.float32),
                         lw["router"][li].to(torch.float32))
            + lw["router_bias"][li].to(torch.float32))


def gates_at(config: ModelConfig, logits: torch.Tensor, top_i: torch.Tensor
             ) -> torch.Tensor:
    """Gates [B, S, k] f32 of the experts top_i: a softmax over their
    logits."""
    return torch.softmax(logits.gather(-1, top_i), dim=-1)


def route(config: ModelConfig, h: torch.Tensor, lw: Dict[str, Any], li: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router of layer li -> (gates [B, S, k] f32, top_i [B, S, k])."""
    logits = router_logits(h, lw, li)
    top_i = torch.topk(logits, config.experts_per_token, dim=-1).indices
    return gates_at(config, logits, top_i), top_i


def _moe_ffn(config: ModelConfig, h: torch.Tensor, lw: Dict[str, Any],
             li: int) -> torch.Tensor:
    """Routed biased experts of layer li: h [B, S, H] -> [B, S, H] in
    h.dtype. Products in h.dtype with f32 sums, the GLU in f32 and the
    down bias added in f32, as in the JAX package."""
    E, k = config.num_experts, config.experts_per_token
    B, S, H = h.shape
    dt = h.dtype
    gates, top_i = route(config, h, lw, li)
    if B * S * k < E:
        # few tokens: gather the k routed experts' weights and biases
        def take(name):
            return lw[name][li][top_i]                      # [B, S, k, ...]
        hk = h[:, :, None, None, :]
        g = (hk @ take("we_gate").to(dt))[..., 0, :] + take("be_gate").to(dt)
        u = (hk @ take("we_up").to(dt))[..., 0, :] + take("be_up").to(dt)
        act = _glu(g.to(torch.float32), u.to(torch.float32)).to(dt)
        out_e = ((act[..., None, :] @ take("we_down").to(dt))[..., 0, :]
                 .to(torch.float32) + take("be_down").to(torch.float32))
        return torch.einsum("bskh,bsk->bsh", out_e,
                            gates.to(torch.float32)).to(dt)
    # every expert on every token, masked by the dense mix
    mix = dense_mix(gates, top_i, E).reshape(B * S, E)
    x = h.reshape(1, B * S, H)
    out = torch.zeros((B * S, H), dtype=torch.float32, device=h.device)
    n = max(1, min(E, _DENSE_ELEMS // (B * S * config.ffn_dim)))
    for e0 in range(0, E, n):
        es = slice(e0, min(e0 + n, E))

        def proj(w, bias):                                  # [n, B*S, F]
            return (torch.matmul(x, lw[w][li, es].to(dt))
                    + lw[bias][li, es, None].to(dt))
        act = _glu(proj("we_gate", "be_gate").to(torch.float32),
                   proj("we_up", "be_up").to(torch.float32)).to(dt)
        y = (torch.matmul(act, lw["we_down"][li, es].to(dt)).to(torch.float32)
             + lw["be_down"][li, es, None].to(torch.float32))
        out = out + torch.einsum("nth,tn->th", y, mix[:, es])
    return out.reshape(B, S, H).to(dt)


# -- attention ----------------------------------------------------------------

def _streaming_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sinks: torch.Tensor, positions: torch.Tensor,
                        kv_len: torch.Tensor, window: Optional[int],
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Causal GQA attention with sinks over key chunks (the JAX package's
    _streaming_attention): an online softmax whose running max starts at
    the sink logit and running sum at 1 is exactly softmax([scores,
    sink]) with the sink dropped. q: [B, S, Hq, D] at `positions` [B, S];
    k/v: [B, Hkv, T, D] (views allowed) of q's dtype, or an int8 cache
    layer with its scale planes k_scale/v_scale [B, Hkv, T] or an fp8 one
    (uint8), each key chunk decoded to q's dtype as the JAX package
    decodes it; keys at or past kv_len [B], past the query, or outside
    the window are masked. -> [B, S, Hq, D] f32."""
    B, S, Hq, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = Hq // Hkv
    f32 = torch.float32
    qf = q.transpose(1, 2).reshape(B, Hkv, G, S, D).to(f32)
    C = min(T, _KEY_CHUNK)              # the last chunk may be shorter
    qpos = positions[:, None, None, :, None]
    kvl = kv_len[:, None, None, None, None]
    m = sinks.to(f32).reshape(1, Hkv, G, 1).expand(B, Hkv, G, S)
    l = torch.ones((B, Hkv, G, S), dtype=f32, device=q.device)
    acc = torch.zeros((B, Hkv, G, S, D), dtype=f32, device=q.device)
    def chunk(x, scale, c0):
        ch = slice(c0, c0 + C)
        return decode_kv(x[:, :, ch], q.dtype, None if scale is None
                         else scale[:, :, ch]).to(f32)
    for c0 in range(0, T, C):
        s = torch.einsum("bhgsd,bhtd->bhgst", qf,
                         chunk(k, k_scale, c0)) * D ** -0.5
        tpos = torch.arange(c0, min(c0 + C, T), device=q.device)
        ok = (tpos <= qpos) & (tpos < kvl)
        if window is not None:
            ok = ok & (tpos > qpos - window)
        s = s.masked_fill(~ok, ops.NEG_INF)
        m2 = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m2[..., None])
        corr = torch.exp(m - m2)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgst,bhtd->bhgsd", p.to(q.dtype).to(f32),
            chunk(v, v_scale, c0))
        m = m2
    out = acc / l[..., None]
    return out.reshape(B, Hq, S, D).transpose(1, 2)


def _out_ffn(config: ModelConfig, x: torch.Tensor, attn: torch.Tensor,
             lw: Dict[str, Any], li: int) -> torch.Tensor:
    """Biased output projection and residual, then RMSNorm -> experts ->
    residual, of layer li. attn: [B, S, Hq, D]."""
    B, S, _ = x.shape
    attn = attn.reshape(B, S, -1).to(x.dtype)
    x = x + (ops.qmatmul(attn, lw["wo"], li) + lw["b_o"][li].to(x.dtype))
    h = ops.rms_norm(x, lw["ffn_norm"][li], config.rms_norm_eps)
    return x + _moe_ffn(config, h, lw, li)


def _layer_forward(config: ModelConfig, x: torch.Tensor, lw: Dict[str, Any],
                   li: int, rope, cache: KVCache, start: torch.Tensor,
                   kv_len: torch.Tensor, fresh_prefill: bool, slots
                   ) -> torch.Tensor:
    """One GPT-OSS block over the stacked cache, which it updates in
    place at layer li (llama.forward's layer_fn; slots as there)."""
    B, S, _ = x.shape
    T = cache.max_seq
    q, k, v = llama._attn_inputs(config, x, lw, li, rope)
    window, sinks = layer_window(config, li), lw["sinks"][li]
    if cache.k.dtype in COMPRESSED_KV:
        # slots: every new token's layer-0 row (llama.cache_rows)
        llama.encode_write(cache.k, cache.v, cache.k_scale, cache.v_scale,
                           k, v, slots, li)
        # a fresh prefill (cache.length == 0) has no key past S: stream
        # over those rows only (the rest would be masked chunks)
        n = S if fresh_prefill else T
        ks = None if cache.k_scale is None else cache.k_scale[li, :, :, :n]
        vs = None if cache.v_scale is None else cache.v_scale[li, :, :, :n]
        if S == 1:
            attn = dispatch.attention_decode(
                q[:, 0], cache.k, cache.v, kv_len, layer_index=li,
                window=window, sinks=sinks, k_scale=cache.k_scale,
                v_scale=cache.v_scale)[:, None]
        else:
            # fresh or not: attend the quantized K/V just written, as the
            # JAX model's prefill attends its cache
            positions = start[:, None] + torch.arange(
                S, device=x.device)[None, :]
            attn = _streaming_attention(q, cache.k[li, :, :, :n],
                                        cache.v[li, :, :, :n], sinks,
                                        positions, kv_len, window, ks, vs)
        return _out_ffn(config, x, attn, lw, li)
    k, v = k.to(cache.k.dtype), v.to(cache.k.dtype)
    if S == 1:
        rows, pos = slots
        cache.k[li, rows, :, pos] = k[:, 0]
        cache.v[li, rows, :, pos] = v[:, 0]
        attn = dispatch.attention_decode(q[:, 0], cache.k, cache.v, kv_len,
                                         layer_index=li, window=window,
                                         sinks=sinks)[:, None]
        return _out_ffn(config, x, attn, lw, li)
    if fresh_prefill:
        # cache.length == 0: write the slab at T offset 0 and attend the
        # just-computed K/V (what the cache now holds: the cache stores
        # the model dtype here), transposed by strides
        cache_write.cache_write_fresh(cache.k, cache.v, k, v, li)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    else:
        for b, s0 in enumerate(slots):
            n = min(S, T - s0)
            cache.k[li, b, :, s0:s0 + n] = k[b, :n].transpose(0, 1)
            cache.v[li, b, :, s0:s0 + n] = v[b, :n].transpose(0, 1)
        kt, vt = cache.k[li], cache.v[li]
    positions = start[:, None] + torch.arange(S, device=x.device)[None, :]
    attn = _streaming_attention(q, kt, vt, sinks, positions, kv_len, window)
    return _out_ffn(config, x, attn, lw, li)


# -- forwards -----------------------------------------------------------------

def forward(params: Dict[str, Any], config: ModelConfig, tokens: torch.Tensor,
            cache: KVCache, *, seq_lens: Optional[torch.Tensor] = None,
            logit_idx: Optional[torch.Tensor] = None,
            fresh_prefill: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """Same contract as llama.forward, with GPT-OSS's blocks."""
    check_supported(config)
    return llama.forward(params, config, tokens, cache, seq_lens=seq_lens,
                         logit_idx=logit_idx, fresh_prefill=fresh_prefill,
                         layer_fn=_layer_forward)


def forward_no_cache(params: Dict[str, Any], config: ModelConfig,
                     tokens: torch.Tensor,
                     seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Same contract as llama.forward_no_cache, with GPT-OSS's blocks."""
    check_supported(config)
    return llama.forward_no_cache(params, config, tokens, seq_lens,
                                  layer_fn=_layer_forward)


def forward_paged_decode(params: Dict[str, Any], config: ModelConfig,
                         tokens: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_table: torch.Tensor,
                         lengths: torch.Tensor):
    """One decode step over the paged pool [L, P, Hkv, page, D] of the
    model dtype, bf16 or fp8 (uint8 e4m3 bits; no int8 pool, as in the
    JAX package) (same contract as llama.forward_paged_decode): the new
    token of row b is written IN PLACE at position lengths[b] (an fp8
    pool through the encode-and-write kernel), then each layer attends
    its gathered pages with the layer's window and sinks. Window and
    sinks are functions of absolute positions, which the block table
    keeps. Returns (logits [B, V] f32, k_pages, v_pages)."""
    check_supported(config)
    if k_pages.dtype == torch.int8:
        raise NotImplementedError(
            "gpt_oss paged decode takes no int8 pool (SUPPORTS_INT8_KV_PAGED"
            " is False); use 'fp8' or 'bf16'")
    B = tokens.shape[0]
    dev = tokens.device
    lengths = lengths.to(device=dev, dtype=torch.int32)
    positions = lengths[:, None]
    kv_len = lengths + 1
    _, P, Hkv, page, _ = k_pages.shape
    pid, poff = llama.page_slots(block_table, positions, P, page)
    fp8 = k_pages.dtype == torch.uint8
    table = block_table.to(device=dev)
    x = ops.embed_lookup(params["embed"], tokens[:, None], config.dtype)
    rope = llama.rope_for(config, positions)
    layers = params["layers"]
    for li in range(config.num_layers):
        q, k, v = llama._attn_inputs(config, x, layers, li, rope)
        if fp8:
            llama.encode_write(k_pages, v_pages, None, None, k, v,
                               pid * (Hkv * page) + poff, li)
        else:
            k_pages[li, pid, :, poff] = k[:, 0].to(k_pages.dtype)
            v_pages[li, pid, :, poff] = v[:, 0].to(v_pages.dtype)
        attn = ops.attention_paged_decode_ref(
            q[:, 0], k_pages[li], v_pages[li], table, kv_len,
            window=layer_window(config, li), sinks=layers["sinks"][li])
        x = _out_ffn(config, x, attn[:, None], layers, li)
    x = ops.rms_norm(x, params["final_norm"], config.rms_norm_eps)
    logits = ops.qmatmul(x, params["lm_head"]).to(torch.float32)
    return logits[:, 0], k_pages, v_pages
