"""DeepSeek V2/V3 in PyTorch (Multi-head Latent Attention and
DeepSeek-MoE): counterpart of turboinfer_tpu/models/deepseek.py.

- **The latent cache.** Per token the cache keeps only the kv_lora_rank
  latent c_kv (after kv_a_norm) in the k slot, [L, B, 1, T, lr], and the
  shared roped key k_pe in the v slot, [L, B, 1, T, dr]: no per-head
  K/V. An int8 cache adds per-token f32 scale planes [L, B, 1, T] for
  each (absmax times f32(1/127), the bytes of models/common
  encode_kv_scaled); an fp8 request stores the model dtype, as the JAX
  package does. The paged pools (engine/paged_cache.py) hold the same
  two planes a page: [L, P, 1, page, lr] and [L, P, 1, page, dr].
- **Absorbed attention.** q_nope goes through the k half of wkv_b
  (q_abs = q_nope . W_kc), scores are q_abs . c_kv + q_pe . k_pe times
  qk_head_dim**-0.5 (with YaRN's mscale^2 when the config ships
  mscale_all_dim), and the value path re-expands the weighted latent
  through the v half (W_vc). Operands are rounded to the compute dtype
  (the model dtype; an int8 cache computes in it too) and every product
  accumulates in f32, as the JAX package's preferred_element_type=f32.
  The softmax runs online over key chunks of C keys, C the first of
  512, 256, 128, 64 that divides T, else T (one block), with int8 scales
  on the score tiles and folded into the probability weights; masked
  scores are -1e30. Decode (one query a row) evaluates the same chunks
  in one pass (the running max by a cumulative max, the later chunks'
  corrections as exp(m_c - m_last)); a prefill loops over the chunks.
  All of it is plain torch, as the JAX package runs it in jnp: only the
  projections reach a kernel (dispatch.qmatmul and the grouped product).
- **Routing** (`_route`): router logits in f32; V2 a softmax, V3 a
  sigmoid with router_bias added for the selection only; group-limited
  selection (n_group > 1, topk_method not "greedy") by each group's max
  (V2) or the sum of its top two (V3 "noaux_tc"), the groups left out
  masked to 0.0 (not -inf); the top-k experts of what remains, gates
  from the bias-free scores, renormalised with +1e-20 under
  norm_topk_prob, times routed_scaling_factor. Every top-k is a stable
  descending sort, so ties go to the lower index as in jax.lax.top_k.
- **Experts**: models/moe.expert_mix (the grouped kernel at B*S == 1
  with quantized experts, the E-loop above), plus gateless shared
  experts (a SwiGLU of ws_gate/ws_up/ws_down) added in f32. The first
  first_k_dense_replace layers have a dense SwiGLU FFN and live in the
  "dense_layers" group; "layers" holds the MoE layers, so MoE layer i
  is cache layer first_k_dense_replace + i.

Parameters (every group stacked on a leading layer axis):
  "attn_norm", "ffn_norm" [n, H]; "wq" [n, H, nH*(dn+dr)], or "wq_a"
  [n, H, qr], "q_a_norm" [n, qr], "wq_b" [n, qr, nH*(dn+dr)]; "wkv_a"
  [n, H, lr+dr]; "kv_a_norm" [n, lr]; "wkv_b" [n, lr, nH*(dn+dv)] (fp
  always: the absorbed math splits it by head); "wo" [n, nH*dv, H];
  MoE group: "router" [Lm, H, E], "router_bias" [Lm, E] f32,
  "we_gate"/"we_up" [Lm, E, H, Fm], "we_down" [Lm, E, Fm, H], shared
  "ws_gate"/"ws_up" [Lm, H, Fs], "ws_down" [Lm, Fs, H]; dense group:
  "w_gate"/"w_up" [kd, H, F], "w_down" [kd, F, H].
There is no forward_paged_verify, as in the JAX package, so the paged
scheduler refuses a draft model for this family.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from turboinfer_tpu_torch.config import ModelConfig, RopeMode
from turboinfer_tpu_torch.kernels import ops
from turboinfer_tpu_torch.models import llama, moe
from turboinfer_tpu_torch.models.common import KVCache, encode_kv_scaled
# the model interface the JAX registry names (models/registry.py)
from turboinfer_tpu_torch.models.common import (  # noqa: F401
    param_bytes, param_count, reset_cache)
from turboinfer_tpu_torch.parallel import comm
from turboinfer_tpu_torch.utils.device import resolve_device
from turboinfer_tpu_torch.utils.errors import ConfigError

ARCHITECTURES = ("deepseek_v2", "deepseek_v3")
# the latent cache takes int8 with scale planes; fp8 becomes the model
# dtype (init_cache, engine/paged_cache.init_paged_cache)
SUPPORTS_INT8_KV = True
NEG_INF = -1e30


def check_supported(config: ModelConfig) -> None:
    """Raise for a config this family does not run."""
    if config.architecture not in ARCHITECTURES:
        raise NotImplementedError(
            f"architecture {config.architecture!r} is not ported yet")
    if not config.kv_lora_rank:
        raise ConfigError("deepseek model needs config.kv_lora_rank (MLA)")
    E, k = config.num_experts, config.experts_per_token
    if E <= 0:
        raise ConfigError("deepseek model needs config.num_experts > 0")
    if not 0 < k <= E:
        raise ConfigError(f"experts_per_token={k} must be in [1, {E}]")
    if config.first_k_dense_replace >= config.num_layers:
        raise ConfigError("first_k_dense_replace must leave MoE layers")
    if _grouped(config) and (E % config.n_group
                             or not 0 < config.topk_group <= config.n_group):
        raise ConfigError(f"n_group={config.n_group} must divide "
                          f"num_experts={E} and hold topk_group="
                          f"{config.topk_group}")


def _dims(config: ModelConfig):
    return (config.num_heads, config.qk_nope_head_dim,
            config.qk_rope_head_dim, config.v_head_dim, config.kv_lora_rank)


def _grouped(config: ModelConfig) -> bool:
    return config.n_group > 1 and config.topk_method != "greedy"


def _softmax_scale(config: ModelConfig) -> float:
    """qk_head_dim**-0.5, times YaRN's mscale^2 when rope_scaling has
    mscale_all_dim and a factor above 1 (HF DeepseekV2/V3Attention)."""
    scale = (config.qk_nope_head_dim + config.qk_rope_head_dim) ** -0.5
    d = dict(config.rope_scaling)
    mad = float(d.get("mscale_all_dim", 0) or 0)
    factor = float(d.get("factor", 1.0))
    if mad and factor > 1:
        mscale = 0.1 * mad * math.log(factor) + 1.0
        scale = scale * mscale * mscale
    return scale


def chunk_size(T: int) -> int:
    """Keys a softmax chunk: the first of 512, 256, 128, 64 that divides
    T, else T."""
    return next((c for c in (512, 256, 128, 64) if T % c == 0), T)


# -- params and cache -----------------------------------------------------------

def init_params(config: ModelConfig, seed: int = 0, device="cuda",
                dtype=None) -> Dict[str, Any]:
    """Random fp parameters (N(0, 1/fan_in)), unit norms, a zero router
    bias (f32), the JAX package's tree."""
    check_supported(config)
    dev = resolve_device(device)
    dtype = dtype or config.dtype
    H, V, L = config.hidden_size, config.vocab_size, config.num_layers
    nH, dn, dr, dv, lr = _dims(config)
    E, kd = config.num_experts, config.first_k_dense_replace
    Lm = L - kd
    Fd = config.ffn_dim
    Fm = config.moe_intermediate_size or Fd
    gen = torch.Generator(device=dev).manual_seed(seed)

    def w(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=dev)
                / fan_in ** 0.5).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def attn_slots(n):
        slots = {"attn_norm": ones(n, H), "ffn_norm": ones(n, H),
                 "wkv_a": w((n, H, lr + dr), H), "kv_a_norm": ones(n, lr),
                 "wkv_b": w((n, lr, nH * (dn + dv)), lr),
                 "wo": w((n, nH * dv, H), nH * dv)}
        if config.q_lora_rank:
            qr = config.q_lora_rank
            slots.update(wq_a=w((n, H, qr), H), q_a_norm=ones(n, qr),
                         wq_b=w((n, qr, nH * (dn + dr)), qr))
        else:
            slots["wq"] = w((n, H, nH * (dn + dr)), H)
        return slots

    layers = attn_slots(Lm)
    layers.update(router=w((Lm, H, E), H),
                  router_bias=torch.zeros((Lm, E), dtype=torch.float32,
                                          device=dev),
                  we_gate=w((Lm, E, H, Fm), H), we_up=w((Lm, E, H, Fm), H),
                  we_down=w((Lm, E, Fm, H), Fm))
    if config.shared_expert_size:
        Fs = config.shared_expert_size
        layers.update(ws_gate=w((Lm, H, Fs), H), ws_up=w((Lm, H, Fs), H),
                      ws_down=w((Lm, Fs, H), Fs))
    params: Dict[str, Any] = {"embed": w((V, H), H), "layers": layers,
                              "final_norm": ones(H), "lm_head": w((H, V), H)}
    if kd:
        dense = attn_slots(kd)
        dense.update(w_gate=w((kd, H, Fd), H), w_up=w((kd, H, Fd), H),
                     w_down=w((kd, Fd, H), Fd))
        params["dense_layers"] = dense
    if config.tie_embeddings:
        params["lm_head"] = params["embed"].T
    return params


def init_cache(config: ModelConfig, batch_size: int, max_seq=None,
               dtype=None, device="cuda") -> KVCache:
    """The latent cache of zeros: k [L, B, 1, T, kv_lora_rank], v [L, B, 1,
    T, qk_rope_head_dim], int8 with two [L, B, 1, T] f32 scale planes; an
    fp8 request (uint8) stores the model dtype, as the JAX package."""
    dev = resolve_device(device)
    T = max_seq or config.max_seq_len
    L, B = config.num_layers, batch_size
    _, _, dr, _, lr = _dims(config)
    dtype = dtype or config.dtype
    if dtype == torch.uint8:
        dtype = config.dtype
    if dtype not in (torch.float32, torch.bfloat16, torch.float16,
                     torch.int8):
        raise ValueError(f"KV cache dtype {dtype} is not a cache storage "
                         "dtype (see models/common.resolve_kv_dtype)")
    ks = vs = None
    if dtype == torch.int8:
        ks = torch.zeros((L, B, 1, T), dtype=torch.float32, device=dev)
        vs = torch.zeros((L, B, 1, T), dtype=torch.float32, device=dev)
    return KVCache(k=torch.zeros((L, B, 1, T, lr), dtype=dtype, device=dev),
                   v=torch.zeros((L, B, 1, T, dr), dtype=dtype, device=dev),
                   length=torch.zeros((B,), dtype=torch.int32, device=dev),
                   k_scale=ks, v_scale=vs)


# -- router ---------------------------------------------------------------------

def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries over the last axis with
    jax.lax.top_k's order: descending, the lower index first on ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _scores(config: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """V3's sigmoid or V2's softmax of the f32 router logits."""
    if config.scoring_func == "sigmoid":
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)


def gates_at(config: ModelConfig, logits: torch.Tensor, top_i: torch.Tensor
             ) -> torch.Tensor:
    """Gates [B, S, k] f32 of the experts top_i: the bias-free scores at
    them, renormalised (+1e-20) under norm_topk_prob, times
    routed_scaling_factor."""
    gates = _scores(config, logits).gather(-1, top_i)
    if config.norm_topk_prob:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    return gates * config.routed_scaling_factor


def _route(config: ModelConfig, h: torch.Tensor, router: torch.Tensor,
           bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (gates [B, S, k] f32, top_i [B, S, k] expert ids)."""
    E, k = config.num_experts, config.experts_per_token
    logits = moe.router_logits(h, router)
    choice = _scores(config, logits)
    if config.scoring_func == "sigmoid":
        choice = choice + bias.to(torch.float32)                # selection
    if _grouped(config):
        G = config.n_group
        gsc = choice.reshape(choice.shape[:-1] + (G, E // G))
        if config.topk_method == "noaux_tc":
            group_scores = top_k(gsc, 2)[0].sum(-1)
        else:
            group_scores = gsc.amax(-1)
        gidx = top_k(group_scores, config.topk_group)[1]
        keep = torch.zeros_like(group_scores, dtype=torch.bool).scatter_(
            -1, gidx, True).repeat_interleave(E // G, dim=-1)
        choice = torch.where(keep, choice, torch.zeros_like(choice))
    top_i = top_k(choice, k)[1]
    return gates_at(config, logits, top_i), top_i


# -- attention --------------------------------------------------------------------

def _project(config: ModelConfig, h: torch.Tensor, lw: Dict[str, Any],
             li: int, tables):
    """Queries and the new latent of layer li: q_nope [B, S, nH, dn],
    roped q_pe [B, S, nH, dr], normed c_kv [B, S, lr] and roped k_pe
    [B, S, dr] (q_pe and k_pe share one RoPE pass, k_pe as one more
    head)."""
    B, S, _ = h.shape
    nH, dn, dr, dv, lr = _dims(config)
    eps = config.rms_norm_eps
    if config.q_lora_rank:
        qa = ops.rms_norm(ops.qmatmul(h, lw["wq_a"], li), lw["q_a_norm"][li],
                          eps)
        q = ops.qmatmul(qa, lw["wq_b"], li)
    else:
        q = ops.qmatmul(h, lw["wq"], li)
    q = q.reshape(B, S, nH, dn + dr)
    ckv = ops.qmatmul(h, lw["wkv_a"], li)
    c_lat = ops.rms_norm(ckv[..., :lr], lw["kv_a_norm"][li], eps)
    pe = torch.cat([q[..., dn:], ckv[..., None, lr:]], dim=2)
    pe = ops.apply_rope(pe, None, mode=RopeMode.INTERLEAVED, tables=tables)
    return q[..., :dn], pe[:, :, :nH], c_lat, pe[:, :, nH]


def _encode(c_lat: torch.Tensor, k_pe: torch.Tensor, dtype):
    """The new latent and rope key as the cache stores them -> (c, pe,
    c_scale, pe_scale); the scales are None unless dtype is int8."""
    c, cs = encode_kv_scaled(c_lat, dtype)
    p, ps = encode_kv_scaled(k_pe, dtype)
    return c, p, cs, ps


def _latent_attention(config: ModelConfig, q_nope: torch.Tensor,
                      q_pe: torch.Tensor, wkv_b: torch.Tensor,
                      c: torch.Tensor, pe: torch.Tensor, c_sc, pe_sc,
                      ok: torch.Tensor, C: int, cdt) -> torch.Tensor:
    """Absorbed attention of q_nope [B, S, nH, dn] and q_pe [B, S, nH, dr]
    over the latent keys c [B, T, lr] and pe [B, T, dr] (cache storage;
    int8 with the scales c_sc/pe_sc [B, T] f32, else None), in chunks of
    C keys; ok [B, 1, S, T] marks the visible keys -> [B, S, nH*dv] f32."""
    B, S, nH, _ = q_nope.shape
    _, dn, _, dv, lr = _dims(config)
    T = c.shape[1]
    f32 = torch.float32
    scale = _softmax_scale(config)
    w = wkv_b.reshape(lr, nH, dn + dv).to(cdt).to(f32)
    q_abs = torch.einsum("bsnd,rnd->bsnr", q_nope.to(cdt).to(f32),
                         w[..., :dn]).to(cdt).to(f32)
    qp = q_pe.to(cdt).to(f32)

    def scores(sl):
        ck, pk = c[:, sl].to(cdt).to(f32), pe[:, sl].to(cdt).to(f32)
        s_c = torch.einsum("bsnr,btr->bnst", q_abs, ck)
        s_p = torch.einsum("bsnd,btd->bnst", qp, pk)
        if c_sc is None:
            s = (s_c + s_p) * scale
        else:
            s = (s_c * c_sc[:, None, None, sl]
                 + s_p * pe_sc[:, None, None, sl]) * scale
        return torch.where(ok[..., sl], s, NEG_INF), ck

    def weights(p, sl):
        # fold an int8 latent's scales into the probability weights
        p = p if c_sc is None else p * c_sc[:, None, None, sl]
        return p.to(cdt).to(f32)

    n = T // C
    if S == 1:
        # every chunk at once: m_c is the running max after chunk c, and
        # the later chunks' corrections multiply to exp(m_c - m_last)
        s, ck = scores(slice(None))
        s = s.reshape(B, nH, S, n, C)
        m = torch.cummax(s.amax(-1), dim=-1).values          # [B, nH, S, n]
        p = torch.exp(s - m[..., None])
        f = torch.exp(m - m[..., -1:])
        denom = (p.sum(-1) * f).sum(-1)
        pv = torch.einsum("bnscu,bcur->bnscr",
                          weights(p.reshape(B, nH, S, T), slice(None))
                          .reshape(B, nH, S, n, C), ck.reshape(B, n, C, lr))
        acc = (pv * f[..., None]).sum(-2)
    else:
        m = torch.full((B, nH, S), -math.inf, dtype=f32, device=c.device)
        denom = torch.zeros((B, nH, S), dtype=f32, device=c.device)
        acc = torch.zeros((B, nH, S, lr), dtype=f32, device=c.device)
        for c0 in range(0, T, C):
            sl = slice(c0, c0 + C)
            s, ck = scores(sl)
            m2 = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m2[..., None])
            corr = torch.exp(m - m2)
            denom = denom * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bnst,btr->bnsr", weights(p, sl), ck)
            m = m2
    lat = (acc / denom[..., None]).transpose(1, 2)          # [B, S, nH, lr]
    out = torch.einsum("bsnr,rnd->bsnd", lat.to(cdt).to(f32), w[..., dn:])
    return out.reshape(B, S, nH * dv)


# -- layers ------------------------------------------------------------------------

def _ffn(config: ModelConfig, h: torch.Tensor, lw: Dict[str, Any], li: int,
         dense: bool) -> torch.Tensor:
    """The dense SwiGLU (dense group) or the routed experts plus the
    gateless shared experts in f32 -> [B, S, H] in h.dtype."""
    if dense:
        g, u = llama.gate_up_proj(h, lw, li)
        return comm.tp_sum(ops.qmatmul(ops.glu(g, u).to(h.dtype),
                                       lw["w_down"], li))
    gates, top_i = _route(config, h, lw["router"][li], lw["router_bias"][li])
    out = moe.expert_mix(config, h, lw, li, gates, top_i)
    if "ws_gate" in lw:
        s = ops.glu(ops.qmatmul(h, lw["ws_gate"], li),
                    ops.qmatmul(h, lw["ws_up"], li))
        s = ops.qmatmul(s.to(h.dtype), lw["ws_down"], li)
        out = out + s.to(torch.float32)
    # the rank's experts and shared-expert rows: one all-reduce for both
    return comm.tp_sum(out).to(h.dtype)


def _groups(params: Dict[str, Any], config: ModelConfig):
    """(weights, weight index, cache layer, dense) of every layer in
    order: the dense group, then the MoE layers."""
    kd = config.first_k_dense_replace
    for i in range(kd):
        yield params["dense_layers"], i, i, True
    for i in range(config.num_layers - kd):
        yield params["layers"], i, kd + i, False


def _block(config: ModelConfig, x: torch.Tensor, lw: Dict[str, Any],
           li: int, dense: bool, attend) -> torch.Tensor:
    """RMSNorm -> MLA (attend(h) -> [B, S, nH*dv] f32) -> wo -> residual
    -> RMSNorm -> FFN -> residual."""
    eps = config.rms_norm_eps
    h = ops.rms_norm(x, lw["attn_norm"][li], eps)
    x = x + comm.tp_sum(ops.qmatmul(attend(h).to(h.dtype), lw["wo"], li))
    h = ops.rms_norm(x, lw["ffn_norm"][li], eps)
    return x + _ffn(config, h, lw, li, dense)


def forward(params: Dict[str, Any], config: ModelConfig, tokens: torch.Tensor,
            cache: KVCache, *, seq_lens: Optional[torch.Tensor] = None,
            logit_idx: Optional[torch.Tensor] = None,
            fresh_prefill: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """Same contract as llama.forward over the latent cache (written in
    place at [start, start + S) of each row, the start clamped so the
    slab fits as JAX's dynamic_update_slice clamps it). fresh_prefill is
    accepted and changes nothing: the prefill always attends the cache
    it just wrote, as the JAX package's does."""
    check_supported(config)
    B, S = tokens.shape
    dev = tokens.device
    T = cache.k.shape[3]
    start = cache.length
    ar = torch.arange(S, dtype=torch.int32, device=dev)
    positions = start[:, None] + ar[None, :]
    if seq_lens is None:
        seq_lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    kv_len = (start + seq_lens).to(torch.int32)
    rows = torch.arange(B, device=dev)[:, None].expand(B, S)
    wpos = start.long().clamp(0, T - S)[:, None] + ar.long()[None, :]
    tpos = torch.arange(T, device=dev)
    ok = ((tpos[None, None, None, :] <= positions[:, None, :, None])
          & (tpos[None, None, None, :] < kv_len[:, None, None, None]))
    tables = ops.rope_tables(positions, config.qk_rope_head_dim,
                             config.rope_theta, RopeMode.INTERLEAVED,
                             config.rope_scaling)
    i8 = cache.k.dtype == torch.int8
    cdt = config.dtype if i8 else cache.k.dtype
    C = chunk_size(T)

    x = ops.embed_lookup(params["embed"], tokens, config.dtype)
    for lw, li, cl, dense in _groups(params, config):
        def attend(h):
            q_nope, q_pe, c_lat, k_pe = _project(config, h, lw, li, tables)
            c, p, cs, ps = _encode(c_lat, k_pe, cache.k.dtype)
            cache.k[cl, rows, 0, wpos] = c
            cache.v[cl, rows, 0, wpos] = p
            if i8:
                cache.k_scale[cl, rows, 0, wpos] = cs
                cache.v_scale[cl, rows, 0, wpos] = ps
            sc = (cache.k_scale[cl, :, 0], cache.v_scale[cl, :, 0]) if i8 \
                else (None, None)
            return _latent_attention(config, q_nope, q_pe, lw["wkv_b"][li],
                                     cache.k[cl, :, 0], cache.v[cl, :, 0],
                                     *sc, ok, C, cdt)
        x = _block(config, x, lw, li, dense, attend)
    if logit_idx is not None:
        x = x[torch.arange(B, device=dev), logit_idx.long()][:, None]
    return llama.head(config, params, x), cache._replace(length=kv_len)


def forward_no_cache(params: Dict[str, Any], config: ModelConfig,
                     tokens: torch.Tensor,
                     seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cacheless full-sequence forward: a model-dtype cache of exactly S
    positions -> logits [B, S, V] f32."""
    B, S = tokens.shape
    cache = init_cache(config, B, max_seq=S, device=tokens.device)
    return forward(params, config, tokens, cache, seq_lens=seq_lens)[0]


def forward_paged_decode(params: Dict[str, Any], config: ModelConfig,
                         tokens: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_table: torch.Tensor,
                         lengths: torch.Tensor, *,
                         k_scale_pages: Optional[torch.Tensor] = None,
                         v_scale_pages: Optional[torch.Tensor] = None):
    """One decode step over the paged latent pools (tokens [B], row b's
    token at position lengths[b]): k_pages [L, P, 1, page, lr] and
    v_pages [L, P, 1, page, dr], an int8 pool with its scale pages [L, P,
    1, page]. The new latent goes into the row's current page (an
    unassigned table entry writes trash page 0), then attention reads
    the row's pages through the block table, a chunk a page. The pools
    are written IN PLACE. Returns (logits [B, V] f32, k_pages,
    v_pages[, k_scale_pages, v_scale_pages when given])."""
    check_supported(config)
    i8 = k_scale_pages is not None
    if (k_pages.dtype == torch.int8) != i8:
        raise ValueError("an int8 latent pool takes k_scale_pages and "
                         "v_scale_pages, another pool none")
    B = tokens.shape[0]
    dev = tokens.device
    _, P, _, page, _ = k_pages.shape
    n = block_table.shape[1]
    lengths = lengths.to(device=dev, dtype=torch.int32)
    positions = lengths[:, None]
    kv_len = lengths + 1
    pid, poff = llama.page_slots(block_table, positions, P, page)
    table = block_table.to(device=dev).long().clamp(0, P - 1)      # [B, n]
    tpos = torch.arange(n * page, device=dev)
    ok = tpos[None, None, None, :] < kv_len[:, None, None, None]
    tables = ops.rope_tables(positions, config.qk_rope_head_dim,
                             config.rope_theta, RopeMode.INTERLEAVED,
                             config.rope_scaling)
    cdt = config.dtype if i8 else k_pages.dtype

    def read(pool, cl):
        g = pool[cl, table, 0]                    # [B, n, page(, D)]
        return g.reshape((B, n * page) + tuple(g.shape[3:]))

    x = ops.embed_lookup(params["embed"], tokens[:, None], config.dtype)
    for lw, li, cl, dense in _groups(params, config):
        def attend(h):
            q_nope, q_pe, c_lat, k_pe = _project(config, h, lw, li, tables)
            c, p, cs, ps = _encode(c_lat[:, 0], k_pe[:, 0], k_pages.dtype)
            k_pages[cl, pid, 0, poff] = c
            v_pages[cl, pid, 0, poff] = p
            sc = (None, None)
            if i8:
                k_scale_pages[cl, pid, 0, poff] = cs
                v_scale_pages[cl, pid, 0, poff] = ps
                sc = (read(k_scale_pages, cl), read(v_scale_pages, cl))
            return _latent_attention(config, q_nope, q_pe, lw["wkv_b"][li],
                                     read(k_pages, cl), read(v_pages, cl),
                                     *sc, ok, page, cdt)
        x = _block(config, x, lw, li, dense, attend)
    logits = llama.head(config, params, x)[:, 0]
    if i8:
        return logits, k_pages, v_pages, k_scale_pages, v_scale_pages
    return logits, k_pages, v_pages
