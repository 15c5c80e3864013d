"""Sparse Mixture-of-Experts decoders in PyTorch (Mixtral, Qwen2-MoE,
Qwen3-MoE, OLMoE): counterpart of turboinfer_tpu/models/moe.py.

The llama attention block (models/llama.py, reused whole through its
ffn_fn hook) with a top-k routed SwiGLU expert FFN. Gate conventions as
in the JAX package: config.norm_topk_prob=True renormalizes the top-k
softmax (Mixtral: a softmax over the selected logits), False keeps the
raw full-softmax probabilities. Per layer the parameters add
  "router" [L, H, E] (fp, applied in f32) and
  "we_gate"/"we_up" [L, E, H, F], "we_down" [L, E, F, H]
(tensors, or 4-D QTensors that prepare_params views as the flat [L*E]
stack and fuses into "we_gateup" + "we_down"). The variants add the
llama body's q/k/v biases ("b_q"/"b_k"/"b_v", Qwen2-MoE) and q/k
RMSNorms ("q_norm"/"k_norm": [L, D] per head for Qwen3-MoE, [L, Hq*D]
over the whole projection for OLMoE), and Qwen2-MoE's shared expert:
"ws_gate"/"ws_up" [L, H, Fs], "ws_down" [L, Fs, H] and "shared_gate"
[L, H, 1] (fp always: N=1), a SwiGLU on every token scaled by the
sigmoid of h @ shared_gate and added to the f32 expert mix.

Expert regimes, all exact (no capacity drops), as in the JAX package:
  - quantized, B*S == 1 (decode at batch 1): the k routed slots
    li*E + top_i stay on the device and feed the grouped qmm kernel, one
    launch per expert matrix;
  - quantized, otherwise: a static loop over the E experts, each applied
    to every token and masked by the dense [B, S, E] mix, summed in f32
    in the order e = 0..E-1 (every expert's weights read once);
  - fp: gather the selected experts when B*S*k < E, else a dense masked
    einsum over all E.
The paged decode and verify run the same FFN through llama's ffn_fn
hook. Under expert parallelism (parallel/shardings.moe_param_specs) a
rank holds E / tp experts of every stack and sums only those; the
router is replicated, and the rank's partial mix (with its rows of the
shared expert) takes one all-reduce.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from turboinfer_tpu_torch.config import ModelConfig
from turboinfer_tpu_torch.core.qtensor import QTensor
from turboinfer_tpu_torch.kernels import ops
from turboinfer_tpu_torch.models import llama
from turboinfer_tpu_torch.models.common import KVCache
from turboinfer_tpu_torch.models.common import (  # noqa: F401
    param_bytes, param_count, reset_cache)
from turboinfer_tpu_torch.parallel import comm
from turboinfer_tpu_torch.utils.device import resolve_device
from turboinfer_tpu_torch.utils.errors import ConfigError

ARCHITECTURES = ("mixtral", "qwen2_moe", "qwen3_moe", "olmoe", "moe")
# ModelConfig knobs this family's forward is not held to against the JAX
# package (whose MoE layer computes none of them), with the value that
# means "off".
_UNPORTED = (("sliding_window", None), ("attn_logit_softcap", None),
             ("final_logit_softcap", None), ("norm_offset", False),
             ("scale_embeddings", False), ("embedding_multiplier", None),
             ("residual_multiplier", None), ("logits_scaling", None),
             ("post_norms", False),
             ("attn_scale", None), ("rope_local_theta", None),
             ("parallel_residual", False), ("alibi", False),
             ("rotary_pct", 1.0), ("kv_lora_rank", None))
# llama's attention body threads the int8 scales and reads fp8 caches
SUPPORTS_INT8_KV = True


def check_supported(config: ModelConfig) -> None:
    """Raise for a config this family's port does not run."""
    if config.architecture not in ARCHITECTURES:
        raise NotImplementedError(
            f"architecture {config.architecture!r} is not ported yet")
    if config.num_experts <= 0:
        raise ConfigError("moe model needs config.num_experts > 0")
    if not 0 < config.experts_per_token <= config.num_experts:
        raise ConfigError(f"experts_per_token={config.experts_per_token} "
                          f"must be in [1, {config.num_experts}]")
    for name, off in _UNPORTED:
        if getattr(config, name) != off:
            raise NotImplementedError(
                f"ModelConfig.{name}={getattr(config, name)!r} is not ported "
                "to the PyTorch package yet")


def init_cache(config: ModelConfig, batch_size: int, max_seq=None,
               dtype=None, device="cuda") -> KVCache:
    """Head-major [L, B, Hkv, T, D] cache of zeros on `device`."""
    return llama.init_cache(config, batch_size, max_seq, dtype, device)


def init_params(config: ModelConfig, seed: int = 0, device="cuda",
                dtype=None) -> Dict[str, Any]:
    """Random fp parameters (N(0, 1/fan_in)), unit norms, and the
    variants' slots as the JAX package's init_params makes them: q/k/v
    biases N(0, 0.02^2) (attn_bias), per-head q/k norms [L, D] (qk_norm)
    and the shared expert with its [L, H, 1] gate (shared_expert_size)."""
    check_supported(config)
    dev = resolve_device(device)
    dtype = dtype or config.dtype
    H, V, L, E = (config.hidden_size, config.vocab_size, config.num_layers,
                  config.num_experts)
    QD, KVD = config.q_dim, config.kv_dim
    F = config.moe_intermediate_size or config.ffn_dim
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
            "router": w((L, H, E), H),
            "we_gate": w((L, E, H, F), H), "we_up": w((L, E, H, F), H),
            "we_down": w((L, E, F, H), F),
        },
        "final_norm": torch.ones((H,), dtype=dtype, device=dev),
        "lm_head": w((H, V), H),
    }
    layers = params["layers"]
    if config.attn_bias:
        for name, n in (("b_q", QD), ("b_k", KVD), ("b_v", KVD)):
            layers[name] = (0.02 * torch.randn((L, n), generator=gen,
                                               device=dev)).to(dtype)
    if config.qk_norm:
        D = config.head_dim_
        layers["q_norm"] = torch.ones((L, D), dtype=dtype, device=dev)
        layers["k_norm"] = torch.ones((L, D), dtype=dtype, device=dev)
    if config.shared_expert_size:
        Fs = config.shared_expert_size
        layers.update(ws_gate=w((L, H, Fs), H), ws_up=w((L, H, Fs), H),
                      ws_down=w((L, Fs, H), Fs), shared_gate=w((L, H, 1), H))
    if config.tie_embeddings:
        params["lm_head"] = params["embed"].T
    return params


def router_logits(h: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """Router logits of one layer in f32: h [B, S, H] and router [H, E],
    both taken to f32 -> [B, S, E]."""
    return torch.matmul(h.to(torch.float32), router.to(torch.float32))


def gates_at(config: ModelConfig, logits: torch.Tensor, top_i: torch.Tensor
             ) -> torch.Tensor:
    """Gates [B, S, k] f32 of the experts top_i: a softmax over their
    logits (norm_topk_prob), else the full softmax at them."""
    if config.norm_topk_prob:
        return torch.softmax(logits.gather(-1, top_i), dim=-1)
    return torch.softmax(logits, dim=-1).gather(-1, top_i)


def route(config: ModelConfig, h: torch.Tensor, router: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router of one layer -> (gates [B, S, k] f32, top_i [B, S, k]
    expert ids): the top-k of the logits, or of their softmax when the
    gates are not renormalised, as the JAX package ranks them."""
    logits = router_logits(h, router)
    scores = logits if config.norm_topk_prob else torch.softmax(logits, -1)
    top_i = torch.topk(scores, config.experts_per_token, dim=-1).indices
    return gates_at(config, logits, top_i), top_i


def _moe_ffn(config: ModelConfig, h: torch.Tensor, lw: Dict[str, Any],
             li: int) -> torch.Tensor:
    """Top-k routed SwiGLU experts of layer li (the ffn_fn hook), plus
    the shared expert when the layer has one: h [B, S, H] -> [B, S, H]
    in h.dtype."""
    gates, top_i = route(config, h, lw["router"][li])
    out = expert_mix(config, h, lw, li, gates, top_i)
    if "ws_gate" in lw:
        out = out + shared_expert(h, lw, li)
    # expert parallel: this rank's experts and shared-expert rows are
    # partial sums, and one all-reduce serves both
    return comm.tp_sum(out).to(h.dtype)


def shared_expert(h: torch.Tensor, lw: Dict[str, Any], li: int
                  ) -> torch.Tensor:
    """Qwen2-MoE's shared expert of layer li -> [B, S, H] f32: a SwiGLU
    of ws_gate/ws_up/ws_down on every token, times sigmoid(h @
    shared_gate) (the gate product summed in f32 and rounded to h.dtype,
    as the JAX package's fp qmatmul returns it)."""
    s = ops.glu(ops.qmatmul(h, lw["ws_gate"], li),
                ops.qmatmul(h, lw["ws_up"], li))
    s = ops.qmatmul(s.to(h.dtype), lw["ws_down"], li)
    sg = torch.sigmoid(ops.qmatmul(h, lw["shared_gate"], li))
    return sg.to(torch.float32) * s.to(torch.float32)


def _gate_up(lw: Dict[str, Any], product):
    """(gate, up) of the experts: product(weight) of the fused
    "we_gateup" split in halves, or of "we_gate" and "we_up"."""
    if "we_gateup" in lw:
        gu = product(lw["we_gateup"])
        F = gu.shape[-1] // 2
        return gu[..., :F], gu[..., F:]
    return product(lw["we_gate"]), product(lw["we_up"])


def dense_mix(gates: torch.Tensor, top_i: torch.Tensor, E: int
               ) -> torch.Tensor:
    """The top-k gates scattered into a dense [B, S, E] f32 mix."""
    mix = torch.zeros(gates.shape[:-1] + (E,), dtype=torch.float32,
                      device=gates.device)
    return mix.scatter_add_(-1, top_i.long(), gates.to(torch.float32))


def local_experts(config: ModelConfig) -> Tuple[int, int]:
    """(first expert, expert count) of this rank: (0, E) off a sharded
    forward, (tp_rank * E / tp, E / tp) under expert parallelism (the
    stacks split on their expert axis)."""
    n = config.num_experts // comm.tp_size()
    return comm.tp_rank() * n, n


def local_slots(top_i: torch.Tensor, gates: torch.Tensor, e0: int, n: int):
    """Routed experts top_i as this rank's local expert ids, and the gates
    with the other ranks' experts at 0: a clamped id still names a local
    plane (read, then weighted 0), so the selection needs no host sync."""
    loc = top_i - e0
    mine = (loc >= 0) & (loc < n)
    return loc.clamp(0, n - 1), gates * mine.to(gates.dtype)


def expert_mix(config: ModelConfig, h: torch.Tensor, lw: Dict[str, Any],
               li: int, gates: torch.Tensor, top_i: torch.Tensor
               ) -> torch.Tensor:
    """Gate-weighted sum of the selected experts' SwiGLU outputs of layer
    li -> [B, S, H] f32. gates/top_i: [B, S, k]. Under expert parallelism
    (local_experts) only this rank's experts are summed: a partial sum."""
    if isinstance(lw["we_down"], QTensor):
        return _expert_ffn_quant(config, h, lw, li, gates, top_i)
    E, k = config.num_experts, config.experts_per_token
    e0, n = local_experts(config)
    B, S, _ = h.shape

    def product(eq, a, w):
        return torch.einsum(eq, a.to(torch.float32),
                            w.to(h.dtype).to(torch.float32)).to(h.dtype)
    if B * S * k < E:
        # few tokens: gather only the selected experts (flat slot ids)
        if n != E:
            top_i, gates = local_slots(top_i, gates, e0, n)
        idx = li * n + top_i

        def take(w):
            return w.reshape((-1,) + tuple(w.shape[2:]))[idx]
        g, u = _gate_up(lw, lambda w: product("bsh,bskhf->bskf", h, take(w)))
        act = ops.glu(g, u).to(h.dtype)
        out_e = product("bskf,bskfh->bskh", act, take(lw["we_down"]))
        return torch.einsum("bskh,bsk->bsh", out_e.to(torch.float32),
                            gates.to(torch.float32))
    mix = dense_mix(gates, top_i, E)
    if n != E:
        mix = mix[..., e0:e0 + n]
    g, u = _gate_up(lw, lambda w: product("bsh,ehf->bsef", h, w[li]))
    act = ops.glu(g, u).to(h.dtype)
    out_e = product("bsef,efh->bseh", act, lw["we_down"][li])
    return torch.einsum("bseh,bse->bsh", out_e.to(torch.float32), mix)


def _expert_ffn_quant(config: ModelConfig, h: torch.Tensor,
                      lw: Dict[str, Any], li: int, gates: torch.Tensor,
                      top_i: torch.Tensor) -> torch.Tensor:
    """Routed experts with quantized weights -> [B, S, H] f32. The
    rank's experts are planes li*n + e of the flat [L*n] stacks (n = E
    off a sharded forward; local_experts)."""
    E, k = config.num_experts, config.experts_per_token
    e0, n = local_experts(config)
    B, S, H = h.shape
    w = {name: v.flat() for name, v in lw.items()
         if name in ("we_gateup", "we_gate", "we_up", "we_down")}
    base = li * n
    if B == 1 and S == 1:
        # the k routed slots, computed and read on the device: one
        # grouped launch per expert matrix, no host sync (each rank reads
        # k planes of its own, the other ranks' experts weighted 0)
        if n != E:
            top_i, gates = local_slots(top_i, gates, e0, n)
        slots = (base + top_i[0, 0]).to(torch.int32)                # [k]
        xg = h[None].expand(k, B, S, H)
        g, u = _gate_up(w, lambda wt: ops.qmatmul_grouped(xg, wt, slots))
        act = ops.glu(g, u).to(h.dtype)
        down = ops.qmatmul_grouped(act, w["we_down"], slots)
        return torch.einsum("kbsh,bsk->bsh", down.to(torch.float32),
                            gates.to(torch.float32))
    mix = dense_mix(gates, top_i, E)
    out = torch.zeros((B, S, H), dtype=torch.float32, device=h.device)
    for e in range(n):
        g, u = _gate_up(w, lambda wt: ops.qmatmul(h, wt, base + e))
        act = ops.glu(g, u).to(h.dtype)
        y = ops.qmatmul(act, w["we_down"], base + e).to(torch.float32)
        out = out + mix[..., e0 + e:e0 + e + 1] * y
    return out


def forward(params: Dict[str, Any], config: ModelConfig, tokens: torch.Tensor,
            cache: KVCache, *, seq_lens: Optional[torch.Tensor] = None,
            logit_idx: Optional[torch.Tensor] = None,
            fresh_prefill: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """Same contract as llama.forward, with the routed experts."""
    check_supported(config)
    return llama.forward(params, config, tokens, cache, seq_lens=seq_lens,
                         logit_idx=logit_idx, fresh_prefill=fresh_prefill,
                         ffn_fn=_moe_ffn)


def forward_no_cache(params: Dict[str, Any], config: ModelConfig,
                     tokens: torch.Tensor,
                     seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Same contract as llama.forward_no_cache, with the routed experts."""
    check_supported(config)
    return llama.forward_no_cache(params, config, tokens, seq_lens,
                                  ffn_fn=_moe_ffn)


def forward_paged_decode(params: Dict[str, Any], config: ModelConfig,
                         tokens: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_table: torch.Tensor,
                         lengths: torch.Tensor, *, k_scale_pages=None,
                         v_scale_pages=None):
    """Same contract as llama.forward_paged_decode, with the experts."""
    check_supported(config)
    return llama.forward_paged_decode(params, config, tokens, k_pages,
                                      v_pages, block_table, lengths,
                                      ffn_fn=_moe_ffn,
                                      k_scale_pages=k_scale_pages,
                                      v_scale_pages=v_scale_pages)


def forward_paged_verify(params: Dict[str, Any], config: ModelConfig,
                         tokens: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_table: torch.Tensor,
                         lengths: torch.Tensor, *, k_scale_pages=None,
                         v_scale_pages=None):
    """Same contract as llama.forward_paged_verify, with the experts."""
    check_supported(config)
    return llama.forward_paged_verify(params, config, tokens, k_pages,
                                      v_pages, block_table, lengths,
                                      ffn_fn=_moe_ffn,
                                      k_scale_pages=k_scale_pages,
                                      v_scale_pages=v_scale_pages)
