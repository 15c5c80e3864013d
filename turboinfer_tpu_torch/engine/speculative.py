"""Speculative decoding: a draft model proposes, the target verifies in
one pass (counterpart of turboinfer_tpu/engine/speculative.py).

A draft model proposes k tokens per row, one (k+1)-wide target pass
scores them, and rejection sampling accepts a prefix: d_i is accepted
iff u * q(d_i) < p(d_i); at the first rejection a correction is drawn
from the residual max(p - q, 0), so the output follows the target's own
filtered distribution. For greedy rows acceptance is exact greedy
matching, so greedy speculative output equals plain greedy decoding of
the target. The scheduler's rounds (engine/scheduler.py) use
rejection_accept and emit_layout; make_spec_step builds the engine-level
round that speculative_generate drives: where JAX jits one fixed-shape
program, a round here is an eager sequence of launches on the device
(draft ingest, k draft steps, the target's verify, acceptance, and the
rollback of both caches' lengths), and the host reads its tokens once.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from turboinfer_tpu_torch.config import InferenceConfig, ModelConfig
from turboinfer_tpu_torch.engine import sampling
from turboinfer_tpu_torch.engine.sampling import SamplingParams
from turboinfer_tpu_torch.kernels.dispatch import prepare_params
from turboinfer_tpu_torch.models import registry
from turboinfer_tpu_torch.models.common import (KVCache, params_to,
                                                resolve_kv_dtype)
from turboinfer_tpu_torch.utils.device import resolve_device


class SpecState(NamedTuple):
    tok: torch.Tensor     # [B] current (confirmed, not yet cached) token
    cache_t: KVCache
    cache_d: KVCache


def rejection_accept(pt: torch.Tensor, qd: torch.Tensor,
                     drafts: torch.Tensor, generator: torch.Generator
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pt/qd: target/draft FILTERED distributions over the k draft
    positions [B, k, V]; drafts [B, k]. Returns (a [B] accepted counts,
    corr [B] the correction drawn at the first rejected position).

    The test is STRICT (u * q < p): u == 0 is a possible draw, and <=
    would accept a draft the target gives zero probability. The
    residual falls back to p when it is empty."""
    k = drafts.shape[1]
    d = drafts.long()[..., None]
    p_d = pt.gather(-1, d)[..., 0]
    q_d = qd.gather(-1, d)[..., 0]
    u = torch.rand(drafts.shape, generator=generator, device=pt.device,
                   dtype=torch.float32)
    ok = (u * q_d < p_d).to(torch.int32)
    a = torch.cumprod(ok, dim=1).sum(dim=1).to(torch.int32)      # [B]
    slot = a.clamp(max=k - 1).long()[:, None, None].expand(-1, 1,
                                                           pt.shape[-1])
    pt_a = pt.gather(1, slot)[:, 0]
    qd_a = qd.gather(1, slot)[:, 0]
    res = (pt_a - qd_a).clamp(min=0.0)
    res_sum = res.sum(dim=-1, keepdim=True)
    res = torch.where(res_sum > 0, res / res_sum.clamp(min=1e-30), pt_a)
    corr = sampling.categorical(generator, torch.log(res.clamp(min=1e-30)))
    return a, corr.to(torch.int32)


def emit_layout(drafts: torch.Tensor, nxt: torch.Tensor, a: torch.Tensor
                ) -> torch.Tensor:
    """A round's output [B, k+1]: d_1..d_a, then nxt, padded with nxt."""
    k = drafts.shape[1]
    pos = torch.arange(k + 1, device=drafts.device)[None, :]
    padded = torch.nn.functional.pad(drafts, (0, 1))
    return torch.where(pos < a[:, None], padded, nxt[:, None]).to(
        drafts.dtype)


def _filtered_probs(logits: torch.Tensor, sp: SamplingParams
                    ) -> torch.Tensor:
    """The (temperature, top-k, top-p) filtered distribution that both
    models' proposals are judged under, as sampling.sample filters."""
    x = sampling.apply_temperature(logits.to(torch.float32), sp.temperature)
    x = sampling.apply_top_k(x, sp.top_k)
    x = sampling.apply_top_p(x, sp.top_p)
    return torch.softmax(x, dim=-1)


def make_spec_step(model_t, cfg_t: ModelConfig, model_d, cfg_d: ModelConfig,
                   k: int, sp: SamplingParams):
    """The one-round step: step(params_t, params_d, state, generator) ->
    (state', out_tokens [B, k+1], out_count [B]); out_tokens[b] holds the
    a_b accepted drafts followed by the correction or bonus token
    (out_count = a_b + 1 valid entries)."""
    greedy = sp.temperature <= 0.0

    def step(params_t, params_d, state: SpecState, gen: torch.Generator):
        # 1. draft ingest of the current token
        lg, cache_d = model_d.forward(params_d, cfg_d, state.tok[:, None],
                                      state.cache_d)
        lg_prev = lg[:, 0]
        # 2. k draft proposals (the k-th also caches d_k, so the draft
        # cache holds exactly the confirmed tokens after the rollback)
        drafts, dlogits = [], []
        for _ in range(k):
            d = (sampling.greedy(lg_prev) if greedy
                 else sampling.sample(gen, lg_prev, sp))
            lg, cache_d = model_d.forward(params_d, cfg_d, d[:, None], cache_d)
            drafts.append(d)
            dlogits.append(lg_prev)
            lg_prev = lg[:, 0]
        drafts = torch.stack(drafts, 1)                        # [B, k]
        dlogits = torch.stack(dlogits, 1)                      # [B, k, V]
        # 3. the target verifies every proposal in one pass
        chunk = torch.cat([state.tok[:, None], drafts], dim=1)
        tlg, cache_t = model_t.forward(params_t, cfg_t, chunk, state.cache_t)
        # 4. acceptance
        if greedy:
            tbest = sampling.greedy(tlg)                       # [B, k+1]
            ok = (tbest[:, :k] == drafts).to(torch.int32)
            a = torch.cumprod(ok, dim=1).sum(dim=1).to(torch.int32)
            # the correction is the target's argmax at the first
            # rejection; the bonus (all accepted) its argmax after d_k
            nxt = tbest.gather(1, a.long()[:, None])[:, 0]
        else:
            pt = _filtered_probs(tlg[:, :k], sp)
            qd = _filtered_probs(dlogits, sp)
            a, corr = rejection_accept(pt, qd, drafts, gen)
            bonus = sampling.sample(gen, tlg[:, k], sp)
            nxt = torch.where(a == k, bonus, corr)
        # 5. rollback: rejected positions stay as masked garbage that
        # later writes overwrite
        len_t = state.cache_t.length + 1 + a
        state = SpecState(tok=nxt.to(torch.int32),
                          cache_t=cache_t._replace(length=len_t),
                          cache_d=cache_d._replace(length=len_t))
        return state, emit_layout(drafts, nxt, a), a + 1

    return step


@dataclasses.dataclass
class SpecResult:
    tokens: List[List[int]]          # prompt + generated, per sequence
    acceptance_rate: float           # accepted drafts / proposed drafts
    tokens_per_round: float          # mean emitted tokens per round
    rounds: int
    total_time_ms: float
    prefill_ms: float = 0.0          # both caches' prefill, of total_time_ms


def speculative_generate(params_t: Dict[str, Any], cfg_t: ModelConfig,
                         params_d: Dict[str, Any], cfg_d: ModelConfig,
                         prompts: Sequence[Sequence[int]],
                         max_new_tokens: int = 64, *, k: int = 4,
                         config: Optional[InferenceConfig] = None,
                         max_seq: Optional[int] = None,
                         device="cuda") -> SpecResult:
    """Batched speculative generation: both caches are prefilled on the
    right-padded prompts less their last token, then rounds run until
    every sequence has max_new_tokens or hit EOS. k: draft tokens per
    round. Randomness comes from one torch.Generator seeded by
    config.seed. device: "cuda" (default) runs the kernels; "cpu" their
    plain versions, when asked for."""
    config = config or InferenceConfig()
    dev = resolve_device(device)
    sp = SamplingParams(temperature=config.temperature,
                        top_k=config.top_k, top_p=config.top_p)
    model_t = registry.get_model(cfg_t.architecture)
    model_d = registry.get_model(cfg_d.architecture)
    B = len(prompts)
    if B == 0 or any(len(p) == 0 for p in prompts):
        raise ValueError("prompts must be non-empty")
    T = max_seq or min(cfg_t.max_seq_len, cfg_d.max_seq_len)
    plens = np.array([len(p) for p in prompts])
    S = int(plens.max())
    dt_t = resolve_kv_dtype(config.kv_cache_dtype, cfg_t.dtype)
    dt_d = resolve_kv_dtype(config.kv_cache_dtype, cfg_d.dtype)
    for m, dt in ((model_t, dt_t), (model_d, dt_d)):
        if dt == torch.int8 and not getattr(m, "SUPPORTS_INT8_KV", False):
            raise ValueError(
                "kv_cache_dtype='int8' is not supported by this model "
                "family (its forward does not thread the per-token KV "
                "scales); use 'fp8' or 'bf16'")
    if S + max_new_tokens + k + 1 > T:
        raise ValueError(
            f"max_seq {T} too small for prompt {S} + {max_new_tokens} "
            f"new + {k} draft slack")
    params_t = prepare_params(params_to(params_t, dev))
    params_d = prepare_params(params_to(params_d, dev))
    arr = np.full((B, S), config.pad_token_id, np.int32)
    for b, p in enumerate(prompts):
        arr[b, : len(p)] = p

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(config.seed)
    cache_t = model_t.init_cache(cfg_t, B, max_seq=T, dtype=dt_t, device=dev)
    cache_d = model_d.init_cache(cfg_d, B, max_seq=T, dtype=dt_d, device=dev)
    if S > 1:
        # both models prefill prompt[:-1]; the last prompt token is the
        # first round's input
        head = torch.from_numpy(arr[:, :-1]).to(dev)
        lens = torch.from_numpy((plens - 1).astype(np.int32)).to(dev)
        _, cache_t = model_t.forward(params_t, cfg_t, head, cache_t,
                                     seq_lens=lens, fresh_prefill=True)
        _, cache_d = model_d.forward(params_d, cfg_d, head, cache_d,
                                     seq_lens=lens, fresh_prefill=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    last = torch.from_numpy(arr[np.arange(B), plens - 1]).to(dev)
    state = SpecState(tok=last, cache_t=cache_t, cache_d=cache_d)
    step = make_spec_step(model_t, cfg_t, model_d, cfg_d, k, sp)
    out: List[List[int]] = [list(p) for p in prompts]
    done = np.zeros((B,), bool)
    accepted = proposed = emitted = rounds = 0
    while not done.all() and rounds < max_new_tokens:
        state, toks, counts = step(params_t, params_d, state, gen)
        host = torch.cat([toks, counts[:, None]], 1).cpu().numpy()  # one read
        rounds += 1
        for b in range(B):
            if done[b]:
                continue
            room = max_new_tokens - (len(out[b]) - len(prompts[b]))
            take = min(int(host[b, -1]), room)
            delivered = 0
            for t in host[b, :take]:
                out[b].append(int(t))
                delivered += 1
                if int(t) == config.eos_token_id:
                    done[b] = True
                    break
            if len(out[b]) - len(prompts[b]) >= max_new_tokens:
                done[b] = True
            # the metrics count what was delivered (a room cap or a
            # mid-round EOS drops the tail of a round)
            accepted += max(delivered - 1, 0)
            proposed += k
            emitted += delivered
    dt = (time.perf_counter() - t0) * 1e3
    return SpecResult(tokens=out, acceptance_rate=accepted / max(proposed, 1),
                      tokens_per_round=emitted / max(rounds * B, 1),
                      rounds=rounds, total_time_ms=dt, prefill_ms=prefill_ms)
