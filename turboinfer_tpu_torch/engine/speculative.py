"""Speculative decoding's acceptance core (counterpart of the shared
pieces of turboinfer_tpu/engine/speculative.py).

A draft model proposes k tokens per row, one (k+1)-wide target pass
scores them, and rejection sampling accepts a prefix: d_i is accepted
iff u * q(d_i) < p(d_i); at the first rejection a correction is drawn
from the residual max(p - q, 0), so the output follows the target's own
filtered distribution. For greedy rows both distributions are one-hot,
and acceptance is exact greedy matching. The scheduler's rounds
(engine/scheduler.py) use rejection_accept and emit_layout; the engine's
own speculative entry point comes in a later slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from turboinfer_tpu_torch.engine import sampling
from turboinfer_tpu_torch.engine.sampling import SamplingParams


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
