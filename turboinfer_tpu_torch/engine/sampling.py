"""On-device sampling, counterpart of turboinfer_tpu/engine/sampling.py:
penalties -> temperature -> top-k -> top-p -> min-p -> categorical draw,
with the same filters, order and tie rules (a logit equal to the k-th
largest survives top-k; the first token crossing p survives top-p).
Draws come from an explicit torch.Generator (Gumbel-max, as
jax.random.categorical draws), so the streams differ from JAX's; compare
the filtered distributions, never sampled tokens.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NEG_INF = -1e30


class SamplingParams(NamedTuple):
    temperature: float = 1.0
    top_k: int = 50
    top_p: float = 0.9
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0

    @property
    def needs_counts(self) -> bool:
        return (self.repetition_penalty != 1.0
                or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0)


def _masked(x: torch.Tensor, drop: torch.Tensor) -> torch.Tensor:
    return torch.where(drop, torch.full_like(x, NEG_INF), x)


def apply_temperature(logits: torch.Tensor, temperature: float
                      ) -> torch.Tensor:
    if temperature <= 0.0:
        return logits
    return logits / temperature


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return _masked(logits, logits < kth)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    if p >= 1.0 or p <= 0.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p
    thresh = torch.where(keep, sorted_logits,
                         torch.full_like(sorted_logits, float("inf"))
                         ).amin(dim=-1, keepdim=True)
    return _masked(logits, logits < thresh)


def apply_min_p(logits: torch.Tensor, min_p: float) -> torch.Tensor:
    if min_p <= 0.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    floor = min_p * probs.amax(dim=-1, keepdim=True)
    return _masked(logits, probs < floor)


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor,
                    repetition_penalty=1.0, presence_penalty=0.0,
                    frequency_penalty=0.0,
                    out_counts: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """HF-convention repetition penalty over `counts` (prompt + output),
    OpenAI-convention presence/frequency penalties over `out_counts`.
    Each penalty is a scalar or a per-row [...] tensor."""
    if out_counts is None:
        out_counts = counts
    x = logits.to(torch.float32)

    def per_row(v):
        if not isinstance(v, torch.Tensor):
            return v
        v = v.to(device=x.device, dtype=torch.float32)
        return v[..., None] if v.dim() == x.dim() - 1 else v
    r = repetition_penalty
    r = (per_row(r).clamp(min=1e-3) if isinstance(r, torch.Tensor)
         else max(float(r), 1e-3))
    penalized = torch.where(x > 0, x / r, x * r)
    x = torch.where(counts > 0, penalized, x)
    return (x - per_row(frequency_penalty) * out_counts.to(torch.float32)
            - per_row(presence_penalty) * (out_counts > 0).to(torch.float32))


def categorical(generator: torch.Generator, logits: torch.Tensor,
                draw=None) -> torch.Tensor:
    """One draw per row from softmax(logits) over the last axis, by
    Gumbel-max (as jax.random.categorical draws) -> int64 indices.
    draw=(first, total): logits [B, V] are rows first..first+B of a batch
    of total rows; the noise is drawn for the whole batch and these rows'
    taken, so a data rank samples what one process running the whole
    batch would."""
    shape = logits.shape if draw is None else (draw[1],) + logits.shape[1:]
    u = torch.rand(shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    if draw is not None:
        u = u[draw[0]:draw[0] + logits.shape[0]]
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def sample(generator: torch.Generator, logits: torch.Tensor,
           params: SamplingParams, counts=None, draw=None) -> torch.Tensor:
    """logits [..., V] -> tokens [...] int32. temperature <= 0 is greedy
    (penalties still apply). counts = (all_counts, out_counts) is needed
    iff params.needs_counts. draw: categorical's."""
    x = logits.to(torch.float32)
    if params.needs_counts:
        all_counts, out_counts = counts
        x = apply_penalties(x, all_counts, params.repetition_penalty,
                            params.presence_penalty, params.frequency_penalty,
                            out_counts=out_counts)
    if params.temperature <= 0.0:
        return greedy(x)
    x = apply_temperature(x, params.temperature)
    k, V = params.top_k, x.shape[-1]
    if 0 < k < V and 0.0 < params.top_p < 1.0:
        # one descending sort serves both top-k and top-p
        sorted_desc = torch.sort(x, dim=-1, descending=True).values
        kth = sorted_desc[..., k - 1:k]
        x = _masked(x, x < kth)
        svals = _masked(sorted_desc, sorted_desc < kth)
        probs = torch.softmax(svals, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < params.top_p
        thresh = torch.where(keep, svals, torch.full_like(svals, float("inf"))
                             ).amin(dim=-1, keepdim=True)
        x = _masked(x, x < thresh)
    else:
        x = apply_top_k(x, params.top_k)
        x = apply_top_p(x, params.top_p)
    x = apply_min_p(x, params.min_p)
    return categorical(generator, x, draw).to(torch.int32)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def log_softmax(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.to(torch.float32), dim=-1)


def token_logprob(logits: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    lp = log_softmax(logits)
    return torch.gather(lp, -1, token[..., None].long())[..., 0]


def filtered_dist_per_slot(logits: torch.Tensor, temperature: torch.Tensor,
                           top_k: torch.Tensor, top_p: torch.Tensor
                           ) -> torch.Tensor:
    """Per-row (temperature -> top-k -> top-p) filtered distribution over
    [B, ..., V]; greedy rows (temperature <= 0) give a one-hot at the
    argmax."""
    V = logits.shape[-1]
    x = logits.to(torch.float32)
    bshape = (x.shape[0],) + (1,) * (x.dim() - 2)
    t = temperature.to(torch.float32).clamp(min=1e-6).reshape(bshape + (1,))
    xs = x / t
    sorted_desc = torch.sort(xs, dim=-1, descending=True).values
    k = torch.where(top_k <= 0, torch.full_like(top_k, V),
                    top_k.clamp(1, V)).reshape(bshape)
    kidx = (k - 1)[..., None].expand(xs.shape[:-1] + (1,)).long()
    kth = torch.gather(sorted_desc, -1, kidx)
    xs = _masked(xs, xs < kth)
    svals = _masked(sorted_desc, sorted_desc < kth)
    probs = torch.softmax(svals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    tp = top_p.to(torch.float32)
    p = torch.where((tp <= 0.0) | (tp >= 1.0), torch.ones_like(tp),
                    tp).reshape(bshape + (1,))
    keep = (cum - probs) < p
    thresh = torch.where(keep, svals, torch.full_like(svals, float("inf"))
                         ).amin(dim=-1, keepdim=True)
    xs = _masked(xs, xs < thresh)
    dist = torch.softmax(xs, dim=-1)
    onehot = torch.nn.functional.one_hot(x.argmax(dim=-1), V).to(torch.float32)
    g = (temperature <= 0.0).reshape(bshape + (1,))
    return torch.where(g, onehot, dist)


def per_slot_candidates(logits: torch.Tensor, temperature: torch.Tensor,
                        top_k: torch.Tensor, top_p: torch.Tensor,
                        num_candidates: int = 128, min_p=None,
                        repetition_penalty=None, presence_penalty=None,
                        frequency_penalty=None, counts=None, out_counts=None):
    """The filtered candidate window of sample_per_slot -> (xs [B, C]
    tempered candidate logits, NEG_INF where a filter drops one; idx
    [B, C] their token ids, logits descending; x [B, V] the penalised
    logits). softmax(xs) is the distribution a sampled row draws from."""
    B, V = logits.shape
    C = min(num_candidates, V)
    x = logits.to(torch.float32)
    if counts is not None:
        # per-row penalties over the whole vocabulary before candidate
        # selection (greedy rows respect them too)
        x = apply_penalties(
            x, counts,
            1.0 if repetition_penalty is None else repetition_penalty,
            0.0 if presence_penalty is None else presence_penalty,
            0.0 if frequency_penalty is None else frequency_penalty,
            out_counts=out_counts)
    vals, idx = torch.topk(x, C, dim=-1)
    xs = vals / temperature.to(torch.float32).clamp(min=1e-6)[:, None]
    pos = torch.arange(C, device=x.device)[None, :]
    k = torch.where(top_k <= 0, torch.full_like(top_k, C),
                    top_k.clamp(max=C))[:, None]
    xs = _masked(xs, pos >= k)
    # top-p among the kept candidates (the first candidate crossing p
    # is kept, as in apply_top_p)
    probs = torch.softmax(xs, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    tp = top_p.to(torch.float32)
    p = torch.where((tp <= 0.0) | (tp >= 1.0), torch.ones_like(tp), tp)
    xs = _masked(xs, (cum - probs) >= p[:, None])
    if min_p is not None:
        # min-p floor within the window (softmax over the candidates)
        mp = min_p.to(torch.float32)[:, None]
        floor = mp * probs.amax(dim=-1, keepdim=True)
        xs = _masked(xs, (probs < floor) & (mp > 0.0))
    return xs, idx, x


def sample_per_slot(generator: torch.Generator, logits: torch.Tensor,
                    temperature: torch.Tensor, top_k: torch.Tensor,
                    top_p: torch.Tensor, num_candidates: int = 128,
                    min_p=None, repetition_penalty=None,
                    presence_penalty=None, frequency_penalty=None,
                    counts=None, out_counts=None) -> torch.Tensor:
    """Per-ROW sampling knobs: each batch slot has its own temperature,
    top-k, top-p and min-p (temperature, top_p, min_p [B] f32; top_k
    [B] int), and its own penalties over counts [B, V]. A row with
    temperature <= 0 is greedy. Filtering runs inside a fixed
    num_candidates-wide top-k window (a row's k is clamped to it), as in
    the JAX package. logits [B, V] -> tokens [B] int32."""
    xs, idx, x = per_slot_candidates(
        logits, temperature, top_k, top_p, num_candidates, min_p,
        repetition_penalty, presence_penalty, frequency_penalty, counts,
        out_counts)
    drawn = idx.gather(1, categorical(generator, xs)[:, None])[:, 0]
    return torch.where(temperature <= 0.0, torch.argmax(x, dim=-1),
                       drawn).to(torch.int32)
