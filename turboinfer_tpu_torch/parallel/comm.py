"""The collectives of the rank-local forwards (no JAX counterpart: GSPMD
places them there).

A sharded model (parallel/shardings.ShardedModel) makes its mesh the
active one for the duration of each forward call; the model code calls
the functions below at the few points where a rank holds a partial
result:
  - tp_sum after each row-parallel product (wo, w_down, ws_down) and
    after the expert combine, in f32 (ROADMAP §3 Decisions);
  - gather_vocab for vocab-split logits;
  - tp_sum of a [.., 1] f32 sum of squares for a norm over heads that
    live on several ranks (OLMoE's whole-width q/k norm).
With no active mesh, or a tp axis of 1, each returns its input and
calls no collective. Every call is synchronous on the rank's one
stream. A gloo group takes host tensors: a CUDA tensor goes through a
host copy and back (two ranks sharing one card run gloo).
gather_rows_for_host gathers host objects over the data axis.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, List, Optional

import torch
import torch.distributed as dist

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("tp_mesh",
                                                        default=None)
# collectives issued by this process (tests hold mesh=None runs to 0)
calls = 0


@contextlib.contextmanager
def active(mesh):
    """Make `mesh` the one the forwards' collectives run on (None, or a
    tp axis of 1: none run)."""
    token = _ACTIVE.set(mesh if mesh is not None and mesh.tp > 1 else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def tp_rank() -> int:
    m = _ACTIVE.get()
    return 0 if m is None else m.tp_rank


def tp_size() -> int:
    m = _ACTIVE.get()
    return 1 if m is None else m.tp


def _staged(mesh, x: torch.Tensor) -> torch.Tensor:
    """x as the group's backend takes it: a host copy under gloo."""
    global calls
    calls += 1
    if mesh.backend == "gloo" and x.device.type != "cpu":
        return x.cpu()
    return x


def tp_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of x over the tp group, reduced in f32 and returned in x's
    dtype; x itself is not modified."""
    mesh = _ACTIVE.get()
    if mesh is None:
        return x
    f = _staged(mesh, x.to(torch.float32, copy=True))
    dist.all_reduce(f, group=mesh.tp_group)
    return f.to(device=x.device, dtype=x.dtype)


def gather_vocab(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Logits [..., V/tp] of a vocab-split head -> [..., V], rank order;
    unchanged when they already span the vocabulary."""
    mesh = _ACTIVE.get()
    if mesh is None or logits.shape[-1] == vocab_size:
        return logits
    x = _staged(mesh, logits.contiguous())
    parts = [torch.empty_like(x) for _ in range(mesh.tp)]
    dist.all_gather(parts, x, group=mesh.tp_group)
    return torch.cat(parts, dim=-1).to(logits.device)


def gather_rows_for_host(obj: Any, mesh) -> List[Any]:
    """Every data rank's `obj` in data-rank order (one host all-gather on
    the data axis's gloo group; [obj] without one)."""
    global calls
    if mesh is None or mesh.data == 1:
        return [obj]
    calls += 1
    out: List[Optional[Any]] = [None] * mesh.data
    dist.all_gather_object(out, obj, group=mesh.data_cpu_group)
    return out


def broadcast_plan(obj: Any, mesh) -> Any:
    """Rank 0's host object on every rank of the mesh (the serving plan,
    on the gloo group)."""
    global calls
    calls += 1
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.cpu_group)
    return box[0]
