"""Process groups and the (data, tp) mesh (counterpart of
turboinfer_tpu/parallel/mesh.py).

One process a rank, one device a rank. Rank r sits at (r // tp, r % tp)
of the (data, tp) grid, as JAX reshapes its device list row-major. The
backend is the caller's choice and nothing replaces it: "nccl" for one
GPU a rank (how the port is deployed), "gloo" for CPU ranks and for
ranks that share one card. Every group gets the timeout given to
initialize_distributed, so a rank that dies fails its peers' next
collective instead of hanging them.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from turboinfer_tpu_torch.utils.device import resolve_device

DATA_AXIS = "data"
TP_AXIS = "tp"
DEFAULT_TIMEOUT_S = 300.0
# the timeout initialize_distributed gave the default group: make_mesh
# gives every group it creates the same
_timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)


def initialize_distributed(backend: str, init_method: str, world_size: int,
                           rank: int, timeout_s: float = DEFAULT_TIMEOUT_S
                           ) -> None:
    """Join the default process group. backend is "nccl" or "gloo" and is
    used as given; init_method is "env://" (torchrun), "tcp://host:port"
    or "file:///path"."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    global _timeout
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    _timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=_timeout)


@dataclasses.dataclass
class Mesh:
    """This rank's view of a (data, tp) mesh: the grid's shape, its own
    coordinates and device, and the groups it belongs to (None on a
    one-process mesh). tp_group runs the backend of the default group on
    device tensors; cpu_group and data_cpu_group are gloo groups for host
    objects (a serving plan, gathered results)."""

    shape: Tuple[int, int]
    coords: Tuple[int, int]
    device: torch.device
    tp_group: Any = None
    cpu_group: Any = None
    data_cpu_group: Any = None
    backend: Optional[str] = None

    @property
    def data(self) -> int:
        return self.shape[0]

    @property
    def tp(self) -> int:
        return self.shape[1]

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def data_rank(self) -> int:
        return self.coords[0]

    @property
    def tp_rank(self) -> int:
        return self.coords[1]

    @property
    def rank(self) -> int:
        return self.coords[0] * self.shape[1] + self.coords[1]


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Sequence[str] = (DATA_AXIS, TP_AXIS),
              device="cuda") -> Mesh:
    """The (data, tp) mesh over the default group's ranks (default: every
    rank on tp). Every rank must call it with the same shape: it creates
    the groups collectively. Without an initialized group only a mesh of
    one rank can be made. A CUDA device becomes the process's current
    one (_use_device)."""
    if tuple(axis_names) != (DATA_AXIS, TP_AXIS):
        raise ValueError(f"the port's mesh axes are ({DATA_AXIS!r}, "
                         f"{TP_AXIS!r}); pipeline and context axes are not "
                         "ported yet (ROADMAP §1 item 13)")
    dev = _use_device(resolve_device(device))
    n = dist.get_world_size() if dist.is_initialized() else 1
    shape = tuple(shape) if shape is not None else (1, n)
    if len(shape) != 2 or shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != process count {n}")
    if n == 1:
        return Mesh(shape=shape, coords=(0, 0), device=dev)
    d, t = shape
    rank = dist.get_rank()
    groups = {}
    # every rank creates every group, in one order (dist.new_group)
    for i in range(d):
        ranks = [i * t + j for j in range(t)]
        g = dist.new_group(ranks, timeout=_timeout)
        if rank in ranks:
            groups["tp"] = g
    for j in range(t):
        ranks = [i * t + j for i in range(d)]
        g = dist.new_group(ranks, backend="gloo", timeout=_timeout)
        if rank in ranks:
            groups["data_cpu"] = g
    return Mesh(shape=shape, coords=(rank // t, rank % t), device=dev,
                tp_group=groups["tp"],
                cpu_group=dist.new_group(list(range(n)), backend="gloo",
                                         timeout=_timeout),
                data_cpu_group=groups["data_cpu"],
                backend=dist.get_backend())


def _use_device(dev: torch.device) -> torch.device:
    """Make a CUDA device with an index the current one. The kernels
    launch through ctypes on the stream of their tensors' device, and the
    runtime resolves that stream (and hopper.cuh's SM count) on the
    current device: rank r on cuda:r must make it current before its
    first launch."""
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return dev


def pick_mesh_shape(n_devices: int, num_kv_heads: int,
                    batch_size: int = None) -> Tuple[int, int]:
    """(data, tp): tp the largest divisor of n that also divides
    num_kv_heads (the KV cache splits evenly over heads), data the rest.
    batch_size is ignored, as in the JAX package (maximising tp already
    minimises data)."""
    for tp in range(min(n_devices, num_kv_heads), 0, -1):
        if n_devices % tp or num_kv_heads % tp:
            continue
        return (n_devices // tp, tp)
    return (n_devices, 1)


def single_device_mesh(device="cuda") -> Mesh:
    """A (1, 1) mesh on `device` (made current, as make_mesh does): no
    group, no collective."""
    return Mesh(shape=(1, 1), coords=(0, 0),
                device=_use_device(resolve_device(device)))
