"""Tensor, data and expert parallelism on torch.distributed (counterpart
of turboinfer_tpu/parallel/ for a (data, tp) mesh).

- mesh.py: process-group bootstrap and the (data, tp) Mesh.
- shardings.py: the JAX package's spec sets, each rank's slice of the
  parameters and caches, and the rank-local model view.
- comm.py: the few collectives the rank-local forwards call.

Pipeline and context parallelism (JAX parallel/pipeline.py and
parallel/context.py) are not ported yet (ROADMAP §1 item 13).
"""

from turboinfer_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, TP_AXIS, Mesh, initialize_distributed, make_mesh,
    pick_mesh_shape, single_device_mesh)
