"""Fused int4 dequant x matmul: the wrapper of csrc/qmm.cu.

Counterpart of turboinfer_tpu/kernels/pallas/qmm.py qmatmul_pallas_stacked
and qmatmul_pallas (one CUDA kernel serves both: a 2-D weight is layer 0
of a stack). On a CUDA tensor the wrapper launches the kernel or raises;
on a CPU tensor it runs the plain version, qmatmul_plain.
"""

from __future__ import annotations

from typing import Optional

import torch

from turboinfer_tpu_torch.core.qtensor import QTensor
from turboinfer_tpu_torch.kernels import _build, ops
from turboinfer_tpu_torch.utils.errors import KernelError


def qmatmul_plain(x: torch.Tensor, qt: QTensor,
                  layer_index: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: x @ dequant(W[layer_index]) in x.dtype."""
    w = qt.layer(layer_index) if layer_index is not None else qt
    if w.stacked:
        raise ValueError("a stacked QTensor needs layer_index")
    return ops.qmatmul_ref(x, w)


def _check(x: torch.Tensor, qt: QTensor, layer_index) -> None:
    K, N = qt.shape
    if qt.bits != 4 or qt.zero_points is not None:
        raise KernelError("qmm_int4 takes symmetric int4 weights only "
                          f"(bits={qt.bits}, zero_points="
                          f"{qt.zero_points is not None})")
    if x.dtype != torch.bfloat16 or qt.scales.dtype != torch.bfloat16:
        raise KernelError(f"qmm_int4 takes bf16 x and scales, got {x.dtype}"
                          f" and {qt.scales.dtype}")
    if qt.data.dtype != torch.uint8 or qt.data.device != x.device \
            or qt.scales.device != x.device:
        raise KernelError("qmm_int4: weight must be uint8 on x's device")
    g = qt.group_size
    if g <= 0 or g % 64 or K % g or N % 8 or x.shape[-1] != K:
        raise KernelError(f"qmm_int4 needs a group size g that is a multiple"
                          f" of 64 and divides K, and N % 8 == 0 (K={K}, "
                          f"N={N}, g={g}, x {tuple(x.shape)})")
    if (qt.stacked and layer_index is None) or \
            (not qt.stacked and layer_index not in (None, 0)):
        raise KernelError("qmm_int4: layer_index must match the weight's "
                          "stacking")
    if not (qt.data.is_contiguous() and qt.scales.is_contiguous()):
        raise KernelError("qmm_int4: weight data and scales must be "
                          "contiguous")


def qmm_int4(x: torch.Tensor, qt: QTensor,
             layer_index: Optional[int] = None) -> torch.Tensor:
    """[..., K] @ dequant(W) -> [..., N] in x.dtype, W = qt (2-D) or layer
    `layer_index` of a stacked qt. Launches the kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return qmatmul_plain(x, qt, layer_index)
    _check(x, qt, layer_index)
    K, N = qt.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()          # the kernel reads x in 16-byte vectors
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y.reshape(*lead, N)
    li = 0 if layer_index is None else int(layer_index)
    w = qt.data[li] if qt.stacked else qt.data
    s = qt.scales[li] if qt.stacked else qt.scales
    if w.data_ptr() % 16 or s.data_ptr() % 16:
        raise KernelError("qmm_int4: weight planes must be 16-byte aligned")
    lib = _build.library()
    nws = lib.ti_qmm_workspace(M, K, N)
    ws = torch.empty((max(nws, 1),), dtype=torch.float32, device=x.device)
    status = lib.ti_qmm_int4(x2.data_ptr(), w.data_ptr(), s.data_ptr(),
                             y.data_ptr(), ws.data_ptr(), M, K, N,
                             qt.group_size,
                             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "qmm_int4")
    qmm_int4.launches += 1
    return y.reshape(*lead, N)


qmm_int4.launches = 0
