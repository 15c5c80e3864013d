"""Fused int4 dequant x matmul: the wrappers of csrc/qmm.cu.

qmm_int4 is the counterpart of turboinfer_tpu/kernels/pallas/qmm.py
qmatmul_pallas_stacked and qmatmul_pallas (one CUDA kernel serves both:
a 2-D weight is layer 0 of a stack); qmm_int4_grouped of
qmatmul_pallas_grouped (G device-chosen planes of a flat expert stack
in one launch). On a CUDA tensor a wrapper launches its kernel or
raises; on a CPU tensor it runs its plain version (qmatmul_plain,
qmatmul_grouped_plain).
"""

from __future__ import annotations

from typing import Optional

import torch

from turboinfer_tpu_torch.core.qtensor import QTensor, dequantize
from turboinfer_tpu_torch.kernels import _build, ops
from turboinfer_tpu_torch.utils.errors import KernelError


def qmatmul_plain(x: torch.Tensor, qt: QTensor,
                  layer_index: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: x @ dequant(W[layer_index]) in x.dtype."""
    if qt.data.dim() == 4:
        raise ValueError("a 4-D expert stack must be flattened first "
                         "(QTensor.flat())")
    w = qt.layer(layer_index) if layer_index is not None else qt
    if w.stacked:
        raise ValueError("a stacked QTensor needs layer_index")
    return ops.qmatmul_ref(x, w)


def qmatmul_grouped_plain(xg: torch.Tensor, qt: QTensor,
                          slots: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: out[g] = xg[g] @ dequant(W[slots[g]]) in
    xg.dtype (weight rounded to xg.dtype, f32 sums), for xg [G, ..., K]
    and a flat stack W [n, ...]; slots are clamped into [0, n-1] as the
    kernel clamps them. No host sync."""
    if not qt.stacked:
        raise ValueError("grouped qmm needs a flat [n, ...] stack (a 4-D "
                         "expert stack goes through QTensor.flat())")
    idx = slots.to(qt.data.device).long().clamp(0, qt.data.shape[0] - 1)
    zp = None if qt.zero_points is None else qt.zero_points[idx]
    w = dequantize(QTensor(data=qt.data[idx], scales=qt.scales[idx],
                           zero_points=zp, bits=qt.bits,
                           group_size=qt.group_size, shape=qt.shape),
                   xg.dtype)                                    # [G, K, N]
    G, K, N = xg.shape[0], qt.shape[0], qt.shape[1]
    y = torch.bmm(xg.reshape(G, -1, K).to(torch.float32),
                  w.to(torch.float32))
    return y.to(xg.dtype).reshape(*xg.shape[:-1], N)


def _check(x: torch.Tensor, qt: QTensor, layer_index,
           name: str = "qmm_int4") -> None:
    K, N = qt.shape
    if qt.data.dim() not in (2, 3):
        raise KernelError(f"{name}: a 4-D expert stack must be flattened "
                          "first (QTensor.flat())")
    if qt.bits != 4 or qt.zero_points is not None:
        raise KernelError(f"{name} takes symmetric int4 weights only "
                          f"(bits={qt.bits}, zero_points="
                          f"{qt.zero_points is not None})")
    if x.dtype != torch.bfloat16 or qt.scales.dtype != torch.bfloat16:
        raise KernelError(f"{name} takes bf16 x and scales, got {x.dtype}"
                          f" and {qt.scales.dtype}")
    if qt.data.dtype != torch.uint8 or qt.data.device != x.device \
            or qt.scales.device != x.device:
        raise KernelError(f"{name}: weight must be uint8 on x's device")
    g = qt.group_size
    if g <= 0 or g % 64 or K % g or N % 8 or x.shape[-1] != K:
        raise KernelError(f"{name} needs a group size g that is a multiple"
                          f" of 64 and divides K, and N % 8 == 0 (K={K}, "
                          f"N={N}, g={g}, x {tuple(x.shape)})")
    if (qt.stacked and layer_index is None) or \
            (not qt.stacked and layer_index not in (None, 0)):
        raise KernelError(f"{name}: layer_index must match the weight's "
                          "stacking")
    if not (qt.data.is_contiguous() and qt.scales.is_contiguous()):
        raise KernelError(f"{name}: weight data and scales must be "
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


def qmm_int4_grouped(xg: torch.Tensor, qt: QTensor,
                     slots: torch.Tensor) -> torch.Tensor:
    """[G, ..., K] -> [G, ..., N] in xg.dtype: group g times dequant of
    plane slots[g] of the flat stack qt, all G groups in one launch for
    CUDA tensors. slots: [G] integer ids on xg's device (read by the
    kernel, never by the host); at most 16 rows per group."""
    if xg.device.type == "cpu":
        return qmatmul_grouped_plain(xg, qt, slots)
    _check(xg, qt, 0, "qmm_int4_grouped")
    if not qt.stacked:
        raise KernelError("qmm_int4_grouped needs a flat [n, K/2, N] stack")
    K, N = qt.shape
    G = xg.shape[0]
    x3 = xg.reshape(G, -1, K).contiguous()
    if x3.data_ptr() % 16:
        x3 = x3.clone()
    M = x3.shape[1]
    lib = _build.library()
    if M > lib.ti_qmm_gemv_max_m():
        raise KernelError(f"qmm_int4_grouped takes at most "
                          f"{lib.ti_qmm_gemv_max_m()} rows per group, got "
                          f"{M}")
    if slots.shape != (G,) or slots.device != xg.device \
            or slots.dtype not in (torch.int32, torch.int64):
        raise KernelError(f"qmm_int4_grouped: slots must be [G={G}] integer"
                          f" ids on {xg.device}, got {tuple(slots.shape)} "
                          f"{slots.dtype} on {slots.device}")
    if qt.data.data_ptr() % 16 or qt.scales.data_ptr() % 16:
        raise KernelError("qmm_int4_grouped: weight planes must be 16-byte "
                          "aligned")
    y = torch.empty((G, M, N), dtype=xg.dtype, device=xg.device)
    if G == 0 or M == 0:
        return y.reshape(*xg.shape[:-1], N)
    slots = slots.to(torch.int32).contiguous()
    ws = torch.empty((max(G * lib.ti_qmm_workspace(M, K, N), 1),),
                     dtype=torch.float32, device=xg.device)
    status = lib.ti_qmm_int4_grouped(
        x3.data_ptr(), qt.data.data_ptr(), qt.scales.data_ptr(),
        slots.data_ptr(), y.data_ptr(), ws.data_ptr(), G, M, K, N,
        qt.group_size, qt.data.shape[0],
        torch.cuda.current_stream(xg.device).cuda_stream)
    _build.check(status, "qmm_int4_grouped")
    qmm_int4_grouped.launches += 1
    return y.reshape(*xg.shape[:-1], N)


qmm_int4_grouped.launches = 0
