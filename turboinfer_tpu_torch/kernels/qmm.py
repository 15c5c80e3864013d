"""Fused int4/int8 dequant x matmul: the wrappers of csrc/qmm.cu.

qmm_int4 and qmm_int8 are the counterparts of
turboinfer_tpu/kernels/pallas/qmm.py qmatmul_pallas_stacked and
qmatmul_pallas (one CUDA kernel serves both: a 2-D weight is layer 0 of
a stack); qmm_int4_grouped and qmm_int8_grouped of
qmatmul_pallas_grouped (G device-chosen planes of a flat expert stack
in one launch). Each takes symmetric weights or zero points
(asymmetric), as the Pallas kernels' asym branches do. On a CUDA tensor
a wrapper launches its kernel or raises; on a CPU tensor it runs its
plain version (qmatmul_plain, qmatmul_grouped_plain).
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


_DATA_DTYPE = {4: torch.uint8, 8: torch.int8}


def _check(x: torch.Tensor, qt: QTensor, layer_index, bits: int,
           name: str) -> None:
    K, N = qt.shape
    if qt.data.dim() not in (2, 3):
        raise KernelError(f"{name}: a 4-D expert stack must be flattened "
                          "first (QTensor.flat())")
    if qt.bits != bits or qt.data.dtype != _DATA_DTYPE[bits]:
        raise KernelError(f"{name} takes int{bits} weights stored as "
                          f"{_DATA_DTYPE[bits]} (bits={qt.bits}, "
                          f"{qt.data.dtype})")
    zp = qt.zero_points
    planes = [t for t in (qt.data, qt.scales, zp) if t is not None]
    if x.dtype != torch.bfloat16 or any(
            t.dtype != torch.bfloat16 for t in planes[1:]):
        raise KernelError(f"{name} takes bf16 x, scales and zero points, "
                          f"got {x.dtype}, {qt.scales.dtype} and "
                          f"{None if zp is None else zp.dtype}")
    if any(t.device != x.device for t in planes):
        raise KernelError(f"{name}: weight, scales and zero points must be "
                          "on x's device")
    g = qt.group_size
    if g <= 0 or g % 64 or K % g or N % 8 or x.shape[-1] != K:
        raise KernelError(f"{name} needs a group size g that is a multiple"
                          f" of 64 and divides K, and N % 8 == 0 (8-column "
                          f"loads) (K={K}, N={N}, g={g}, x "
                          f"{tuple(x.shape)})")
    if zp is not None and zp.shape != qt.scales.shape:
        raise KernelError(f"{name}: zero points {tuple(zp.shape)} must have "
                          f"the scales' shape {tuple(qt.scales.shape)}")
    if (qt.stacked and layer_index is None) or \
            (not qt.stacked and layer_index not in (None, 0)):
        raise KernelError(f"{name}: layer_index must match the weight's "
                          "stacking")
    if not all(t.is_contiguous() for t in planes):
        raise KernelError(f"{name}: weight data, scales and zero points "
                          "must be contiguous")


def _aligned(name: str, *ts) -> None:
    if any(t is not None and t.data_ptr() % 16 for t in ts):
        raise KernelError(f"{name}: weight planes, scales and zero points "
                          "must be 16-byte aligned")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _qmm(x: torch.Tensor, qt: QTensor, layer_index: Optional[int],
         bits: int, name: str) -> torch.Tensor:
    """One launch of ti_qmm on the CUDA tensors (checked first)."""
    _check(x, qt, layer_index, bits, name)
    K, N = qt.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()          # the kernel reads x in 16-byte vectors
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y.reshape(*lead, N)
    w = qt.layer(0 if layer_index is None else int(layer_index))
    _aligned(name, w.data, w.scales, w.zero_points)
    lib = _build.library()
    nws = lib.ti_qmm_workspace(M, K, N, bits)
    ws = torch.empty((max(nws, 1),), dtype=torch.float32, device=x.device)
    status = lib.ti_qmm(x2.data_ptr(), w.data.data_ptr(), w.scales.data_ptr(),
                        _ptr(w.zero_points), y.data_ptr(), ws.data_ptr(), M,
                        K, N, qt.group_size, bits,
                        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, name)
    return y.reshape(*lead, N)


def _qmm_grouped(xg: torch.Tensor, qt: QTensor, slots: torch.Tensor,
                 bits: int, name: str) -> torch.Tensor:
    """One launch of ti_qmm_grouped on the CUDA tensors (checked first)."""
    _check(xg, qt, 0, bits, name)
    if not qt.stacked:
        raise KernelError(f"{name} needs a flat [n, K(/2), N] stack")
    K, N = qt.shape
    G = xg.shape[0]
    x3 = xg.reshape(G, -1, K).contiguous()
    if x3.data_ptr() % 16:
        x3 = x3.clone()
    M = x3.shape[1]
    lib = _build.library()
    if M > lib.ti_qmm_gemv_max_m():
        raise KernelError(f"{name} takes at most {lib.ti_qmm_gemv_max_m()} "
                          f"rows per group, got {M}")
    if slots.shape != (G,) or slots.device != xg.device \
            or slots.dtype not in (torch.int32, torch.int64):
        raise KernelError(f"{name}: slots must be [G={G}] integer ids on "
                          f"{xg.device}, got {tuple(slots.shape)} "
                          f"{slots.dtype} on {slots.device}")
    _aligned(name, qt.data, qt.scales, qt.zero_points)
    y = torch.empty((G, M, N), dtype=xg.dtype, device=xg.device)
    if G == 0 or M == 0:
        return y.reshape(*xg.shape[:-1], N)
    slots = slots.to(torch.int32).contiguous()
    ws = torch.empty((max(G * lib.ti_qmm_workspace(M, K, N, bits), 1),),
                     dtype=torch.float32, device=xg.device)
    status = lib.ti_qmm_grouped(
        x3.data_ptr(), qt.data.data_ptr(), qt.scales.data_ptr(),
        _ptr(qt.zero_points), slots.data_ptr(), y.data_ptr(), ws.data_ptr(),
        G, M, K, N, qt.group_size, bits, qt.data.shape[0],
        torch.cuda.current_stream(xg.device).cuda_stream)
    _build.check(status, name)
    return y.reshape(*xg.shape[:-1], N)


def qmm_int4(x: torch.Tensor, qt: QTensor,
             layer_index: Optional[int] = None) -> torch.Tensor:
    """[..., K] @ dequant(W) -> [..., N] in x.dtype, W = int4 qt (2-D) or
    layer `layer_index` of a stacked qt, with or without zero points.
    Launches the kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return qmatmul_plain(x, qt, layer_index)
    y = _qmm(x, qt, layer_index, 4, "qmm_int4")
    qmm_int4.launches += 1
    return y


qmm_int4.launches = 0


def qmm_int8(x: torch.Tensor, qt: QTensor,
             layer_index: Optional[int] = None) -> torch.Tensor:
    """qmm_int4's counterpart for int8 weights ([K, N] int8 codes per
    layer), with or without zero points."""
    if x.device.type == "cpu":
        return qmatmul_plain(x, qt, layer_index)
    y = _qmm(x, qt, layer_index, 8, "qmm_int8")
    qmm_int8.launches += 1
    return y


qmm_int8.launches = 0


def qmm_int4_grouped(xg: torch.Tensor, qt: QTensor,
                     slots: torch.Tensor) -> torch.Tensor:
    """[G, ..., K] -> [G, ..., N] in xg.dtype: group g times dequant of
    plane slots[g] of the flat int4 stack qt (zero points optional), all
    G groups in one launch for CUDA tensors. slots: [G] integer ids on
    xg's device (read by the kernel, never by the host); at most 16 rows
    per group."""
    if xg.device.type == "cpu":
        return qmatmul_grouped_plain(xg, qt, slots)
    y = _qmm_grouped(xg, qt, slots, 4, "qmm_int4_grouped")
    qmm_int4_grouped.launches += 1
    return y


qmm_int4_grouped.launches = 0


def qmm_int8_grouped(xg: torch.Tensor, qt: QTensor,
                     slots: torch.Tensor) -> torch.Tensor:
    """qmm_int4_grouped's counterpart for a flat int8 stack [n, K, N]."""
    if xg.device.type == "cpu":
        return qmatmul_grouped_plain(xg, qt, slots)
    y = _qmm_grouped(xg, qt, slots, 8, "qmm_int8_grouped")
    qmm_int8_grouped.launches += 1
    return y


qmm_int8_grouped.launches = 0
