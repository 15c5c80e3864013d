"""Fused int4/int8 dequant x matmul: the wrappers of csrc/qmm.cu (with
csrc/qmm_tc.cu, its wgmma path for M > 16) and csrc/qmm_a8.cu.

qmm_int4 and qmm_int8 are the counterparts of
turboinfer_tpu/kernels/pallas/qmm.py qmatmul_pallas_stacked and
qmatmul_pallas (one CUDA kernel serves both: a 2-D weight is layer 0 of
a stack); qmm_int4_grouped and qmm_int8_grouped of
qmatmul_pallas_grouped (G device-chosen planes of a flat expert stack
in one launch). Each takes symmetric weights or zero points
(asymmetric), as the Pallas kernels' asym branches do. On a CUDA tensor
a wrapper launches its kernel or raises; on a CPU tensor it runs its
plain version (qmatmul_plain, qmatmul_grouped_plain).

W4A8 (csrc/qmm_a8.cu): with TURBOINFER_QMM_A8=1 the JAX package runs
some int4 products with int8 activations (_kernel_int4_a8[_idx]), which
changes their numbers. a8_applies is that decision; a8_quantize_rows and
qmm_int4_a8 are the two kernels of such a product (per-row int8
activations, then int8 x int4 on the tensor cores with the group scales
applied per group), a8_quantize_rows_plain and qmatmul_a8_plain their
plain versions.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from turboinfer_tpu_torch.core.qtensor import QTensor, dequantize
from turboinfer_tpu_torch.kernels import _build, ops
from turboinfer_tpu_torch.utils.errors import KernelError


def _plain_layer(qt: QTensor, layer_index: Optional[int]) -> QTensor:
    """The 2-D weight a plain version multiplies: layer `layer_index` of
    a stack, or qt itself."""
    if qt.data.dim() == 4:
        raise ValueError("a 4-D expert stack must be flattened first "
                         "(QTensor.flat())")
    w = qt.layer(layer_index) if layer_index is not None else qt
    if w.stacked:
        raise ValueError("a stacked QTensor needs layer_index")
    return w


def qmatmul_plain(x: torch.Tensor, qt: QTensor,
                  layer_index: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: x @ dequant(W[layer_index]) in x.dtype."""
    return ops.qmatmul_ref(x, _plain_layer(qt, layer_index))


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


# -- W4A8 ---------------------------------------------------------------------

# The JAX package's dispatch threshold (turboinfer_tpu/kernels/dispatch.py
# _QMM_MIN_BYTES): a weight plane smaller than this runs its jnp path
# there, never a Pallas kernel, so never W4A8. For routing it is a TPU
# workaround; under TURBOINFER_QMM_A8=1 it decides which products get
# int8 activations, so a8_applies keeps it.
QMM_MIN_BYTES = 262144


def a8_applies(M: int, qt: QTensor, layer_index: Optional[int] = None
               ) -> bool:
    """Whether the JAX package on a TPU runs the product of M activation
    rows with qt (layer `layer_index` of a stack) through its W4A8 body
    (_qmm_2d / _qmm_stacked, turboinfer_tpu/kernels/pallas/qmm.py:650-657
    and :856-863): TURBOINFER_QMM_A8=1, int4 symmetric weights, M > 8,
    g/2 a multiple of 128 (_fact_mode's "wide", :168-171; also off under
    TURBOINFER_QMM_NO_FACT=1), tiles found, and a weight plane of at
    least TURBOINFER_QMM_MIN_BYTES (default QMM_MIN_BYTES) bytes.
    Environment variables are read at each call. At M > 8 with g % 256
    == 0, _pick_tiles (:518) finds tiles exactly when 128 divides N
    (under its default TURBOINFER_QMM_TN/_TK tiling)."""
    if os.environ.get("TURBOINFER_QMM_A8", "0") != "1" or qt.bits != 4 \
            or qt.zero_points is not None or M <= 8 \
            or os.environ.get("TURBOINFER_QMM_NO_FACT") == "1":
        return False
    planes = qt.data.shape[0] if (layer_index is not None
                                  and qt.data.dim() == 3) else 1
    min_bytes = int(os.environ.get("TURBOINFER_QMM_MIN_BYTES",
                                   str(QMM_MIN_BYTES)))
    return (qt.data.numel() // planes >= min_bytes
            and qt.group_size % 256 == 0 and qt.shape[1] % 128 == 0)


def a8_quantize_rows_plain(x2: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the JAX package's _a8_quantize_rows as
    its compiled form computes it: per row of x2 [M, K], sx = max(absmax,
    1e-8) times f32(1/127) (XLA turns the `/ 127.0` into that multiply),
    codes round-half-even(x / sx) (a true division) clipped to +-127.
    Returns (codes int8 [M, K], sx f32 [M])."""
    from turboinfer_tpu_torch.models.common import INV_127
    xf = x2.to(torch.float32)
    sx = xf.abs().amax(dim=-1).clamp_min(1e-8) * INV_127
    xq = torch.round(xf / sx[:, None]).clamp(-127, 127).to(torch.int8)
    return xq, sx


def qmatmul_a8_plain(x: torch.Tensor, qt: QTensor,
                     layer_index: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the W4A8 product (the JAX package's
    _int4_a8_body with the caller's row scaling): x's rows quantized by
    a8_quantize_rows_plain; per scale group the integer partial
    sum(xq * (u - 8)) (exact in f32: |partial| <= 127 * 8 * g < 2^24),
    times the group's scale, added to an f32 accumulator in group order;
    the accumulator cast to x.dtype, then times sx in f32 and cast again
    (two roundings for bf16 x, one for f32)."""
    from turboinfer_tpu_torch.core.qtensor import unpack_int4
    w = _plain_layer(qt, layer_index)
    if w.bits != 4 or w.zero_points is not None:
        raise ValueError("W4A8 takes int4 symmetric weights")
    K, N = w.shape
    g = w.group_size
    if 127 * 8 * g >= 1 << 24:
        raise ValueError(f"group size {g} too large for exact f32 partials")
    f32 = torch.float32
    lead = x.shape[:-1]
    xq, sx = a8_quantize_rows_plain(x.reshape(-1, K))
    u = unpack_int4(w.data, g).to(f32)                    # [K, N], u - 8
    s = w.scales.to(f32)
    acc = torch.zeros((xq.shape[0], N), dtype=f32, device=x.device)
    for j in range(K // g):
        ks = slice(j * g, (j + 1) * g)
        acc = acc + torch.matmul(xq[:, ks].to(f32), u[ks]) * s[j]
    y = (acc.to(x.dtype).to(f32) * sx[:, None]).to(x.dtype)
    return y.reshape(*lead, N)


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
    cnt = _build.counters(x.device, lib.ti_qmm_counters(N))
    status = lib.ti_qmm(x2.data_ptr(), w.data.data_ptr(), w.scales.data_ptr(),
                        _ptr(w.zero_points), y.data_ptr(), ws.data_ptr(),
                        cnt.data_ptr(), M, K, N, qt.group_size, bits,
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
    nws = lib.ti_qmm_grouped_workspace(G, M, K, N, bits)
    ws = torch.empty((max(nws, 1),), dtype=torch.float32, device=xg.device)
    cnt = _build.counters(xg.device, G * lib.ti_qmm_counters(N))
    status = lib.ti_qmm_grouped(
        x3.data_ptr(), qt.data.data_ptr(), qt.scales.data_ptr(),
        _ptr(qt.zero_points), slots.data_ptr(), y.data_ptr(), ws.data_ptr(),
        cnt.data_ptr(), G, M, K, N, qt.group_size, bits, qt.data.shape[0],
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


# Longest row a8_quantize_rows takes (csrc/qmm_a8.cu kQMaxK): the kernel
# holds a row in shared memory.
A8_MAX_K = 112 * 1024


def a8_quantize_rows(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2 bf16 [M, K] -> (codes int8 [M, K], sx f32 [M]), the bytes of
    a8_quantize_rows_plain, in one launch for CUDA tensors (K <=
    A8_MAX_K)."""
    if x2.device.type == "cpu":
        return a8_quantize_rows_plain(x2)
    if x2.dim() != 2 or x2.dtype != torch.bfloat16 or x2.shape[1] % 8 \
            or x2.shape[1] > A8_MAX_K or not x2.is_contiguous() \
            or x2.data_ptr() % 16:
        raise KernelError(f"a8_quantize_rows takes a contiguous, 16-byte "
                          f"aligned bf16 [M, K] with K % 8 == 0 and K <= "
                          f"{A8_MAX_K}, got {x2.dtype} {tuple(x2.shape)}")
    M, K = x2.shape
    xq = torch.empty((M, K), dtype=torch.int8, device=x2.device)
    sx = torch.empty((M,), dtype=torch.float32, device=x2.device)
    if M == 0:
        return xq, sx
    status = _build.library().ti_a8_quantize_rows(
        x2.data_ptr(), xq.data_ptr(), sx.data_ptr(), M, K,
        torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(status, "a8_quantize_rows")
    a8_quantize_rows.launches += 1
    return xq, sx


a8_quantize_rows.launches = 0


def qmm_int4_a8(x: torch.Tensor, qt: QTensor,
                layer_index: Optional[int] = None) -> torch.Tensor:
    """The W4A8 product [..., K] -> [..., N] in x.dtype with int4
    symmetric qt (2-D, or layer `layer_index` of a stack): for CUDA
    tensors a8_quantize_rows, then the int8 tensor-core kernel; never a
    bf16 qmm in its place."""
    if x.device.type == "cpu":
        return qmatmul_a8_plain(x, qt, layer_index)
    name = "qmm_int4_a8"
    _check(x, qt, layer_index, 4, name)
    if qt.zero_points is not None:
        raise KernelError(f"{name} takes symmetric weights (the JAX "
                          "package's W4A8 body has no zero points)")
    K, N = qt.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    if x2.data_ptr() % 16:
        x2 = x2.clone()
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y.reshape(*lead, N)
    w = qt.layer(0 if layer_index is None else int(layer_index))
    _aligned(name, w.data, w.scales)
    xq, sx = a8_quantize_rows(x2)
    status = _build.library().ti_qmm_a8(
        xq.data_ptr(), sx.data_ptr(), w.data.data_ptr(), w.scales.data_ptr(),
        y.data_ptr(), M, K, N, qt.group_size,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, name)
    qmm_int4_a8.launches += 1
    return y.reshape(*lead, N)


qmm_int4_a8.launches = 0
