"""Paged decode and verify attention: the wrapper of the kernels in
csrc/paged_attention.cuh (C interface in paged_attention.cu; the int8 and
fp8 instances in paged_attention_int8.cu and paged_attention_fp8.cu).

Counterpart of turboinfer_tpu/kernels/pallas/paged_attention.py
paged_decode_pallas and paged_verify_pallas (one Pallas body,
_paged_decode, at g_tokens = 1 and G): the G query tokens q
[B, G, Hq, D] of each sequence attend layer `layer_index` of the stacked
pool [L, P, Hkv, page, D] through the block table [B, max_pages], read
in place through a pointer offset. The pool is bf16, int8 with its f32
scale pages k_scale/v_scale [L, P, Hkv, page], or fp8 (uint8 e4m3
bits). Query g sits at kv_len - G + g and sees keys at or before it,
optionally only those > its position - `window`; the scores may be
soft-capped to `softcap` * tanh(s / softcap) before the mask.
Table ids are clamped to [0, P-1] and kv_len to at least 1, as the JAX
kernel clamps them.

On CUDA tensors paged_attention launches the kernel (one launch: the
slices of a long sequence are merged by the last block to finish) or
raises, with no host sync; on CPU tensors it runs paged_plain.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from turboinfer_tpu_torch.kernels import _build, ops
from turboinfer_tpu_torch.kernels.decode_attention import (KV_DTYPES,
                                                           check_scales,
                                                           window_cap)
from turboinfer_tpu_torch.utils.errors import KernelError

HEAD_DIMS = (32, 64, 96, 128, 256)
MAX_GROUP = 8          # query heads per kv head
MAX_TOKENS = 16        # G, the chunk tokens of a verify
MAX_PAGE = 256


def paged_plain(q: torch.Tensor, k_pages: torch.Tensor,
                v_pages: torch.Tensor, table: torch.Tensor,
                kv_len: torch.Tensor, layer_index: int, g_tokens: int,
                k_scale: Optional[torch.Tensor] = None,
                v_scale: Optional[torch.Tensor] = None,
                window: Optional[int] = None,
                softcap: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version on the gathered pages, the layer's pool
    decoded to f32 values first (models/common.decode_kv: int8 codes
    times their scales, not rounded to q.dtype, as the kernel takes
    them), in f32, out in q.dtype. q: [B, G, Hq, D] with G = g_tokens
    -> [B, G, Hq, D]."""
    from turboinfer_tpu_torch.models.common import decode_kv
    li, f32 = layer_index, torch.float32
    kp = decode_kv(k_pages[li], f32, None if k_scale is None
                   else k_scale[li])
    vp = decode_kv(v_pages[li], f32, None if v_scale is None
                   else v_scale[li])
    kv = kv_len.clamp(min=1)
    if g_tokens == 1:
        out = ops.attention_paged_decode_ref(q[:, 0].to(f32), kp, vp, table,
                                             kv, window=window,
                                             softcap=softcap)[:, None]
    else:
        out = ops.attention_paged_verify_ref(q.to(f32), kp, vp, table, kv,
                                             window=window, softcap=softcap)
    return out.to(q.dtype)


def _check(q, k_pages, v_pages, table, layer_index, k_scale,
           v_scale) -> None:
    B, G, Hq, D = q.shape
    L, P, Hkv, page, Dc = k_pages.shape
    if q.dtype != torch.bfloat16 or k_pages.dtype not in KV_DTYPES \
            or v_pages.dtype != k_pages.dtype:
        raise KernelError(f"paged_attention takes a bf16 query and a bf16, "
                          f"int8 or fp8 (uint8) pool, got {q.dtype}, "
                          f"{k_pages.dtype}, {v_pages.dtype}")
    check_scales(k_pages, v_pages, k_scale, v_scale, "paged_attention")
    if (D not in HEAD_DIMS or Dc != D or Hq % Hkv or Hq // Hkv > MAX_GROUP
            or not 1 <= G <= MAX_TOKENS or page % 8 or not 8 <= page <= MAX_PAGE
            or v_pages.shape != k_pages.shape or table.dim() != 2
            or table.shape[0] != B or not 0 <= int(layer_index) < L):
        raise KernelError(f"paged_attention: unsupported shapes q "
                          f"{tuple(q.shape)} pool {tuple(k_pages.shape)} "
                          f"table {tuple(table.shape)}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()) \
            or k_pages.device != q.device or v_pages.device != q.device:
        raise KernelError("paged_attention: contiguous pools on q's device "
                          "required")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, table: torch.Tensor,
                    kv_len: torch.Tensor, layer_index: int,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q [B, G, Hq, D] -> [B, G, Hq, D] in q.dtype (see paged_plain)."""
    win, cap = window_cap(window, softcap, "paged_attention")
    if q.device.type == "cpu":
        return paged_plain(q, k_pages, v_pages, table, kv_len, layer_index,
                           q.shape[1], k_scale, v_scale, window, softcap)
    _check(q, k_pages, v_pages, table, layer_index, k_scale, v_scale)
    B, G, Hq, D = q.shape
    _, P, Hkv, page, _ = k_pages.shape
    gh, max_pages = Hq // Hkv, table.shape[1]
    R = G * gh
    # token-major rows per kv head: row r is token r // gh, head r % gh
    # of the group (a view for G == 1, one small copy for a verify)
    q4 = q.reshape(B, G, Hkv, gh, D).transpose(1, 2).reshape(B, Hkv, R, D)
    if q4.stride(-1) != 1 or any(s % 8 for s in q4.stride()[:-1]) \
            or q4.data_ptr() % 16:
        q4 = q4.contiguous()
    li = int(layer_index)
    kp, vp = k_pages[li], v_pages[li]
    ks = None if k_scale is None else k_scale[li].data_ptr()
    vs = None if v_scale is None else v_scale[li].data_ptr()
    table = table.to(device=q.device, dtype=torch.int32).contiguous()
    kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, Hkv, R, D), dtype=q.dtype, device=q.device)
    lib = _build.library()
    # the slice plan lives in C: it follows the pool's capacity and the
    # shapes, never kv_len's values, so nothing here waits on the device
    nws = lib.ti_paged_workspace(B, Hkv, R, max_pages * page, D)
    work = torch.empty((max(nws, 1),), dtype=torch.float32, device=q.device)
    strides = _build.longlongs(q4.stride(0), q4.stride(1), q4.stride(2))
    status = lib.ti_paged_attention(
        q4.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks, vs, out.data_ptr(),
        work.data_ptr(), _build.counters(q.device, B * Hkv).data_ptr(),
        table.data_ptr(), kv_len.data_ptr(), B, Hkv, R, gh, G, P, page,
        max_pages, D, KV_DTYPES[k_pages.dtype], strides, 1.0 / math.sqrt(D),
        win, cap, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "paged_attention")
    paged_attention.launches += 1
    return out.reshape(B, Hkv, G, gh, D).transpose(1, 2).reshape(B, G, Hq, D)


paged_attention.launches = 0
