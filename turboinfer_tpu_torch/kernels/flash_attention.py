"""Causal GQA prefill attention: the wrapper of the wgmma/TMA kernel in
csrc/flash_prefill.cuh (entry ti_flash_prefill in csrc/flash_prefill.cu).

Counterpart of turboinfer_tpu/kernels/pallas/flash_attention.py
prefill_pallas and _prefill_stacked. K/V are any [B, Hkv, T, D] view:
the fresh prefill passes the just-computed [B, S, Hkv, D] K/V transposed
by strides, a stacked-cache read passes layer li of the cache; neither
is copied. A cache read may be int8 with its f32 scale planes
k_scale/v_scale [B, Hkv, T] (layer li of [L, B, Hkv, T]) or fp8 (uint8
e4m3 bits); the kernel decodes each K/V tile to bf16 in shared memory.
On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs prefill_plain.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from turboinfer_tpu_torch.kernels import _build, ops
from turboinfer_tpu_torch.kernels.decode_attention import (KV_DTYPES,
                                                           check_scales)
from turboinfer_tpu_torch.utils.errors import KernelError

HEAD_DIMS = (32, 64, 128)


def prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_len: torch.Tensor, q_start: torch.Tensor,
                  k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version. q: [B, S, Hq, D]; k/v: [B, Hkv, T, D],
    decoded to q.dtype first (models/common.decode_kv); query s of
    sequence b at position q_start[b] + s."""
    from turboinfer_tpu_torch.models.common import decode_kv
    S = q.shape[1]
    positions = q_start[:, None] + torch.arange(S, device=q.device)[None, :]
    return ops.attention_prefill_ref(q, decode_kv(k, q.dtype, k_scale),
                                     decode_kv(v, q.dtype, v_scale),
                                     causal=True, positions=positions,
                                     kv_len=kv_len)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_len: torch.Tensor, q_start: torch.Tensor,
                  k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal attention -> [B, S, Hq, D] in q.dtype (see prefill_plain)."""
    if q.device.type == "cpu":
        return prefill_plain(q, k, v, kv_len, q_start, k_scale, v_scale)
    B, S, Hq, D = q.shape
    _, Hkv, T, _ = k.shape
    if q.dtype != torch.bfloat16 or k.dtype not in KV_DTYPES \
            or v.dtype != k.dtype:
        raise KernelError(f"flash_prefill takes bf16 q and bf16, int8 or fp8 "
                          f"(uint8) k/v, got {q.dtype}, {k.dtype}, {v.dtype}")
    check_scales(k, v, k_scale, v_scale, "flash_prefill")
    int8 = k_scale is not None
    if D not in HEAD_DIMS or Hq % Hkv or k.shape != v.shape \
            or k.shape[0] != B or k.shape[3] != D:
        raise KernelError(f"flash_prefill: unsupported shapes q "
                          f"{tuple(q.shape)} k {tuple(k.shape)} "
                          f"v {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        align = 16 // t.element_size()     # 16-byte vectors
        if t.stride(-1) != 1 or any(s % align for s in t.stride()[:-1]) \
                or t.data_ptr() % 16 or t.device != q.device:
            raise KernelError(f"flash_prefill: {name} needs a contiguous, "
                              "16-byte aligned head dim on q's device")
    kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    q_start = q_start.to(device=q.device, dtype=torch.int32).contiguous()
    o = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    strides = _build.longlongs(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        o.stride(0), o.stride(1), o.stride(2),
        *(k_scale.stride()[:2] if int8 else (0, 0)))
    lib = _build.library()
    status = lib.ti_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if int8 else None,
        v_scale.data_ptr() if int8 else None, o.data_ptr(),
        kv_len.data_ptr(), q_start.data_ptr(), B, S, Hq, Hkv, T, D,
        KV_DTYPES[k.dtype], strides, 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "flash_prefill")
    flash_prefill.launches += 1
    return o


flash_prefill.launches = 0
