"""Causal GQA prefill attention: the wrapper of the wgmma/TMA kernel in
csrc/flash_prefill.cuh (entry ti_flash_prefill in csrc/flash_prefill.cu).

Counterpart of turboinfer_tpu/kernels/pallas/flash_attention.py
prefill_pallas and _prefill_stacked. K/V are any [B, Hkv, T, D] view:
the fresh prefill passes the just-computed [B, S, Hkv, D] K/V transposed
by strides, a stacked-cache read passes layer li of the cache; neither
is copied. A cache read may be int8 with its f32 scale planes
k_scale/v_scale [B, Hkv, T] (layer li of [L, B, Hkv, T]) or fp8 (uint8
e4m3 bits); the kernel decodes each K/V tile to bf16 in shared memory.
Optionally a query at position p sees only the keys > p - `window`
(Mistral, Gemma-2's local layers), and the scores are soft-capped to
`softcap` * tanh(s / softcap) before the mask (Gemma-2). On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs prefill_plain.
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


def prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_len: torch.Tensor, q_start: torch.Tensor,
                  k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version. q: [B, S, Hq, D]; k/v: [B, Hkv, T, D],
    decoded to f32 values first (models/common.decode_kv: int8 codes
    times their scales, as the kernel's f32 scores take them, not
    rounded to q.dtype), all in f32, out in q.dtype; query s of sequence
    b at position q_start[b] + s."""
    from turboinfer_tpu_torch.models.common import decode_kv
    S = q.shape[1]
    positions = q_start[:, None] + torch.arange(S, device=q.device)[None, :]
    f32 = torch.float32
    return ops.attention_prefill_ref(
        q.to(f32), decode_kv(k, f32, k_scale), decode_kv(v, f32, v_scale),
        causal=True, positions=positions, kv_len=kv_len, window=window,
        softcap=softcap).to(q.dtype)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_len: torch.Tensor, q_start: torch.Tensor,
                  k_scale: Optional[torch.Tensor] = None,
                  v_scale: Optional[torch.Tensor] = None,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """Causal attention -> [B, S, Hq, D] in q.dtype (see prefill_plain)."""
    win, cap = window_cap(window, softcap, "flash_prefill")
    if q.device.type == "cpu":
        return prefill_plain(q, k, v, kv_len, q_start, k_scale, v_scale,
                             window, softcap)
    B, S, Hq, D = q.shape
    _, Hkv, T, _ = k.shape
    if q.dtype != torch.bfloat16 or k.dtype not in KV_DTYPES \
            or v.dtype != k.dtype:
        raise KernelError(f"flash_prefill takes bf16 q and bf16, int8 or fp8 "
                          f"(uint8) k/v, got {q.dtype}, {k.dtype}, {v.dtype}")
    check_scales(k, v, k_scale, v_scale, "flash_prefill")
    int8 = k_scale is not None
    if D not in HEAD_DIMS:
        raise KernelError(f"flash_prefill: head dim {D} has no kernel "
                          f"instance (head dims {HEAD_DIMS})")
    if Hq % Hkv or k.shape != v.shape \
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
    # a lone kv head's stride is free: take it past the positions for K
    # and V alike, so one layout reads both (the kernel takes the head or
    # the position axis as the outer one by comparing the two strides)
    ks_h, vs_h = ((k.stride(2) * T, v.stride(2) * T) if Hkv == 1
                  else (k.stride(1), v.stride(1)))
    strides = _build.longlongs(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), ks_h, k.stride(2),
        v.stride(0), vs_h, v.stride(2),
        o.stride(0), o.stride(1), o.stride(2),
        *(k_scale.stride()[:2] if int8 else (0, 0)))
    lib = _build.library()
    status = lib.ti_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if int8 else None,
        v_scale.data_ptr() if int8 else None, o.data_ptr(),
        kv_len.data_ptr(), q_start.data_ptr(), B, S, Hq, Hkv, T, D,
        KV_DTYPES[k.dtype], strides, 1.0 / math.sqrt(D), win, cap,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "flash_prefill")
    flash_prefill.launches += 1
    return o


flash_prefill.launches = 0
