"""Causal GQA prefill attention: the wrapper of csrc/flash_prefill.cu.

Counterpart of turboinfer_tpu/kernels/pallas/flash_attention.py
prefill_pallas (and the model-dtype read of _prefill_stacked). K/V are
any [B, Hkv, T, D] view: the fresh prefill passes the just-computed
[B, S, Hkv, D] K/V transposed by strides, a stacked-cache read passes
layer li of the cache; neither is copied. On a CUDA tensor the wrapper
launches the kernel or raises; on a CPU tensor it runs prefill_plain.
"""

from __future__ import annotations

import math

import torch

from turboinfer_tpu_torch.kernels import _build, ops
from turboinfer_tpu_torch.utils.errors import KernelError

HEAD_DIMS = (32, 64, 128)


def prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_len: torch.Tensor, q_start: torch.Tensor
                  ) -> torch.Tensor:
    """Plain PyTorch version. q: [B, S, Hq, D]; k/v: [B, Hkv, T, D];
    query s of sequence b at position q_start[b] + s."""
    S = q.shape[1]
    positions = q_start[:, None] + torch.arange(S, device=q.device)[None, :]
    return ops.attention_prefill_ref(q, k, v, causal=True,
                                     positions=positions, kv_len=kv_len)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_len: torch.Tensor, q_start: torch.Tensor
                  ) -> torch.Tensor:
    """Causal attention -> [B, S, Hq, D] in q.dtype (see prefill_plain)."""
    if q.device.type == "cpu":
        return prefill_plain(q, k, v, kv_len, q_start)
    B, S, Hq, D = q.shape
    _, Hkv, T, _ = k.shape
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise KernelError(f"flash_prefill takes bf16 q/k/v, got {q.dtype}, "
                          f"{k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS or Hq % Hkv or k.shape != v.shape \
            or k.shape[0] != B or k.shape[3] != D:
        raise KernelError(f"flash_prefill: unsupported shapes q "
                          f"{tuple(q.shape)} k {tuple(k.shape)} "
                          f"v {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) \
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
        o.stride(0), o.stride(1), o.stride(2))
    lib = _build.library()
    status = lib.ti_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        kv_len.data_ptr(), q_start.data_ptr(), B, S, Hq, Hkv, T, D, strides,
        1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "flash_prefill")
    flash_prefill.launches += 1
    return o


flash_prefill.launches = 0
