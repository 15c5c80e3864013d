"""Single-query decode attention: the wrapper of csrc/decode_attention.cu.

Counterpart of turboinfer_tpu/kernels/pallas/decode_attention.py
decode_pallas and decode_fused_pallas for a model-dtype cache: q
[B, Hq, D] attends the first kv_len[b] rows (clamped to [1, T], as the
JAX kernel clamps to >= 1) of layer `layer_index` of the stacked
head-major cache [L, B, Hkv, T, D], read through a pointer offset;
optionally only the last `window` of them, and with per-head f32 sink
logits `sinks` [Hq] (GPT-OSS). On CUDA tensors it launches the kernel or
raises; on CPU tensors it runs decode_plain.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from turboinfer_tpu_torch.kernels import _build, ops
from turboinfer_tpu_torch.utils.errors import KernelError

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8        # query heads per kv head one block computes


def decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, kv_len: torch.Tensor,
                 layer_index: int, window: Optional[int] = None,
                 sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version over layer `layer_index` of the stack."""
    T = k_cache.shape[3]
    kv = kv_len.clamp(1, T)
    return ops.attention_decode_ref(q, k_cache[layer_index],
                                    v_cache[layer_index], kv, window=window,
                                    sinks=sinks)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor,
                     layer_index: int, window: Optional[int] = None,
                     sinks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-> [B, Hq, D] in q.dtype (see decode_plain)."""
    if window is not None and int(window) < 1:
        raise ValueError(f"decode_attention: window must be >= 1, got "
                         f"{window}")
    if q.device.type == "cpu":
        return decode_plain(q, k_cache, v_cache, kv_len, layer_index, window,
                            sinks)
    B, Hq, D = q.shape
    L, Bc, Hkv, T, Dc = k_cache.shape
    if q.dtype != torch.bfloat16 or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise KernelError(f"decode_attention takes a bf16 query and cache, "
                          f"got {q.dtype}, {k_cache.dtype}")
    if (D not in HEAD_DIMS or Dc != D or Bc != B or Hq % Hkv
            or Hq // Hkv > MAX_GROUP or v_cache.shape != k_cache.shape
            or not 0 <= int(layer_index) < L):
        raise KernelError(f"decode_attention: unsupported shapes q "
                          f"{tuple(q.shape)} cache {tuple(k_cache.shape)}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()) \
            or q.stride(-1) != 1 or any(s % 8 for s in q.stride()[:-1]) \
            or q.data_ptr() % 16 or k_cache.device != q.device:
        raise KernelError("decode_attention: contiguous caches and a "
                          "16-byte aligned query on one device required")
    if sinks is not None and (tuple(sinks.shape) != (Hq,)
                              or sinks.dtype != torch.float32
                              or not sinks.is_contiguous()
                              or sinks.device != q.device):
        raise KernelError(f"decode_attention: sinks must be contiguous f32 "
                          f"[{Hq}] on {q.device} (dispatch.prepare_params "
                          f"casts them once), got {sinks.dtype} "
                          f"{tuple(sinks.shape)} on {sinks.device}")
    kc, vc = k_cache[int(layer_index)], v_cache[int(layer_index)]
    kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    lib = _build.library()
    work = torch.empty((lib.ti_decode_workspace(B, Hq, T, D),),
                       dtype=torch.float32, device=q.device)
    strides = _build.longlongs(q.stride(0), q.stride(1), kc.stride(0),
                               kc.stride(1))
    status = lib.ti_decode_attention(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(),
        work.data_ptr(), kv_len.data_ptr(),
        None if sinks is None else sinks.data_ptr(), B, Hq, Hkv, T, D,
        0 if window is None else int(window), strides, 1.0 / math.sqrt(D),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
