"""Single-query decode attention: the wrapper of csrc/decode_attention.cu.

Counterpart of turboinfer_tpu/kernels/pallas/decode_attention.py
decode_pallas and decode_fused_pallas: q [B, Hq, D] attends the first
kv_len[b] rows (clamped to [1, T], as the JAX kernel clamps to >= 1) of
layer `layer_index` of the stacked head-major cache [L, B, Hkv, T, D],
read through a pointer offset; optionally only the last `window` of
them, with per-head f32 sink logits `sinks` [Hq] (GPT-OSS), and with
the scores soft-capped to `softcap` * tanh(s / softcap) (Gemma-2). The
cache is bf16, int8 with its f32 scale planes k_scale/v_scale
[L, B, Hkv, T], or fp8 (uint8 e4m3 bits); the kernel reads the
compressed rows in place. On CUDA tensors it launches the kernel or
raises; on CPU tensors it runs decode_plain.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from turboinfer_tpu_torch.kernels import _build, ops
from turboinfer_tpu_torch.utils.errors import KernelError

HEAD_DIMS = (32, 64, 96, 128, 256)
MAX_GROUP = 8        # query heads per kv head one block computes
# cache storage dtype -> the kernel's element-type code
KV_DTYPES = {torch.bfloat16: 0, torch.int8: 1, torch.uint8: 2}


def check_scales(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_scale: Optional[torch.Tensor],
                 v_scale: Optional[torch.Tensor], name: str) -> None:
    """An int8 cache needs both f32 scale planes of its leading shape, on
    its device and contiguous, and any other cache none (decode_pallas
    returns None on a mismatch)."""
    int8 = k_cache.dtype == torch.int8
    if (k_scale is None) == int8 or (v_scale is None) == int8:
        raise KernelError(f"{name}: an int8 cache takes k_scale and v_scale "
                          f"and another cache none, got {k_cache.dtype} with "
                          f"scales {k_scale is not None}/{v_scale is not None}")
    if int8 and any(s.dtype != torch.float32 or s.shape != k_cache.shape[:-1]
                    or not s.is_contiguous() or s.device != k_cache.device
                    for s in (k_scale, v_scale)):
        raise KernelError(f"{name}: scales must be contiguous f32 "
                          f"{tuple(k_cache.shape[:-1])} on the cache's device")


def window_cap(window: Optional[int], softcap: Optional[float],
               name: str):
    """The C form of a window and a softcap: (window, or 0 for none;
    softcap, or 0.0 for none); raises ValueError on window < 1 or
    softcap <= 0."""
    if window is not None and int(window) < 1:
        raise ValueError(f"{name}: window must be >= 1, got {window}")
    if softcap is not None and not float(softcap) > 0.0:
        raise ValueError(f"{name}: softcap must be > 0, got {softcap}")
    return (0 if window is None else int(window),
            0.0 if softcap is None else float(softcap))


def decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, kv_len: torch.Tensor,
                 layer_index: int, window: Optional[int] = None,
                 sinks: Optional[torch.Tensor] = None,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None,
                 softcap: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version over layer `layer_index` of the stack: the
    layer decoded to f32 values (models/common.decode_kv: int8 codes
    times their scales, not rounded to q.dtype, as the kernel takes
    them), then the reference attention in f32, out in q.dtype."""
    from turboinfer_tpu_torch.models.common import decode_kv
    T = k_cache.shape[3]
    kv = kv_len.clamp(1, T)
    li, f32 = layer_index, torch.float32
    k = decode_kv(k_cache[li], f32, None if k_scale is None else k_scale[li])
    v = decode_kv(v_cache[li], f32, None if v_scale is None else v_scale[li])
    return ops.attention_decode_ref(q.to(f32), k, v, kv, window=window,
                                    sinks=sinks, softcap=softcap).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor,
                     layer_index: int, window: Optional[int] = None,
                     sinks: Optional[torch.Tensor] = None,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """-> [B, Hq, D] in q.dtype (see decode_plain)."""
    win, cap = window_cap(window, softcap, "decode_attention")
    if q.device.type == "cpu":
        return decode_plain(q, k_cache, v_cache, kv_len, layer_index, window,
                            sinks, k_scale, v_scale, softcap)
    B, Hq, D = q.shape
    L, Bc, Hkv, T, Dc = k_cache.shape
    if q.dtype != torch.bfloat16 or k_cache.dtype not in KV_DTYPES \
            or v_cache.dtype != k_cache.dtype:
        raise KernelError(f"decode_attention takes a bf16 query and a bf16, "
                          f"int8 or fp8 (uint8) cache, got {q.dtype}, "
                          f"{k_cache.dtype}, {v_cache.dtype}")
    check_scales(k_cache, v_cache, k_scale, v_scale, "decode_attention")
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
    li = int(layer_index)
    kc, vc = k_cache[li], v_cache[li]
    ks = None if k_scale is None else k_scale[li].data_ptr()
    vs = None if v_scale is None else v_scale[li].data_ptr()
    kv_len = kv_len.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    lib = _build.library()
    nws = lib.ti_decode_workspace(B, Hq, Hkv, T, D, win)
    work = torch.empty((max(nws, 1),), dtype=torch.float32, device=q.device)
    strides = _build.longlongs(q.stride(0), q.stride(1), kc.stride(0),
                               kc.stride(1))
    status = lib.ti_decode_attention(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), ks, vs, out.data_ptr(),
        work.data_ptr(), _build.counters(q.device, B * Hkv).data_ptr(),
        kv_len.data_ptr(), None if sinks is None else sinks.data_ptr(), B,
        Hq, Hkv, T, D, KV_DTYPES[k_cache.dtype], win, strides,
        1.0 / math.sqrt(D), cap,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
