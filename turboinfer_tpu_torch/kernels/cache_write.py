"""KV cache writers: the wrappers of csrc/cache_write.cu.

cache_write_fresh: counterpart of turboinfer_tpu/kernels/pallas/
cache_write.py cache_write_fresh, fused with the [B, S, Hkv, D] ->
[B, Hkv, S, D] transpose the JAX model does before calling it. Writes K
and V of a cold prefill into layer `layer_index` of the stacked
head-major model-dtype cache at T offset 0, in place (the port updates
the cache buffers in place where JAX returns new arrays).

kv_encode_write: every write into an int8 or fp8 cache or page pool,
fused with the encode of models/common.encode_kv_scaled (the JAX model
encodes, then writes with dynamic_update_slice): token n, head h lands in
row rows[n] + layer_off + h * head_stride of the storage viewed as
[rows, D], its int8 scale at the same index of the [rows] scale plane.
The kernel reads each K/V row as 16-byte vectors (D / 8 lanes a row),
takes the int8 quotient x / scale from x * (1 / scale) and two FMA
corrections instead of a division, and converts fp8 with the hardware's
saturating e4m3 conversion before masking in the NaN codes; its bytes
and scales equal the plain version's bit for bit (the argument is in
csrc/cache_write.cu). It needs 16-byte aligned K/V rows and caches (the
C entry checks the pointers and strides), and raises on others.

On CUDA tensors each wrapper launches its kernel or raises; on CPU
tensors it runs its plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from turboinfer_tpu_torch.kernels import _build
from turboinfer_tpu_torch.utils.errors import KernelError

HEAD_DIMS = (32, 64, 96, 128, 256)
MISALIGNED = -1    # ti_kv_encode_write's refusal (checked in C: no host cost)


def cache_write_plain(k_cache: torch.Tensor, v_cache: torch.Tensor,
                      k_new: torch.Tensor, v_new: torch.Tensor,
                      layer_index: int) -> None:
    """Plain PyTorch version. caches: [L, B, Hkv, T, D];
    k_new/v_new: [B, S, Hkv, D]."""
    S = k_new.shape[1]
    k_cache[layer_index, :, :, :S].copy_(k_new.transpose(1, 2))
    v_cache[layer_index, :, :, :S].copy_(v_new.transpose(1, 2))


def cache_write_fresh(k_cache: torch.Tensor, v_cache: torch.Tensor,
                      k_new: torch.Tensor, v_new: torch.Tensor,
                      layer_index: int) -> None:
    """Write k_new/v_new [B, S, Hkv, D] into k/v_cache[layer_index, :, :,
    :S] ([L, B, Hkv, T, D]) in place."""
    if k_cache.device.type == "cpu":
        cache_write_plain(k_cache, v_cache, k_new, v_new, layer_index)
        return
    L, B, Hkv, T, D = k_cache.shape
    S = k_new.shape[1]
    if (k_new.shape != (B, S, Hkv, D) or v_new.shape != k_new.shape
            or v_cache.shape != k_cache.shape or S > T
            or not 0 <= int(layer_index) < L):
        raise KernelError(f"cache_write_fresh: shapes cache "
                          f"{tuple(k_cache.shape)} new {tuple(k_new.shape)} "
                          f"layer {layer_index}")
    esize = k_cache.element_size()
    row_bytes = D * esize
    for t in (k_new, v_new):
        if (t.dtype != k_cache.dtype or t.device != k_cache.device
                or t.stride(-1) != 1
                or any((s * esize) % 16 for s in t.stride()[:-1])
                or t.data_ptr() % 16):
            raise KernelError("cache_write_fresh: new K/V must match the "
                              "cache dtype and device with 16-byte aligned "
                              "contiguous rows")
    if row_bytes % 16 or not (k_cache.is_contiguous()
                              and v_cache.is_contiguous()) \
            or v_cache.dtype != k_cache.dtype:
        raise KernelError("cache_write_fresh: caches must be contiguous "
                          "with 16-byte rows")
    kc, vc = k_cache[int(layer_index)], v_cache[int(layer_index)]
    strides = _build.longlongs(*(s * esize for s in k_new.stride()[:3]),
                               *(s * esize for s in v_new.stride()[:3]))
    lib = _build.library()
    status = lib.ti_cache_write_fresh(
        k_new.data_ptr(), v_new.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        B, S, Hkv, T, row_bytes, strides,
        torch.cuda.current_stream(k_cache.device).cuda_stream)
    _build.check(status, "cache_write_fresh")
    cache_write_fresh.launches += 1


cache_write_fresh.launches = 0


def kv_encode_write_plain(k_new: torch.Tensor, v_new: torch.Tensor,
                          k_cache: torch.Tensor, v_cache: torch.Tensor,
                          k_scale: Optional[torch.Tensor],
                          v_scale: Optional[torch.Tensor], rows: torch.Tensor,
                          layer_off: int, head_stride: int) -> None:
    """Plain PyTorch version: encode_kv_scaled plus an indexed assignment.
    k_new/v_new: [N, Hkv, D]; caches: int8 or uint8 storage of any shape
    whose trailing dim is D; scales: f32 planes of the caches' leading
    shape (int8) or None; rows: [N] int64 (< 0: skip)."""
    from turboinfer_tpu_torch.models.common import encode_kv_scaled
    N, Hkv, D = k_new.shape
    live = rows >= 0
    r = (rows[live][:, None] + int(layer_off) + int(head_stride)
         * torch.arange(Hkv, device=rows.device)[None, :])     # [n, Hkv]
    for new, cache, scale in ((k_new, k_cache, k_scale),
                              (v_new, v_cache, v_scale)):
        code, s = encode_kv_scaled(new[live.to(new.device)], cache.dtype)
        cache.view(-1, D)[r] = code
        if s is not None:
            scale.view(-1)[r] = s


def kv_encode_write(k_new: torch.Tensor, v_new: torch.Tensor,
                    k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_scale: Optional[torch.Tensor],
                    v_scale: Optional[torch.Tensor], rows: torch.Tensor,
                    layer_off: int, head_stride: int) -> None:
    """Encode k_new/v_new [N, Hkv, D] into an int8 (with k_scale/v_scale)
    or fp8 (uint8 e4m3 bits, no scales) cache in place; see
    kv_encode_write_plain for the addressing."""
    if k_cache.device.type == "cpu":
        kv_encode_write_plain(k_new, v_new, k_cache, v_cache, k_scale,
                              v_scale, rows, layer_off, head_stride)
        return
    N, Hkv, D = k_new.shape
    fp8 = k_cache.dtype == torch.uint8
    if k_cache.dtype not in (torch.int8, torch.uint8) \
            or v_cache.dtype != k_cache.dtype \
            or (k_scale is None) != fp8 or (v_scale is None) != fp8:
        raise KernelError(f"kv_encode_write takes an int8 cache with f32 "
                          f"scale planes or an fp8 (uint8) cache without, "
                          f"got {k_cache.dtype}, scales "
                          f"{None if k_scale is None else k_scale.dtype}")
    if D not in HEAD_DIMS or v_new.shape != k_new.shape \
            or k_cache.shape[-1] != D or v_cache.shape != k_cache.shape \
            or rows.shape != (N,) or rows.dtype != torch.int64:
        raise KernelError(f"kv_encode_write: shapes new {tuple(k_new.shape)} "
                          f"cache {tuple(k_cache.shape)} rows "
                          f"{tuple(rows.shape)} {rows.dtype}")
    dev = k_cache.device
    for t in (k_new, v_new):
        if t.dtype != torch.bfloat16 or t.device != dev or t.stride(-1) != 1:
            raise KernelError("kv_encode_write: new K/V must be bf16 on the "
                              "cache's device with contiguous D rows")
    tensors = [k_cache, v_cache, rows] + ([] if fp8 else [k_scale, v_scale])
    if any(t.device != dev or not t.is_contiguous() for t in tensors) or (
            not fp8 and (k_scale.dtype != torch.float32
                         or v_scale.dtype != torch.float32
                         or k_scale.shape != k_cache.shape[:-1]
                         or v_scale.shape != k_scale.shape)):
        raise KernelError("kv_encode_write: contiguous caches, f32 scale "
                          "planes of the cache's leading shape and int64 "
                          "rows on one device required")
    strides = _build.longlongs(k_new.stride(0), k_new.stride(1),
                               v_new.stride(0), v_new.stride(1))
    lib = _build.library()
    status = lib.ti_kv_encode_write(
        k_new.data_ptr(), v_new.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), None if fp8 else k_scale.data_ptr(),
        None if fp8 else v_scale.data_ptr(), rows.data_ptr(), N, Hkv, D,
        int(fp8), int(layer_off), int(head_stride), strides,
        torch.cuda.current_stream(dev).cuda_stream)
    if status == MISALIGNED:
        raise KernelError(f"kv_encode_write: K/V rows and caches must be "
                          f"16-byte aligned (K/V strides {k_new.stride()}, "
                          f"{v_new.stride()})")
    _build.check(status, "kv_encode_write")
    kv_encode_write.launches += 1


kv_encode_write.launches = 0
