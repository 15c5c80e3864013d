"""Fresh-prefill KV cache writer: the wrapper of csrc/cache_write.cu.

Counterpart of turboinfer_tpu/kernels/pallas/cache_write.py
cache_write_fresh, fused with the [B, S, Hkv, D] -> [B, Hkv, S, D]
transpose the JAX model does before calling it. Writes K and V of a
cold prefill into layer `layer_index` of the stacked head-major cache at
T offset 0, in place (the port updates the cache buffers in place where
JAX returns new arrays). On CUDA tensors it launches the kernel or
raises; on CPU tensors it runs cache_write_plain.
"""

from __future__ import annotations

import torch

from turboinfer_tpu_torch.kernels import _build
from turboinfer_tpu_torch.utils.errors import KernelError


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
