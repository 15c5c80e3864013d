"""Kernel dispatch: the single switch point between the model and the
kernels, as turboinfer_tpu/kernels/dispatch.py is for the JAX package.

Each function hands its tensors to a kernel wrapper. The wrapper runs
the plain PyTorch version for tensors on the CPU, and for CUDA tensors
launches its Hopper kernel or raises on a shape the kernel does not
take; nothing falls back quietly. Every QTensor product on the card
goes through the kernel, whatever its size.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from turboinfer_tpu_torch.core.qtensor import QTensor


def qmatmul(x: torch.Tensor, qt: QTensor,
            layer_index: Optional[int] = None) -> torch.Tensor:
    from turboinfer_tpu_torch.kernels import qmm
    return qmm.qmm_int4(x, qt, layer_index if qt.stacked else None)


def attention_prefill(q, k, v, *, kv_len, q_start, layer_index=None):
    """q: [B, S, Hq, D]; k/v: [B, Hkv, T, D] views, or the stacked
    [L, B, Hkv, T, D] cache with `layer_index` (read in place)."""
    from turboinfer_tpu_torch.kernels import flash_attention
    if layer_index is not None:
        k, v = k[layer_index], v[layer_index]
    return flash_attention.flash_prefill(q, k, v, kv_len, q_start)


def attention_decode(q, k_cache, v_cache, kv_len, layer_index=None):
    """q: [B, Hq, D]; caches stacked [L, B, Hkv, T, D] with
    `layer_index`, or one layer [B, Hkv, T, D]."""
    from turboinfer_tpu_torch.kernels import decode_attention
    if layer_index is None:
        k_cache, v_cache, layer_index = k_cache[None], v_cache[None], 0
    return decode_attention.decode_attention(q, k_cache, v_cache, kv_len,
                                             layer_index)


def prepare_params(params: Any) -> Any:
    """One-time engine setup: fuse same-input projections (wq/wk/wv ->
    wqkv, w_gate/w_up -> w_gateup). Idempotent. The JAX package's scale
    pre-tiling is a TPU layout workaround with no counterpart here."""
    from turboinfer_tpu_torch.models.common import fuse_projections
    return fuse_projections(params)
