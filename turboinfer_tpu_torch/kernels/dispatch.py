"""Kernel dispatch: the single switch point between the model and the
kernels, as turboinfer_tpu/kernels/dispatch.py is for the JAX package.

Each function hands its tensors to a kernel wrapper. The wrapper runs
the plain PyTorch version for tensors on the CPU, and for CUDA tensors
launches its Hopper kernel or raises on a shape the kernel does not
take; nothing falls back quietly. Every QTensor product on the card
goes through a kernel (int4 or int8, symmetric or with zero points),
whatever its size: for routing, the JAX package's size threshold
(_QMM_MIN_BYTES) is a TPU workaround. Under TURBOINFER_QMM_A8=1 it also
decides which int4 products the JAX package runs with int8 activations,
so qmm.a8_applies keeps it there.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from turboinfer_tpu_torch.core.qtensor import QTensor


def qmatmul(x: torch.Tensor, qt: QTensor,
            layer_index: Optional[int] = None) -> torch.Tensor:
    """By qt.bits: int4 to qmm_int4, int8 to qmm_int8 (either with its
    zero points, when qt has them); any other width raises there. An
    int4 product that the JAX package runs as W4A8 (qmm.a8_applies:
    TURBOINFER_QMM_A8=1, M > 8, g % 256 == 0, ...) goes to qmm_int4_a8."""
    from turboinfer_tpu_torch.kernels import qmm
    li = layer_index if qt.stacked else None
    if qt.bits == 8:
        fn = qmm.qmm_int8
    elif qmm.a8_applies(x.numel() // max(x.shape[-1], 1), qt, li):
        fn = qmm.qmm_int4_a8
    else:
        fn = qmm.qmm_int4
    return fn(x, qt, li)


def qmatmul_grouped(x: torch.Tensor, qt: QTensor,
                    slots: torch.Tensor) -> torch.Tensor:
    """x: [G, ..., K]; slots: [G] device ids into the flat [L*E] stack of
    qt -> [G, ..., N], all G groups in one launch (by qt.bits, as
    qmatmul)."""
    from turboinfer_tpu_torch.kernels import qmm
    fn = qmm.qmm_int8_grouped if qt.bits == 8 else qmm.qmm_int4_grouped
    return fn(x, qt, slots)


def attention_prefill(q, k, v, *, kv_len, q_start, layer_index=None,
                      k_scale=None, v_scale=None, window=None, softcap=None,
                      alibi=None):
    """q: [B, S, Hq, D]; k/v: [B, Hkv, T, D] views, or the stacked
    [L, B, Hkv, T, D] cache with `layer_index` (read in place), int8
    with its scale planes k_scale/v_scale ([..., Hkv, T] f32) or fp8
    (uint8 e4m3 bits) too. window: a query at p sees keys > p - window;
    softcap: cap * tanh(s / cap) on the scaled scores. alibi: [Hq] f32
    slopes (Falcon-RW, BLOOM); the flash kernel carries no per-head
    score bias, as the JAX package's Pallas kernels do not, so such a
    call runs the torch reference attention (alibi_prefill), on the card
    too."""
    from turboinfer_tpu_torch.kernels import flash_attention
    if layer_index is not None:
        k, v = k[layer_index], v[layer_index]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer_index], v_scale[layer_index]
    if alibi is not None:
        return alibi_prefill(q, k, v, kv_len, q_start, k_scale, v_scale,
                             window, softcap, alibi)
    return flash_attention.flash_prefill(q, k, v, kv_len, q_start, k_scale,
                                         v_scale, window, softcap)


def alibi_prefill(q, k, v, kv_len, q_start, k_scale, v_scale, window,
                  softcap, alibi):
    """The JAX package's ALiBi prefill (dispatch.attention_prefill with
    alibi): K/V decoded to q.dtype, then ops.attention_prefill_ref."""
    from turboinfer_tpu_torch.kernels import ops
    from turboinfer_tpu_torch.models.common import decode_kv
    S = q.shape[1]
    positions = q_start[:, None] + torch.arange(S, device=q.device)[None, :]
    return ops.attention_prefill_ref(
        q, decode_kv(k, q.dtype, k_scale), decode_kv(v, q.dtype, v_scale),
        causal=True, positions=positions, kv_len=kv_len, window=window,
        softcap=softcap, alibi=alibi)


def attention_decode(q, k_cache, v_cache, kv_len, layer_index=None,
                     window=None, sinks=None, k_scale=None, v_scale=None,
                     softcap=None, alibi=None):
    """q: [B, Hq, D]; caches stacked [L, B, Hkv, T, D] with
    `layer_index`, or one layer [B, Hkv, T, D]. window: the last
    `window` keys only; sinks: [Hq] per-head sink logits; k_scale/
    v_scale: an int8 cache's scale planes ([..., Hkv, T] f32); softcap:
    cap * tanh(s / cap) on the scaled scores. alibi: [Hq] f32 slopes; as
    in attention_prefill, such a call runs the torch reference
    (ops.attention_decode_ref over the layer decoded to q.dtype, as the
    JAX package's jnp path)."""
    from turboinfer_tpu_torch.kernels import decode_attention
    if alibi is not None:
        from turboinfer_tpu_torch.kernels import ops
        from turboinfer_tpu_torch.models.common import decode_kv
        if layer_index is not None:
            k_cache, v_cache = k_cache[layer_index], v_cache[layer_index]
            if k_scale is not None:
                k_scale, v_scale = k_scale[layer_index], v_scale[layer_index]
        return ops.attention_decode_ref(
            q, decode_kv(k_cache, q.dtype, k_scale),
            decode_kv(v_cache, q.dtype, v_scale), kv_len, window=window,
            sinks=sinks, softcap=softcap, alibi=alibi)
    if layer_index is None:
        k_cache, v_cache, layer_index = k_cache[None], v_cache[None], 0
        if k_scale is not None:
            k_scale, v_scale = k_scale[None], v_scale[None]
    return decode_attention.decode_attention(q, k_cache, v_cache, kv_len,
                                             layer_index, window, sinks,
                                             k_scale, v_scale, softcap)


def attention_paged_decode(q, k_pages, v_pages, block_table, kv_len,
                           layer_index, k_scale=None, v_scale=None,
                           window=None, softcap=None):
    """q: [B, Hq, D]; pools stacked [L, P, Hkv, page, D] read at
    `layer_index` through block_table [B, max_pages] -> [B, Hq, D];
    k_scale/v_scale: an int8 pool's scale pages [L, P, Hkv, page];
    window and softcap as in attention_decode."""
    from turboinfer_tpu_torch.kernels import paged_attention
    return paged_attention.paged_attention(q[:, None], k_pages, v_pages,
                                           block_table, kv_len, layer_index,
                                           k_scale, v_scale, window,
                                           softcap)[:, 0]


def attention_paged_verify(q, k_pages, v_pages, block_table, kv_len,
                           layer_index, k_scale=None, v_scale=None,
                           window=None, softcap=None):
    """q: [B, G, Hq, D], the G chunk tokens already in their pages and
    counted in kv_len (query g at kv_len - G + g) -> [B, G, Hq, D];
    window and softcap as in attention_prefill."""
    from turboinfer_tpu_torch.kernels import paged_attention
    return paged_attention.paged_attention(q, k_pages, v_pages, block_table,
                                           kv_len, layer_index, k_scale,
                                           v_scale, window, softcap)


def prepare_params(params: Any) -> Any:
    """One-time engine setup: view 4-D expert QTensors [L, E, ...] as the
    flat [L*E] stack the kernels index (what qmm.prepare_scales does in
    the JAX package, without its TPU scale tiling), cast the sink logits
    to the f32 the decode kernel reads and LoRA adapter slots ("lora_*",
    which models/llama.add_lora multiplies in f32) to f32 once, then fuse
    same-input projections (wq/wk/wv -> wqkv, w_gate/w_up -> w_gateup,
    we_gate/we_up -> we_gateup); the adapter slots stay unfused, their
    updates added after the fused product's split. Idempotent."""
    from turboinfer_tpu_torch.models.common import fuse_projections
    if isinstance(params, dict) and isinstance(params.get("layers"), dict):
        params = {**params, "layers": {
            k: v.flat() if isinstance(v, QTensor)
            else v.to(torch.float32).contiguous()
            if k == "sinks" or k.startswith("lora_") else v
            for k, v in params["layers"].items()}}
    return fuse_projections(params)
