"""Model-level quantizer (counterpart of turboinfer_tpu/quant/quantizer.py
quantize_params): int4/int8 of every llama or MoE matmul weight,
group-wise along K, symmetric (absmax or "mse" scales) or asymmetric
(with zero points), byte-identical to the JAX package's.
MoE expert weights [L, E, K, N] become 4-D QTensors; the router stays
fp, and so do GPT-OSS's biased experts (marked by a "be_gate" slot),
as in the JAX package. Unless skip_embeddings, lm_head quantizes like
any matmul and the embedding table to per-row int8 (QEmbed)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from turboinfer_tpu_torch.config import QuantizationConfig, QuantType
from turboinfer_tpu_torch.core.qtensor import (QEmbed, QTensor, quantize,
                                               quantize_embed)

# Per-layer [L, K, N] matmul slots; a MoE layer holds only the first
# four (its experts are the 4-D slots below, its router stays fp).
_LAYER_MATMULS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_MOE_EXPERT_SLOTS = ("we_gate", "we_up", "we_down")


def _quantize_stacked(w: torch.Tensor, cfg: QuantizationConfig) -> QTensor:
    qts = [quantize(w[i], cfg.type, group_size=cfg.group_size,
                    symmetric=cfg.symmetric, scale_method=cfg.scale_method)
           for i in range(w.shape[0])]
    zp = (None if qts[0].zero_points is None
          else torch.stack([q.zero_points for q in qts]))
    return QTensor(data=torch.stack([q.data for q in qts]),
                   scales=torch.stack([q.scales for q in qts]),
                   zero_points=zp, bits=qts[0].bits,
                   group_size=qts[0].group_size, shape=qts[0].shape)


def _quantize_experts(w: torch.Tensor, cfg: QuantizationConfig) -> QTensor:
    """[L, E, K, N] -> a 4-D QTensor (data [L, E, K(/2), N], scales and
    zero points [L, E, K/g, N]), expert by expert."""
    L, E = w.shape[:2]
    qt = _quantize_stacked(w.reshape((L * E,) + tuple(w.shape[2:])), cfg)

    def unflat(a):
        return None if a is None else a.reshape((L, E) + tuple(a.shape[1:]))
    return QTensor(data=unflat(qt.data), scales=unflat(qt.scales),
                   zero_points=unflat(qt.zero_points), bits=qt.bits,
                   group_size=qt.group_size, shape=qt.shape)


def quantize_params(params: Dict[str, Any], cfg: QuantizationConfig
                    ) -> Dict[str, Any]:
    if cfg.type == QuantType.NONE:
        return params
    if cfg.type == QuantType.FLOAT16:
        raise NotImplementedError("FLOAT16 quantization is not ported yet")
    out = {k: v for k, v in params.items() if k not in ("layers", "lm_head")}
    layers = dict(params["layers"])
    for name in _LAYER_MATMULS:
        w = layers.get(name)
        if isinstance(w, torch.Tensor) and w.dim() == 3:
            layers[name] = _quantize_stacked(w, cfg)
    for name in _MOE_EXPERT_SLOTS if "be_gate" not in layers else ():
        w = layers.get(name)
        if isinstance(w, torch.Tensor) and w.dim() == 4:
            layers[name] = _quantize_experts(w, cfg)
    out["layers"] = layers
    head = params["lm_head"]
    if cfg.skip_embeddings or isinstance(head, QTensor) or head.dim() != 2:
        out["lm_head"] = head
    else:
        out["lm_head"] = quantize(head, cfg.type, group_size=cfg.group_size,
                                  symmetric=cfg.symmetric,
                                  scale_method=cfg.scale_method)
    emb = out.get("embed")
    if (not cfg.skip_embeddings and isinstance(emb, torch.Tensor)
            and emb.dim() == 2):
        out["embed"] = quantize_embed(emb)
    return out
