"""Model-level quantizer (counterpart of turboinfer_tpu/quant/quantizer.py
quantize_params): symmetric absmax int4/int8 of every llama matmul
weight, group-wise along K, byte-identical to the JAX package's. Unless
skip_embeddings, lm_head quantizes like any matmul and the embedding
table to per-row int8 (QEmbed)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from turboinfer_tpu_torch.config import QuantizationConfig, QuantType
from turboinfer_tpu_torch.core.qtensor import (QEmbed, QTensor, quantize,
                                               quantize_embed)

_LAYER_MATMULS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _quantize_stacked(w: torch.Tensor, cfg: QuantizationConfig) -> QTensor:
    qts = [quantize(w[i], cfg.type, group_size=cfg.group_size,
                    symmetric=cfg.symmetric, scale_method=cfg.scale_method)
           for i in range(w.shape[0])]
    return QTensor(data=torch.stack([q.data for q in qts]),
                   scales=torch.stack([q.scales for q in qts]),
                   zero_points=None, bits=qts[0].bits,
                   group_size=qts[0].group_size, shape=qts[0].shape)


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
