"""Activation-calibrated quantization: the counterpart of
turboinfer_tpu/quant/calibrate.py.

1. Run the fp model over calibration sequences (the llama family's
   forward_no_cache on the params' device) with a tap on
   kernels/ops.qmatmul (ops.qmm_tap).
2. At every quantized matmul, accumulate per-input-channel second
   moments E[x_k^2] of the activations entering that weight.
3. Quantize with the per-group scale search weighted by those moments
   (core/qtensor._mse_scale(moments=...)): the objective becomes the
   diagonal approximation of the layer output error
   ||x @ W - x @ W_hat||^2, so channels the model drives hard stay
   faithful and dead channels absorb the clipping.

Scope, as in the JAX package: the llama family (wq/wk/wv/wo/w_gate/
w_up/w_down + lm_head); a family without separate (or fused) q/k/v
slots (GPT-2, the NeoX family, DeepSeek's MLA projections) falls back
to uncalibrated quantization with a warning, so its result is
quantize_params' bytes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from turboinfer_tpu_torch.config import ModelConfig, QuantizationConfig
from turboinfer_tpu_torch.core.qtensor import QTensor
from turboinfer_tpu_torch.kernels import ops
from turboinfer_tpu_torch.quant.quantizer import _device_of, quantize_params
from turboinfer_tpu_torch.utils import logging as tlog
from turboinfer_tpu_torch.utils.errors import QuantizationError

# Slots whose input activations are collected (the llama-family
# quantizable matmuls, quant/quantizer._ARCH_MATMULS' "llama").
_LLAMA_SLOTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


class _MomentAccumulator:
    """Per-key running f32 sum of squared activations + row count, on the
    activations' device."""

    def __init__(self):
        self.sq: Dict[Any, torch.Tensor] = {}
        self.rows: Dict[Any, int] = {}

    def add(self, key, x: torch.Tensor):
        flat = x.to(torch.float32).reshape(-1, x.shape[-1])
        s = torch.square(flat).sum(dim=0)
        if key in self.sq:
            self.sq[key] += s
            self.rows[key] += flat.shape[0]
        else:
            self.sq[key] = s
            self.rows[key] = flat.shape[0]

    def mean(self, key) -> Optional[torch.Tensor]:
        if key not in self.sq or self.rows[key] == 0:
            return None
        return self.sq[key] / float(self.rows[key])


def collect_moments(params: Dict[str, Any], config: ModelConfig,
                    sample_tokens: Sequence[Sequence[int]]
                    ) -> Dict[str, torch.Tensor]:
    """Per-input-channel activation second moments for every llama
    matmul slot present in `params`: {slot: [L, K] f32} for the layer
    slots plus "lm_head": [K], on the params' device. Each sequence runs
    alone (B=1) through the model's forward_no_cache, the forward every
    path of the family computes."""
    from turboinfer_tpu_torch.models import registry
    layers = params.get("layers", {})
    missing = [s for s in ("wq", "wk", "wv") if s not in layers]
    if missing and "wqkv" not in layers:
        raise QuantizationError(
            "calibration supports the llama family (wq/wk/wv/... "
            f"slots); params lack {missing}")
    for s in _LLAMA_SLOTS:
        if isinstance(layers.get(s), QTensor):
            raise QuantizationError(
                f"calibration needs fp params; '{s}' is already "
                "quantized")
    # Tap routing: object identity of the stacked weight -> slot name.
    wid_to_slot = {id(layers[s]): s for s in _LLAMA_SLOTS if s in layers}
    head = params.get("lm_head")
    if head is not None and not isinstance(head, QTensor):
        wid_to_slot[id(head)] = "lm_head"
    acc = _MomentAccumulator()

    def tap(x, w, layer_index):
        slot = wid_to_slot.get(id(w))
        if slot is None:
            return
        acc.add(slot if slot == "lm_head" else (slot, int(layer_index)), x)

    model = registry.get_model(config.architecture)
    dev = _device_of(params)
    with torch.no_grad(), ops.qmm_tap(tap):
        for toks in sample_tokens:
            toks = list(toks)
            if toks:
                model.forward_no_cache(params, config, torch.tensor(
                    [toks], dtype=torch.int32, device=dev))
    out: Dict[str, torch.Tensor] = {}
    for slot in _LLAMA_SLOTS:
        per_layer: List[torch.Tensor] = []
        for i in range(config.num_layers):
            m = acc.mean((slot, i))
            if m is None:
                break
            per_layer.append(m)
        if slot in layers and len(per_layer) == config.num_layers:
            out[slot] = torch.stack(per_layer)
    mh = acc.mean("lm_head")
    if mh is not None:
        out["lm_head"] = mh
    return out


def default_calibration_tokens(cfg: QuantizationConfig,
                               model_config: ModelConfig,
                               seed: int = 0) -> List[List[int]]:
    """cfg.calibration_samples random sequences of
    min(cfg.calibration_max_len, max_seq_len) tokens from a numpy
    RandomState(seed): the JAX package's draw, token for token. Real
    deployments should pass tokenized text instead."""
    n = max(1, int(cfg.calibration_samples))
    slen = max(2, min(int(cfg.calibration_max_len),
                      model_config.max_seq_len))
    rng = np.random.RandomState(seed)
    return [rng.randint(1, model_config.vocab_size,
                        size=slen).tolist() for _ in range(n)]


def calibrated_quantize_params(
        params: Dict[str, Any], cfg: QuantizationConfig,
        model_config: ModelConfig,
        sample_tokens: Optional[Sequence[Sequence[int]]] = None,
        seed: int = 0) -> Dict[str, Any]:
    """quantize_params with activation-calibrated scales (sample_tokens
    default to default_calibration_tokens)."""
    if not cfg.symmetric:
        raise QuantizationError(
            "calibrated quantization requires symmetric=True")
    layers = params.get("layers", {})
    if "wqkv" not in layers and any(s not in layers
                                    for s in ("wq", "wk", "wv")):
        tlog.log_warning(
            "calibration supports the llama family only; %s falls "
            "back to uncalibrated quantization",
            model_config.architecture)
        return quantize_params(params, cfg)
    if sample_tokens is None:
        sample_tokens = default_calibration_tokens(cfg, model_config, seed)
    moments = collect_moments(params, model_config, sample_tokens)
    return quantize_params(params, cfg, moments=moments)
