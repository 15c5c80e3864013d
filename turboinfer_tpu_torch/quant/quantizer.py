"""Model-level quantizer (counterpart of turboinfer_tpu/quant/quantizer.py
quantize_params): int4/int8 of every llama or MoE matmul weight,
group-wise along K, symmetric (absmax or "mse" scales) or asymmetric
(with zero points), byte-identical to the JAX package's.
MoE expert weights [L, E, K, N] become 4-D QTensors; the router stays
fp, and so do GPT-OSS's biased experts (marked by a "be_gate" slot),
as in the JAX package. Unless skip_embeddings, lm_head quantizes like
any matmul and the embedding table to per-row int8 (QEmbed). FLOAT16
casts every f32 tensor to bf16, as the JAX package's does. With
`moments` (quant/calibrate.py) the slots they cover take the
activation-weighted scale search.

Also the JAX module's model-level tools: dequantize_params,
validate_quantization_accuracy (logprob and perplexity deltas of the fp
and quantized models) and quantize_model_file (load, quantize, TINQ)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from turboinfer_tpu_torch.config import (ModelConfig, QuantizationConfig,
                                         QuantType)
from turboinfer_tpu_torch.core.qtensor import (QEmbed, QTensor, dequantize,
                                               dequantize_embed, quantize,
                                               quantize_embed)

# Per-layer [L, K, N] matmul slots; a MoE layer holds only the first
# four (its experts are the 4-D slots below, its router stays fp).
_LAYER_MATMULS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_MOE_EXPERT_SLOTS = ("we_gate", "we_up", "we_down")


def _quantize_stacked(w: torch.Tensor, cfg: QuantizationConfig,
                      moments=None) -> QTensor:
    """[L, K, N] layer by layer; moments: optional [L, K] activation
    second moments (quant/calibrate.py)."""
    qts = [quantize(w[i], cfg.type, group_size=cfg.group_size,
                    symmetric=cfg.symmetric, scale_method=cfg.scale_method,
                    weight_moments=None if moments is None
                    else moments[i]) for i in range(w.shape[0])]
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


def _to_bf16(tree):
    """Every f32 tensor of a tree (QTensor and QEmbed fields included)
    cast to bf16: the JAX package's FLOAT16 tree map."""
    if isinstance(tree, dict):
        return {k: _to_bf16(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return dataclasses.replace(
            tree, data=_to_bf16(tree.data), scales=_to_bf16(tree.scales),
            zero_points=_to_bf16(tree.zero_points))
    if isinstance(tree, QEmbed):
        return QEmbed(_to_bf16(tree.data), _to_bf16(tree.scales))
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32:
        return tree.to(torch.bfloat16)
    return tree


def quantize_params(params: Dict[str, Any], cfg: QuantizationConfig,
                    moments: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """moments: optional {slot: [L, K]} (and "lm_head": [K]) activation
    second moments from quant/calibrate.collect_moments; the slots they
    cover take the activation-weighted scale search."""
    if cfg.type == QuantType.NONE:
        return params
    if cfg.type == QuantType.FLOAT16:
        return _to_bf16(params)
    moments = moments or {}
    out = {k: v for k, v in params.items() if k not in ("layers", "lm_head")}
    layers = dict(params["layers"])
    for name in _LAYER_MATMULS:
        w = layers.get(name)
        if isinstance(w, torch.Tensor) and w.dim() == 3:
            layers[name] = _quantize_stacked(w, cfg, moments.get(name))
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
                                  scale_method=cfg.scale_method,
                                  weight_moments=moments.get("lm_head"))
    emb = out.get("embed")
    if (not cfg.skip_embeddings and isinstance(emb, torch.Tensor)
            and emb.dim() == 2):
        out["embed"] = quantize_embed(emb)
    return out


def dequantize_params(params: Dict[str, Any], dtype=torch.float32
                      ) -> Dict[str, Any]:
    """Reconstruct fp params from a quantized tree (stacked and [L, E]
    expert QTensors, QEmbed tables); other leaves as they are."""
    if isinstance(params, dict):
        return {k: dequantize_params(v, dtype) for k, v in params.items()}
    if isinstance(params, QTensor):
        return dequantize(params, dtype)
    if isinstance(params, QEmbed):
        return dequantize_embed(params, dtype)
    return params


@dataclasses.dataclass
class ValidationReport:
    """Per-token logprob deltas and perplexities of an fp model and its
    quantized copy."""
    mean_abs_logprob_delta: float
    max_abs_logprob_delta: float
    perplexity_fp: float
    perplexity_quant: float

    @property
    def perplexity_ratio(self) -> float:
        return self.perplexity_quant / max(self.perplexity_fp, 1e-9)


def _device_of(params: Dict[str, Any]) -> torch.device:
    emb = params["embed"]
    return (emb.data if isinstance(emb, QEmbed) else emb).device


def validate_quantization_accuracy(
        params_fp: Dict[str, Any], params_q: Dict[str, Any],
        model_config: ModelConfig,
        sample_tokens: Optional[Sequence[Sequence[int]]] = None,
        seed: int = 0) -> ValidationReport:
    """Compare per-token logprobs of the fp and the quantized model on
    sample sequences (default: 4 random sequences of 32 tokens from a
    numpy RandomState(seed), as the JAX package draws them), through the
    model's forward_no_cache on the params' device."""
    from turboinfer_tpu_torch.models import registry
    model = registry.get_model(model_config.architecture)
    if sample_tokens is None:
        rng = np.random.RandomState(seed)
        sample_tokens = [rng.randint(
            1, model_config.vocab_size, size=32).tolist() for _ in range(4)]
    dev = _device_of(params_fp)
    deltas, ce_fp, ce_q, count = [], 0.0, 0.0, 0
    for toks in sample_tokens:
        t = torch.tensor([list(toks)], dtype=torch.int32, device=dev)
        tgt = t[0, 1:].long()[:, None]
        lp = []
        for p in (params_fp, params_q):
            lg = torch.log_softmax(model.forward_no_cache(
                p, model_config, t).to(torch.float32), dim=-1)
            lp.append(lg[0, :-1].gather(-1, tgt)[:, 0].cpu().numpy())
        deltas.append(np.abs(lp[0] - lp[1]))
        ce_fp += -lp[0].sum()
        ce_q += -lp[1].sum()
        count += len(lp[0])
    d = np.concatenate(deltas)
    return ValidationReport(
        mean_abs_logprob_delta=float(d.mean()),
        max_abs_logprob_delta=float(d.max()),
        perplexity_fp=float(np.exp(ce_fp / count)),
        perplexity_quant=float(np.exp(ce_q / count)))


def quantize_model_file(input_path: str, output_path: str,
                        cfg: QuantizationConfig, *,
                        calibrate: bool = False,
                        sample_tokens: Optional[
                            Sequence[Sequence[int]]] = None,
                        device="cuda") -> None:
    """Load a model file onto `device`, quantize it (calibrated with
    `sample_tokens` or cfg.calibration_samples random sequences when
    calibrate) and write it as TINQ."""
    from turboinfer_tpu_torch.loader import loader, tinq
    model = loader.load_model_data(input_path, device=device)
    if calibrate:
        from turboinfer_tpu_torch.quant.calibrate import \
            calibrated_quantize_params
        qparams = calibrated_quantize_params(
            model.params, cfg, model.config, sample_tokens=sample_tokens)
    else:
        qparams = quantize_params(model.params, cfg)
    tinq.save(output_path, qparams, model.config, cfg)
