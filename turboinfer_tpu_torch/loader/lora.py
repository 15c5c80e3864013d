"""LoRA adapters (PEFT format): the counterpart of
turboinfer_tpu/loader/lora.py.

load_lora reads a PEFT adapter (adapter_config.json +
adapter_model.safetensors) into stacked slots of the layers dict,
`lora_<slot>_a` [L, in, r] and `lora_<slot>_b` [L, r, out], with the
alpha/r scaling (rsLoRA: alpha/sqrt(r)) folded into B; layers the
adapter does not target get zero blocks. apply_lora attaches them to a
parameter dict, quantized bases included: models/llama.py adds the
low-rank update, computed in f32, to each product's output at run time.
merge_lora instead folds W += A @ B into full-precision weights.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict

import torch

from turboinfer_tpu_torch.config import ModelConfig
from turboinfer_tpu_torch.core.qtensor import QTensor
from turboinfer_tpu_torch.utils import logging as tlog
from turboinfer_tpu_torch.utils.device import resolve_device
from turboinfer_tpu_torch.utils.errors import ModelFormatError

# PEFT module name -> runtime slot
_MODULE_SLOTS = {
    "q_proj": "wq", "k_proj": "wk", "v_proj": "wv", "o_proj": "wo",
    "gate_proj": "w_gate", "up_proj": "w_up", "down_proj": "w_down",
}
_KEY_RE = re.compile(
    r"(?:base_model\.model\.)?model\.layers\.(\d+)\.(?:self_attn|mlp)\."
    r"(\w+)\.lora_(A|B)\.weight")


def load_lora(path: str, config: ModelConfig, dtype=None,
              device="cuda") -> Dict[str, Any]:
    """A PEFT adapter directory (or its adapter_model.safetensors path)
    -> dict of stacked lora slots on `device`, ready for apply_lora."""
    from turboinfer_tpu_torch.loader import safetensors as st_mod
    dev = resolve_device(device)
    if os.path.isdir(path):
        cfg_path = os.path.join(path, "adapter_config.json")
        st_path = os.path.join(path, "adapter_model.safetensors")
    else:
        cfg_path = os.path.join(os.path.dirname(path) or ".",
                                "adapter_config.json")
        st_path = path
    acfg: Dict[str, Any] = {}
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            acfg = json.load(f)
    r = int(acfg.get("r", 8))
    alpha = float(acfg.get("lora_alpha", r))
    scale = (alpha / (r ** 0.5)) if acfg.get("use_rslora") else (alpha / r)
    dtype = dtype or config.dtype
    L = config.num_layers

    # slot -> layer -> {"A": [r, in], "B": [out, r]} f32
    per_slot: Dict[str, Dict[int, Dict[str, torch.Tensor]]] = {}
    with st_mod.read_safetensors(st_path) as sf:
        for name in sf.keys():
            m = _KEY_RE.match(name)
            if not m:
                continue
            layer, module, which = int(m.group(1)), m.group(2), m.group(3)
            slot = _MODULE_SLOTS.get(module)
            if slot is None:
                continue
            per_slot.setdefault(slot, {}).setdefault(layer, {})[which] = \
                sf.torch_tensor(name).to(torch.float32)
    if not per_slot:
        raise ModelFormatError(
            f"no LoRA tensors recognized in {st_path} (expected PEFT "
            "…lora_A/lora_B.weight keys)")

    out: Dict[str, Any] = {}
    for slot, layers in per_slot.items():
        for i, ab in layers.items():
            if "A" not in ab or "B" not in ab:
                raise ModelFormatError(
                    f"layer {i} {slot}: incomplete LoRA pair")
            if not 0 <= i < L:
                raise ModelFormatError(
                    f"adapter targets layer {i} ({slot}) but the base "
                    f"model has {L} layers — wrong base model?")
        any_layer = next(iter(layers.values()))
        rr, d_in = any_layer["A"].shape
        d_out = any_layer["B"].shape[0]
        a = torch.zeros((L, d_in, rr), dtype=torch.float32)
        b = torch.zeros((L, rr, d_out), dtype=torch.float32)
        for i, ab in layers.items():
            a[i] = ab["A"].T                      # [r, in] -> [in, r]
            b[i] = ab["B"].T * scale              # [out, r] -> [r, out]
        out[f"lora_{slot}_a"] = a.to(dtype).to(dev)
        out[f"lora_{slot}_b"] = b.to(dtype).to(dev)
    tlog.log_info("loaded LoRA %s: r=%d alpha=%g targets=%s", path, r,
                  alpha, sorted(per_slot))
    return out


def apply_lora(params: Dict[str, Any], lora: Dict[str, Any]
               ) -> Dict[str, Any]:
    """Attach adapter slots to a parameter dict (the runtime low-rank
    path; works with quantized bases)."""
    layers = dict(params["layers"])
    layers.update(lora)
    return {**params, "layers": layers}


def strip_lora(params: Dict[str, Any]) -> Dict[str, Any]:
    """Remove any attached adapter slots."""
    layers = {k: v for k, v in params["layers"].items()
              if not k.startswith("lora_")}
    return {**params, "layers": layers}


def merge_lora(params: Dict[str, Any], lora: Dict[str, Any]
               ) -> Dict[str, Any]:
    """Fold the adapter into full-precision base weights (W += A @ B per
    layer, in f32, back to the weight's dtype); a quantized slot raises
    (use apply_lora)."""
    layers = dict(params["layers"])
    for key in [k for k in lora if k.endswith("_a")]:
        slot = key[len("lora_"):-len("_a")]
        base = layers.get(slot)
        if base is None:
            raise ModelFormatError(f"adapter targets missing slot {slot}")
        if isinstance(base, QTensor):
            raise ModelFormatError(
                f"cannot merge LoRA into quantized '{slot}' — use "
                "apply_lora (runtime path) instead")
        a = lora[key].to(torch.float32)
        b = lora[f"lora_{slot}_b"].to(torch.float32)
        delta = torch.einsum("lir,lro->lio", a, b)
        layers[slot] = (base.to(torch.float32) + delta).to(base.dtype)
    return {**params, "layers": layers}
