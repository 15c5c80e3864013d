"""Model registry: architecture name -> model module, as the JAX
registry maps them: the llama family (models/llama.py), GPT-2
(models/gpt2.py), the NeoX family of GPT-NeoX/Pythia, Phi-1/2, Falcon
and BLOOM (models/neox.py), the MoE family of Mixtral, Qwen2-MoE,
Qwen3-MoE and OLMoE (models/moe.py), DeepSeek V2/V3 (models/deepseek.py)
and GPT-OSS (models/gptoss.py)."""

from __future__ import annotations

from turboinfer_tpu_torch.utils.errors import ConfigError


def get_model(architecture: str):
    from turboinfer_tpu_torch.models import (deepseek, gpt2, gptoss, llama,
                                             moe, neox)
    families = (llama, gpt2, neox, moe, deepseek)
    for mod in families:
        if architecture in mod.ARCHITECTURES:
            return mod
    if architecture == "gpt_oss":
        return gptoss
    known = [a for mod in families for a in mod.ARCHITECTURES] + ["gpt_oss"]
    raise ConfigError(f"architecture {architecture!r} is not ported to the "
                      f"PyTorch package yet (ported: {', '.join(known)})")
