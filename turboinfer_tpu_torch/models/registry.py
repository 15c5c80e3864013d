"""Model registry: architecture name -> model module, as the JAX
registry maps them: the llama family (models/llama.py), GPT-2
(models/gpt2.py), the NeoX family of GPT-NeoX/Pythia, Phi-1/2, Falcon
and BLOOM (models/neox.py), the Mixtral-style MoE family and GPT-OSS.
DeepSeek's MLA and the MoE variants (qwen2_moe, qwen3_moe, olmoe) are
not ported yet."""

from __future__ import annotations

from turboinfer_tpu_torch.utils.errors import ConfigError


def get_model(architecture: str):
    from turboinfer_tpu_torch.models import gpt2, llama, neox
    for mod in (llama, gpt2, neox):
        if architecture in mod.ARCHITECTURES:
            return mod
    if architecture in ("mixtral", "moe"):
        from turboinfer_tpu_torch.models import moe
        return moe
    if architecture == "gpt_oss":
        from turboinfer_tpu_torch.models import gptoss
        return gptoss
    ported = llama.ARCHITECTURES + gpt2.ARCHITECTURES + neox.ARCHITECTURES
    raise ConfigError(f"architecture {architecture!r} is not ported to the "
                      f"PyTorch package yet (ported: {', '.join(ported)}, "
                      "mixtral, moe, gpt_oss)")
