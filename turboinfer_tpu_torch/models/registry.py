"""Model registry: architecture name -> model module. The llama family
(with the names the JAX registry sends to its llama body), the
Mixtral-style MoE family and GPT-OSS are ported so far."""

from __future__ import annotations

from turboinfer_tpu_torch.utils.errors import ConfigError


def get_model(architecture: str):
    from turboinfer_tpu_torch.models import llama
    if architecture in llama.ARCHITECTURES:
        return llama
    if architecture in ("mixtral", "moe"):
        from turboinfer_tpu_torch.models import moe
        return moe
    if architecture == "gpt_oss":
        from turboinfer_tpu_torch.models import gptoss
        return gptoss
    raise ConfigError(f"architecture {architecture!r} is not ported to the "
                      f"PyTorch package yet (ported: "
                      f"{', '.join(llama.ARCHITECTURES)}, mixtral, moe, "
                      "gpt_oss)")
