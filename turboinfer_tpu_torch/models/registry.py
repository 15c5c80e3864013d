"""Model registry: architecture name -> model module. The llama family,
the Mixtral-style MoE family and GPT-OSS are ported so far."""

from __future__ import annotations

from turboinfer_tpu_torch.utils.errors import ConfigError


def get_model(architecture: str):
    if architecture == "llama":
        from turboinfer_tpu_torch.models import llama
        return llama
    if architecture in ("mixtral", "moe"):
        from turboinfer_tpu_torch.models import moe
        return moe
    if architecture == "gpt_oss":
        from turboinfer_tpu_torch.models import gptoss
        return gptoss
    raise ConfigError(f"architecture {architecture!r} is not ported to the "
                      "PyTorch package yet (ported: llama, mixtral, moe, "
                      "gpt_oss)")
