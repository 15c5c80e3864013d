"""Model registry: architecture name -> model module. The llama family
and the Mixtral-style MoE family are ported so far."""

from __future__ import annotations

from turboinfer_tpu_torch.utils.errors import ConfigError


def get_model(architecture: str):
    if architecture == "llama":
        from turboinfer_tpu_torch.models import llama
        return llama
    if architecture in ("mixtral", "moe"):
        from turboinfer_tpu_torch.models import moe
        return moe
    raise ConfigError(f"architecture {architecture!r} is not ported to the "
                      "PyTorch package yet (ported: llama, mixtral, moe)")
