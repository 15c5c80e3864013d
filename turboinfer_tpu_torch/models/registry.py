"""Model registry: architecture name -> model module. Only the llama
family is ported so far."""

from __future__ import annotations

from turboinfer_tpu_torch.utils.errors import ConfigError


def get_model(architecture: str):
    if architecture == "llama":
        from turboinfer_tpu_torch.models import llama
        return llama
    raise ConfigError(f"architecture {architecture!r} is not ported to the "
                      "PyTorch package yet (ported: llama)")
