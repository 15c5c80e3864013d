"""The port's device rule: entry points run on the card unless the
caller asks for the CPU, and never drift onto the CPU on their own."""

from __future__ import annotations

import torch

from turboinfer_tpu_torch.utils.errors import DeviceError


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises DeviceError when CUDA is asked
    for (the default everywhere) and no GPU is present."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise DeviceError(
            "CUDA device requested but torch.cuda.is_available() is False;"
            " pass device='cpu' to run the plain PyTorch versions on the CPU")
    if d.type not in ("cuda", "cpu"):
        raise DeviceError(f"unsupported device {d}")
    return d
