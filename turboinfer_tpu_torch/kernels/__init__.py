"""Kernels of the port: plain PyTorch ops (ops.py), the dispatch, and one
wrapper module per hand-written Hopper kernel (CUDA sources in csrc/).

Every wrapper counts its own launches in a plain integer attribute,
`wrapper.launches`; launch_counts() reads them and reset_launch_counts()
sets them to 0.
"""

from __future__ import annotations

from typing import Callable, Dict


def wrappers() -> Dict[str, Callable]:
    """Kernel name -> wrapper function."""
    from turboinfer_tpu_torch.kernels import (cache_write, decode_attention,
                                              flash_attention, qmm)
    return {"qmm_int4": qmm.qmm_int4,
            "flash_prefill": flash_attention.flash_prefill,
            "cache_write_fresh": cache_write.cache_write_fresh,
            "decode_attention": decode_attention.decode_attention}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0
