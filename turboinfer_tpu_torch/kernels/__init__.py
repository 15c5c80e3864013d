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
                                              flash_attention, paged_attention,
                                              qmm)
    return {"qmm_int4": qmm.qmm_int4,
            "qmm_int4_grouped": qmm.qmm_int4_grouped,
            "qmm_int8": qmm.qmm_int8,
            "qmm_int8_grouped": qmm.qmm_int8_grouped,
            "a8_quantize_rows": qmm.a8_quantize_rows,
            "qmm_int4_a8": qmm.qmm_int4_a8,
            "flash_prefill": flash_attention.flash_prefill,
            "cache_write_fresh": cache_write.cache_write_fresh,
            "kv_encode_write": cache_write.kv_encode_write,
            "decode_attention": decode_attention.decode_attention,
            "paged_attention": paged_attention.paged_attention}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0
