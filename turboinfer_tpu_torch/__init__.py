"""turboinfer_tpu_torch: the PyTorch/CUDA port of turboinfer_tpu.

The JAX package stays the reference. This package imports torch and no
JAX; its hot path runs hand-written Hopper kernels (CUDA sources in
csrc/, wrappers in kernels/). Entry points run on the GPU unless the
caller passes device="cpu", which runs the plain PyTorch versions.

The library facade (the JAX package's __init__): initialize/shutdown,
version and build_info, load_model, and tokenize/detokenize/
generate_text over a cache of loaded engines. The command line is
`python -m turboinfer_tpu_torch` (cli.py).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from turboinfer_tpu_torch.version import __version__, version_string
from turboinfer_tpu_torch.config import (InferenceConfig, ModelConfig,
                                         QuantizationConfig, QuantType,
                                         RopeMode, tiny_config,
                                         llama7b_config)
from turboinfer_tpu_torch.core.qtensor import QTensor, quantize, dequantize
from turboinfer_tpu_torch.engine.engine import (GenerationResult,
                                               InferenceEngine, StreamChunk,
                                               quick_generate)
from turboinfer_tpu_torch.utils import logging as tlog

_initialized = False
_engine_cache: Dict[Tuple[str, str], InferenceEngine] = {}
_cache_lock = threading.Lock()


def build_info() -> str:
    """Version, torch and CUDA versions, and the visible GPUs."""
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    dev = torch.cuda.get_device_name(0) if n else "none"
    return (f"turboinfer_tpu_torch {__version__} | torch {torch.__version__}"
            f" | CUDA {torch.version.cuda} | devices {n} ({dev})")


def initialize(enable_logging: bool = True) -> bool:
    """Library init: the log level, and a build_info line when logging."""
    global _initialized
    if enable_logging:
        tlog.set_level("INFO")
        tlog.log_info("turboinfer_tpu_torch %s initializing: %s",
                      __version__, build_info())
    else:
        tlog.set_level("ERROR")
    _initialized = True
    return True


def shutdown() -> None:
    """Clears the engine cache behind tokenize/detokenize/generate_text."""
    global _initialized
    with _cache_lock:
        _engine_cache.clear()
    _initialized = False


def is_initialized() -> bool:
    return _initialized


def load_model(model_path: str,
               config: Optional[InferenceConfig] = None,
               device="cuda", **engine_kw) -> InferenceEngine:
    """Load a model file (.gguf, .safetensors, .pt, .tinq, an HF or
    checkpoint directory) into a ready engine on `device`; engine_kw
    passes through to loader.load_engine (lora=, mesh=, ...:
    a parallel.mesh.Mesh runs the engine on this rank's slice)."""
    from turboinfer_tpu_torch.loader import loader
    return loader.load_engine(model_path, config, device=device, **engine_kw)


def _cached_engine(model_path: str, device) -> InferenceEngine:
    """One loaded engine per (path, device), behind tokenize, detokenize
    and generate_text."""
    key = (model_path, str(device))
    with _cache_lock:
        eng = _engine_cache.get(key)
        if eng is None:
            eng = load_model(model_path, device=device)
            _engine_cache[key] = eng
        return eng


def tokenize(text: str, model_path: str, device="cuda") -> List[int]:
    return _cached_engine(model_path, device).encode(text)


def detokenize(tokens: Sequence[int], model_path: str, device="cuda") -> str:
    return _cached_engine(model_path, device).decode(tokens)


def generate_text(model_path: str, prompt: str, max_tokens: int = 50,
                  device="cuda", **sampling_kw) -> str:
    """One-shot text generation through the cached engine."""
    eng = _cached_engine(model_path, device)
    res = eng.generate(eng.encode(prompt), max_tokens, **sampling_kw)
    return eng.decode(res.tokens)


__all__ = [
    "__version__", "version_string", "build_info", "initialize", "shutdown",
    "is_initialized", "load_model", "tokenize", "detokenize", "generate_text",
    "ModelConfig", "InferenceConfig", "QuantizationConfig", "QuantType",
    "RopeMode", "tiny_config", "llama7b_config", "QTensor", "quantize",
    "dequantize", "InferenceEngine", "GenerationResult", "StreamChunk",
    "quick_generate",
]
