"""turboinfer_tpu_torch: the PyTorch/CUDA port of turboinfer_tpu.

The JAX package stays the reference. This package imports torch and no
JAX; its hot path runs hand-written Hopper kernels (CUDA sources in
csrc/, wrappers in kernels/). Entry points run on the GPU unless the
caller passes device="cpu", which runs the plain PyTorch versions.
"""

from turboinfer_tpu_torch.config import (InferenceConfig, ModelConfig,
                                         QuantizationConfig, QuantType,
                                         RopeMode, llama7b_config,
                                         tiny_config)
from turboinfer_tpu_torch.engine.engine import (GenerationResult,
                                               InferenceEngine, StreamChunk,
                                               quick_generate)
from turboinfer_tpu_torch.version import __version__

__all__ = ["InferenceConfig", "ModelConfig", "QuantizationConfig",
           "QuantType", "RopeMode", "llama7b_config", "tiny_config",
           "InferenceEngine", "GenerationResult", "StreamChunk",
           "quick_generate", "__version__"]
