"""Configuration dataclasses, field for field those of turboinfer_tpu.config.

ModelConfig, InferenceConfig and QuantizationConfig keep the JAX
package's names, defaults and derived properties; only the dtype field
holds a torch dtype. They are frozen, so a config can key a cache.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Optional, Tuple

import torch


class QuantType(str, enum.Enum):
    """Quantization data types."""

    NONE = "none"
    FLOAT16 = "float16"
    INT8 = "int8"
    INT4 = "int4"


class RopeMode(str, enum.Enum):
    """RoPE pairing convention: INTERLEAVED rotates (2i, 2i+1) pairs (the
    GGUF convention), HALF rotates (i, i + d/2) pairs (HuggingFace)."""

    INTERLEAVED = "interleaved"
    HALF = "half"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static architecture description of a decoder-only transformer."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None
    intermediate_size: Optional[int] = None
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    rope_mode: RopeMode = RopeMode.HALF
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 2048
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None
    sliding_window_pattern: Optional[int] = None
    num_experts: int = 0
    experts_per_token: int = 2
    moe_intermediate_size: Optional[int] = None
    norm_topk_prob: bool = True
    shared_expert_size: Optional[int] = None
    scoring_func: str = "softmax"
    topk_method: str = "greedy"
    n_group: int = 1
    topk_group: int = 1
    routed_scaling_factor: float = 1.0
    first_k_dense_replace: int = 0
    kv_lora_rank: Optional[int] = None
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    embedding_multiplier: Optional[float] = None
    residual_multiplier: Optional[float] = None
    logits_scaling: Optional[float] = None
    attn_bias: bool = False
    qk_norm: bool = False
    scale_embeddings: bool = False
    norm_offset: bool = False
    hidden_act: str = "silu"
    post_norms: bool = False
    attn_scale: Optional[float] = None
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    rope_local_theta: Optional[float] = None
    rope_scaling: Tuple[Tuple[str, Any], ...] = ()
    rotary_pct: float = 1.0
    parallel_residual: bool = False
    alibi: bool = False
    name: str = "llama"
    architecture: str = "llama"
    dtype: Any = torch.bfloat16
    extra: Tuple[Tuple[str, str], ...] = ()

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads if self.num_kv_heads is not None else self.num_heads

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.hidden_size // self.num_heads

    @property
    def ffn_dim(self) -> int:
        if self.intermediate_size is not None:
            return self.intermediate_size
        d = int(2 * 4 * self.hidden_size / 3)
        return ((d + 255) // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim_

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim_

    def extra_params(self) -> Dict[str, str]:
        return dict(self.extra)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Generation-time settings. decode_loop, prefill_chunk and
    kv_cache_dtype other than "model" are accepted for compatibility;
    the engine raises on values this port does not run yet."""

    max_seq_len: int = 2048
    max_batch_size: int = 32
    temperature: float = 1.0
    top_p: float = 0.9
    top_k: int = 50
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    length_penalty: float = 1.0
    eos_token_id: int = 2
    pad_token_id: int = 0
    use_cache: bool = True
    seed: int = 0
    decode_loop: str = "scan"
    prefill_bucket: bool = True
    prefill_chunk: int = 0
    kv_cache_dtype: str = "model"
    measure_ttft: bool = False


@dataclasses.dataclass(frozen=True)
class QuantizationConfig:
    """Weight-only quantization settings (group-wise along K)."""

    type: QuantType = QuantType.INT8
    symmetric: bool = True
    group_size: int = 64
    skip_embeddings: bool = False
    scale_method: str = "absmax"
    calibration_samples: int = 128
    calibration_max_len: int = 512

    @property
    def bits(self) -> int:
        return {QuantType.INT8: 8, QuantType.INT4: 4,
                QuantType.FLOAT16: 16, QuantType.NONE: 32}[self.type]


def tiny_config(**kw) -> ModelConfig:
    base = dict(vocab_size=1000, hidden_size=128, num_layers=2, num_heads=4,
                num_kv_heads=4, intermediate_size=512, max_seq_len=256,
                rope_theta=10000.0, name="tiny-llama")
    base.update(kw)
    return ModelConfig(**base)


def llama7b_config(**kw) -> ModelConfig:
    base = dict(vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
                num_kv_heads=32, intermediate_size=11008, max_seq_len=2048,
                rope_theta=10000.0, name="llama-7b")
    base.update(kw)
    return ModelConfig(**base)
