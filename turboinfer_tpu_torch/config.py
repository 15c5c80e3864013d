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
    """Generation-time settings. kv_cache_dtype: "model" (the model's
    dtype), "bf16", "int8" (symmetric per-(token, head) codes with f32
    scale planes) or "fp8" (float8_e4m3 stored as uint8 bits), honoured
    by the engine, both schedulers and the draft cache of speculative
    serving, for the llama and MoE families. GPT-OSS takes every value in
    its contiguous caches and fp8 page pools, and refuses int8 page pools
    as the JAX package does (models/gptoss.py SUPPORTS_INT8_KV_PAGED).
    The engine and schedulers raise on other values this port does not
    run yet (e.g. prefill_chunk > 0 in a scheduler)."""

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


def mixtral_config(**kw) -> ModelConfig:
    """Mixtral-8x7B shape: 32 layers, 8 experts, top-2 routing."""
    base = dict(vocab_size=32000, hidden_size=4096, num_layers=32,
                num_heads=32, num_kv_heads=8, intermediate_size=14336,
                num_experts=8, experts_per_token=2, max_seq_len=4096,
                rope_theta=1000000.0, architecture="mixtral",
                name="mixtral-8x7b")
    base.update(kw)
    return ModelConfig(**base)


def gptoss20b_config(**kw) -> ModelConfig:
    """openai/gpt-oss-20b's published config.json as the JAX package's
    loader maps it (loader/mapping.py): 24 layers, 32 experts top-4,
    attention sinks, 128-token windows on even layers, YaRN factor 32."""
    base = dict(vocab_size=201088, hidden_size=2880, num_layers=24,
                num_heads=64, num_kv_heads=8, head_dim=64,
                intermediate_size=2880, num_experts=32, experts_per_token=4,
                sliding_window=128, sliding_window_pattern=2,
                rope_theta=150000.0, attn_bias=True, max_seq_len=131072,
                rope_scaling=(("beta_fast", 32.0), ("beta_slow", 1.0),
                              ("factor", 32.0),
                              ("original_max_position_embeddings", 4096),
                              ("rope_type", "yarn"), ("truncate", False)),
                architecture="gpt_oss", name="gpt-oss-20b")
    base.update(kw)
    return ModelConfig(**base)


def gemma2_27b_config(**kw) -> ModelConfig:
    """google/gemma-2-27b's published config.json as the JAX package's
    loader maps it (loader/mapping.py, the HF branch): 46 layers, hidden
    4608, 32 query and 16 kv heads of 128, FFN 36864 (GeGLU,
    hidden_activation gelu_pytorch_tanh), vocab 256000, 8192 positions;
    sliding_window 4096 on every even layer (pattern 2), attention and
    final logit softcaps 50 and 30, query_pre_attn_scalar 144 (so
    attn_scale = 144**-0.5, not head_dim**-0.5), (1 + w) norms, embeddings
    times sqrt(hidden), sandwich norms and tied embeddings."""
    base = dict(vocab_size=256000, hidden_size=4608, num_layers=46,
                num_heads=32, num_kv_heads=16, head_dim=128,
                intermediate_size=36864, rope_theta=10000.0,
                rope_mode=RopeMode.HALF, rms_norm_eps=1e-6,
                max_seq_len=8192, sliding_window=4096,
                sliding_window_pattern=2, attn_logit_softcap=50.0,
                final_logit_softcap=30.0, attn_scale=144.0 ** -0.5,
                norm_offset=True, scale_embeddings=True, post_norms=True,
                hidden_act="gelu", tie_embeddings=True,
                architecture="gemma2", name="google/gemma-2-27b")
    base.update(kw)
    return ModelConfig(**base)


def gemma3_12b_config(**kw) -> ModelConfig:
    """google/gemma-3-12b-pt's published config.json (its text_config) as
    the JAX package's loader maps it (loader/mapping.py, the HF branch):
    48 layers, hidden 3840, 16 query and 8 kv heads of 256, FFN 15360
    (GeGLU, gelu_pytorch_tanh), vocab 262208, 131072 positions; a
    1024-key window on five layers of every six (layer_types: a global
    layer every 6th, pattern 6); rope_theta 1e6 with linear rope_scaling
    factor 8 on the global layers and rope_local_base_freq 1e4 on the
    local ones; query_pre_attn_scalar 256 (attn_scale 256**-0.5), per-head
    q/k RMSNorms, (1 + w) norms, embeddings times sqrt(hidden), sandwich
    norms, no softcaps and tied embeddings."""
    base = dict(vocab_size=262208, hidden_size=3840, num_layers=48,
                num_heads=16, num_kv_heads=8, head_dim=256,
                intermediate_size=15360, rope_theta=1000000.0,
                rope_local_theta=10000.0,
                rope_scaling=(("factor", 8.0), ("rope_type", "linear")),
                rope_mode=RopeMode.HALF, rms_norm_eps=1e-6,
                max_seq_len=131072, sliding_window=1024,
                sliding_window_pattern=6, attn_scale=256.0 ** -0.5,
                qk_norm=True, norm_offset=True, scale_embeddings=True,
                post_norms=True, hidden_act="gelu", tie_embeddings=True,
                architecture="gemma3", name="google/gemma-3-12b-pt")
    base.update(kw)
    return ModelConfig(**base)


def phi3_mini_4k_config(**kw) -> ModelConfig:
    """microsoft/Phi-3-mini-4k-instruct's published config.json as the JAX
    package's loader maps it (loader/mapping.py, the HF branch): 32
    layers, hidden 3072, 32 query and 32 kv heads of 96, FFN 8192 (SiLU),
    vocab 32064, 4096 positions, rope_theta 1e4 without rope_scaling, a
    2047-key window on every layer, rms_norm_eps 1e-5 and untied
    embeddings. The checkpoint's fused qkv_proj / gate_up_proj are the
    loader's concern; the model body is the llama one."""
    base = dict(vocab_size=32064, hidden_size=3072, num_layers=32,
                num_heads=32, num_kv_heads=32, intermediate_size=8192,
                rope_theta=10000.0, rms_norm_eps=1e-5, max_seq_len=4096,
                sliding_window=2047, tie_embeddings=False,
                architecture="phi3",
                name="microsoft/Phi-3-mini-4k-instruct")
    base.update(kw)
    return ModelConfig(**base)
