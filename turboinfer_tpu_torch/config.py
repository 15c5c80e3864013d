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
    prefill_chunk > 0: the engine prefills in chunks of that width, the
    contiguous scheduler admits long prompts chunk by chunk while decodes
    are live, and the paged scheduler ignores it, as JAX's does."""

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


def falcon7b_config(**kw) -> ModelConfig:
    """tiiuae/falcon-7b's published config.json as the loader maps it
    (loader/mapping.py config_from_hf_dict, the falcon branch): 32
    layers, hidden 4544, 71 query heads on one kv head (multi_query) of
    64, FFN 4 x 4544 = 18176 (GELU), vocab 65024, 2048 positions, the
    parallel block (parallel_attn), no biases, RoPE (alibi false, theta
    1e4) on every dim, layer_norm_epsilon 1e-5, tied embeddings."""
    base = dict(vocab_size=65024, hidden_size=4544, num_layers=32,
                num_heads=71, num_kv_heads=1, head_dim=64,
                intermediate_size=18176, rope_theta=10000.0,
                rope_mode=RopeMode.HALF, rms_norm_eps=1e-5,
                max_seq_len=2048, parallel_residual=True, alibi=False,
                rotary_pct=1.0, tie_embeddings=True, architecture="falcon",
                name="tiiuae/falcon-7b")
    base.update(kw)
    return ModelConfig(**base)


def gpt2_xl_config(**kw) -> ModelConfig:
    """openai-community/gpt2-xl's published config.json as the loader maps
    it (the gpt2 branch): 48 layers, n_embd 1600, 25 heads of 64, FFN
    4 x 1600 (n_inner null), vocab 50257, 1024 positions, layer_norm_epsilon
    1e-5, tied embeddings."""
    base = dict(vocab_size=50257, hidden_size=1600, num_layers=48,
                num_heads=25, num_kv_heads=25, head_dim=64,
                intermediate_size=6400, rms_norm_eps=1e-5, max_seq_len=1024,
                tie_embeddings=True, architecture="gpt2", name="gpt2-xl")
    base.update(kw)
    return ModelConfig(**base)


def pythia_6_9b_config(**kw) -> ModelConfig:
    """EleutherAI/pythia-6.9b's published config.json as the loader maps
    it (the generic HF branch): 32 layers, hidden 4096, 32 heads of 128,
    FFN 16384, vocab 50432, 2048 positions, rotary_pct 0.25 (rotary base
    1e4), the parallel residual, layer_norm_eps 1e-5, untied embed_out."""
    base = dict(vocab_size=50432, hidden_size=4096, num_layers=32,
                num_heads=32, num_kv_heads=32, intermediate_size=16384,
                rope_theta=10000.0, rope_mode=RopeMode.HALF,
                rms_norm_eps=1e-5, max_seq_len=2048, rotary_pct=0.25,
                parallel_residual=True, tie_embeddings=False,
                architecture="gpt_neox", name="EleutherAI/pythia-6.9b")
    base.update(kw)
    return ModelConfig(**base)


def bloom_7b1_config(**kw) -> ModelConfig:
    """bigscience/bloom-7b1's published config.json as the loader maps it
    (the bloom branch): 30 layers, hidden 4096, 32 heads of 128, FFN 4 x
    4096, vocab 250880, ALiBi and no rotary, sequential blocks, the
    embedding LayerNorm, layer_norm_epsilon 1e-5, tied embeddings, 2048
    positions (the branch's default: the config names none)."""
    base = dict(vocab_size=250880, hidden_size=4096, num_layers=30,
                num_heads=32, num_kv_heads=32, head_dim=128,
                intermediate_size=16384, rms_norm_eps=1e-5, max_seq_len=2048,
                parallel_residual=False, alibi=True, rotary_pct=0.0,
                tie_embeddings=True, architecture="bloom",
                name="bigscience/bloom-7b1")
    base.update(kw)
    return ModelConfig(**base)


def phi2_config(**kw) -> ModelConfig:
    """microsoft/phi-2's published config.json as the loader maps it (the
    generic HF branch): 32 layers, hidden 2560, 32 heads of 80, FFN
    10240, vocab 51200, 2048 positions, partial_rotary_factor 0.4 (rope
    theta 1e4), the parallel block, layer_norm_eps 1e-5, untied head (with
    its bias). Head dim 80 has no kernel instance on the card."""
    base = dict(vocab_size=51200, hidden_size=2560, num_layers=32,
                num_heads=32, num_kv_heads=32, intermediate_size=10240,
                rope_theta=10000.0, rope_mode=RopeMode.HALF,
                rms_norm_eps=1e-5, max_seq_len=2048, rotary_pct=0.4,
                parallel_residual=True, tie_embeddings=False,
                architecture="phi", name="microsoft/phi-2")
    base.update(kw)
    return ModelConfig(**base)


def deepseek_v2_lite_config(**kw) -> ModelConfig:
    """DeepSeek-V2-Lite as the JAX package's deepseek_v2_lite_config
    transcribes it (15.7B total, 2.4B active): 27 layers, hidden 2048, 16
    heads, MLA with kv_lora_rank 512, nope/rope/v head dims 128/64/128
    and no q-LoRA; 64 routed experts top-6 of width 1408 (softmax,
    greedy, no renormalisation) plus two shared experts (2816); the first
    layer dense (intermediate 10944); vocab 102400, 4096 positions."""
    base = dict(vocab_size=102400, hidden_size=2048, num_layers=27,
                num_heads=16, intermediate_size=10944,
                moe_intermediate_size=1408, shared_expert_size=2816,
                num_experts=64, experts_per_token=6,
                norm_topk_prob=False, scoring_func="softmax",
                topk_method="greedy", routed_scaling_factor=1.0,
                first_k_dense_replace=1, kv_lora_rank=512,
                q_lora_rank=None, qk_nope_head_dim=128,
                qk_rope_head_dim=64, v_head_dim=128, max_seq_len=4096,
                rope_theta=10000.0, architecture="deepseek_v2",
                name="deepseek-v2-lite")
    base.update(kw)
    return ModelConfig(**base)


# The published config.json of three MoE checkpoints, the keys the HF
# mapping reads (loader/mapping.config_from_hf_dict) transcribed as
# shipped (no weights or files can be fetched).
QWEN1_5_MOE_A2_7B_CONFIG_JSON = {
    "model_type": "qwen2_moe", "hidden_act": "silu", "hidden_size": 2048,
    "intermediate_size": 5632, "max_position_embeddings": 8192,
    "num_attention_heads": 16, "num_hidden_layers": 24,
    "num_key_value_heads": 16, "rms_norm_eps": 1e-06,
    "rope_theta": 1000000.0, "sliding_window": 32768,
    "use_sliding_window": False, "tie_word_embeddings": False,
    "vocab_size": 151936, "decoder_sparse_step": 1,
    "moe_intermediate_size": 1408, "shared_expert_intermediate_size": 5632,
    "num_experts_per_tok": 4, "num_experts": 60, "norm_topk_prob": False}
QWEN3_30B_A3B_CONFIG_JSON = {
    "model_type": "qwen3_moe", "attention_bias": False, "head_dim": 128,
    "hidden_act": "silu", "hidden_size": 2048, "intermediate_size": 6144,
    "max_position_embeddings": 40960, "moe_intermediate_size": 768,
    "norm_topk_prob": True, "num_attention_heads": 32, "num_experts": 128,
    "num_experts_per_tok": 8, "num_hidden_layers": 48,
    "num_key_value_heads": 4, "rms_norm_eps": 1e-06, "rope_scaling": None,
    "rope_theta": 1000000.0, "sliding_window": None,
    "use_sliding_window": False, "tie_word_embeddings": False,
    "vocab_size": 151936}
OLMOE_1B_7B_0924_CONFIG_JSON = {
    "model_type": "olmoe", "attention_bias": False, "hidden_act": "silu",
    "hidden_size": 2048, "intermediate_size": 1024,
    "max_position_embeddings": 4096, "norm_topk_prob": False,
    "num_attention_heads": 16, "num_experts": 64, "num_experts_per_tok": 8,
    "num_hidden_layers": 16, "num_key_value_heads": 16, "rms_norm_eps": 1e-05,
    "rope_scaling": None, "rope_theta": 10000.0, "tie_word_embeddings": False,
    "vocab_size": 50304}


def _from_hf(hf: Dict[str, Any], name: str, kw) -> ModelConfig:
    from turboinfer_tpu_torch.loader.mapping import config_from_hf_dict
    return config_from_hf_dict(hf).replace(name=name, **kw)


def qwen1_5_moe_a2_7b_config(**kw) -> ModelConfig:
    """Qwen/Qwen1.5-MoE-A2.7B's config.json through the HF mapping: 24
    layers, hidden 2048, 16:16 heads of 128 with q/k/v biases, 60 experts
    top-4 of width 1408 with raw softmax gates (norm_topk_prob false), a
    shared expert of 5632, vocab 151936, 8192 positions."""
    return _from_hf(QWEN1_5_MOE_A2_7B_CONFIG_JSON, "Qwen/Qwen1.5-MoE-A2.7B",
                    kw)


def qwen3_30b_a3b_config(**kw) -> ModelConfig:
    """Qwen/Qwen3-30B-A3B's config.json through the HF mapping: 48 layers,
    hidden 2048, 32:4 heads of 128 with per-head q/k RMSNorm, 128 experts
    top-8 of width 768, renormalised gates, vocab 151936, 40960
    positions."""
    return _from_hf(QWEN3_30B_A3B_CONFIG_JSON, "Qwen/Qwen3-30B-A3B", kw)


def olmoe_1b_7b_config(**kw) -> ModelConfig:
    """allenai/OLMoE-1B-7B-0924's config.json through the HF mapping: 16
    layers, hidden 2048, 16:16 heads of 128 with q/k RMSNorm over the
    whole projection (the checkpoint's [Hq*D] norm weights), 64 experts
    top-8 of width 1024 (intermediate_size), raw softmax gates, vocab
    50304, 4096 positions."""
    return _from_hf(OLMOE_1B_7B_0924_CONFIG_JSON, "allenai/OLMoE-1B-7B-0924",
                    kw)
