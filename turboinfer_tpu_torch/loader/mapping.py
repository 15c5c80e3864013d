"""Weight-name conventions, the stacked-parameter assembly and the
config mappings: the counterpart of turboinfer_tpu/loader/mapping.py.

resolve_name tries the same name templates in the same order (GGUF
blk.*, HF model.layers.*, and the reference's fallbacks); assemble_params
builds the llama-family and MoE parameter dict (weights transposed to
[in, out], layers stacked on a leading axis), including Phi-3's fused
qkv_proj / gate_up_proj and llama.cpp's attn_qkv and double-width
ffn_up, which it splits; assemble_params_gptoss builds GPT-OSS's. The
output is torch tensors on the asked device, bit for bit the JAX
package's arrays after the same cast to `dtype` (each weight moves to
the device in its file dtype and is cast there, by way of f32). The
config functions (GGUF metadata, HF config.json, the TINQ dict) are the
JAX package's, whole.

The GPT-2, GPT-NeoX, Phi-1/2, Falcon, BLOOM and DeepSeek assemblers
wait for their model families (ROADMAP item 12): assemble_for raises
ModelFormatError for those architectures.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from turboinfer_tpu_torch.config import ModelConfig, RopeMode
from turboinfer_tpu_torch.utils.device import resolve_device
from turboinfer_tpu_torch.utils.errors import ModelFormatError

# Name templates per logical slot. {i} = layer index. Order = priority.
# Conventions covered: GGUF-native (blk.*), HF (model.layers.*), and the
# reference's two fallbacks (layers.N.attention.*, layers.N.self_attn.* —
# inference_engine.cpp:510-564).
SLOT_TEMPLATES: Dict[str, List[str]] = {
    "embed": [
        "token_embd.weight",                      # GGUF
        "model.embed_tokens.weight",              # HF
        "embed_tokens.weight",                    # reference convention
        "token_embeddings.weight",                # reference convention
        "tok_embeddings.weight",                  # llama original
        "transformer.wte.weight",                 # GPT-2
    ],
    "attn_norm": [
        "blk.{i}.attn_norm.weight",
        "model.layers.{i}.input_layernorm.weight",
        "layers.{i}.input_layernorm.weight",
        "layers.{i}.attention_norm.weight",
        "transformer.h.{i}.ln_1.weight",
    ],
    "wq": [
        "blk.{i}.attn_q.weight",
        "model.layers.{i}.self_attn.q_proj.weight",
        "layers.{i}.self_attn.q_proj.weight",
        "layers.{i}.attention.q_proj.weight",
        "layers.{i}.attention.wq.weight",
    ],
    "wk": [
        "blk.{i}.attn_k.weight",
        "model.layers.{i}.self_attn.k_proj.weight",
        "layers.{i}.self_attn.k_proj.weight",
        "layers.{i}.attention.k_proj.weight",
        "layers.{i}.attention.wk.weight",
    ],
    "wv": [
        "blk.{i}.attn_v.weight",
        "model.layers.{i}.self_attn.v_proj.weight",
        "layers.{i}.self_attn.v_proj.weight",
        "layers.{i}.attention.v_proj.weight",
        "layers.{i}.attention.wv.weight",
    ],
    "wo": [
        "blk.{i}.attn_output.weight",
        "model.layers.{i}.self_attn.o_proj.weight",
        "layers.{i}.self_attn.o_proj.weight",
        "layers.{i}.attention.o_proj.weight",
        "layers.{i}.attention.wo.weight",
    ],
    "ffn_norm": [
        "blk.{i}.ffn_norm.weight",
        # Gemma2/3 sandwich-norm checkpoints: ffn_norm is the PRE-ffn
        # norm; post_attention_layernorm binds to post_attn_norm there.
        "model.layers.{i}.pre_feedforward_layernorm.weight",
        "model.layers.{i}.post_attention_layernorm.weight",
        "layers.{i}.post_attention_layernorm.weight",
        "layers.{i}.ffn_norm.weight",
        "transformer.h.{i}.ln_2.weight",
    ],
    # Optional per-layer slots, fetched only when the config asks:
    "b_q": [
        "blk.{i}.attn_q.bias",
        "model.layers.{i}.self_attn.q_proj.bias",
        "layers.{i}.self_attn.q_proj.bias",
    ],
    "b_k": [
        "blk.{i}.attn_k.bias",
        "model.layers.{i}.self_attn.k_proj.bias",
        "layers.{i}.self_attn.k_proj.bias",
    ],
    "b_v": [
        "blk.{i}.attn_v.bias",
        "model.layers.{i}.self_attn.v_proj.bias",
        "layers.{i}.self_attn.v_proj.bias",
    ],
    "q_norm": [
        "blk.{i}.attn_q_norm.weight",
        "model.layers.{i}.self_attn.q_norm.weight",
        "layers.{i}.self_attn.q_norm.weight",
    ],
    "k_norm": [
        "blk.{i}.attn_k_norm.weight",
        "model.layers.{i}.self_attn.k_norm.weight",
        "layers.{i}.self_attn.k_norm.weight",
    ],
    "post_attn_norm": [
        "blk.{i}.post_attention_norm.weight",
        "model.layers.{i}.post_attention_layernorm.weight",
        "layers.{i}.post_attention_layernorm.weight",
    ],
    "post_ffn_norm": [
        "blk.{i}.post_ffw_norm.weight",
        "model.layers.{i}.post_feedforward_layernorm.weight",
        "layers.{i}.post_feedforward_layernorm.weight",
    ],
    "w_gate": [
        "blk.{i}.ffn_gate.weight",
        "model.layers.{i}.mlp.gate_proj.weight",
        "layers.{i}.mlp.gate_proj.weight",
        "layers.{i}.feed_forward.w1.weight",
    ],
    "w_up": [
        "blk.{i}.ffn_up.weight",
        "model.layers.{i}.mlp.up_proj.weight",
        "layers.{i}.mlp.up_proj.weight",
        "layers.{i}.feed_forward.w3.weight",
    ],
    "w_down": [
        "blk.{i}.ffn_down.weight",
        "model.layers.{i}.mlp.down_proj.weight",
        "layers.{i}.mlp.down_proj.weight",
        "layers.{i}.feed_forward.w2.weight",
    ],
    # MoE slots ({e} = expert index). Covers Mixtral's block_sparse_moe
    # naming (w1=gate, w3=up, w2=down) and Qwen2/Qwen3-MoE's mlp.experts.
    "router": [
        "blk.{i}.ffn_gate_inp.weight",
        "model.layers.{i}.block_sparse_moe.gate.weight",
        "model.layers.{i}.mlp.gate.weight",
    ],
    # Per-expert split names; modern GGUFs instead pack all experts in
    # one stacked blk.{i}.ffn_*_exps.weight tensor (assemble_params
    # handles those directly).
    "we_gate": [
        "blk.{i}.ffn_gate.{e}.weight",
        "model.layers.{i}.block_sparse_moe.experts.{e}.w1.weight",
        "model.layers.{i}.mlp.experts.{e}.gate_proj.weight",
    ],
    "we_up": [
        "blk.{i}.ffn_up.{e}.weight",
        "model.layers.{i}.block_sparse_moe.experts.{e}.w3.weight",
        "model.layers.{i}.mlp.experts.{e}.up_proj.weight",
    ],
    "we_down": [
        "blk.{i}.ffn_down.{e}.weight",
        "model.layers.{i}.block_sparse_moe.experts.{e}.w2.weight",
        "model.layers.{i}.mlp.experts.{e}.down_proj.weight",
    ],
    # Qwen2-MoE shared expert (dense SwiGLU on every token).
    "ws_gate": ["blk.{i}.ffn_gate_shexp.weight",
                "model.layers.{i}.mlp.shared_expert.gate_proj.weight"],
    "ws_up": ["blk.{i}.ffn_up_shexp.weight",
              "model.layers.{i}.mlp.shared_expert.up_proj.weight"],
    "ws_down": ["blk.{i}.ffn_down_shexp.weight",
                "model.layers.{i}.mlp.shared_expert.down_proj.weight"],
    "shared_gate": ["blk.{i}.ffn_gate_inp_shexp.weight",
                    "model.layers.{i}.mlp.shared_expert_gate.weight"],
    "final_norm": [
        "output_norm.weight",
        "model.norm.weight",
        "norm.weight",
        "transformer.ln_f.weight",
    ],
    "lm_head": [
        "output.weight",
        "lm_head.weight",
    ],
}

# Slots whose file layout is [out, in] and must be transposed to [in, out].
_TRANSPOSED = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head",
               "router", "we_gate", "we_up", "we_down",
               "ws_gate", "ws_up", "ws_down", "shared_gate"}
_PER_LAYER = {"attn_norm", "wq", "wk", "wv", "wo", "ffn_norm",
              "w_gate", "w_up", "w_down"}


def resolve_name(names: Sequence[str], slot: str, layer: Optional[int] = None,
                 expert: Optional[int] = None) -> Optional[str]:
    """First matching concrete name for a slot (reference behavior:
    try conventions in order, inference_engine.cpp:483-564)."""
    nameset = set(names)
    for tmpl in SLOT_TEMPLATES[slot]:
        cand = tmpl.format(i=layer, e=expert) \
            if "{" in tmpl else tmpl
        if cand in nameset:
            return cand
    return None


def as_torch(a) -> torch.Tensor:
    """A getter's result (numpy array or torch tensor, in file dtype) as
    a CPU torch tensor; a read-only numpy view is copied."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if not a.flags.writeable:
        a = np.array(a)
    return torch.from_numpy(a)


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    """t in `dtype`, by way of f32 (the JAX package reads every weight as
    f32 and casts that)."""
    if t.dtype == dtype:
        return t
    return t.to(torch.float32).to(dtype)


def _stack(rows: List[torch.Tensor], dtype, device) -> torch.Tensor:
    """Stack same-shaped device tensors into one [len(rows), ...] tensor
    of `dtype` on `device` (each row cast as it is copied in)."""
    out = torch.empty((len(rows),) + tuple(rows[0].shape), dtype=dtype,
                      device=device)
    for i, r in enumerate(rows):
        out[i].copy_(_cast(r, dtype))
    return out


def assemble_params(get: Callable[[str], Any], names: Sequence[str],
                    config: ModelConfig, dtype=None,
                    device="cuda") -> Dict[str, Any]:
    """Build the stacked-layer parameter dict from a name -> array
    getter.

    `get(name)` returns a host array (numpy or torch) in file layout
    ([out, in] for matmul weights). Each tensor moves to `device` in its
    file dtype and is transposed and cast there. Missing lm_head falls
    back to tied embeddings (a transposed view of the table)."""
    dtype = dtype or config.dtype
    dev = resolve_device(device)
    L = config.num_layers
    nameset = set(names)

    def load(name: str) -> torch.Tensor:
        return as_torch(get(name)).to(dev)

    def fetch_fused(slot: str, layer: int) -> Optional[torch.Tensor]:
        """Phi-3-style checkpoints store qkv_proj / gate_up_proj fused
        along the output axis; split the file-layout [out, in] rows.
        llama.cpp GGUFs of the same models store the fusions as
        blk.{i}.attn_qkv.weight and a DOUBLE-width
        blk.{i}.ffn_up.weight (no ffn_gate tensor)."""
        if slot in ("wq", "wk", "wv"):
            for cand in (f"model.layers.{layer}.self_attn.qkv_proj.weight",
                         f"blk.{layer}.attn_qkv.weight"):
                if cand in nameset:
                    arr = load(cand)
                    qd, kvd = config.q_dim, config.kv_dim
                    return {"wq": arr[:qd], "wk": arr[qd:qd + kvd],
                            "wv": arr[qd + kvd:qd + 2 * kvd]}[slot]
            return None
        if slot in ("w_gate", "w_up"):
            cand = f"model.layers.{layer}.mlp.gate_up_proj.weight"
            if cand not in nameset:
                cand = f"blk.{layer}.ffn_up.weight"
                if not (cand in nameset
                        and f"blk.{layer}.ffn_gate.weight" not in nameset
                        and config.intermediate_size
                        and as_torch(get(cand)).shape[0]
                        == 2 * config.intermediate_size):
                    return None
            arr = load(cand)
            f = arr.shape[0] // 2
            return arr[:f] if slot == "w_gate" else arr[f:]
        return None

    def fetch(slot: str, layer: Optional[int] = None,
              required: bool = True) -> Optional[torch.Tensor]:
        name = resolve_name(names, slot, layer)
        if name is None:
            if layer is not None:
                arr = fetch_fused(slot, layer)
                if arr is not None:
                    return arr.T if slot in _TRANSPOSED else arr
            if required:
                where = f" (layer {layer})" if layer is not None else ""
                raise KeyError(
                    f"no tensor found for slot '{slot}'{where}; tried "
                    f"{[t.format(i=layer) for t in SLOT_TEMPLATES[slot]]}")
            return None
        arr = load(name)
        if (slot == "w_up" and layer is not None
                and config.intermediate_size
                and arr.shape[0] == 2 * config.intermediate_size
                and resolve_name(names, "w_gate", layer) is None):
            # Phi-3 GGUF: blk.{i}.ffn_up.weight holds gate|up fused
            # (no ffn_gate tensor) — resolve_name matches it as w_up
            # directly, so split here (w_gate takes the fused path).
            arr = arr[config.intermediate_size:]
        if slot in _TRANSPOSED:
            arr = arr.T
        return arr

    def stack(slot: str) -> torch.Tensor:
        return _stack([fetch(slot, i) for i in range(L)], dtype, dev)

    per_layer = set(_PER_LAYER)
    if config.attn_bias:
        per_layer |= {"b_q", "b_k", "b_v"}
    if config.qk_norm:
        per_layer |= {"q_norm", "k_norm"}
    if config.post_norms:
        per_layer |= {"post_attn_norm", "post_ffn_norm"}
    if config.num_experts:
        # MoE: the dense FFN slots are replaced by router + per-expert
        # weights stacked to [L, E, in, out] (models/moe.py layout).
        per_layer -= {"w_gate", "w_up", "w_down"}
        per_layer |= {"router"}
        if config.shared_expert_size:
            per_layer |= {"ws_gate", "ws_up", "ws_down", "shared_gate"}

    def stack_experts(slot: str) -> torch.Tensor:
        E = config.num_experts
        kind = {"we_gate": "gate", "we_up": "up", "we_down": "down"}[slot]
        per_l = []
        for i in range(L):
            stacked = f"blk.{i}.ffn_{kind}_exps.weight"
            if stacked in nameset:
                # GGUF expert-stacked tensor: reversed dims give
                # [E, out, in]; transpose each expert to [in, out].
                per_l.append(load(stacked).transpose(1, 2))
                continue
            rows = []
            for e in range(E):
                name = resolve_name(names, slot, i, e)
                if name is None:
                    raise KeyError(
                        f"no tensor for MoE slot '{slot}' "
                        f"(layer {i}, expert {e})")
                rows.append(load(name).T)
            per_l.append(_stack(rows, dtype, dev))
        return _stack(per_l, dtype, dev)

    embed = _cast(fetch("embed"), dtype).contiguous()
    layers: Dict[str, Any] = {slot: stack(slot)
                              for slot in sorted(per_layer)}
    if config.num_experts:
        for slot in ("we_gate", "we_up", "we_down"):
            layers[slot] = stack_experts(slot)
    params: Dict[str, Any] = {
        "embed": embed,
        "layers": layers,
        "final_norm": _cast(fetch("final_norm"), dtype).contiguous(),
    }
    head = fetch("lm_head", required=False)
    params["lm_head"] = (embed.T if head is None
                         else _cast(head, dtype).contiguous())
    return params


def assemble_params_gptoss(get: Callable[[str], Any], names: Sequence[str],
                           config: ModelConfig, dtype=None,
                           device="cuda") -> Dict[str, Any]:
    """GPT-OSS (models/gptoss.py structure). HF stores expert weights
    as [E, in, out] Parameters (no transpose) with gate/up INTERLEAVED
    along the fused gate_up output axis (even=gate, odd=up) — they are
    de-interleaved into separate slots here, once, at load."""
    dtype = dtype or config.dtype
    dev = resolve_device(device)
    nameset = set(names)
    L = config.num_layers

    def fetch(name, transpose=False, required=True):
        if name not in nameset:
            if required:
                raise KeyError(f"no tensor '{name}' in checkpoint")
            return None
        arr = as_torch(get(name)).to(dev)
        return arr.T if transpose else arr

    g: Dict[str, List[torch.Tensor]] = {}

    def add(slot, arr):
        g.setdefault(slot, []).append(arr)

    for i in range(L):
        p = f"model.layers.{i}"
        add("attn_norm", fetch(f"{p}.input_layernorm.weight"))
        add("ffn_norm", fetch(f"{p}.post_attention_layernorm.weight"))
        for slot, nm in (("wq", "q_proj"), ("wk", "k_proj"),
                         ("wv", "v_proj"), ("wo", "o_proj")):
            add(slot, fetch(f"{p}.self_attn.{nm}.weight", transpose=True))
            add("b_" + slot[1], fetch(f"{p}.self_attn.{nm}.bias"))
        add("sinks", fetch(f"{p}.self_attn.sinks"))
        add("router", fetch(f"{p}.mlp.router.weight", transpose=True))
        add("router_bias", fetch(f"{p}.mlp.router.bias"))
        gu = fetch(f"{p}.mlp.experts.gate_up_proj")       # [E, H, 2F]
        gub = fetch(f"{p}.mlp.experts.gate_up_proj_bias")  # [E, 2F]
        add("we_gate", gu[..., 0::2])
        add("we_up", gu[..., 1::2])
        add("be_gate", gub[..., 0::2])
        add("be_up", gub[..., 1::2])
        add("we_down", fetch(f"{p}.mlp.experts.down_proj"))  # [E, F, H]
        add("be_down", fetch(f"{p}.mlp.experts.down_proj_bias"))
    layers = {k: _stack(v, dtype, dev) for k, v in g.items()}
    embed = _cast(fetch("model.embed_tokens.weight"), dtype).contiguous()
    head = fetch("lm_head.weight", transpose=True, required=False)
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": _cast(fetch("model.norm.weight"), dtype).contiguous(),
        "lm_head": (embed.T if head is None
                    else _cast(head, dtype).contiguous()),
    }


# architecture -> the JAX assembler that waits for its model family
_UNPORTED_ASSEMBLERS = {
    "gpt2": "assemble_params_gpt2", "gpt_neox": "assemble_params_neox",
    "falcon": "assemble_params_falcon", "bloom": "assemble_params_bloom",
    "phi": "assemble_params_phi", "deepseek_v2": "assemble_params_deepseek",
    "deepseek_v3": "assemble_params_deepseek"}


def assemble_for(config: ModelConfig):
    """Architecture-appropriate assembler (loaders dispatch here)."""
    if config.architecture in _UNPORTED_ASSEMBLERS:
        raise ModelFormatError(
            f"architecture {config.architecture!r}: its model family and "
            f"{_UNPORTED_ASSEMBLERS[config.architecture]} are not ported to "
            "the PyTorch package yet (ROADMAP item 12)")
    if config.architecture == "gpt_oss":
        return assemble_params_gptoss
    return assemble_params


# ---------------------------------------------------------------------------
# GGUF metadata -> ModelConfig (reference: model_loader.cpp:752-771)
# ---------------------------------------------------------------------------

def config_from_gguf_metadata(md: Dict[str, Any],
                              vocab_size_hint: Optional[int] = None,
                              dtype=torch.bfloat16) -> ModelConfig:
    arch = str(md.get("general.architecture", "llama"))
    p = arch  # GGUF prefixes per-arch keys with the architecture name

    def geti(key: str, default: int) -> int:
        return int(md.get(f"{p}.{key}", default))

    def getf(key: str, default: float) -> float:
        return float(md.get(f"{p}.{key}", default))

    hidden = geti("embedding_length", 4096)
    heads = geti("attention.head_count", max(hidden // 128, 1))
    kv_heads = geti("attention.head_count_kv", heads)
    # vocab 0 = unknown; the loader fills it from the embedding shape.
    vocab = (vocab_size_hint or geti("vocab_size", 0)
             or len(md.get("tokenizer.ggml.tokens", [])))

    extra = tuple(sorted(
        (k, str(v)) for k, v in md.items()
        if isinstance(v, (str, int, float, bool)) and not k.startswith("tokenizer.")))

    is_gemma = arch.startswith("gemma")
    # RoPE pairing: llama.cpp permutes q/k at conversion for llama-family
    # ("NORM" rope = interleaved pairs); qwen/gemma/phi3 use "NEOX" rope
    # (half-split pairs, no permutation).
    interleaved = arch in ("llama", "mistral", "mixtral", "moe")

    # MoE: llama.cpp keeps arch "llama" for Mixtral and uses dedicated
    # qwen2moe/qwen3moe arch strings; expert_count>0 selects models/moe.
    num_experts = geti("expert_count", 0)
    arch_out = arch
    if num_experts:
        arch_out = {"llama": "mixtral", "qwen2moe": "qwen2_moe",
                    "qwen3moe": "qwen3_moe"}.get(arch, arch)
    pattern = None
    if arch == "gemma2":
        pattern = 2
    elif arch == "gemma3":
        pattern = 6
    attn_scale = None
    if arch == "gemma2":
        # query_pre_attn_scalar: 27B (46 layers) uses hidden/heads;
        # 2B/9B use head_dim (llama.cpp keys the same way off the
        # layer count — the old unconditional hidden/heads inflated
        # 2B/9B attention logits ~6-7%). head_dim**-0.5 is the
        # runtime default, so None is correct for 2B/9B.
        if geti("block_count", 32) == 46:
            attn_scale = float(heads / hidden) ** 0.5
    elif arch == "gemma3":
        attn_scale = 256.0 ** -0.5
    softcap_a = float(md.get(f"{p}.attn_logit_softcapping", 0.0)) or None
    softcap_f = float(md.get(f"{p}.final_logit_softcapping", 0.0)) or None

    return ModelConfig(
        vocab_size=int(vocab),
        hidden_size=hidden,
        num_layers=geti("block_count", 32),
        num_heads=heads,
        num_kv_heads=kv_heads,
        intermediate_size=geti("feed_forward_length", 0) or None,
        head_dim=geti("attention.key_length", 0) or None,
        rope_theta=getf("rope.freq_base", 10000.0),
        rope_mode=(RopeMode.INTERLEAVED if interleaved else RopeMode.HALF),
        rope_local_theta=(getf("rope.local_freq_base", 10000.0)
                          if arch == "gemma3" else None),
        rms_norm_eps=getf("attention.layer_norm_rms_epsilon", 1e-5),
        max_seq_len=geti("context_length", 2048),
        # Mistral/Mixtral GGUFs carry e.g. llama.attention.sliding_window
        # (llama.cpp convention); 0/absent = full causal attention.
        sliding_window=geti("attention.sliding_window", 0) or None,
        sliding_window_pattern=pattern,
        attn_bias=arch in ("qwen2", "qwen2moe"),
        qk_norm=arch in ("qwen3", "qwen3moe", "gemma3"),
        num_experts=num_experts,
        experts_per_token=geti("expert_used_count", 2),
        moe_intermediate_size=geti("expert_feed_forward_length", 0)
        or None,
        shared_expert_size=geti("expert_shared_feed_forward_length", 0)
        or None,
        norm_topk_prob=bool(md.get(f"{p}.expert_weights_norm",
                                   arch != "qwen2moe")),
        scale_embeddings=is_gemma,
        norm_offset=is_gemma,
        hidden_act="gelu" if is_gemma else "silu",
        post_norms=arch in ("gemma2", "gemma3"),
        attn_scale=attn_scale,
        attn_logit_softcap=softcap_a,
        final_logit_softcap=softcap_f,
        name=str(md.get("general.name", arch)),
        architecture=arch_out,
        dtype=dtype,
        extra=extra,
    )


# torch dtype <-> its numpy/JAX name, as configs and TINQ headers store it
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
                torch.float16: "float16", torch.float64: "float64",
                torch.uint8: "uint8", torch.int8: "int8", torch.int16: "int16",
                torch.int32: "int32", torch.int64: "int64", torch.bool: "bool"}
_DTYPES_BY_NAME = {v: k for k, v in _DTYPE_NAMES.items()}


def dtype_name(dtype) -> str:
    """The numpy/JAX name of a torch dtype ("bfloat16", "uint8", ...)."""
    if dtype not in _DTYPE_NAMES:
        raise ValueError(f"no numpy name for {dtype}")
    return _DTYPE_NAMES[dtype]


def dtype_from_name(name: str):
    """The torch dtype of a numpy/JAX dtype name."""
    if name not in _DTYPES_BY_NAME:
        raise ModelFormatError(f"unsupported dtype {name!r}")
    return _DTYPES_BY_NAME[name]


def config_to_dict(config: ModelConfig) -> Dict[str, Any]:
    """JSON-safe serialization (tinq persistence)."""
    d = {
        "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size,
        "num_layers": config.num_layers,
        "num_heads": config.num_heads,
        "num_kv_heads": config.num_kv_heads,
        "intermediate_size": config.intermediate_size,
        "head_dim": config.head_dim,
        "rope_theta": config.rope_theta,
        "rope_mode": config.rope_mode.value,
        "rms_norm_eps": config.rms_norm_eps,
        "max_seq_len": config.max_seq_len,
        "sliding_window": config.sliding_window,
        "sliding_window_pattern": config.sliding_window_pattern,
        "tie_embeddings": config.tie_embeddings,
        "attn_bias": config.attn_bias,
        "qk_norm": config.qk_norm,
        "scale_embeddings": config.scale_embeddings,
        "norm_offset": config.norm_offset,
        "hidden_act": config.hidden_act,
        "post_norms": config.post_norms,
        "attn_scale": config.attn_scale,
        "attn_logit_softcap": config.attn_logit_softcap,
        "final_logit_softcap": config.final_logit_softcap,
        "rope_local_theta": config.rope_local_theta,
        # Granite scaling knobs — omitting them silently un-scaled
        # embeddings/residuals/logits after a TINQ round-trip
        "embedding_multiplier": config.embedding_multiplier,
        "residual_multiplier": config.residual_multiplier,
        "logits_scaling": config.logits_scaling,
        "rope_scaling": list(list(kv) for kv in config.rope_scaling),
        "rotary_pct": config.rotary_pct,
        "parallel_residual": config.parallel_residual,
        "alibi": config.alibi,
        "num_experts": config.num_experts,
        "experts_per_token": config.experts_per_token,
        "moe_intermediate_size": config.moe_intermediate_size,
        "norm_topk_prob": config.norm_topk_prob,
        "shared_expert_size": config.shared_expert_size,
        "scoring_func": config.scoring_func,
        "topk_method": config.topk_method,
        "n_group": config.n_group,
        "topk_group": config.topk_group,
        "routed_scaling_factor": config.routed_scaling_factor,
        "first_k_dense_replace": config.first_k_dense_replace,
        "kv_lora_rank": config.kv_lora_rank,
        "q_lora_rank": config.q_lora_rank,
        "qk_nope_head_dim": config.qk_nope_head_dim,
        "qk_rope_head_dim": config.qk_rope_head_dim,
        "v_head_dim": config.v_head_dim,
        "name": config.name,
        "architecture": config.architecture,
        "dtype": dtype_name(config.dtype),
        "extra": list(list(kv) for kv in config.extra),
    }
    return d


def config_from_dict(d: Dict[str, Any]) -> ModelConfig:
    d = dict(d)
    d["rope_mode"] = RopeMode(d.get("rope_mode", "half"))
    d["dtype"] = dtype_from_name(d.get("dtype", "bfloat16"))
    d["extra"] = tuple((k, v) for k, v in d.get("extra", []))
    d["rope_scaling"] = tuple(
        (k, v) for k, v in d.get("rope_scaling", []))
    return ModelConfig(**d)


# ---------------------------------------------------------------------------
# HF config.json -> ModelConfig (sidecar of safetensors checkpoints)
# ---------------------------------------------------------------------------

def config_from_hf_dict(hf: Dict[str, Any], dtype=None) -> ModelConfig:
    """Build a ModelConfig from a HuggingFace config.json dict.

    Covers the LLaMA-family architectures this framework runs natively:
    llama/mistral/mixtral/qwen2/qwen3/gemma/gemma2/gemma3/phi3 (plus
    gpt2). Unknown model_types fall back to llama-shaped defaults.
    """
    mt = str(hf.get("model_type", "llama")).lower()
    if mt == "gemma3" and "text_config" in hf:      # multimodal wrapper
        hf = {**hf["text_config"], "model_type": "gemma3"}
    arch = {"gemma3_text": "gemma3"}.get(mt, mt)

    if arch == "gpt2":
        # GPT2Config serializes n_embd/n_layer/n_head/n_positions —
        # the generic branch's hidden_size/num_hidden_layers defaults
        # built a bogus 4096-hidden/32-layer config for stock HF gpt2.
        hidden = int(hf.get("n_embd", hf.get("hidden_size", 768)))
        heads = int(hf.get("n_head", hf.get("num_attention_heads", 12)))
        return ModelConfig(
            vocab_size=int(hf.get("vocab_size", 50257)),
            hidden_size=hidden,
            num_layers=int(hf.get("n_layer",
                                  hf.get("num_hidden_layers", 12))),
            num_heads=heads,
            num_kv_heads=heads,
            head_dim=hidden // heads,
            intermediate_size=int(hf.get("n_inner") or 4 * hidden),
            rms_norm_eps=float(hf.get("layer_norm_epsilon", 1e-5)),
            max_seq_len=int(hf.get("n_positions",
                                   hf.get("max_position_embeddings",
                                          1024))),
            tie_embeddings=bool(hf.get("tie_word_embeddings", True)),
            name=str(hf.get("_name_or_path", "gpt2")) or "gpt2",
            architecture="gpt2",
            dtype=dtype or torch.bfloat16,
        )

    if arch == "bloom":
        hidden = int(hf.get("hidden_size", hf.get("n_embed", 4096)))
        heads = int(hf.get("n_head", hf.get("num_attention_heads", 32)))
        return ModelConfig(
            vocab_size=int(hf.get("vocab_size", 250880)),
            hidden_size=hidden,
            num_layers=int(hf.get("n_layer",
                                  hf.get("num_hidden_layers", 30))),
            num_heads=heads,
            num_kv_heads=heads,
            head_dim=hidden // heads,
            intermediate_size=4 * hidden,
            rms_norm_eps=float(hf.get("layer_norm_epsilon", 1e-5)),
            max_seq_len=int(hf.get("max_position_embeddings", 2048)),
            parallel_residual=False,
            alibi=True,
            rotary_pct=0.0,
            tie_embeddings=bool(hf.get("tie_word_embeddings", True)),
            name=str(hf.get("_name_or_path", "bloom")) or "bloom",
            architecture="bloom",
            dtype=dtype or torch.bfloat16,
        )

    if arch == "falcon":
        heads = int(hf.get("num_attention_heads", 71))
        hidden = int(hf.get("hidden_size", 4544))
        new_arch = bool(hf.get("new_decoder_architecture", False))
        if new_arch:
            kv = int(hf.get("num_kv_heads") or heads)
        else:
            kv = 1 if bool(hf.get("multi_query", True)) else heads
        use_alibi = bool(hf.get("alibi", False))
        return ModelConfig(
            vocab_size=int(hf.get("vocab_size", 65024)),
            hidden_size=hidden,
            num_layers=int(hf.get("num_hidden_layers", 32)),
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=int(hf.get("head_dim") or hidden // heads),
            intermediate_size=int(hf.get("ffn_hidden_size") or 4 * hidden),
            rope_theta=float(hf.get("rope_theta", 10000.0)),
            rope_mode=RopeMode.HALF,
            rms_norm_eps=float(hf.get("layer_norm_epsilon", 1e-5)),
            max_seq_len=int(hf.get("max_position_embeddings", 2048)),
            # new_decoder_architecture always takes the parallel path in
            # HF regardless of the parallel_attn flag.
            parallel_residual=new_arch or bool(hf.get("parallel_attn",
                                                      True)),
            alibi=use_alibi,
            rotary_pct=0.0 if use_alibi else 1.0,
            tie_embeddings=bool(hf.get("tie_word_embeddings", True)),
            name=str(hf.get("_name_or_path", "falcon")) or "falcon",
            architecture="falcon",
            dtype=dtype or torch.bfloat16,
        )

    if arch in ("deepseek_v2", "deepseek_v3"):
        v3 = arch == "deepseek_v3"
        n_shared = hf.get("n_shared_experts")
        moe_inter = int(hf.get("moe_intermediate_size", 1024))
        ds_scaling: Tuple[Tuple[str, Any], ...] = ()
        rs = hf.get("rope_scaling")
        if isinstance(rs, dict):
            ds_scaling = tuple(sorted(
                (str(k), v) for k, v in rs.items()
                if isinstance(v, (str, int, float))))
        return ModelConfig(
            vocab_size=int(hf.get("vocab_size", 102400)),
            hidden_size=int(hf.get("hidden_size", 4096)),
            num_layers=int(hf.get("num_hidden_layers", 30)),
            num_heads=int(hf.get("num_attention_heads", 32)),
            num_kv_heads=int(hf.get("num_key_value_heads",
                                    hf.get("num_attention_heads", 32))),
            intermediate_size=hf.get("intermediate_size"),
            rope_theta=float(hf.get("rope_theta", 10000.0)),
            rope_mode=RopeMode.INTERLEAVED,
            rope_scaling=ds_scaling,
            rms_norm_eps=float(hf.get("rms_norm_eps", 1e-6)),
            max_seq_len=int(hf.get("max_position_embeddings", 4096)),
            tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
            num_experts=int(hf.get("n_routed_experts", 64)),
            experts_per_token=int(hf.get("num_experts_per_tok", 6)),
            moe_intermediate_size=moe_inter,
            shared_expert_size=(moe_inter * int(n_shared)
                                if n_shared else None),
            norm_topk_prob=bool(hf.get("norm_topk_prob", v3)),
            scoring_func=str(hf.get("scoring_func",
                                    "sigmoid" if v3 else "softmax")),
            topk_method=str(hf.get("topk_method",
                                   "noaux_tc" if v3 else "greedy")),
            n_group=int(hf.get("n_group") or 1),
            topk_group=int(hf.get("topk_group") or 1),
            routed_scaling_factor=float(hf.get("routed_scaling_factor",
                                               1.0)),
            first_k_dense_replace=int(hf.get("first_k_dense_replace", 0)),
            kv_lora_rank=int(hf.get("kv_lora_rank", 512)),
            q_lora_rank=(int(hf["q_lora_rank"])
                         if hf.get("q_lora_rank") else None),
            qk_nope_head_dim=int(hf.get("qk_nope_head_dim", 128)),
            qk_rope_head_dim=int(hf.get("qk_rope_head_dim", 64)),
            v_head_dim=int(hf.get("v_head_dim", 128)),
            name=str(hf.get("_name_or_path", arch)) or arch,
            architecture=arch,
            dtype=dtype or torch.bfloat16,
        )

    hidden = int(hf.get("hidden_size", 4096))
    heads = int(hf.get("num_attention_heads", max(hidden // 128, 1)))
    is_gemma = arch.startswith("gemma")
    rope_scaling: Tuple[Tuple[str, Any], ...] = ()
    rs = hf.get("rope_scaling")
    if isinstance(rs, dict):
        rope_scaling = tuple(sorted(
            (str(k), v) for k, v in rs.items()
            if isinstance(v, (str, int, float))))

    # Gemma2: every ODD layer (1-indexed even) is global -> pattern 2.
    # Gemma3: layer_types has a global every 6th layer -> pattern 6
    # (sliding_window_pattern key on older configs).
    pattern = None
    if arch == "gemma2":
        pattern = 2
    elif arch == "gemma3":
        pattern = int(hf.get("sliding_window_pattern", 6))
    lt = hf.get("layer_types")
    if isinstance(lt, list) and "full_attention" in lt:
        pattern = lt.index("full_attention") + 1
    sliding = hf.get("sliding_window")
    if not hf.get("use_sliding_window", True):
        sliding = None           # Qwen2 ships the key but disables it
    if pattern == 1:
        sliding, pattern = None, None    # every layer full attention

    qpas = hf.get("query_pre_attn_scalar")
    # Granite: attention_multiplier IS the score scale (not **-0.5).
    attn_scale = float(qpas) ** -0.5 if qpas else None
    if hf.get("attention_multiplier") is not None:
        attn_scale = float(hf["attention_multiplier"])
    return ModelConfig(
        vocab_size=int(hf.get("vocab_size", 32000)),
        hidden_size=hidden,
        num_layers=int(hf.get("num_hidden_layers", 32)),
        num_heads=heads,
        num_kv_heads=int(hf.get("num_key_value_heads", heads)),
        intermediate_size=hf.get("intermediate_size"),
        head_dim=hf.get("head_dim"),
        rope_theta=float(hf.get("rope_theta", 10000.0)),
        rope_mode=RopeMode.HALF,
        rope_scaling=rope_scaling,
        rope_local_theta=(float(hf["rope_local_base_freq"])
                          if "rope_local_base_freq" in hf else None),
        rms_norm_eps=float(hf.get("rms_norm_eps",
                                  hf.get("layer_norm_eps", 1e-5))),
        max_seq_len=int(hf.get("max_position_embeddings", 2048)),
        rotary_pct=float(hf.get("rotary_pct",
                                hf.get("partial_rotary_factor", 1.0))),
        parallel_residual=bool(hf.get("use_parallel_residual",
                                      arch in ("gpt_neox", "phi"))),
        sliding_window=sliding,
        sliding_window_pattern=pattern,
        tie_embeddings=bool(hf.get("tie_word_embeddings", is_gemma)),
        attn_bias=bool(hf.get("attention_bias",
                              arch in ("qwen2", "qwen2_moe"))),
        qk_norm=arch in ("qwen3", "qwen3_moe", "gemma3", "olmoe"),
        # MoE (mixtral / qwen2_moe / qwen3_moe). Mixtral renormalizes
        # the top-k gates; Qwen2-MoE defaults to raw softmax probs.
        num_experts=int(hf.get("num_local_experts",
                               hf.get("num_experts", 0)) or 0),
        experts_per_token=int(hf.get("num_experts_per_tok", 2)),
        moe_intermediate_size=hf.get("moe_intermediate_size"),
        shared_expert_size=hf.get("shared_expert_intermediate_size"),
        norm_topk_prob=bool(hf.get("norm_topk_prob",
                                   arch not in ("qwen2_moe", "olmoe"))),
        scale_embeddings=is_gemma,
        norm_offset=is_gemma,
        hidden_act="gelu" if is_gemma else "silu",
        post_norms=arch in ("gemma2", "gemma3"),
        attn_scale=attn_scale,
        embedding_multiplier=hf.get("embedding_multiplier"),
        residual_multiplier=hf.get("residual_multiplier"),
        logits_scaling=hf.get("logits_scaling"),
        attn_logit_softcap=hf.get("attn_logit_softcapping"),
        final_logit_softcap=hf.get("final_logit_softcapping"),
        name=str(hf.get("_name_or_path", arch)) or arch,
        architecture=arch,
        dtype=dtype or torch.bfloat16,
    )
