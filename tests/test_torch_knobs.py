"""The llama-family knobs of the port against turboinfer_tpu on bridged params.

One tiny f32 config per family the JAX registry sends to its llama body
(D=32, GQA 4:2; one Gemma-3 also at its own D=256): Gemma-2
(alternating windows, both softcaps, (1 + w) norms, sandwich norms,
GeGLU, attn_scale, scaled and tied embeddings),
Mistral (a window on every layer), Qwen2 (q/k/v biases), Qwen3 (per-head
q/k norms, and the whole-projection form), Gemma-3 (q/k norms, pattern
6, a second RoPE base for the local layers) and Granite (the three
multipliers and attn_scale). Every norm weight is perturbed from its
init value, so the weights and the norm offset are both exercised.

Held against JAX: f32 logits of forward (fresh prefill, decode, chunked
prefill), of forward_paged_verify and forward_paged_decode, within 1e-4
(the same f32 arithmetic, another summation order), and greedy
trajectories of generate_batch, token for token. Gemma-2 runs twice: with
caps that bite (the scores reach several times the cap) and with the
published 50 / 30, which these scores stay below.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import turboinfer_tpu as ti
from turboinfer_tpu.config import InferenceConfig as JInferenceConfig
from turboinfer_tpu.config import ModelConfig as JModelConfig
from turboinfer_tpu.models import llama as jllama
from turboinfer_tpu_torch import bridge
from turboinfer_tpu_torch import config as tconfig
from turboinfer_tpu_torch.config import InferenceConfig
from turboinfer_tpu_torch.engine.engine import InferenceEngine
from turboinfer_tpu_torch.kernels.dispatch import prepare_params
from turboinfer_tpu_torch.models import gptoss as tgptoss
from turboinfer_tpu_torch.models import llama as tllama
from turboinfer_tpu_torch.models import moe as tmoe
from turboinfer_tpu_torch.models import registry

torch.set_num_threads(2)

LOGIT_ATOL = 1e-4

BASE = dict(vocab_size=300, hidden_size=128, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=256, max_seq_len=96)
GEMMA2 = dict(architecture="gemma2", sliding_window=11,
              sliding_window_pattern=2, norm_offset=True,
              scale_embeddings=True, post_norms=True, hidden_act="gelu",
              attn_scale=24.0 ** -0.5, tie_embeddings=True, rms_norm_eps=1e-6)
FAMILIES = {
    "gemma2": dict(GEMMA2, num_layers=3, attn_logit_softcap=0.5,
                   final_logit_softcap=0.7),
    "gemma2_published_caps": dict(GEMMA2, attn_logit_softcap=50.0,
                                  final_logit_softcap=30.0),
    "mistral": dict(architecture="mistral", sliding_window=13,
                    rope_theta=1e6),
    "qwen2": dict(architecture="qwen2", attn_bias=True, rope_theta=1e6),
    "qwen3": dict(architecture="qwen3", qk_norm=True),
    "qwen3_whole_qk_norm": dict(architecture="qwen3", qk_norm=True),
    "gemma3": dict(architecture="gemma3", num_layers=6, qk_norm=True,
                   sliding_window=9, sliding_window_pattern=6,
                   rope_local_theta=10000.0, rope_theta=1e6,
                   rope_scaling=(("factor", 8.0), ("rope_type", "linear")),
                   norm_offset=True, scale_embeddings=True, post_norms=True,
                   hidden_act="gelu", attn_scale=32.0 ** -0.5,
                   tie_embeddings=True),
    # Gemma-3 at its own head dim (D=256, as every Gemma-3 size), 4:2
    "gemma3_d256": dict(architecture="gemma3", num_layers=6, head_dim=256,
                        qk_norm=True, sliding_window=9,
                        sliding_window_pattern=6, rope_local_theta=10000.0,
                        rope_theta=1e6,
                        rope_scaling=(("factor", 8.0),
                                      ("rope_type", "linear")),
                        norm_offset=True, scale_embeddings=True,
                        post_norms=True, hidden_act="gelu",
                        attn_scale=256.0 ** -0.5, tie_embeddings=True),
    "granite": dict(architecture="granite", embedding_multiplier=12.0,
                    residual_multiplier=0.22, logits_scaling=8.0,
                    attn_scale=0.0625),
}

_PARAMS = {}


def _perturb(rng, a):
    return (np.asarray(a) + 0.2 * rng.normal(size=np.shape(a))).astype(
        np.float32)


def models(name):
    """(JAX config, JAX params, port config, port params), the same
    numbers: JAX init_params, norm weights perturbed, bridged."""
    if name not in _PARAMS:
        kw = dict(BASE, **FAMILIES[name])
        jcfg = JModelConfig(dtype=jnp.float32, **kw)
        tcfg = tconfig.ModelConfig(dtype=torch.float32, **kw)
        jp = jax.tree_util.tree_map(
            np.asarray, jllama.init_params(jax.random.PRNGKey(3), jcfg))
        rng = np.random.default_rng(len(name))
        layers = jp["layers"]
        if name == "qwen3_whole_qk_norm":      # OLMoE's [Hq*D] weights
            L = jcfg.num_layers
            layers["q_norm"] = np.ones((L, jcfg.q_dim), np.float32)
            layers["k_norm"] = np.ones((L, jcfg.kv_dim), np.float32)
        for k in [k for k in layers if "norm" in k]:
            layers[k] = _perturb(rng, layers[k])
        jp["final_norm"] = _perturb(rng, jp["final_norm"])
        tp = bridge.params_from_numpy(jp, device="cpu")
        if jcfg.tie_embeddings:
            tp["lm_head"] = tp["embed"].T
        jp = jax.tree_util.tree_map(jnp.asarray, jp)
        if jcfg.tie_embeddings:
            jp["lm_head"] = jp["embed"].T
        _PARAMS[name] = (jcfg, jp, tcfg, tp)
    return _PARAMS[name]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGIT_ATOL, rtol=1e-4)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_forward_prefill_decode_chunked_logits(name):
    """A fresh prefill past the window, two decode steps, then a chunked
    prefill of 12 more tokens at q_start 24..: every logit against JAX's,
    and the head-major caches equal."""
    jcfg, jp, tcfg, tp = models(name)
    tp = prepare_params(tp) if name == "qwen2" else tp   # the fused b_qkv
    rng = np.random.default_rng(1)
    B, S, T = 2, 24, 64
    toks = rng.integers(1, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    lens = np.array([24, 17], np.int32)
    jc = jllama.init_cache(jcfg, B, max_seq=T, fused=False)
    jl, jc = jllama.forward(jp, jcfg, jnp.asarray(toks), jc,
                            seq_lens=jnp.asarray(lens), fresh_prefill=True)
    tc = tllama.init_cache(tcfg, B, max_seq=T, device="cpu")
    tl, tc = tllama.forward(tp, tcfg, torch.from_numpy(toks), tc,
                            seq_lens=torch.from_numpy(lens),
                            fresh_prefill=True)
    for b, n in enumerate(lens):
        _close(tl[b, :n], jl[b, :n])
    nxt = np.asarray(jnp.argmax(jl[np.arange(B), lens - 1], -1)).astype(
        np.int32)
    for _ in range(2):
        jl, jc = jllama.forward(jp, jcfg, jnp.asarray(nxt[:, None]), jc)
        tl, tc = tllama.forward(tp, tcfg, torch.from_numpy(nxt[:, None]), tc)
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)
    chunk = rng.integers(1, jcfg.vocab_size, size=(B, 12)).astype(np.int32)
    jl, jc = jllama.forward(jp, jcfg, jnp.asarray(chunk), jc)
    tl, tc = tllama.forward(tp, tcfg, torch.from_numpy(chunk), tc)
    _close(tl, jl)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-5)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_forward_paged_logits(name):
    """forward_paged_verify (G=4) and forward_paged_decode over a random
    pool whose rows reach past the window, against JAX's."""
    jcfg, jp, tcfg, tp = models(name)
    rng = np.random.default_rng(7)
    L, P, page, B = jcfg.num_layers, 12, 8, 3
    Hkv, D = jcfg.kv_heads, jcfg.head_dim_
    kp = rng.normal(size=(L, P, Hkv, page, D)).astype(np.float32)
    vp = rng.normal(size=(L, P, Hkv, page, D)).astype(np.float32)
    table = np.array([[3, 7, 1, 5, 10], [8, 2, 11, 4, -1],
                      [6, 9, -1, -1, -1]], np.int32)
    lengths = np.array([29, 21, 5], np.int32)
    for G in (4, 1):
        tokens = rng.integers(1, jcfg.vocab_size, (B, G)).astype(np.int32)
        cache = bridge.paged_cache_from_numpy(kp, vp, table, lengths,
                                              device="cpu")
        if G == 1:
            want = jllama.forward_paged_decode(
                jp, jcfg, jnp.asarray(tokens[:, 0]), jnp.asarray(kp),
                jnp.asarray(vp), jnp.asarray(table), jnp.asarray(lengths))
            got = tllama.forward_paged_decode(
                tp, tcfg, torch.from_numpy(tokens[:, 0]), cache.k_pages,
                cache.v_pages, cache.block_table, cache.lengths)
        else:
            want = jllama.forward_paged_verify(
                jp, jcfg, jnp.asarray(tokens), jnp.asarray(kp),
                jnp.asarray(vp), jnp.asarray(table), jnp.asarray(lengths))
            got = tllama.forward_paged_verify(
                tp, tcfg, torch.from_numpy(tokens), cache.k_pages,
                cache.v_pages, cache.block_table, cache.lengths)
        _close(got[0], want[0])
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_generate_batch_greedy_matches_jax(name):
    """Greedy trajectories of generate_batch, prompts on both sides of
    the window, token for token with the JAX engine's."""
    jcfg, jp, tcfg, tp = models(name)
    icfg = dict(max_seq_len=jcfg.max_seq_len)
    je = ti.InferenceEngine(jp, jcfg, JInferenceConfig(**icfg))
    te = InferenceEngine(tp, tcfg, InferenceConfig(**icfg), device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, jcfg.vocab_size, size=n).tolist()
               for n in (5, 30, 14)]
    jres = je.generate_batch(prompts, 20, temperature=0.0)
    tres = te.generate_batch(prompts, 20, temperature=0.0)
    for a, b in zip(jres, tres):
        assert b.tokens == a.tokens and b.stop_reason == a.stop_reason


def test_gemma2_27b_config_matches_the_jax_mapping():
    """gemma2_27b_config() against the JAX loader's mapping of
    google/gemma-2-27b's config.json keys."""
    from turboinfer_tpu.loader.mapping import config_from_hf_dict
    hf = {"architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2",
          "vocab_size": 256000, "hidden_size": 4608,
          "num_hidden_layers": 46, "num_attention_heads": 32,
          "num_key_value_heads": 16, "head_dim": 128,
          "intermediate_size": 36864, "rope_theta": 10000.0,
          "rms_norm_eps": 1e-6, "max_position_embeddings": 8192,
          "sliding_window": 4096, "query_pre_attn_scalar": 144,
          "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0,
          "hidden_activation": "gelu_pytorch_tanh",
          "tie_word_embeddings": True}
    j = config_from_hf_dict(hf)
    t = tconfig.gemma2_27b_config()
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "kv_heads", "head_dim_", "ffn_dim", "rope_theta",
              "rms_norm_eps", "max_seq_len", "sliding_window",
              "sliding_window_pattern", "attn_logit_softcap",
              "final_logit_softcap", "attn_scale", "norm_offset",
              "scale_embeddings", "post_norms", "hidden_act",
              "tie_embeddings", "architecture", "qk_norm", "attn_bias"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.rope_mode.value == j.rope_mode.value
    tllama.check_supported(t)
    assert [tllama.layer_window(t, li) for li in range(4)] == [
        4096, None, 4096, None]


def test_gemma3_12b_config_matches_the_jax_mapping():
    """gemma3_12b_config() against the JAX loader's mapping of
    google/gemma-3-12b-pt's config.json: the multimodal wrapper's
    text_config keys (layer_types giving a global layer every 6th,
    linear rope_scaling factor 8, rope_local_base_freq,
    query_pre_attn_scalar 256)."""
    from turboinfer_tpu.loader.mapping import config_from_hf_dict
    layer_types = (["sliding_attention"] * 5 + ["full_attention"]) * 8
    hf = {"architectures": ["Gemma3ForConditionalGeneration"],
          "model_type": "gemma3",
          "text_config": {
              "model_type": "gemma3_text", "vocab_size": 262208,
              "hidden_size": 3840, "num_hidden_layers": 48,
              "num_attention_heads": 16, "num_key_value_heads": 8,
              "head_dim": 256, "intermediate_size": 15360,
              "rope_theta": 1000000.0, "rope_local_base_freq": 10000.0,
              "rope_scaling": {"factor": 8.0, "rope_type": "linear"},
              "rms_norm_eps": 1e-6, "max_position_embeddings": 131072,
              "sliding_window": 1024, "layer_types": layer_types,
              "query_pre_attn_scalar": 256,
              "attn_logit_softcapping": None,
              "final_logit_softcapping": None,
              "hidden_activation": "gelu_pytorch_tanh",
              "tie_word_embeddings": True}}
    j = config_from_hf_dict(hf)
    t = tconfig.gemma3_12b_config()
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "kv_heads", "head_dim_", "ffn_dim", "rope_theta",
              "rope_local_theta", "rope_scaling", "rms_norm_eps",
              "max_seq_len", "sliding_window", "sliding_window_pattern",
              "attn_logit_softcap", "final_logit_softcap", "attn_scale",
              "norm_offset", "scale_embeddings", "post_norms", "hidden_act",
              "tie_embeddings", "architecture", "qk_norm", "attn_bias"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.rope_mode.value == j.rope_mode.value
    assert (t.sliding_window_pattern, t.attn_scale, t.head_dim_) == (
        6, 1 / 16, 256)
    tllama.check_supported(t)
    assert [tllama.layer_window(t, li) for li in range(12)] == [
        1024] * 5 + [None] + [1024] * 5 + [None]


def test_families_are_accepted_and_others_refused():
    for name in FAMILIES:
        tllama.check_supported(models(name)[2])
    for arch in tllama.ARCHITECTURES:
        assert registry.get_model(arch) is tllama
    for knob in (dict(parallel_residual=True), dict(alibi=True),
                 dict(rotary_pct=0.5), dict(architecture="gpt2")):
        with pytest.raises(NotImplementedError):
            tllama.check_supported(tconfig.ModelConfig(**BASE, **knob))
    # the MoE and GPT-OSS bodies still refuse the knobs they were never
    # held to against JAX
    moe = dict(BASE, num_experts=4, architecture="mixtral")
    for knob in (dict(attn_logit_softcap=30.0), dict(norm_offset=True),
                 dict(post_norms=True), dict(rope_local_theta=1e4)):
        with pytest.raises(NotImplementedError):
            tmoe.check_supported(tconfig.ModelConfig(**moe, **knob))
        with pytest.raises(NotImplementedError):
            tgptoss.check_supported(tconfig.ModelConfig(
                **dict(moe, architecture="gpt_oss"), **knob))
