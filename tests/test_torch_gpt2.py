"""GPT-2 of the port (models/gpt2.py) against turboinfer_tpu.

A tiny f32 GPT-2 (MHA 4 heads of 16, learned positions, tied head):
the JAX package's init_params, every LayerNorm weight and bias perturbed
from its init value, bridged to the port. Held against JAX: logits of a
fresh prefill, two decode steps and a chunked prefill (q_start 26 and
19, with test_torch_neox's jax_chunk_positions) within 1e-4 over a
model-dtype cache and within 1e-3 of max|logit| over int8 and fp8
caches; positions past the table clip as JAX clips them; greedy
trajectories of generate_batch over each cache dtype; the quantizer's
codes; the assembler on HF (Conv1D [in, out]) names array for array,
and the GGUF round trip of JAX's tests/test_gpt2.py through the port's
writer and loader; the registry, param_count, reset_cache and the
cacheless forward.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import turboinfer_tpu as ti
from turboinfer_tpu.config import InferenceConfig as JInferenceConfig
from turboinfer_tpu.config import ModelConfig as JModelConfig
from turboinfer_tpu.config import QuantizationConfig as JQuantCfg
from turboinfer_tpu.config import QuantType as JQuantType
from turboinfer_tpu.loader import mapping as jmapping
from turboinfer_tpu.models import common as jcommon
from turboinfer_tpu.models import gpt2 as jgpt2
from turboinfer_tpu.quant import quantizer as jquantizer
from turboinfer_tpu_torch import bridge
from turboinfer_tpu_torch import config as tconfig
from turboinfer_tpu_torch.config import InferenceConfig
from turboinfer_tpu_torch.config import QuantizationConfig, QuantType
from turboinfer_tpu_torch.engine.engine import InferenceEngine
from turboinfer_tpu_torch.loader import gguf as tgguf
from turboinfer_tpu_torch.loader import loader as tloader
from turboinfer_tpu_torch.loader import mapping as tmapping
from turboinfer_tpu_torch.models import common as tcommon
from turboinfer_tpu_torch.models import gpt2 as tgpt2
from turboinfer_tpu_torch.models import registry
from turboinfer_tpu_torch.quant import quantizer as tquantizer

from test_torch_neox import (KINDS, KV, _close, _same_tree,  # noqa: F401
                             jax_chunk_positions, jax_to_numpy)

torch.set_num_threads(2)

CFG = dict(vocab_size=300, hidden_size=64, num_layers=2, num_heads=4,
           num_kv_heads=4, intermediate_size=160, max_seq_len=64,
           architecture="gpt2", name="tiny-gpt2")
_P = {}


def model(quant=False):
    """(JAX config, JAX params, port config, port params), the same f32
    numbers (quant: the JAX quantizer's int4 g=32 output, bridged)."""
    if quant not in _P:
        jcfg = JModelConfig(dtype=jnp.float32, **CFG)
        tcfg = tconfig.ModelConfig(dtype=torch.float32, **CFG)
        jp = jax_to_numpy(jgpt2.init_params(jax.random.PRNGKey(2), jcfg))
        rng = np.random.default_rng(2)
        for k in [k for k in jp["layers"] if k.startswith(("ln", "b"))]:
            a = jp["layers"][k]
            jp["layers"][k] = (a + 0.2 * rng.normal(size=a.shape)).astype(
                np.float32)
        for k in ("final_norm_w", "final_norm_b"):
            jp[k] = (jp[k] + 0.2 * rng.normal(size=jp[k].shape)).astype(
                np.float32)
        tp = bridge.params_from_numpy(jp, device="cpu")
        tp["lm_head"] = tp["embed"].T                      # tied
        jp = jax.tree_util.tree_map(jnp.asarray, jp)
        jp["lm_head"] = jp["embed"].T
        if quant:
            jp = jquantizer.quantize_params(
                jp, JQuantCfg(type=JQuantType.INT4, group_size=32))
            tp = bridge.params_from_numpy(jax_to_numpy(jp), device="cpu")
        _P[quant] = (jcfg, jp, tcfg, tp)
    return _P[quant]


@pytest.mark.parametrize("kind", **KINDS)
def test_gpt2_forward_prefill_decode_chunked_logits(kind,
                                                    jax_chunk_positions):
    """A fresh prefill (24 and 17 tokens), two decode steps, a chunked
    prefill of 12 tokens, then decode steps past the 64-row position
    table's end clip as in JAX: every logit against JAX's."""
    jcfg, jp, tcfg, tp = model()
    rng = np.random.default_rng(1)
    B, S, T = 2, 24, 96
    toks = rng.integers(1, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    lens = np.array([24, 17], np.int32)
    jkw = {} if kind is None else dict(dtype=KV[kind][0])
    tkw = {} if kind is None else dict(dtype=KV[kind][1])
    jc = jgpt2.init_cache(jcfg, B, max_seq=T, fused=False, **jkw)
    tc = tgpt2.init_cache(tcfg, B, max_seq=T, device="cpu", **tkw)
    jl, jc = jgpt2.forward(jp, jcfg, jnp.asarray(toks), jc,
                           seq_lens=jnp.asarray(lens))
    tl, tc = tgpt2.forward(tp, tcfg, torch.from_numpy(toks), tc,
                           seq_lens=torch.from_numpy(lens),
                           fresh_prefill=True)
    for b, n in enumerate(lens):
        _close(tl[b, :n], jl[b, :n], kind)
    nxt = np.asarray(jnp.argmax(jl[np.arange(B), lens - 1], -1)).astype(
        np.int32)
    for _ in range(2):
        jl, jc = jgpt2.forward(jp, jcfg, jnp.asarray(nxt[:, None]), jc)
        tl, tc = tgpt2.forward(tp, tcfg, torch.from_numpy(nxt[:, None]), tc)
        _close(tl, jl, kind)
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)
    for n in (12, 30):             # the second chunk runs past position 63
        chunk = rng.integers(1, jcfg.vocab_size, size=(B, n)).astype(np.int32)
        jl, jc = jgpt2.forward(jp, jcfg, jnp.asarray(chunk), jc)
        tl, tc = tgpt2.forward(tp, tcfg, torch.from_numpy(chunk), tc)
        _close(tl, jl, kind)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


@pytest.mark.parametrize("kind", **KINDS)
def test_gpt2_generate_batch_greedy_matches_jax(kind):
    jcfg, jp, tcfg, tp = model()
    icfg = dict(max_seq_len=jcfg.max_seq_len, eos_token_id=-1,
                kv_cache_dtype="model" if kind is None else kind)
    je = ti.InferenceEngine(jp, jcfg, JInferenceConfig(**icfg))
    te = InferenceEngine(tp, tcfg, InferenceConfig(**icfg), device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, jcfg.vocab_size, size=n).tolist()
               for n in (5, 30, 14)]
    jres = je.generate_batch(prompts, 16, temperature=0.0)
    tres = te.generate_batch(prompts, 16, temperature=0.0)
    for a, b in zip(jres, tres):
        assert b.tokens == a.tokens and b.stop_reason == a.stop_reason


def test_gpt2_quantized_codes_and_logits_match_jax():
    """quantize_params int4 g=32 of the tied tree: the four products and
    the head byte for byte with JAX's; the quantized prefill logits."""
    tp = model()[3]
    jcfg, jq, tcfg, tq = model(quant=True)
    got = tquantizer.quantize_params(
        tp, QuantizationConfig(type=QuantType.INT4, group_size=32))
    want = jax_to_numpy(jq)
    assert sorted(got["layers"]) == sorted(want["layers"])
    for slot in ("w_qkv", "wo", "w_fc", "w_proj"):
        g, w = got["layers"][slot], want["layers"][slot]
        np.testing.assert_array_equal(g.data.numpy(), w["data"])
        np.testing.assert_array_equal(g.scales.view(torch.int16).numpy(),
                                      w["scales"].view(np.int16))
    np.testing.assert_array_equal(got["lm_head"].data.numpy(),
                                  want["lm_head"]["data"])
    toks = np.random.default_rng(3).integers(
        1, jcfg.vocab_size, size=(1, 20)).astype(np.int32)
    jl, _ = jgpt2.forward(jq, jcfg, jnp.asarray(toks),
                          jgpt2.init_cache(jcfg, 1, max_seq=32, fused=False))
    tl, _ = tgpt2.forward(tq, tcfg, torch.from_numpy(toks),
                          tgpt2.init_cache(tcfg, 1, max_seq=32, device="cpu"),
                          fresh_prefill=True)
    _close(tl, jl)


def _hf_names(jp, jcfg, lm_head: bool):
    """HF GPT-2 names (Conv1D weights [in, out]) from a JAX tree."""
    t = {"transformer.wte.weight": jp["embed"],
         "transformer.wpe.weight": jp["pos_embed"],
         "transformer.ln_f.weight": jp["final_norm_w"],
         "transformer.ln_f.bias": jp["final_norm_b"]}
    hf = dict(ln1_w="ln_1.weight", ln1_b="ln_1.bias", w_qkv="attn.c_attn.weight",
              b_qkv="attn.c_attn.bias", wo="attn.c_proj.weight",
              bo="attn.c_proj.bias", ln2_w="ln_2.weight", ln2_b="ln_2.bias",
              w_fc="mlp.c_fc.weight", b_fc="mlp.c_fc.bias",
              w_proj="mlp.c_proj.weight", b_proj="mlp.c_proj.bias")
    for i in range(jcfg.num_layers):
        for slot, name in hf.items():
            t[f"transformer.h.{i}.{name}"] = jp["layers"][slot][i]
    if lm_head:
        t["lm_head.weight"] = jp["lm_head"].T
    return {k: np.ascontiguousarray(v, np.float32) for k, v in t.items()}


@pytest.mark.parametrize("lm_head", [False, True], ids=["tied", "untied"])
def test_gpt2_assembler_matches_jax(lm_head):
    jcfg, jp, tcfg, _ = model()
    t = _hf_names(jax_to_numpy(jp), jcfg, lm_head)
    for dtype in ("float32", "bfloat16"):
        got = tmapping.assemble_params_gpt2(
            t.__getitem__, list(t), tcfg, dtype=getattr(torch, dtype),
            device="cpu")
        want = jmapping.assemble_params_gpt2(t.__getitem__, list(t), jcfg,
                                             dtype=getattr(jnp, dtype))
        _same_tree(got, want)
    assert tmapping.assemble_for(tcfg) is tmapping.assemble_params_gpt2


def test_gpt2_gguf_roundtrip(tmp_path):
    """JAX's tests/test_gpt2.py GGUF round trip through the port: GGUF
    names ([out, in] weights), written by the port's writer, loaded by
    load_model_data (config from the gpt2.* metadata), logits equal to
    the in-memory model's and to the JAX loader's tree and logits."""
    jcfg, jp, tcfg, tp = model()
    p = jax_to_numpy(jp)
    t = {"token_embd.weight": p["embed"], "position_embd.weight":
         p["pos_embed"], "output_norm.weight": p["final_norm_w"],
         "output_norm.bias": p["final_norm_b"],
         "output.weight": p["lm_head"].T}
    names = dict(ln1_w="attn_norm.weight", ln1_b="attn_norm.bias",
                 w_qkv="attn_qkv.weight", b_qkv="attn_qkv.bias",
                 wo="attn_output.weight", bo="attn_output.bias",
                 ln2_w="ffn_norm.weight", ln2_b="ffn_norm.bias",
                 w_fc="ffn_up.weight", b_fc="ffn_up.bias",
                 w_proj="ffn_down.weight", b_proj="ffn_down.bias")
    for i in range(jcfg.num_layers):
        for slot, name in names.items():
            a = p["layers"][slot][i]
            t[f"blk.{i}.{name}"] = a.T if a.ndim == 2 else a
    t = {k: np.ascontiguousarray(v, np.float32) for k, v in t.items()}
    md = {"general.architecture": "gpt2", "general.name": "tiny-gpt2",
          "gpt2.embedding_length": jcfg.hidden_size,
          "gpt2.block_count": jcfg.num_layers,
          "gpt2.attention.head_count": jcfg.num_heads,
          "gpt2.feed_forward_length": jcfg.intermediate_size,
          "gpt2.context_length": jcfg.max_seq_len}
    path = str(tmp_path / "tiny-gpt2.gguf")
    tgguf.write_gguf(path, md, t)
    data = tloader.load_model_data(path, dtype=torch.float32, device="cpu")
    from turboinfer_tpu.loader import loader as jloader
    jdata = jloader.load_model_data(path, dtype=jnp.float32)
    assert data.config.architecture == "gpt2"
    _same_tree(data.params, jdata.params)
    toks = np.asarray([[1, 5, 42, 7]], np.int32)
    want = tgpt2.forward_no_cache(tp, tcfg, torch.from_numpy(toks))
    got = tgpt2.forward_no_cache(
        data.params, data.config.replace(dtype=torch.float32),
        torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    jl = jgpt2.forward_no_cache(jdata.params,
                                jdata.config.replace(dtype=jnp.float32),
                                jnp.asarray(toks))
    _close(got, jl)


def test_gpt2_registry_helpers_and_nocache():
    """The registry routes gpt2 here; param_count and reset_cache as
    JAX's; forward_no_cache against JAX's; grouped heads refused."""
    jcfg, jp, tcfg, tp = model()
    assert registry.get_model("gpt2") is tgpt2
    assert tcommon.param_count(tp) == jcommon.param_count(jp)
    toks = np.random.default_rng(9).integers(
        1, jcfg.vocab_size, size=(2, 11)).astype(np.int32)
    _close(tgpt2.forward_no_cache(tp, tcfg, torch.from_numpy(toks)),
           jgpt2.forward_no_cache(jp, jcfg, jnp.asarray(toks)))
    c = tgpt2.init_cache(tcfg, 2, max_seq=16, dtype=torch.int8, device="cpu")
    c = c._replace(length=torch.ones(2, dtype=torch.int32))
    z = tgpt2.reset_cache(c)
    assert z.k_scale is not None and not z.length.any()
    with pytest.raises(Exception):
        tgpt2.check_supported(tcfg.replace(num_kv_heads=2))
