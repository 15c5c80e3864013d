"""The NeoX family of the port (models/neox.py) against turboinfer_tpu.

Tiny f32 configs of each family the JAX registry sends to its NeoX
body: GPT-NeoX with the parallel residual and rotary_pct 0.25 and a
sequential one at 0.5, Phi (rotary 0.4, a biased head), Falcon legacy
MQA (a group of 12 query heads on one kv head), Falcon's new
architecture (GQA 8:2), Falcon-RW (ALiBi, sequential, slopes times
D^-0.5) and BLOOM (ALiBi at 6 heads, so the odd slopes of a
non-power-of-two count, and the embedding LayerNorm). The JAX package's
init_params draw the weights; LayerNorm weights and every bias are
perturbed from their init values (and BLOOM's embedding LayerNorm and
Phi's head bias added), bridged to the port.

Held against JAX: f32 logits of a fresh prefill, two decode steps and a
chunked prefill within 1e-4 over a model-dtype cache, and over int8 and
fp8 caches within 1e-3 of max|logit| (an 8-bit code one step apart
where the two packages' f32 differ by an ulp upstream); greedy
trajectories of generate_batch token for token; quantize_params codes
byte for byte; each assembler array for array on the same tensor dict;
alibi_slopes at 71 heads. The Falcon configs run these checks in
tests/test_torch_falcon.py.
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
from turboinfer_tpu.core.qtensor import QEmbed as JQEmbed
from turboinfer_tpu.core.qtensor import QTensor as JQTensor
from turboinfer_tpu.kernels import ops as jops
from turboinfer_tpu.loader import mapping as jmapping
from turboinfer_tpu.models import neox as jneox
from turboinfer_tpu.quant import quantizer as jquantizer
from turboinfer_tpu_torch import bridge
from turboinfer_tpu_torch import config as tconfig
from turboinfer_tpu_torch.config import InferenceConfig
from turboinfer_tpu_torch.config import QuantizationConfig, QuantType
from turboinfer_tpu_torch.engine.engine import InferenceEngine
from turboinfer_tpu_torch.kernels import ops as tops
from turboinfer_tpu_torch.loader import mapping as tmapping
from turboinfer_tpu_torch.models import neox as tneox
from turboinfer_tpu_torch.quant import quantizer as tquantizer

torch.set_num_threads(2)

LOGIT_ATOL = 1e-4
KV = {"int8": (jnp.int8, torch.int8), "fp8": (jnp.uint8, torch.uint8)}
KV_LOGIT_RTOL = 1e-3     # of max|logit|: codes one step apart

BASE = dict(vocab_size=300, num_layers=2, intermediate_size=192,
            max_seq_len=96)
FAMILIES = {
    "neox_parallel": dict(architecture="gpt_neox", hidden_size=128,
                          num_heads=4, rotary_pct=0.25,
                          parallel_residual=True),
    "neox_sequential": dict(architecture="gpt_neox", hidden_size=128,
                            num_heads=4, rotary_pct=0.5, rope_theta=1e6),
    "phi": dict(architecture="phi", hidden_size=128, num_heads=4,
                rotary_pct=0.4, parallel_residual=True),
    # legacy Falcon-7B layout: one kv head, here a group of 12
    "falcon_mqa": dict(architecture="falcon", hidden_size=192, num_heads=12,
                       num_kv_heads=1, parallel_residual=True),
    # new decoder architecture (40B/180B): grouped kv heads
    "falcon_gqa": dict(architecture="falcon", hidden_size=128, num_heads=8,
                       num_kv_heads=2, parallel_residual=True),
    # Falcon-RW: ALiBi (slopes times D^-0.5), sequential
    "falcon_rw": dict(architecture="falcon", hidden_size=128, num_heads=4,
                      alibi=True, rotary_pct=0.0),
    "bloom": dict(architecture="bloom", hidden_size=96, num_heads=6,
                  alibi=True, rotary_pct=0.0),
}
_P = {}


def jax_to_numpy(tree):
    """The JAX half of the bridge: a JAX param tree as numpy."""
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, JQTensor):
        return {"data": np.asarray(tree.data),
                "scales": np.asarray(tree.scales),
                "zero_points": None if tree.zero_points is None
                else np.asarray(tree.zero_points), "bits": tree.bits,
                "group_size": tree.group_size, "shape": tree.shape}
    if isinstance(tree, JQEmbed):
        return {"data": np.asarray(tree.data),
                "row_scales": np.asarray(tree.scales)}
    return np.asarray(tree)


def _perturbed(name, jcfg, jp):
    """JAX init_params as numpy with every LayerNorm weight and bias moved
    off its init value, plus BLOOM's embedding LayerNorm and Phi's head
    bias."""
    rng = np.random.default_rng(len(name))
    jp = jax_to_numpy(jp)

    def move(a):
        return (a + 0.2 * rng.normal(size=a.shape)).astype(np.float32)
    layers = jp["layers"]
    for k in [k for k in layers if k.startswith(("ln", "b"))]:
        layers[k] = move(layers[k])
    for k in ("final_norm_w", "final_norm_b"):
        jp[k] = move(jp[k])
    H, V = jcfg.hidden_size, jcfg.vocab_size
    if jcfg.architecture == "bloom":
        jp["embed_norm_w"] = move(np.ones(H, np.float32))
        jp["embed_norm_b"] = move(np.zeros(H, np.float32))
    if jcfg.architecture == "phi":
        jp["lm_head_b"] = move(np.zeros(V, np.float32))
    return jp


def models(name, quant=False):
    """(JAX config, JAX params, port config, port params) on the same f32
    numbers (quant: the JAX quantizer's int4 g=32 output, bridged)."""
    if (name, quant) not in _P:
        kw = dict(BASE, **FAMILIES[name])
        jcfg = JModelConfig(dtype=jnp.float32, **kw)
        tcfg = tconfig.ModelConfig(dtype=torch.float32, **kw)
        jp = _perturbed(name, jcfg,
                        jneox.init_params(jax.random.PRNGKey(1), jcfg))
        jp = jax.tree_util.tree_map(jnp.asarray, jp)
        if quant:
            jp = jquantizer.quantize_params(
                jp, JQuantCfg(type=JQuantType.INT4, group_size=32))
        tp = bridge.params_from_numpy(jax_to_numpy(jp), device="cpu")
        _P[name, quant] = (jcfg, jp, tcfg, tp)
    return _P[name, quant]


def _close(got, want, kind=None):
    want = np.asarray(want)
    got = got.numpy()
    if kind is None:
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=KV_LOGIT_RTOL * np.abs(want).max())


KINDS = dict(argvalues=[None, "int8", "fp8"], ids=["model", "int8", "fp8"])


@pytest.fixture
def jax_chunk_positions(monkeypatch):
    """The JAX package's gpt2/neox layers hand attention_prefill q_start
    but no positions; its Pallas kernel places the queries at q_start,
    while the jnp reference (what a CPU run, or a shape the kernel
    declines, computes) drops q_start and masks as if the chunk started
    at position 0. A chunked prefill is compared with the kernel's
    semantics: positions = q_start + s, passed through."""
    from turboinfer_tpu.kernels import dispatch as jdispatch
    orig = jdispatch.attention_prefill

    def placed(q, k, v, *, positions=None, q_start=None, **kw):
        if positions is None and q_start is not None:
            positions = q_start[:, None] + jnp.arange(q.shape[1])[None, :]
        return orig(q, k, v, positions=positions, q_start=q_start, **kw)
    monkeypatch.setattr(jdispatch, "attention_prefill", placed)


# the Falcon configs run in tests/test_torch_falcon.py, through the same
# checks
NEOX = [n for n in FAMILIES if not n.startswith("falcon")]


@pytest.mark.parametrize("kind", **KINDS)
@pytest.mark.parametrize("name", NEOX)
def test_forward_prefill_decode_chunked_logits(name, kind,
                                              jax_chunk_positions):
    check_forward(name, kind)


@pytest.mark.parametrize("kind", **KINDS)
@pytest.mark.parametrize("name", NEOX)
def test_generate_batch_greedy_matches_jax(name, kind):
    check_greedy(name, kind)


def check_forward(name, kind):
    """A fresh prefill (24 and 17 tokens), two decode steps, then a
    chunked prefill of 12 tokens at q_start 26 and 19: every logit
    against JAX's (with jax_chunk_positions), over a model-dtype, int8
    or fp8 cache; over the model-dtype cache the chunk's logits also
    equal a cacheless forward of each row's whole sequence."""
    jcfg, jp, tcfg, tp = models(name)
    rng = np.random.default_rng(1)
    B, S, T = 2, 24, 64
    toks = rng.integers(1, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    lens = np.array([24, 17], np.int32)
    jkw = {} if kind is None else dict(dtype=KV[kind][0])
    tkw = {} if kind is None else dict(dtype=KV[kind][1])
    jc = jneox.init_cache(jcfg, B, max_seq=T, fused=False, **jkw)
    tc = tneox.init_cache(tcfg, B, max_seq=T, device="cpu", **tkw)
    jl, jc = jneox.forward(jp, jcfg, jnp.asarray(toks), jc,
                           seq_lens=jnp.asarray(lens))
    tl, tc = tneox.forward(tp, tcfg, torch.from_numpy(toks), tc,
                           seq_lens=torch.from_numpy(lens),
                           fresh_prefill=True)
    for b, n in enumerate(lens):
        _close(tl[b, :n], jl[b, :n], kind)
    nxt = np.asarray(jnp.argmax(jl[np.arange(B), lens - 1], -1)).astype(
        np.int32)
    fed = []
    for _ in range(2):
        fed.append(nxt)
        jl, jc = jneox.forward(jp, jcfg, jnp.asarray(nxt[:, None]), jc)
        tl, tc = tneox.forward(tp, tcfg, torch.from_numpy(nxt[:, None]), tc)
        _close(tl, jl, kind)
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)
    fed = np.stack(fed)
    chunk = rng.integers(1, jcfg.vocab_size, size=(B, 12)).astype(np.int32)
    jl, jc = jneox.forward(jp, jcfg, jnp.asarray(chunk), jc)
    tl, tc = tneox.forward(tp, tcfg, torch.from_numpy(chunk), tc)
    _close(tl, jl, kind)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    if kind is None:
        for b, n in enumerate(lens):
            seq = np.concatenate([toks[b, :n], fed[:, b], chunk[b]])[None]
            full = tneox.forward_no_cache(tp, tcfg, torch.from_numpy(seq))
            _close(tl[b], full[0, -12:].numpy())


def check_greedy(name, kind):
    """Greedy trajectories of generate_batch, token for token with the
    JAX engine's, over each cache dtype."""
    jcfg, jp, tcfg, tp = models(name)
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


@pytest.mark.parametrize("name", ["bloom"])
def test_quantized_codes_and_logits_match_jax(name):
    """quantize_params (int4 g=32) on the same f32 tree: every code,
    scale and the tree's slots byte for byte with the JAX quantizer's
    (w_qkv, wo, w_fc, w_proj, the head); then the quantized models'
    prefill logits."""
    tp = models(name)[3]
    jcfg, jq, tcfg, tq = models(name, quant=True)
    got = tquantizer.quantize_params(
        tp, QuantizationConfig(type=QuantType.INT4, group_size=32))
    want = jax_to_numpy(jq)
    for slot in ("w_qkv", "wo", "w_fc", "w_proj"):
        g, w = got["layers"][slot], want["layers"][slot]
        assert isinstance(w, dict) and g.bits == 4 and g.group_size == 32
        np.testing.assert_array_equal(g.data.numpy(), w["data"])
        np.testing.assert_array_equal(g.scales.view(torch.int16).numpy(),
                                      w["scales"].view(np.int16))
    np.testing.assert_array_equal(got["lm_head"].data.numpy(),
                                  want["lm_head"]["data"])
    assert sorted(got["layers"]) == sorted(want["layers"])
    toks = np.random.default_rng(3).integers(
        1, jcfg.vocab_size, size=(1, 20)).astype(np.int32)
    jl, _ = jneox.forward(jq, jcfg, jnp.asarray(toks),
                          jneox.init_cache(jcfg, 1, max_seq=32, fused=False))
    tl, _ = tneox.forward(tq, tcfg, torch.from_numpy(toks),
                          tneox.init_cache(tcfg, 1, max_seq=32, device="cpu"),
                          fresh_prefill=True)
    _close(tl, jl)


def test_alibi_slopes_match_jax():
    for n in (71, 6, 32, 1, 128):
        np.testing.assert_array_equal(tops.alibi_slopes(n).numpy(),
                                      np.asarray(jops.alibi_slopes(n)))


# -- assemblers ---------------------------------------------------------------

def _interleave(w, Hq, D):
    """q|k|v contiguous rows -> HF's head-interleaved [Hq, 3, D] rows."""
    parts = np.split(w, 3, axis=0)
    return np.stack([p.reshape(Hq, D, *w.shape[1:]) for p in parts],
                    1).reshape(w.shape)


BIAS = {"wo": "bo", "w_fc": "b_fc", "w_proj": "b_proj"}


def _hf_tensors(name, jcfg, jp):
    """The family's HF checkpoint names and layouts ([out, in] weights,
    fused qkv interleaved as the family ships it) from a JAX tree."""
    L, Hq, Hkv, D = (jcfg.num_layers, jcfg.num_heads, jcfg.kv_heads,
                     jcfg.head_dim_)
    QD, KVD = jcfg.q_dim, jcfg.kv_dim
    lw = jp["layers"]
    t = {}
    arch = jcfg.architecture
    for i in range(L):
        qkv_w, qkv_b = lw["w_qkv"][i].T, lw["b_qkv"][i]
        if arch == "gpt_neox":
            p = f"gpt_neox.layers.{i}."
            t[p + "attention.query_key_value.weight"] = _interleave(
                qkv_w, Hq, D)
            t[p + "attention.query_key_value.bias"] = _interleave(
                qkv_b, Hq, D)
            for s, n in (("input_layernorm", "ln1"),
                         ("post_attention_layernorm", "ln2")):
                t[p + s + ".weight"] = lw[n + "_w"][i]
                t[p + s + ".bias"] = lw[n + "_b"][i]
            names = dict(wo="attention.dense", w_fc="mlp.dense_h_to_4h",
                         w_proj="mlp.dense_4h_to_h")
        elif arch == "phi":
            p = f"model.layers.{i}."
            for n, lo, hi in (("q", 0, QD), ("k", QD, QD + KVD),
                              ("v", QD + KVD, QD + 2 * KVD)):
                t[p + f"self_attn.{n}_proj.weight"] = qkv_w[lo:hi]
                t[p + f"self_attn.{n}_proj.bias"] = qkv_b[lo:hi]
            t[p + "input_layernorm.weight"] = lw["ln1_w"][i]
            t[p + "input_layernorm.bias"] = lw["ln1_b"][i]
            names = dict(wo="self_attn.dense", w_fc="mlp.fc1",
                         w_proj="mlp.fc2")
        else:                                    # falcon, bloom
            p = f"transformer.h.{i}."
            if Hkv == Hq:                        # RW / BLOOM: interleaved
                w, b = _interleave(qkv_w, Hq, D), _interleave(qkv_b, Hq, D)
            elif Hkv > 1:                        # new arch: per-kv groups
                m = Hq // Hkv

                def group(a):
                    q = a[:QD].reshape(Hkv, m, D, *a.shape[1:])
                    k = a[QD:QD + KVD].reshape(Hkv, 1, D, *a.shape[1:])
                    v = a[QD + KVD:].reshape(Hkv, 1, D, *a.shape[1:])
                    return np.concatenate([q, k, v], 1).reshape(a.shape)
                w, b = group(qkv_w), group(qkv_b)
            else:                                # legacy MQA: q|k|v
                w, b = qkv_w, qkv_b
            t[p + "self_attention.query_key_value.weight"] = w
            t[p + "self_attention.query_key_value.bias"] = b
            if arch == "falcon" and Hkv > 1:
                lns = (("ln_attn", "ln1"), ("ln_mlp", "ln2"))
            elif arch == "falcon" and jcfg.parallel_residual:
                lns = (("input_layernorm", "ln1"),)     # 7B: one shared LN
            else:
                lns = (("input_layernorm", "ln1"),
                       ("post_attention_layernorm", "ln2"))
            for s, n in lns:
                t[p + s + ".weight"] = lw[n + "_w"][i]
                t[p + s + ".bias"] = lw[n + "_b"][i]
            names = dict(wo="self_attention.dense",
                         w_fc="mlp.dense_h_to_4h", w_proj="mlp.dense_4h_to_h")
        for slot, hf in names.items():
            t[p + hf + ".weight"] = lw[slot][i].T
            t[p + hf + ".bias"] = lw[BIAS[slot]][i]
    root = {"gpt_neox": ("gpt_neox.", "embed_in", "final_layer_norm",
                         "embed_out"),
            "phi": ("model.", "embed_tokens", "final_layernorm", None),
            "falcon": ("transformer.", "word_embeddings", "ln_f", None),
            "bloom": ("transformer.", "word_embeddings", "ln_f", None)}[arch]
    t[root[0] + root[1] + ".weight"] = jp["embed"]
    t[root[0] + root[2] + ".weight"] = jp["final_norm_w"]
    t[root[0] + root[2] + ".bias"] = jp["final_norm_b"]
    t[(root[3] or "lm_head") + ".weight"] = jp["lm_head"].T
    if "lm_head_b" in jp:
        t["lm_head.bias"] = jp["lm_head_b"]
    if "embed_norm_w" in jp:
        t["transformer.word_embeddings_layernorm.weight"] = jp["embed_norm_w"]
        t["transformer.word_embeddings_layernorm.bias"] = jp["embed_norm_b"]
    return {k: np.ascontiguousarray(v, np.float32) for k, v in t.items()}


def _same_tree(got, want):
    """Two parameter trees array for array, both read as f32."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _same_tree(got[k], w)
        else:
            np.testing.assert_array_equal(
                got[k].float().numpy(),
                np.asarray(jnp.asarray(w).astype(jnp.float32)), err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NEOX)
def test_assembler_matches_jax(name, dtype):
    check_assembler(name, dtype)


def check_assembler(name, dtype):
    """assemble_for(config) on the family's HF tensors (its fused qkv in
    the family's own layout), array for array with the JAX assembler's on
    the same dict, in f32 and cast to bf16."""
    jcfg, jp, tcfg, _ = models(name)
    t = _hf_tensors(name, jcfg, jax_to_numpy(jp))
    assert tmapping.assemble_for(tcfg).__name__ == \
        jmapping.assemble_for(jcfg).__name__
    got = tmapping.assemble_for(tcfg)(t.__getitem__, list(t), tcfg,
                                      dtype=getattr(torch, dtype),
                                      device="cpu")
    want = jmapping.assemble_for(jcfg)(t.__getitem__, list(t), jcfg,
                                       dtype=getattr(jnp, dtype))
    _same_tree(got, want)
    if dtype == "float32" and name in ("neox_parallel", "falcon_gqa",
                                       "bloom"):
        # no shared LayerNorm: the tensors give back the tree they came from
        _same_tree(got, jax_to_numpy(jp))
