"""Phi-3 (head dim 96) and the cacheless model interface of the port
against turboinfer_tpu on bridged params.

A tiny Phi-3 in f32: hidden 384, 3 layers, 4 query and 4 kv heads of 96
(MHA, as Phi-3-mini; Hkv*D = 384 keeps the JAX package on its fused-head
decode kernel), SiLU FFN 256, a 13-key window on every layer (below the
prompts), V=300. Held against JAX:

- f32 logits of forward (fresh prefill, decode, chunked prefill),
  forward_paged_decode and forward_paged_verify within 1e-4 (the same
  f32 arithmetic, another summation order) over model-dtype caches and
  pools; over int8 and fp8 ones the K/V the two packages encode come out
  of those sums, so a value one ulp apart may round to the neighbouring
  code (at most CODE_FLIPS of the codes, one step each), and the logits
  are held within KV_LOGIT_RTOL of max|logit|, as test_torch_kvcache.py
  holds them; a later layer's K/V follow the earlier layers' flipped
  codes, so over three layers the int8 scales sit within SCALE_RTOL =
  KV_LOGIT_RTOL (3.9e-4 seen), not test_torch_kvcache.py's 1e-5 of two
  layers at D=32;
- greedy generate_batch trajectories, token for token (the JAX engine
  resolves its fused cache for D=96);
- the plain decode at D=96 with a window against decode_fused_pallas in
  interpret mode, the fused-head and head-major caches built from one
  numpy array; the plain flash at D=96 against the JAX package's jnp
  attention (prefill_pallas declines D % 64 != 0, so JAX runs that);
- phi3_mini_4k_config() against the JAX loader's mapping of
  microsoft/Phi-3-mini-4k-instruct's config.json.

The model-interface helpers the JAX registry names: forward_no_cache of
the llama (Phi-3), MoE and GPT-OSS modules against JAX's; param_count
against JAX's on the same bridged params, int4 [L, E] expert stacks
included; reset_cache; and generate_batch with use_cache=False against
the JAX engine's use_cache=False and the port's cached path (tokens,
logprobs and the eos, max_seq and length stop reasons).
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
from turboinfer_tpu.kernels.pallas import decode_attention as jda
from turboinfer_tpu.kernels.pallas import flash_attention as jfa
from turboinfer_tpu.models import common as jcommon
from turboinfer_tpu.models import gptoss as jgptoss
from turboinfer_tpu.models import llama as jllama
from turboinfer_tpu.models import moe as jmoe
from turboinfer_tpu.quant import quantizer as jquantizer
from turboinfer_tpu_torch import bridge
from turboinfer_tpu_torch import config as tconfig
from turboinfer_tpu_torch.config import InferenceConfig
from turboinfer_tpu_torch.engine.engine import InferenceEngine
from turboinfer_tpu_torch.kernels import decode_attention as tda
from turboinfer_tpu_torch.kernels import flash_attention as tfa
from turboinfer_tpu_torch.models import common as tcommon
from turboinfer_tpu_torch.models import gptoss as tgptoss
from turboinfer_tpu_torch.models import llama as tllama
from turboinfer_tpu_torch.models import moe as tmoe
from turboinfer_tpu_torch.models import registry

torch.set_num_threads(2)

LOGIT_ATOL = 1e-4
KV = {"int8": (jnp.int8, torch.int8), "fp8": (jnp.uint8, torch.uint8)}
KV_LOGIT_RTOL = 1e-3     # of max|logit|: codes one step apart
CODE_FLIPS = 1e-3        # share of codes allowed one step apart
SCALE_RTOL = 1e-3        # int8 scales, after flips upstream (see above)
KERNEL_RTOL = 2e-2       # the Pallas kernels' bf16 operands

PHI3 = dict(vocab_size=300, hidden_size=384, num_layers=3, num_heads=4,
            num_kv_heads=4, intermediate_size=256, max_seq_len=96,
            sliding_window=13, rms_norm_eps=1e-5, tie_embeddings=False,
            architecture="phi3", name="tiny-phi3")
LLAMA = dict(vocab_size=300, hidden_size=128, num_layers=2, num_heads=4,
             num_kv_heads=2, intermediate_size=256, max_seq_len=96)
MOE = dict(vocab_size=300, hidden_size=128, num_layers=2, num_heads=4,
           num_kv_heads=2, intermediate_size=128, num_experts=4,
           experts_per_token=2, max_seq_len=96, architecture="mixtral",
           name="tiny-mixtral")
GPTOSS = dict(vocab_size=300, hidden_size=256, num_layers=2, num_heads=16,
              num_kv_heads=2, head_dim=64, intermediate_size=128,
              num_experts=4, experts_per_token=2, attn_bias=True,
              sliding_window=8, sliding_window_pattern=2, max_seq_len=96,
              rope_scaling=(("factor", 4.0),
                            ("original_max_position_embeddings", 16),
                            ("rope_type", "yarn"), ("truncate", False)),
              architecture="gpt_oss", name="tiny-gptoss")
FAMILIES = {"phi3": (PHI3, jllama, tllama), "llama": (LLAMA, jllama, tllama),
            "moe": (MOE, jmoe, tmoe), "gptoss": (GPTOSS, jgptoss, tgptoss)}

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


def models(family, quant=False):
    """(JAX module, JAX config, JAX params, port module, port config, port
    params) on the same f32 weights (quant: the JAX quantizer's int4 g=64
    output, bridged)."""
    if (family, quant) not in _P:
        kw, jm, tm = FAMILIES[family]
        jcfg = JModelConfig(dtype=jnp.float32, **kw)
        tcfg = tconfig.ModelConfig(dtype=torch.float32, **kw)
        jp = jm.init_params(jax.random.PRNGKey(len(family)), jcfg)
        if quant:
            jp = jquantizer.quantize_params(
                jp, JQuantCfg(type=JQuantType.INT4, group_size=64))
        tp = bridge.params_from_numpy(jax_to_numpy(jp), device="cpu")
        _P[family, quant] = (jm, jcfg, jp, tm, tcfg, tp)
    return _P[family, quant]


def _close(got, want, kind=None):
    """Logits: within LOGIT_ATOL (model dtype), or KV_LOGIT_RTOL of
    max|logit| over an 8-bit cache (see the module docstring)."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if kind is None:
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=KV_LOGIT_RTOL * np.abs(want).max())


def _codes_close(got, want):
    """At most CODE_FLIPS of the codes differ, each by one step: an int8
    code by one, an e4m3 byte (uint8) to the neighbouring value, with +0
    and -0 (0x00, 0x80) one value."""
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype == np.uint8:       # e4m3 bits -> signed magnitude order
        got, want = (np.where(c & 0x80, -(c & 0x7F).astype(np.int16),
                              (c & 0x7F).astype(np.int16))
                     for c in (got, want))
    got, want = got.astype(np.int16), want.astype(np.int16)
    diff = got != want
    assert diff.mean() <= CODE_FLIPS, diff.mean()
    assert (np.abs(got[diff] - want[diff]) == 1).all()


def _same_cache(tc, jc, kind):
    if kind is None:
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-5)
        np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=1e-5)
    else:
        for t, j in ((tc.k, jc.k), (tc.v, jc.v)):
            _codes_close(t.numpy(), j)
        for t, j in ((tc.k_scale, jc.k_scale), (tc.v_scale, jc.v_scale)):
            if j is not None:
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=SCALE_RTOL, atol=0)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def _store(rng, shape, kind):
    """Random K/V as stored in a pool of `kind` (None: f32) -> (JAX
    storage, JAX scales, port storage, port scales), the same bytes."""
    x = rng.normal(size=shape).astype(np.float32)
    if kind is None:
        return jnp.asarray(x), None, torch.from_numpy(x), None
    q, s = tcommon.encode_kv_scaled(torch.from_numpy(x), KV[kind][1])
    js = None if s is None else jnp.asarray(s.numpy())
    return jnp.asarray(q.numpy()), js, q, s


KINDS = dict(argvalues=[None, "int8", "fp8"], ids=["model", "int8", "fp8"])


# -- Phi-3 at head dim 96 ---------------------------------------------------

@pytest.mark.parametrize("kind", **KINDS)
def test_phi3_forward_prefill_decode_chunked_logits(kind):
    """A fresh prefill past the window (24 and 17 tokens), two decode
    steps, then a chunked prefill of 12 tokens at q_start 26 and 19:
    every logit and the head-major caches against JAX's."""
    jm, jcfg, jp, tm, tcfg, tp = models("phi3")
    rng = np.random.default_rng(1)
    B, S, T = 2, 24, 64
    toks = rng.integers(1, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    lens = np.array([24, 17], np.int32)
    jkw = {} if kind is None else dict(dtype=KV[kind][0])
    tkw = {} if kind is None else dict(dtype=KV[kind][1])
    jc = jm.init_cache(jcfg, B, max_seq=T, fused=False, **jkw)
    tc = tm.init_cache(tcfg, B, max_seq=T, device="cpu", **tkw)
    jl, jc = jm.forward(jp, jcfg, jnp.asarray(toks), jc,
                        seq_lens=jnp.asarray(lens), fresh_prefill=True)
    tl, tc = tm.forward(tp, tcfg, torch.from_numpy(toks), tc,
                        seq_lens=torch.from_numpy(lens), fresh_prefill=True)
    for b, n in enumerate(lens):
        _close(tl[b, :n], jl[b, :n], kind)
    _same_cache(tc, jc, kind)
    nxt = np.asarray(jnp.argmax(jl[np.arange(B), lens - 1], -1)).astype(
        np.int32)
    for _ in range(2):
        jl, jc = jm.forward(jp, jcfg, jnp.asarray(nxt[:, None]), jc)
        tl, tc = tm.forward(tp, tcfg, torch.from_numpy(nxt[:, None]), tc)
        _close(tl, jl, kind)
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)
    chunk = rng.integers(1, jcfg.vocab_size, size=(B, 12)).astype(np.int32)
    jl, jc = jm.forward(jp, jcfg, jnp.asarray(chunk), jc)
    tl, tc = tm.forward(tp, tcfg, torch.from_numpy(chunk), tc)
    _close(tl, jl, kind)
    _same_cache(tc, jc, kind)


@pytest.mark.parametrize("G", [1, 5])
@pytest.mark.parametrize("kind", **KINDS)
def test_phi3_forward_paged_logits(kind, G):
    """forward_paged_decode (G=1) and forward_paged_verify (G=5) over a
    random pool whose rows reach past the window: logits and the pools
    after the write, against JAX's."""
    jm, jcfg, jp, tm, tcfg, tp = models("phi3")
    rng = np.random.default_rng(7 + G)
    L, P, page, B = jcfg.num_layers, 12, 8, 3
    shape = (L, P, jcfg.kv_heads, page, jcfg.head_dim_)
    jk, jks, tk, tks = _store(rng, shape, kind)
    jv, jvs, tv, tvs = _store(rng, shape, kind)
    table = np.array([[3, 7, 1, 5, 10], [8, 2, 11, 4, -1],
                      [6, 9, -1, -1, -1]], np.int32)
    lengths = np.array([29, 21, 5], np.int32)
    tokens = rng.integers(1, jcfg.vocab_size, (B, G)).astype(np.int32)
    jscale = {} if jks is None else dict(k_scale_pages=jks, v_scale_pages=jvs)
    tscale = {} if tks is None else dict(k_scale_pages=tks, v_scale_pages=tvs)
    jargs = (jk, jv, jnp.asarray(table), jnp.asarray(lengths))
    targs = (tk, tv, torch.from_numpy(table), torch.from_numpy(lengths))
    if G == 1:
        want = jm.forward_paged_decode(jp, jcfg, jnp.asarray(tokens[:, 0]),
                                       *jargs, **jscale)
        got = tm.forward_paged_decode(tp, tcfg,
                                      torch.from_numpy(tokens[:, 0]), *targs,
                                      **tscale)
    else:
        want = jm.forward_paged_verify(jp, jcfg, jnp.asarray(tokens), *jargs,
                                       **jscale)
        got = tm.forward_paged_verify(tp, tcfg, torch.from_numpy(tokens),
                                      *targs, **tscale)
    assert len(got) == len(want)
    _close(got[0], want[0], kind)
    for g, w in zip(got[1:3], want[1:3]):
        if kind is None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
        else:
            _codes_close(g.numpy(), w)
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=SCALE_RTOL, atol=0)


@pytest.mark.parametrize("kind", **KINDS)
def test_phi3_generate_batch_greedy_matches_jax(kind):
    """Greedy trajectories of generate_batch, prompts on both sides of
    the window, token for token with the JAX engine's (its fused-head
    cache at D=96)."""
    _, jcfg, jp, _, tcfg, tp = models("phi3")
    icfg = dict(max_seq_len=jcfg.max_seq_len, eos_token_id=-1,
                kv_cache_dtype="model" if kind is None else kind)
    je = ti.InferenceEngine(jp, jcfg, JInferenceConfig(**icfg))
    te = InferenceEngine(tp, tcfg, InferenceConfig(**icfg), device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, jcfg.vocab_size, size=n).tolist()
               for n in (5, 30, 14)]
    jres = je.generate_batch(prompts, 20, temperature=0.0)
    tres = te.generate_batch(prompts, 20, temperature=0.0)
    for a, b in zip(jres, tres):
        assert b.tokens == a.tokens and b.stop_reason == a.stop_reason


# (window, kv_len per row): lone-head rows and windows that start inside
# and outside a 64-row sub-slice, kv_len 1, odd, and the capacity
_D96_CASES = {"global": (None, [1, 97, 128, 255]),
              "w13": (13, [1, 14, 129, 256]),
              "w2047": (2047, [3, 64, 65, 256]),
              "w100": (100, [1, 99, 101, 200])}


@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 4)], ids=["mha", "gqa"])
@pytest.mark.parametrize("case", list(_D96_CASES))
def test_decode_plain_d96_matches_fused_pallas(case, Hq, Hkv):
    """decode_plain at D=96 with a window (what decode_attention runs on
    the CPU) against decode_fused_pallas in interpret mode, whose
    fused-head cache [L, B, T, Hkv*D] and the port's head-major one come
    from one numpy array; and exactly JAX's jnp fused reference."""
    window, lens = _D96_CASES[case]
    rng = np.random.default_rng(96 + len(case) + Hq)
    L, B, D, T = 2, 4, 96, 256
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    k = rng.normal(size=(L, B, Hkv, T, D)).astype(np.float32)
    v = rng.normal(size=(L, B, Hkv, T, D)).astype(np.float32)
    kv_len = np.asarray(lens, np.int32)

    def fused(c):
        return jnp.asarray(c.transpose(0, 1, 3, 2, 4).reshape(L, B, T, Hkv * D))
    for li in (0, 1):
        want = jda.decode_fused_pallas(
            jnp.asarray(q), fused(k), fused(v), jnp.asarray(kv_len),
            layer_index=jnp.int32(li), window=window, interpret=True)
        assert want is not None
        got = tda.decode_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(kv_len), li, window=window)
        got, want = got.numpy(), np.asarray(want)
        assert np.abs(got - want).max() < KERNEL_RTOL * np.abs(want).max()
        np.testing.assert_allclose(got, np.asarray(
            jops.attention_decode_fused_ref(
                jnp.asarray(q), fused(k)[li], fused(v)[li],
                jnp.asarray(kv_len), window=window)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [None, 13, 2047], ids=str)
@pytest.mark.parametrize("stacked", [False, True], ids=["fresh", "stacked"])
def test_prefill_plain_d96_matches_jnp_reference(window, stacked):
    """The plain flash at D=96 (what flash_prefill runs on the CPU)
    against the JAX package's jnp attention, which is what JAX runs at
    D=96: prefill_pallas declines head dims that are not multiples of 64.
    Fresh (q_start 0) and a chunk at q_start 40 / 3 over a T=128 layer,
    kv_len inside the chunk."""
    rng = np.random.default_rng(960 + (window or 0) + stacked)
    B, S, Hq, Hkv, D, T = 2, 24, 8, 4, 96, 128
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, T if stacked else S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, T if stacked else S, D)).astype(np.float32)
    q_start = np.array([40, 3] if stacked else [0, 0], np.int32)
    kv_len = q_start + np.array([24, 19], np.int32)
    assert jfa.prefill_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              kv_len=jnp.asarray(kv_len),
                              q_start=jnp.asarray(q_start),
                              window=window, interpret=True) is None
    got = tfa.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(kv_len),
                            torch.from_numpy(q_start), window=window)
    positions = q_start[:, None] + np.arange(S, dtype=np.int32)[None, :]
    want = jops.attention_prefill_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        positions=jnp.asarray(positions), kv_len=jnp.asarray(kv_len),
        window=window)
    rows = positions < kv_len[:, None]
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows],
                               rtol=1e-5, atol=1e-5)


def test_phi3_mini_4k_config_matches_the_jax_mapping():
    """phi3_mini_4k_config() against the JAX loader's mapping of
    microsoft/Phi-3-mini-4k-instruct's config.json keys."""
    from turboinfer_tpu.loader.mapping import config_from_hf_dict
    hf = {"architectures": ["Phi3ForCausalLM"], "model_type": "phi3",
          "vocab_size": 32064, "hidden_size": 3072,
          "num_hidden_layers": 32, "num_attention_heads": 32,
          "num_key_value_heads": 32, "intermediate_size": 8192,
          "hidden_act": "silu", "max_position_embeddings": 4096,
          "original_max_position_embeddings": 4096, "rope_theta": 10000.0,
          "rope_scaling": None, "rms_norm_eps": 1e-05,
          "sliding_window": 2047, "tie_word_embeddings": False,
          "attention_bias": False, "bos_token_id": 1, "eos_token_id": 32000,
          "pad_token_id": 32000, "torch_dtype": "bfloat16"}
    j = config_from_hf_dict(hf)
    t = tconfig.phi3_mini_4k_config()
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "kv_heads", "head_dim_", "ffn_dim", "rope_theta",
              "rope_scaling", "rms_norm_eps", "max_seq_len", "sliding_window",
              "sliding_window_pattern", "attn_logit_softcap",
              "final_logit_softcap", "attn_scale", "norm_offset",
              "scale_embeddings", "post_norms", "hidden_act",
              "tie_embeddings", "architecture", "qk_norm", "attn_bias"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.rope_mode.value == j.rope_mode.value
    assert (t.head_dim_, t.kv_heads, t.sliding_window) == (96, 32, 2047)
    tllama.check_supported(t)
    assert registry.get_model(t.architecture) is tllama
    assert {tllama.layer_window(t, li) for li in range(32)} == {2047}


# -- the model-interface helpers: forward_no_cache, param_count, reset_cache

@pytest.mark.parametrize("family", list(FAMILIES))
def test_forward_no_cache_matches_jax(family):
    """forward_no_cache (a cache of exactly S positions, one prefill) ->
    logits [B, S, V] against JAX's, rows past seq_lens left out; the port
    module is the one its registry names."""
    jm, jcfg, jp, tm, tcfg, tp = models(family)
    assert registry.get_model(tcfg.architecture) is tm
    rng = np.random.default_rng(len(family))
    toks = rng.integers(1, jcfg.vocab_size, size=(2, 20)).astype(np.int32)
    lens = np.array([20, 13], np.int32)
    want = jm.forward_no_cache(jp, jcfg, jnp.asarray(toks),
                               seq_lens=jnp.asarray(lens))
    got = tm.forward_no_cache(tp, tcfg, torch.from_numpy(toks),
                              seq_lens=torch.from_numpy(lens))
    assert tuple(got.shape) == (2, 20, jcfg.vocab_size)
    assert got.dtype == torch.float32
    for b, n in enumerate(lens):
        _close(got[b, :n], np.asarray(want)[b, :n])


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int4"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_param_count_matches_jax(family, quant):
    """param_count on the same bridged params: a QTensor is its logical
    K x N times every stacking dim, so the int4 MoE's [L, E, ...] expert
    stacks count L * E matrices; every family module exports it."""
    jm, jcfg, jp, tm, tcfg, tp = models(family, quant)
    want = jcommon.param_count(jp)
    assert tm.param_count(tp) == want == tcommon.param_count(tp)
    assert tm.param_bytes(tp) == tcommon.param_bytes(tp)
    if quant and family == "moe":
        we = tp["layers"]["we_gate"]
        assert we.data.dim() == 4
        assert tcommon.param_count({"w": we}) == (
            jcfg.num_layers * jcfg.num_experts * we.shape[0] * we.shape[1])


@pytest.mark.parametrize("kind", [None, "int8", "fp8"],
                         ids=["model", "int8", "fp8"])
def test_reset_cache_zeroes_everything(kind):
    """reset_cache: zeros of the same shapes and dtypes in new tensors, a
    scale plane each from its own tensor (never one shared), and the
    source cache untouched; every family module exports it."""
    _, jcfg, _, tm, tcfg, _ = models("phi3")
    dtype = None if kind is None else KV[kind][1]
    c = tm.init_cache(tcfg, 2, max_seq=16, dtype=dtype, device="cpu")
    for t in (c.k, c.v, c.k_scale, c.v_scale):
        if t is not None:
            t.copy_(torch.ones_like(t))
    c = c._replace(length=torch.tensor([5, 9], dtype=torch.int32))
    for mod in (tllama, tmoe, tgptoss):
        r = mod.reset_cache(c)
        for new, old in zip(r, c):
            if old is None:
                assert new is None
                continue
            assert new.shape == old.shape and new.dtype == old.dtype
            assert not new.any() and old.any()
            assert new.data_ptr() != old.data_ptr()
        if kind == "int8":
            assert r.k_scale.data_ptr() != r.v_scale.data_ptr()
    j = jcommon.reset_cache(jllama.init_cache(jcfg, 2, max_seq=16,
                                              fused=False))
    assert tuple(np.asarray(j.k).shape) == tuple(r.k.shape)


@pytest.mark.parametrize("family", ["phi3", "moe", "gptoss"])
def test_generate_batch_use_cache_false_matches_jax_and_cached(family):
    """generate_batch with use_cache=False recomputes every token: its
    greedy tokens, logprobs and stop reasons equal the JAX engine's
    use_cache=False and the port's cached path. max_seq_len 48 stops the
    40-token prompt on "max_seq"; an eos taken from the first run stops a
    row on "eos" in the second."""
    _, jcfg, jp, _, tcfg, tp = models(family)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, jcfg.vocab_size, size=n).tolist()
               for n in (7, 40, 18)]
    eos = -1
    for attempt in range(2):
        icfg = dict(max_seq_len=48, eos_token_id=eos)
        je = ti.InferenceEngine(jp, jcfg, JInferenceConfig(use_cache=False,
                                                           **icfg))
        tn = InferenceEngine(tp, tcfg, InferenceConfig(use_cache=False,
                                                       **icfg), device="cpu")
        tc = InferenceEngine(tp, tcfg, InferenceConfig(**icfg), device="cpu")
        jr = je.generate_batch(prompts, 12, temperature=0.0,
                               return_logprobs=True)
        nr = tn.generate_batch(prompts, 12, temperature=0.0,
                               return_logprobs=True)
        cr = tc.generate_batch(prompts, 12, temperature=0.0,
                               return_logprobs=True)
        for a, b, c in zip(jr, nr, cr):
            assert b.tokens == a.tokens == c.tokens
            assert b.stop_reason == a.stop_reason == c.stop_reason
            assert b.finished == a.finished
            np.testing.assert_allclose(b.logprobs, a.logprobs, atol=1e-4)
            np.testing.assert_allclose(b.logprobs, c.logprobs, atol=1e-4)
        reasons = [r.stop_reason for r in nr]
        if attempt == 0:
            assert reasons == ["length", "max_seq", "length"]
            eos = nr[2].tokens[18 + 3]       # row 2's fourth new token
        else:
            assert reasons[2] == "eos" and nr[2].tokens[-1] == eos
