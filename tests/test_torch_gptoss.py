"""GPT-OSS of the port (models/gptoss.py) against turboinfer_tpu's.

A tiny GPT-OSS in f32 that takes the JAX package's fused-head decode
path (Hkv*D = 128): H=256, L=4, Hq=16, Hkv=2, D=64, F=128, E=4, top-2,
a window of 8 on even layers (pattern 2), YaRN factor 4 over 16
original positions with truncate false, V=512, max_seq 64. Weights come
from the JAX package's init_params, bridged through numpy; in the int4
cases the attention projections and the head are the JAX quantizer's
int4 g=64 output (the experts stay f32, as there). Logits are compared
within 1e-4 of max|logit| (the same f32 arithmetic on the CPU; only the
summation order differs), routing exactly, greedy trajectories token
for token. Sequences run past the window, so the sliding layers mask.

int8 and fp8 caches (contiguous) and fp8 page pools: the K/V the two
packages encode come out of f32 sums taken in another order, so a value
one ulp apart may round to the neighbouring code: at most CODE_FLIPS of
the codes differ, each by one step, int8 scales within SCALE_RTOL, and
logits within KV_LOGIT_RTOL of max|logit| (as in test_torch_kvcache.py);
the plain 8-bit decode with sinks and a window against
decode_fused_pallas in interpret mode; int8 pools refused as the JAX
package refuses them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import turboinfer_tpu as ti
from turboinfer_tpu.config import ModelConfig as JModelConfig
from turboinfer_tpu.config import QuantizationConfig as JQuantCfg
from turboinfer_tpu.config import QuantType as JQuantType
from turboinfer_tpu.core.qtensor import QEmbed as JQEmbed
from turboinfer_tpu.core.qtensor import QTensor as JQTensor
from turboinfer_tpu.engine.scheduler import \
    PagedContinuousScheduler as JPaged
from turboinfer_tpu.kernels.pallas import decode_attention as jda
from turboinfer_tpu.loader.mapping import config_from_hf_dict
from turboinfer_tpu.models import gptoss as jgptoss
from turboinfer_tpu.quant import quantizer as jquantizer
from turboinfer_tpu_torch import bridge, kernels
from turboinfer_tpu_torch import config as tconfig
from turboinfer_tpu_torch.config import (InferenceConfig, QuantizationConfig,
                                         QuantType)
from turboinfer_tpu_torch.core.qtensor import QTensor
from turboinfer_tpu_torch.engine.engine import InferenceEngine
from turboinfer_tpu_torch.engine.scheduler import \
    PagedContinuousScheduler as TPaged
from turboinfer_tpu_torch.kernels import decode_attention as tda
from turboinfer_tpu_torch.kernels.dispatch import prepare_params
from turboinfer_tpu_torch.models import common as tcommon
from turboinfer_tpu_torch.models import gptoss as tgptoss
from turboinfer_tpu_torch.models import registry
from turboinfer_tpu_torch.quant import quantizer as tquantizer
from turboinfer_tpu_torch.utils.errors import ConfigError, DeviceError

torch.set_num_threads(2)

LOGIT_RTOL = 1e-4        # of max|logit|
# compressed caches (see the module docstring)
KV = {"int8": (jnp.int8, torch.int8), "fp8": (jnp.uint8, torch.uint8)}
KV_LOGIT_RTOL = 1e-3     # of max|logit|: codes one step apart
SCALE_RTOL = 1e-5
CODE_FLIPS = 1e-3
KERNEL_RTOL = 2e-2       # the Pallas kernels' bf16 operands, as there

CFG = dict(vocab_size=512, hidden_size=256, num_layers=4, num_heads=16,
           num_kv_heads=2, head_dim=64, intermediate_size=128,
           num_experts=4, experts_per_token=2, attn_bias=True,
           sliding_window=8, sliding_window_pattern=2, max_seq_len=64,
           rope_scaling=(("factor", 4.0),
                         ("original_max_position_embeddings", 16),
                         ("rope_type", "yarn"), ("truncate", False)),
           architecture="gpt_oss", name="tiny-gptoss")

_P = {}


def jax_to_numpy(tree):
    """The JAX half of the bridge: a JAX param tree as numpy."""
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, JQTensor):
        return {"data": np.asarray(tree.data), "scales": np.asarray(tree.scales),
                "zero_points": None if tree.zero_points is None
                else np.asarray(tree.zero_points), "bits": tree.bits,
                "group_size": tree.group_size, "shape": tree.shape}
    if isinstance(tree, JQEmbed):
        return {"data": np.asarray(tree.data),
                "row_scales": np.asarray(tree.scales)}
    return np.asarray(tree)


def models(quant=False):
    """(JAX config, JAX params, port config, port params) on the same
    weights: f32, or the JAX quantizer's g=64 output, int4 (quant True)
    or int8 ("int8") attention and head."""
    if quant not in _P:
        jcfg = JModelConfig(dtype=jnp.float32, **CFG)
        tcfg = tconfig.ModelConfig(dtype=torch.float32, **CFG)
        jp = jgptoss.init_params(jax.random.PRNGKey(0), jcfg)
        if quant:
            qtype = JQuantType.INT8 if quant == "int8" else JQuantType.INT4
            jp = jquantizer.quantize_params(
                jp, JQuantCfg(type=qtype, group_size=64))
        tp = bridge.params_from_numpy(jax_to_numpy(jp), device="cpu")
        _P[quant] = (jcfg, jp, tcfg, tp)
    return _P[quant]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max())


def _layer(lw, li):
    return {k: v[li] for k, v in lw.items()}


# -- FFN ------------------------------------------------------------------------

def test_glu_matches_jax_and_clamps():
    rng = np.random.default_rng(1)
    g = np.concatenate([rng.normal(scale=4.0, size=64),
                        [-100.0, 0.0, 7.0, 7.5, 100.0]]).astype(np.float32)
    u = np.concatenate([rng.normal(scale=4.0, size=64),
                        [-100.0, -7.5, 0.0, 7.5, 100.0]]).astype(np.float32)
    got = tgptoss._glu(torch.from_numpy(g), torch.from_numpy(u)).numpy()
    want = np.asarray(jgptoss._glu(jnp.asarray(g), jnp.asarray(u)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert got[-1] == pytest.approx(8 * 7 / (1 + np.exp(-1.702 * 7)),
                                    rel=1e-6)


@pytest.mark.parametrize("B,S", [(1, 1), (2, 3)], ids=["gather", "dense"])
def test_moe_ffn_and_routing_match_jax(monkeypatch, B, S):
    """_moe_ffn of every layer in both expert regimes (B*S*k < E
    gathers the routed experts, else the dense mix), and top_i exactly
    as jax.lax.top_k hands it to the JAX package's _moe_ffn."""
    jcfg, jp, tcfg, tp = models()
    jrec, trec = [], []
    j_top_k, t_route = jax.lax.top_k, tgptoss.route

    def j_spy(x, k):
        out = j_top_k(x, k)
        jrec.append(np.asarray(out[1]))
        return out

    def t_spy(*a):
        out = t_route(*a)
        trec.append(out[1].numpy())
        return out
    monkeypatch.setattr(jax.lax, "top_k", j_spy)
    monkeypatch.setattr(tgptoss, "route", t_spy)
    h = np.random.default_rng(B).normal(size=(B, S, 256)).astype(np.float32)
    for li in range(jcfg.num_layers):
        want = jgptoss._moe_ffn(jcfg, jnp.asarray(h),
                                _layer(jp["layers"], li), None)
        got = tgptoss._moe_ffn(tcfg, torch.from_numpy(h), tp["layers"], li)
        assert got.shape == (B, S, 256) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert len(jrec) == len(trec) == jcfg.num_layers
    for a, b in zip(jrec, trec):
        np.testing.assert_array_equal(b, a)


def test_dense_regime_expert_groups_agree(monkeypatch):
    """Grouping the experts of the dense regime (to bound temporaries)
    changes no sum beyond f32 rounding."""
    _, _, tcfg, tp = models()
    h = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 5, 256)).astype(np.float32))
    whole = tgptoss._moe_ffn(tcfg, h, tp["layers"], 1)
    monkeypatch.setattr(tgptoss, "_DENSE_ELEMS", 1)     # one expert a group
    torch.testing.assert_close(tgptoss._moe_ffn(tcfg, h, tp["layers"], 1),
                               whole, rtol=1e-5, atol=1e-6)


# -- quantizer and fusion --------------------------------------------------------

def test_quantize_params_keeps_experts_fp_and_matches_jax():
    jcfg, jp, tcfg, tp = models()
    qcfg = dict(type=QuantType.INT4, group_size=64)
    jq = jquantizer.quantize_params(jp, JQuantCfg(type=JQuantType.INT4,
                                                  group_size=64))
    tq = tquantizer.quantize_params(tp, QuantizationConfig(**qcfg))
    lw = tq["layers"]
    for name in ("we_gate", "we_up", "we_down", "router", "sinks",
                 "be_gate", "b_q", "b_o"):
        assert not isinstance(lw[name], QTensor), name
        assert torch.equal(lw[name], tp["layers"][name]), name
    for name in ("wq", "wk", "wv", "wo"):
        np.testing.assert_array_equal(lw[name].data.numpy(),
                                      np.asarray(jq["layers"][name].data))
        np.testing.assert_array_equal(
            lw[name].scales.view(torch.int16).numpy(),
            np.asarray(jq["layers"][name].scales).view(np.int16))
    np.testing.assert_array_equal(tq["lm_head"].data.numpy(),
                                  np.asarray(jq["lm_head"].data))


def test_prepare_params_fuses_biases_not_fp_experts():
    """b_q/b_k/b_v fuse into b_qkv with wqkv, the fp expert stacks stay
    split; logits do not move."""
    _, _, tcfg, tp = models(quant=True)
    prep = prepare_params(tp)
    lw = prep["layers"]
    assert "wqkv" in lw and "b_qkv" in lw
    assert not {"wq", "b_q", "b_k", "b_v", "we_gateup"} & set(lw)
    assert "we_gate" in lw and "we_up" in lw
    torch.testing.assert_close(lw["b_qkv"], torch.cat(
        [tp["layers"][n] for n in ("b_q", "b_k", "b_v")], -1), rtol=0, atol=0)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        1, 512, (1, 12)).astype(np.int32))
    outs = []
    for p in (tp, prep):
        c = tgptoss.init_cache(tcfg, 1, max_seq=32, device="cpu")
        lg, c = tgptoss.forward(p, tcfg, toks, c)
        lg2, _ = tgptoss.forward(p, tcfg, toks[:, :1], c)
        outs.append((lg, lg2))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_prepare_params_casts_sinks_to_f32_once():
    """The decode kernel reads f32 sinks: prepare_params casts a bf16
    model's sinks once (same values), and again is a no-op."""
    _, _, _, tp = models()
    bf = {**tp, "layers": {**tp["layers"], "sinks":
                           tp["layers"]["sinks"].to(torch.bfloat16)}}
    prep = prepare_params(bf)
    snk = prep["layers"]["sinks"]
    assert snk.dtype == torch.float32 and snk.is_contiguous()
    assert torch.equal(snk, bf["layers"]["sinks"].float())
    assert prepare_params(prep)["layers"]["sinks"] is snk


# -- forwards --------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True, "int8"],
                         ids=["f32", "int4", "int8"])
@pytest.mark.parametrize("B,fresh", [(1, True), (3, False)])
def test_forward_prefill_and_decode_logits(quant, B, fresh):
    """Every prefill position, then decode steps through the decode
    kernel's plain version (fused-head decode_fused_pallas path in JAX);
    rows of 14, 9 and 3 tokens, so the sliding layers mask."""
    jcfg, jp, tcfg, tp = models(quant)
    rng = np.random.default_rng(B)
    S, T = 14, 32
    toks = rng.integers(1, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    lens = np.array([14, 9, 3][:B], np.int32)
    jc = jgptoss.init_cache(jcfg, B, max_seq=T, fused=None)
    assert jc.fused_layout                 # the sink-aware fused kernel path
    jl, jc = jgptoss.forward(jp, jcfg, jnp.asarray(toks), jc,
                             seq_lens=jnp.asarray(lens))
    tc = tgptoss.init_cache(tcfg, B, max_seq=T, device="cpu")
    tl, tc = tgptoss.forward(tp, tcfg, torch.from_numpy(toks), tc,
                             seq_lens=torch.from_numpy(lens),
                             fresh_prefill=fresh)
    assert tl.shape == (B, S, jcfg.vocab_size) and tl.dtype == torch.float32
    valid = np.arange(S)[None, :] < lens[:, None]
    _close(tl.numpy()[valid], np.asarray(jl)[valid])
    nxt = np.asarray(jnp.argmax(jl[np.arange(B), lens - 1], -1)).astype(
        np.int32)
    for _ in range(3):
        jl, jc = jgptoss.forward(jp, jcfg, jnp.asarray(nxt[:, None]), jc)
        tl, tc = tgptoss.forward(tp, tcfg, torch.from_numpy(nxt[:, None]), tc)
        _close(tl.numpy(), jl)
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def test_streaming_attention_chunking_is_exact(monkeypatch):
    """A cache spanning several key chunks (T=128 -> 2 x 64) gives the
    same prefill logits as one chunk (T=32), sinks and windows included."""
    _, _, tcfg, tp = models()
    monkeypatch.setattr(tgptoss, "_KEY_CHUNK", 64)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        1, 512, (2, 20)).astype(np.int32))
    out = []
    for T in (32, 128):
        c = tgptoss.init_cache(tcfg, 2, max_seq=T, device="cpu")
        out.append(tgptoss.forward(tp, tcfg, toks, c)[0])
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=1e-5)


def test_streaming_attention_unaligned_keys_chunk_with_a_short_tail(
        monkeypatch):
    """A fresh prefill of S=70 keys (no multiple of the chunk) streams in
    chunks of 16 with a 6-key tail, never one [.., S, S] block: the
    logits equal those of a single chunk, sinks and windows included."""
    _, _, tcfg, tp = models()
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        1, 512, (2, 70)).astype(np.int32))
    lens = torch.tensor([70, 41], dtype=torch.int32)
    seen, stream = [], tgptoss._streaming_attention

    def spy(q, k, *a):
        seen.append(k.shape[2])
        return stream(q, k, *a)
    monkeypatch.setattr(tgptoss, "_streaming_attention", spy)
    out = []
    for chunk in (512, 16):
        monkeypatch.setattr(tgptoss, "_KEY_CHUNK", chunk)
        c = tgptoss.init_cache(tcfg, 2, max_seq=128, device="cpu")
        out.append(tgptoss.forward(tp, tcfg, toks, c, seq_lens=lens,
                                   fresh_prefill=True)[0])
    assert set(seen) == {70}            # the slab, not the cache width
    valid = torch.arange(70)[None, :] < lens[:, None]
    torch.testing.assert_close(out[1][valid], out[0][valid], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int4"])
def test_paged_decode_matches_jax(quant):
    """One paged decode step over random pages through a shuffled table
    with -1 past each row's need; lengths past the window."""
    jcfg, jp, tcfg, tp = models(quant)
    rng = np.random.default_rng(11)
    L, P, page, B = jcfg.num_layers, 10, 8, 3
    Hkv, D = jcfg.kv_heads, jcfg.head_dim_
    kp = rng.normal(size=(L, P, Hkv, page, D)).astype(np.float32)
    vp = rng.normal(size=(L, P, Hkv, page, D)).astype(np.float32)
    table = np.array([[3, 7, 1, -1], [8, 2, -1, -1], [5, 4, 6, 9]], np.int32)
    lengths = np.array([13, 6, 20], np.int32)
    tokens = rng.integers(1, jcfg.vocab_size, (B,)).astype(np.int32)
    want = jgptoss.forward_paged_decode(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lengths))
    tcache = bridge.paged_cache_from_numpy(kp, vp, table, lengths,
                                           device="cpu")
    got = tgptoss.forward_paged_decode(
        tp, tcfg, torch.from_numpy(tokens), tcache.k_pages, tcache.v_pages,
        tcache.block_table, tcache.lengths)
    assert got[0].shape == (B, jcfg.vocab_size)
    _close(got[0].numpy(), want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_paged_decode_matches_contiguous_forward():
    """Row 0's 13-token prefix decoded token by token into pages, then
    one more step, against a contiguous prefill and decode step."""
    _, _, tcfg, tp = models()
    rng = np.random.default_rng(12)
    L, P, page = tcfg.num_layers, 6, 8
    seq = rng.integers(1, 512, 14).astype(np.int32)
    c = tgptoss.init_cache(tcfg, 1, max_seq=32, device="cpu")
    _, c = tgptoss.forward(tp, tcfg, torch.from_numpy(seq[None, :13]), c)
    lg, _ = tgptoss.forward(tp, tcfg, torch.from_numpy(seq[None, 13:]), c)
    tk = torch.zeros((L, P, 2, page, 64))
    tv = torch.zeros_like(tk)
    tbl = torch.tensor([[4, 1, -1, -1]], dtype=torch.int32)
    for pos in range(14):
        plg, tk, tv = tgptoss.forward_paged_decode(
            tp, tcfg, torch.from_numpy(seq[pos:pos + 1]), tk, tv, tbl,
            torch.tensor([pos], dtype=torch.int32))
    _close(plg.numpy(), lg[:, 0].numpy())


# -- engine and scheduler ---------------------------------------------------------

_E = {}


def engines(quant):
    if quant not in _E:
        jcfg, jp, tcfg, tp = models(quant)
        _E[quant] = (ti.InferenceEngine(jp, jcfg,
                                        ti.InferenceConfig(max_seq_len=64)),
                     InferenceEngine(tp, tcfg, InferenceConfig(max_seq_len=64),
                                     device="cpu"))
    return _E[quant]


@pytest.mark.parametrize("quant,B", [(False, 1), (False, 3), (True, 3),
                                     ("int8", 3)],
                         ids=["f32-B1", "f32-B3", "int4-B3", "int8-B3"])
def test_generate_batch_greedy_identical(quant, B):
    je, te = engines(quant)
    rng = np.random.default_rng(20 + B)
    prompts = [rng.integers(1, 512, size=n).tolist() for n in (7, 15, 4)[:B]]
    jres = je.generate_batch(prompts, 12, temperature=0.0)
    tres = te.generate_batch(prompts, 12, temperature=0.0)
    for a, b in zip(jres, tres):
        assert b.tokens == a.tokens
        assert b.stop_reason == a.stop_reason


def test_paged_scheduler_greedy_identical():
    jcfg, jp, tcfg, tp = models()
    icfg = dict(max_seq_len=64, temperature=0.0, eos_token_id=-1, seed=0)
    js = JPaged(jp, jcfg, ti.InferenceConfig(**icfg), batch_slots=2,
                page_size=8)
    ts = TPaged(tp, tcfg, InferenceConfig(**icfg), batch_slots=2,
                page_size=8, device="cpu")
    rng = np.random.default_rng(13)
    system = rng.integers(1, 512, 16).tolist()
    reqs = [system + rng.integers(1, 512, n).tolist() for n in (3, 9)] + \
        [rng.integers(1, 512, 11).tolist()]
    jids = [js.submit(r, 10) for r in reqs]
    tids = [ts.submit(r, 10) for r in reqs]
    jr, tr = js.run(), ts.run()
    for a, b in zip(jids, tids):
        assert tr[b].tokens == jr[a].tokens
        assert tr[b].stop_reason == jr[a].stop_reason
    assert ts.pool.hits == js.pool.hits > 0


def test_speculative_paged_serving_refused_as_in_jax():
    jcfg, jp, tcfg, tp = models()
    with pytest.raises(NotImplementedError, match="forward_paged_verify"):
        JPaged(jp, jcfg, ti.InferenceConfig(max_seq_len=64), batch_slots=2,
               page_size=8, draft_params=jp, draft_config=jcfg)
    with pytest.raises(NotImplementedError, match="forward_paged_verify"):
        TPaged(tp, tcfg, InferenceConfig(max_seq_len=64), batch_slots=2,
               page_size=8, draft_params=tp, draft_config=tcfg, device="cpu")
    assert not hasattr(tgptoss, "forward_paged_verify")


def test_cpu_path_never_launches():
    _, _, tcfg, tp = models()
    eng = InferenceEngine(tp, tcfg, InferenceConfig(max_seq_len=32),
                          device="cpu")
    kernels.reset_launch_counts()
    assert len(eng.generate([3, 1, 4], 5, temperature=0.0).tokens) == 8
    assert all(v == 0 for v in kernels.launch_counts().values())


# -- config, refusals and names ----------------------------------------------------

def test_gptoss20b_config_is_the_published_one():
    """gptoss20b_config against the JAX loader's mapping of
    openai/gpt-oss-20b's config.json."""
    hf = {"model_type": "gpt_oss", "attention_bias": True, "head_dim": 64,
          "hidden_size": 2880, "intermediate_size": 2880,
          "layer_types": ["sliding_attention", "full_attention"] * 12,
          "max_position_embeddings": 131072, "num_attention_heads": 64,
          "num_experts_per_tok": 4, "num_hidden_layers": 24,
          "num_key_value_heads": 8, "num_local_experts": 32,
          "rms_norm_eps": 1e-05, "rope_theta": 150000,
          "rope_scaling": {"beta_fast": 32.0, "beta_slow": 1.0,
                           "factor": 32.0,
                           "original_max_position_embeddings": 4096,
                           "rope_type": "yarn", "truncate": False},
          "sliding_window": 128, "tie_word_embeddings": False,
          "vocab_size": 201088}
    j = config_from_hf_dict(hf)
    t = tconfig.gptoss20b_config()
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "kv_heads", "head_dim_", "ffn_dim", "num_experts",
              "experts_per_token", "sliding_window", "sliding_window_pattern",
              "rope_theta", "rope_scaling", "attn_bias", "rms_norm_eps",
              "max_seq_len", "tie_embeddings", "architecture",
              "norm_topk_prob"):
        assert getattr(t, f) == getattr(j, f), f
    tgptoss.check_supported(t)
    assert tgptoss.layer_window(t, 0) == 128 and tgptoss.layer_window(t, 1) \
        is None


@pytest.mark.parametrize("knob", [dict(attn_logit_softcap=30.0),
                                  dict(qk_norm=True), dict(alibi=True),
                                  dict(architecture="mixtral")])
def test_check_supported_refuses(knob):
    with pytest.raises(NotImplementedError):
        tgptoss.check_supported(tconfig.ModelConfig(**{**CFG, **knob}))


def test_check_supported_config_errors():
    for kw in (dict(num_experts=0), dict(experts_per_token=5),
               dict(sliding_window=0)):
        with pytest.raises(ConfigError):
            tgptoss.check_supported(tconfig.ModelConfig(**{**CFG, **kw}))


def test_registry_names():
    assert registry.get_model("gpt_oss") is tgptoss


def test_gptoss_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.ModelConfig(**CFG)
    for call in (lambda: tgptoss.init_params(cfg),
                 lambda: tgptoss.init_cache(cfg, 1)):
        with pytest.raises(DeviceError):
            call()


# -- int8 and fp8 caches -----------------------------------------------------------

def _codes_close(got, want):
    """At most CODE_FLIPS of the codes differ, each by one step (int8: one
    code; fp8: the neighbouring e4m3 value of the same sign)."""
    got = np.asarray(got).astype(np.int16)
    want = np.asarray(want).astype(np.int16)
    diff = got != want
    assert diff.mean() <= CODE_FLIPS, diff.mean()
    assert (np.abs(got[diff] - want[diff]) == 1).all()


def _same_cache(tc, jc, scale_rtol=SCALE_RTOL):
    """Codes, int8 scale planes and lengths of the port's cache against
    the JAX package's head-major one. After decode steps pass
    scale_rtol=KV_LOGIT_RTOL: their K/V come from hidden states that read
    codes one step apart, as the logits do."""
    for t, j in ((tc.k, jc.k), (tc.v, jc.v)):
        _codes_close(t.numpy(), j)
    for t, j in ((tc.k_scale, jc.k_scale), (tc.v_scale, jc.v_scale)):
        assert (t is None) == (j is None)
        if t is not None:
            np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                       rtol=scale_rtol, atol=0)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def _kv_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=KV_LOGIT_RTOL * np.abs(want).max())


def _encoded(rng, shape, kind):
    """Random K/V (|x| < 448 for fp8: JAX's plain decode reads 0x7F/0xFF
    as NaN) encoded by the port's codec -> (JAX storage, JAX scales,
    port storage, port scales), the same bytes."""
    x = np.clip(rng.normal(size=shape) * 3, -400, 400).astype(np.float32)
    q, s = tcommon.encode_kv_scaled(torch.from_numpy(x), KV[kind][1])
    return (jnp.asarray(q.numpy()), None if s is None
            else jnp.asarray(s.numpy()), q, s)


@pytest.mark.parametrize("kind", list(KV))
@pytest.mark.parametrize("window", [8, None], ids=["window", "full"])
def test_compressed_decode_plain_matches_decode_fused_pallas(kind, window):
    """GPT-OSS's 8-bit decode: the decode kernel's plain version (what
    the wrapper runs on the CPU) on the head-major int8 (scale planes) or
    fp8 cache, with per-head sinks, against decode_fused_pallas in
    interpret mode on the same bytes transposed to its fused-head layout
    [L, B, T, Hkv*D] (the scale planes stay head-major there too)."""
    rng = np.random.default_rng(len(kind) + (window or 0))
    L, B, Hkv, T, D, Hq = 2, 3, 2, 128, 64, 16
    jk, jks, tk, tks = _encoded(rng, (L, B, Hkv, T, D), kind)
    jv, jvs, tv, tvs = _encoded(rng, (L, B, Hkv, T, D), kind)
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    sinks = (2 * rng.normal(size=(Hq,))).astype(np.float32)
    kv = np.array([1, 70, 128], np.int32)

    def fused(x):
        return jnp.transpose(x, (0, 1, 3, 2, 4)).reshape(L, B, T, Hkv * D)
    want = jda.decode_fused_pallas(
        jnp.asarray(q), fused(jk), fused(jv), jnp.asarray(kv),
        layer_index=jnp.int32(1), window=window, sinks=jnp.asarray(sinks),
        k_scale=jks, v_scale=jvs, interpret=True)
    assert want is not None
    got = tda.decode_attention(torch.from_numpy(q), tk, tv,
                               torch.from_numpy(kv), 1, window,
                               torch.from_numpy(sinks), tks, tvs)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= \
        KERNEL_RTOL * np.abs(want).max()


@pytest.mark.parametrize("kind", list(KV))
@pytest.mark.parametrize("B,fresh", [(1, True), (3, False)])
def test_compressed_forward_prefill_and_decode_match_jax(kind, B, fresh):
    """Prefill into an int8 or fp8 cache (both packages attend the
    quantized K/V read back from it, fresh or not), then decode steps
    through the decode kernel's 8-bit read with sinks and windows:
    logits, cache bytes and scale planes after every call."""
    jcfg, jp, tcfg, tp = models()
    jd, td = KV[kind]
    rng = np.random.default_rng(30 + B)
    S, T = 14, 32
    toks = rng.integers(1, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    lens = np.array([14, 9, 3][:B], np.int32)
    jc = jgptoss.init_cache(jcfg, B, max_seq=T, dtype=jd, fused=False)
    jl, jc = jgptoss.forward(jp, jcfg, jnp.asarray(toks), jc,
                             seq_lens=jnp.asarray(lens))
    tc = tgptoss.init_cache(tcfg, B, max_seq=T, dtype=td, device="cpu")
    assert (tc.k_scale is not None) == (kind == "int8")
    tl, tc = tgptoss.forward(tp, tcfg, torch.from_numpy(toks), tc,
                             seq_lens=torch.from_numpy(lens),
                             fresh_prefill=fresh)
    valid = np.arange(S)[None, :] < lens[:, None]
    _kv_close(tl.numpy()[valid], np.asarray(jl)[valid])
    _same_cache(tc, jc)
    nxt = np.asarray(jnp.argmax(jl[np.arange(B), lens - 1], -1)).astype(
        np.int32)
    for _ in range(3):
        jl, jc = jgptoss.forward(jp, jcfg, jnp.asarray(nxt[:, None]), jc)
        tl, tc = tgptoss.forward(tp, tcfg, torch.from_numpy(nxt[:, None]), tc)
        _kv_close(tl.numpy(), jl)
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)
    _same_cache(tc, jc, KV_LOGIT_RTOL)


def test_compressed_fresh_prefill_attends_the_cache():
    """With an int8 cache the fresh prefill sees the quantized K/V (what
    a later step reads back), not the fresh values: its logits equal a
    non-fresh prefill's (which streams over the whole cache, so its sums
    run over more, masked, keys) and differ from the model-dtype
    cache's."""
    _, _, tcfg, tp = models()
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, 512, (2, 12)).astype(np.int32))
    out = {}
    for name, dt, fresh in (("fresh", torch.int8, True),
                            ("chunked", torch.int8, False),
                            ("model", None, True)):
        c = tgptoss.init_cache(tcfg, 2, max_seq=32, dtype=dt, device="cpu")
        out[name] = tgptoss.forward(tp, tcfg, toks, c,
                                    fresh_prefill=fresh)[0]
    torch.testing.assert_close(out["fresh"], out["chunked"], rtol=0,
                               atol=1e-5)
    assert not torch.allclose(out["fresh"], out["model"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", list(KV))
def test_compressed_generate_batch_greedy_identical(kind):
    """generate_batch over int8 and fp8 caches: greedy tokens equal the
    JAX engine's, and the cache holds the dtype's bytes."""
    jcfg, jp, tcfg, tp = models()
    je = ti.InferenceEngine(jp, jcfg, ti.InferenceConfig(
        max_seq_len=64, kv_cache_dtype=kind))
    te = InferenceEngine(tp, tcfg, InferenceConfig(max_seq_len=64,
                                                   kv_cache_dtype=kind),
                         device="cpu")
    rng = np.random.default_rng(40)
    prompts = [rng.integers(1, 512, size=n).tolist() for n in (7, 15, 4)]
    jres = je.generate_batch(prompts, 12, temperature=0.0)
    tres = te.generate_batch(prompts, 12, temperature=0.0)
    for a, b in zip(jres, tres):
        assert b.tokens == a.tokens and b.stop_reason == a.stop_reason
    assert te._take_cache(3).k.dtype == KV[kind][1]


def test_paged_fp8_decode_matches_jax():
    """One paged decode step over fp8 pages (written through the
    encode-and-write path, read through the plain sink- and window-aware
    form) against the JAX package's forward_paged_decode: logits and the
    pages after the write."""
    jcfg, jp, tcfg, tp = models(True)
    rng = np.random.default_rng(14)
    L, P, page, B = jcfg.num_layers, 10, 8, 3
    Hkv, D = jcfg.kv_heads, jcfg.head_dim_
    jk, _, tk, _ = _encoded(rng, (L, P, Hkv, page, D), "fp8")
    jv, _, tv, _ = _encoded(rng, (L, P, Hkv, page, D), "fp8")
    table = np.array([[3, 7, 1, -1], [8, 2, -1, -1], [5, 4, 6, 9]], np.int32)
    lengths = np.array([13, 6, 20], np.int32)
    tokens = rng.integers(1, jcfg.vocab_size, (B,)).astype(np.int32)
    want = jgptoss.forward_paged_decode(
        jp, jcfg, jnp.asarray(tokens), jk, jv, jnp.asarray(table),
        jnp.asarray(lengths))
    got = tgptoss.forward_paged_decode(
        tp, tcfg, torch.from_numpy(tokens), tk, tv, torch.from_numpy(table),
        torch.from_numpy(lengths))
    _kv_close(got[0].numpy(), want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.uint8
        _codes_close(g.numpy(), w)
    with pytest.raises(NotImplementedError):
        tgptoss.forward_paged_decode(
            tp, tcfg, torch.from_numpy(tokens), tk.view(torch.int8),
            tv.view(torch.int8), torch.from_numpy(table),
            torch.from_numpy(lengths))


def test_paged_scheduler_fp8_greedy_identical_and_int8_refused():
    """The paged scheduler serves an fp8 pool (prefix hits included) with
    the JAX package's greedy tokens, and refuses an int8 pool at
    construction as the JAX package does (its contiguous scheduler and
    engine take int8)."""
    jcfg, jp, tcfg, tp = models()
    icfg = dict(max_seq_len=64, temperature=0.0, eos_token_id=-1, seed=0)
    js = JPaged(jp, jcfg, ti.InferenceConfig(kv_cache_dtype="fp8", **icfg),
                batch_slots=2, page_size=8)
    ts = TPaged(tp, tcfg, InferenceConfig(kv_cache_dtype="fp8", **icfg),
                batch_slots=2, page_size=8, device="cpu")
    assert ts.cache.k_pages.dtype == torch.uint8
    rng = np.random.default_rng(15)
    system = rng.integers(1, 512, 16).tolist()
    reqs = [system + rng.integers(1, 512, n).tolist() for n in (3, 9)] + \
        [rng.integers(1, 512, 11).tolist()]
    jids = [js.submit(r, 10) for r in reqs]
    tids = [ts.submit(r, 10) for r in reqs]
    jr, tr = js.run(), ts.run()
    for a, b in zip(jids, tids):
        assert tr[b].tokens == jr[a].tokens
    assert ts.pool.hits == js.pool.hits > 0
    with pytest.raises(NotImplementedError, match="int8"):
        JPaged(jp, jcfg, ti.InferenceConfig(kv_cache_dtype="int8", **icfg),
               batch_slots=2, page_size=8)
    with pytest.raises(NotImplementedError, match="int8"):
        TPaged(tp, tcfg, InferenceConfig(kv_cache_dtype="int8", **icfg),
               batch_slots=2, page_size=8, device="cpu")
