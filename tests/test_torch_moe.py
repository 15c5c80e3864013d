"""The MoE family of the port (models/moe.py) against turboinfer_tpu's.

A tiny Mixtral (H=128, L=2, Hq=4, Hkv=2, D=32, F=256, E=4, top-2,
V=512) and one with D=128 (Hq=2, Hkv=1), in f32, with fp experts and
with int4 g=64 experts from the JAX quantizer, bridged through numpy.
Logits are compared within 1e-4 of max|logit| (the same f32 arithmetic
on the CPU; only summation order differs), the routing exactly, greedy
trajectories token for token. B=1 decode takes the grouped regime, B=3
the E-loop (int4) or the dense einsum (fp).
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
from turboinfer_tpu.models import moe as jmoe
from turboinfer_tpu.quant import quantizer as jquantizer
from turboinfer_tpu_torch import bridge, kernels
from turboinfer_tpu_torch import config as tconfig
from turboinfer_tpu_torch.config import InferenceConfig, QuantizationConfig
from turboinfer_tpu_torch.config import QuantType
from turboinfer_tpu_torch.core.qtensor import QTensor, dequantize
from turboinfer_tpu_torch.engine.engine import InferenceEngine
from turboinfer_tpu_torch.engine.scheduler import \
    PagedContinuousScheduler as TPaged
from turboinfer_tpu_torch.kernels import ops, qmm
from turboinfer_tpu_torch.kernels.dispatch import prepare_params
from turboinfer_tpu_torch.loader.synthetic import \
    create_synthetic_quantized_model
from turboinfer_tpu_torch.models import llama as tllama
from turboinfer_tpu_torch.models import moe as tmoe
from turboinfer_tpu_torch.models import registry
from turboinfer_tpu_torch.quant import quantizer as tquantizer
from turboinfer_tpu_torch.utils.errors import ConfigError, DeviceError

torch.set_num_threads(2)

LOGIT_RTOL = 1e-4        # of max|logit|

CFGS = {
    "tiny": dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
                 num_kv_heads=2, intermediate_size=256, num_experts=4,
                 experts_per_token=2, max_seq_len=128,
                 architecture="mixtral", name="tiny-mixtral"),
    "d128": dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
                 num_kv_heads=1, intermediate_size=256, num_experts=4,
                 experts_per_token=2, max_seq_len=128,
                 architecture="mixtral", name="tiny-mixtral-d128"),
}

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


# quant -> (weight type, symmetric) for the JAX quantizer at g=64
QUANTS = {True: (JQuantType.INT4, True), "int8": (JQuantType.INT8, True),
          "int8_asym": (JQuantType.INT8, False)}
QUANT_PARAMS = dict(argvalues=[False, True, "int8", "int8_asym"],
                    ids=["fp", "int4", "int8", "int8_asym"])


def models(name="tiny", quant=False, norm_topk_prob=True, **extra):
    """(JAX config, JAX params, port config, port params) on the same
    weights: fp (quant False), or the JAX quantizer's g=64 output: int4
    (quant True), int8 ("int8") or int8 with zero points
    ("int8_asym")."""
    key = (name, quant, norm_topk_prob, tuple(sorted(extra.items())))
    if key not in _P:
        kw = dict(CFGS[name], norm_topk_prob=norm_topk_prob, **extra)
        jcfg = JModelConfig(dtype=jnp.float32, **kw)
        tcfg = tconfig.ModelConfig(dtype=torch.float32, **kw)
        jp = jmoe.init_params(jax.random.PRNGKey(0), jcfg)
        if quant:
            qtype, sym = QUANTS[quant]
            jp = jquantizer.quantize_params(
                jp, JQuantCfg(type=qtype, group_size=64, symmetric=sym))
        tp = bridge.params_from_numpy(jax_to_numpy(jp), device="cpu")
        _P[key] = (jcfg, jp, tcfg, tp)
    return _P[key]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max())


# -- forward ------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int4"])
@pytest.mark.parametrize("norm_topk_prob", [True, False],
                         ids=["renorm", "raw"])
@pytest.mark.parametrize("B", [1, 3])
def test_forward_prefill_and_decode_logits(name, quant, norm_topk_prob, B):
    _check_forward(name, quant, norm_topk_prob, B)


@pytest.mark.parametrize("quant", ["int8", "int8_asym"])
@pytest.mark.parametrize("B", [1, 3])
def test_forward_logits_int8_weights(quant, B):
    """int8 experts and attention, symmetric and with zero points (the
    B=1 decode through the grouped path, B=3 through the E-loop)."""
    _check_forward("tiny", quant, True, B)


def _check_forward(name, quant, norm_topk_prob, B):
    jcfg, jp, tcfg, tp = models(name, quant, norm_topk_prob)
    rng = np.random.default_rng(B)
    S, T = 12, 32
    toks = rng.integers(1, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    lens = np.array([12, 7, 3][:B], np.int32)
    idx = lens - 1
    jc = jmoe.init_cache(jcfg, B, max_seq=T)
    jl, jc = jmoe.forward(jp, jcfg, jnp.asarray(toks), jc,
                          seq_lens=jnp.asarray(lens),
                          logit_idx=jnp.asarray(idx), fresh_prefill=True)
    tc = tmoe.init_cache(tcfg, B, max_seq=T, device="cpu")
    tl, tc = tmoe.forward(tp, tcfg, torch.from_numpy(toks), tc,
                          seq_lens=torch.from_numpy(lens),
                          logit_idx=torch.from_numpy(idx), fresh_prefill=True)
    assert tl.shape == (B, 1, jcfg.vocab_size) and tl.dtype == torch.float32
    _close(tl.numpy(), jl)
    nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)
    for _ in range(2):
        jl, jc = jmoe.forward(jp, jcfg, jnp.asarray(nxt[:, None]), jc)
        tl, tc = tmoe.forward(tp, tcfg, torch.from_numpy(nxt[:, None]), tc)
        _close(tl.numpy(), jl)
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)


@pytest.mark.parametrize("norm_topk_prob", [True, False],
                         ids=["renorm", "raw"])
@pytest.mark.parametrize("B", [1, 3])
def test_routing_identical(monkeypatch, norm_topk_prob, B):
    """top_i and the gates of every layer, prefill and decode, as the
    JAX package's _moe_ffn hands them to expert_mix."""
    jcfg, jp, tcfg, tp = models("tiny", True, norm_topk_prob)
    jrec, trec = [], []
    j_mix, t_mix = jmoe.expert_mix, tmoe.expert_mix

    def j_spy(config, h, lw, gates, top_i, layer_index=None):
        jax.debug.callback(lambda g, i: jrec.append((np.asarray(g),
                                                     np.asarray(i))),
                           gates, top_i, ordered=True)
        return j_mix(config, h, lw, gates, top_i, layer_index=layer_index)

    def t_spy(config, h, lw, li, gates, top_i):
        trec.append((gates.numpy(), top_i.numpy()))
        return t_mix(config, h, lw, li, gates, top_i)
    monkeypatch.setattr(jmoe, "expert_mix", j_spy)
    monkeypatch.setattr(tmoe, "expert_mix", t_spy)
    toks = np.random.default_rng(5).integers(1, 512, (B, 10)).astype(np.int32)
    jc = jmoe.init_cache(jcfg, B, max_seq=16)
    jl, jc = jmoe.forward(jp, jcfg, jnp.asarray(toks), jc)
    tc = tmoe.init_cache(tcfg, B, max_seq=16, device="cpu")
    _, tc = tmoe.forward(tp, tcfg, torch.from_numpy(toks), tc)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    jmoe.forward(jp, jcfg, jnp.asarray(nxt), jc)
    tmoe.forward(tp, tcfg, torch.from_numpy(nxt), tc)
    jax.effects_barrier()
    assert len(trec) == len(jrec) == 2 * jcfg.num_layers
    for (jg, ji), (tg, tI) in zip(jrec, trec):
        np.testing.assert_array_equal(tI, ji)
        np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=1e-6)
        if norm_topk_prob:
            np.testing.assert_allclose(tg.sum(-1), 1.0, rtol=1e-6)


def test_prepared_params_are_flat_fused_and_equal():
    """prepare_params views the 4-D expert stacks as [L*E] and fuses
    we_gate/we_up into we_gateup; the logits do not move."""
    _, _, tcfg, tp = models("tiny", True)
    prep = prepare_params(tp)
    lw = prep["layers"]
    L, E = tcfg.num_layers, tcfg.num_experts
    assert "we_gate" not in lw and "we_up" not in lw
    assert lw["we_gateup"].data.shape == (L * E, 64, 512)
    assert lw["we_down"].data.shape == (L * E, 128, 128)
    assert lw["we_gateup"].shape == (128, 512)
    assert prepare_params(prep)["layers"].keys() == lw.keys()
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        1, 512, (1, 9)).astype(np.int32))
    outs = []
    for p in (tp, prep):
        c = tmoe.init_cache(tcfg, 1, max_seq=16, device="cpu")
        lg, c = tmoe.forward(p, tcfg, toks, c)
        lg2, _ = tmoe.forward(p, tcfg, toks[:, :1], c)
        outs.append((lg, lg2))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


# -- quantizer, fixture, bridge, 4-D guard ------------------------------------

def test_quantize_experts_bytes_identical():
    rng = np.random.default_rng(7)
    w = rng.normal(size=(2, 3, 128, 64)).astype(np.float32)
    cfg = dict(type=QuantType.INT4, group_size=64)
    want = jquantizer._quantize_experts(
        jnp.asarray(w), JQuantCfg(type=JQuantType.INT4, group_size=64))
    got = tquantizer._quantize_experts(torch.from_numpy(w),
                                       QuantizationConfig(**cfg))
    assert got.data.shape == (2, 3, 64, 64) and got.scales.shape == (2, 3, 2, 64)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(
        got.scales.view(torch.int16).numpy(),
        np.asarray(want.scales).view(np.int16))
    # the whole tree: attention stacks, experts, head; the router stays fp
    jcfg, jp, tcfg, tp = models("tiny")
    jq = jquantizer.quantize_params(jp, JQuantCfg(type=JQuantType.INT4,
                                                  group_size=64))
    tq = tquantizer.quantize_params(tp, QuantizationConfig(**cfg))
    assert not isinstance(tq["layers"]["router"], QTensor)
    for name in ("wq", "wo", "we_gate", "we_up", "we_down"):
        np.testing.assert_array_equal(tq["layers"][name].data.numpy(),
                                      np.asarray(jq["layers"][name].data))
    # dequantize of the 4-D stack is the per-expert dequantize
    full = dequantize(got)
    assert full.shape == (2, 3, 128, 64)
    torch.testing.assert_close(full[1, 2], dequantize(QTensor(
        data=got.data[1, 2], scales=got.scales[1, 2], zero_points=None,
        bits=4, group_size=64, shape=(128, 64))))


@pytest.mark.parametrize("qtype,jtype", [(QuantType.INT4, JQuantType.INT4),
                                         (QuantType.INT8, JQuantType.INT8)])
def test_quantize_params_asymmetric_experts_identical(qtype, jtype):
    """Zero points of 4-D expert stacks: [L, E, K/g, N] like the scales,
    byte-identical to JAX's, kept through the bridge, flat() and the
    we_gate/we_up fusion of prepare_params."""
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    _, jp, _, tp = models("tiny")
    jq = jquantizer.quantize_params(jp, JQuantCfg(
        type=jtype, group_size=64, symmetric=False))
    tq = tquantizer.quantize_params(tp, QuantizationConfig(
        type=qtype, group_size=64, symmetric=False))
    bridged = bridge.params_from_numpy(jax_to_numpy(jq), device="cpu")
    for name in ("wq", "wo", "we_gate", "we_up", "we_down"):
        got, want = tq["layers"][name], jq["layers"][name]
        assert got.zero_points.shape == got.scales.shape
        for a, b in ((got.data, want.data), (bridged["layers"][name].data,
                                             want.data)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a in (got.zero_points, bridged["layers"][name].zero_points):
            np.testing.assert_array_equal(
                a.view(torch.int16).numpy(),
                np.asarray(want.zero_points).view(np.int16))
    assert tq["layers"]["we_down"].zero_points.dim() == 4
    fused = prepare_params(tq)["layers"]["we_gateup"]
    L, E = 2, 4
    zg = np.asarray(jq["layers"]["we_gate"].zero_points).view(np.int16)
    zu = np.asarray(jq["layers"]["we_up"].zero_points).view(np.int16)
    np.testing.assert_array_equal(
        fused.zero_points.view(torch.int16).numpy(),
        np.concatenate([zg, zu], -1).reshape(L * E, zg.shape[2], -1))


def test_bridge_carries_a_moe_tree():
    _, jp, _, tp = models("tiny", True)
    lw = tp["layers"]
    assert isinstance(lw["we_down"], QTensor) and lw["we_down"].data.dim() == 4
    assert lw["router"].shape == (2, 128, 4)
    back = bridge.to_numpy(tp)
    want = jax_to_numpy(jp)
    for name in ("we_gate", "we_up", "we_down"):
        np.testing.assert_array_equal(back["layers"][name]["data"],
                                      want["layers"][name]["data"])
        np.testing.assert_array_equal(back["layers"][name]["scales"],
                                      want["layers"][name]["scales"])
    np.testing.assert_array_equal(back["layers"]["router"],
                                  want["layers"]["router"])


def test_a_4d_expert_stack_is_never_indexed_as_layers():
    _, _, _, tp = models("tiny", True)
    qt = tp["layers"]["we_down"]
    x = torch.randn(1, 256)
    with pytest.raises(ValueError):
        qt.layer(1)
    with pytest.raises(ValueError):
        ops.qmatmul(x, qt, 1)
    with pytest.raises(ValueError):
        qmm.qmatmul_grouped_plain(x[None], qt, torch.tensor([0]))
    flat = qt.flat()
    assert flat.stacked and flat.data.shape[0] == 8
    assert flat.data.data_ptr() == qt.data.data_ptr()
    torch.testing.assert_close(ops.qmatmul(x, flat, 5),
                               qmm.qmatmul_plain(x, QTensor(
                                   data=qt.data[1, 1], scales=qt.scales[1, 1],
                                   zero_points=None, bits=4, group_size=64,
                                   shape=qt.shape)))


def test_synthetic_moe_fixture_serves_on_the_cpu():
    cfg = tconfig.mixtral_config(vocab_size=256, hidden_size=128,
                                 num_layers=2, num_heads=4, num_kv_heads=2,
                                 intermediate_size=128, max_seq_len=64)
    data = create_synthetic_quantized_model(cfg, device="cpu")
    lw = data.params["layers"]
    assert "w_gate" not in lw and lw["router"].dtype == torch.bfloat16
    assert lw["router"].shape == (2, 128, 8)
    assert lw["we_gate"].data.shape == (2, 8, 64, 128)
    assert lw["we_down"].scales.shape == (2, 8, 2, 128)
    eng = InferenceEngine(data.params, cfg, InferenceConfig(max_seq_len=64),
                          device="cpu")
    kernels.reset_launch_counts()
    res = eng.generate([3, 1, 4, 1, 5], 6, temperature=0.0)
    assert len(res.tokens) == 11
    assert all(v == 0 for v in kernels.launch_counts().values())


def test_synthetic_int8_fixture_with_fused_experts():
    """bits=8 draws int8 codes; fused_experts draws the serving layout
    we_gateup directly, which prepare_params then leaves as it is (no
    second copy of the gate and up stacks)."""
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    cfg = tconfig.mixtral_config(vocab_size=256, hidden_size=128,
                                 num_layers=2, num_heads=4, num_kv_heads=2,
                                 intermediate_size=128, max_seq_len=64)
    lw = create_synthetic_quantized_model(cfg, bits=8, device="cpu",
                                          fused_experts=True).params["layers"]
    assert "we_gate" not in lw and "we_up" not in lw
    qt = lw["we_gateup"]
    assert (qt.bits, qt.data.dtype, qt.data.shape, qt.shape) == (
        8, torch.int8, (2, 8, 128, 256), (128, 256))
    assert lw["wq"].data.dtype == torch.int8
    flat = prepare_params({"layers": lw})["layers"]["we_gateup"]
    assert flat.data.shape == (16, 128, 256)
    assert flat.data.data_ptr() == qt.data.data_ptr()       # a view


def test_mixtral_config_shape():
    c = tconfig.mixtral_config()
    assert (c.hidden_size, c.num_layers, c.num_heads, c.kv_heads,
            c.head_dim_, c.ffn_dim, c.num_experts, c.experts_per_token,
            c.vocab_size, c.rope_theta) == (4096, 32, 32, 8, 128, 14336, 8,
                                            2, 32000, 1e6)
    j = ti.config.mixtral_config()
    for f in ("hidden_size", "num_layers", "num_heads", "num_kv_heads",
              "intermediate_size", "num_experts", "experts_per_token",
              "vocab_size", "rope_theta", "architecture", "max_seq_len"):
        assert getattr(c, f) == getattr(j, f), f


# -- paged forwards -------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int4"])
@pytest.mark.parametrize("G", [1, 3])
def test_paged_forwards_match_jax_with_rope_scaling(quant, G):
    """The paged decode (G=1) and verify (G=3) bodies with the MoE FFN,
    on a rope-scaled config: RoPE scaling must be the same in the paged
    body as in the contiguous one (the JAX package once dropped it in
    MoE paged prefill)."""
    jcfg, jp, tcfg, tp = models(
        "tiny", quant, rope_scaling=(("type", "linear"), ("factor", 2.0)))
    rng = np.random.default_rng(G)
    L, P, page, B = jcfg.num_layers, 10, 8, 3
    Hkv, D = jcfg.kv_heads, jcfg.head_dim_
    kp = rng.normal(size=(L, P, Hkv, page, D)).astype(np.float32)
    vp = rng.normal(size=(L, P, Hkv, page, D)).astype(np.float32)
    table = np.array([[3, 7, 1, -1], [8, 2, -1, -1], [5, 4, 6, 9]], np.int32)
    lengths = np.array([13, 6, 20], np.int32)
    tokens = rng.integers(1, jcfg.vocab_size, (B, G)).astype(np.int32)
    tcache = bridge.paged_cache_from_numpy(kp, vp, table, lengths,
                                           device="cpu")
    args = (jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
            jnp.asarray(lengths))
    targs = (tcache.k_pages, tcache.v_pages, tcache.block_table,
             tcache.lengths)
    if G == 1:
        want = jmoe.forward_paged_decode(jp, jcfg, jnp.asarray(tokens[:, 0]),
                                         *args)
        got = tmoe.forward_paged_decode(tp, tcfg,
                                        torch.from_numpy(tokens[:, 0]), *targs)
    else:
        want = jmoe.forward_paged_verify(jp, jcfg, jnp.asarray(tokens), *args)
        got = tmoe.forward_paged_verify(tp, tcfg, torch.from_numpy(tokens),
                                        *targs)
    _close(got[0].numpy(), want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    # and the same positions through the contiguous forward: a prefill of
    # row 0's prefix then its decode token, against the paged decode
    if G == 1:
        seq = rng.integers(1, jcfg.vocab_size, 13).astype(np.int32)
        c = tmoe.init_cache(tcfg, 1, max_seq=32, device="cpu")
        _, c = tmoe.forward(tp, tcfg, torch.from_numpy(seq[None]), c)
        lg, _ = tmoe.forward(tp, tcfg, torch.from_numpy(tokens[:1, :1]), c)
        tk = torch.zeros((L, P, Hkv, page, D))
        tv = torch.zeros_like(tk)
        tbl = torch.tensor([[1, 2, -1, -1]], dtype=torch.int32)
        for pos in range(13):
            _, tk, tv = tmoe.forward_paged_decode(
                tp, tcfg, torch.from_numpy(seq[pos:pos + 1]), tk, tv, tbl,
                torch.tensor([pos], dtype=torch.int32))
        plg, _, _ = tmoe.forward_paged_decode(
            tp, tcfg, torch.from_numpy(tokens[:1, 0]), tk, tv, tbl,
            torch.tensor([13], dtype=torch.int32))
        _close(plg.numpy(), lg[:, 0].numpy())


# -- engine and scheduler -----------------------------------------------------

_E = {}


def engines(name, quant):
    if (name, quant) not in _E:
        jcfg, jp, tcfg, tp = models(name, quant)
        icfg = dict(max_seq_len=64)
        _E[name, quant] = (ti.InferenceEngine(jp, jcfg,
                                              ti.InferenceConfig(**icfg)),
                           InferenceEngine(tp, tcfg, InferenceConfig(**icfg),
                                           device="cpu"))
    return _E[name, quant]


@pytest.mark.parametrize("name,quant", [("tiny", True), ("tiny", False),
                                        ("d128", True), ("tiny", "int8"),
                                        ("tiny", "int8_asym")])
@pytest.mark.parametrize("B", [1, 3])
def test_generate_batch_greedy_identical(name, quant, B):
    je, te = engines(name, quant)
    rng = np.random.default_rng(10 + B)
    prompts = [rng.integers(1, 512, size=n).tolist() for n in (7, 15, 4)[:B]]
    jres = je.generate_batch(prompts, 12, temperature=0.0)
    tres = te.generate_batch(prompts, 12, temperature=0.0)
    for a, b in zip(jres, tres):
        assert b.tokens == a.tokens
        assert b.stop_reason == a.stop_reason


@pytest.mark.parametrize("quant", **QUANT_PARAMS)
def test_paged_scheduler_greedy_identical(quant):
    jcfg, jp, tcfg, tp = models("tiny", quant)
    icfg = dict(max_seq_len=64, temperature=0.0, eos_token_id=-1, seed=0)
    js = JPaged(jp, jcfg, ti.InferenceConfig(**icfg), batch_slots=2,
                page_size=8)
    ts = TPaged(tp, tcfg, InferenceConfig(**icfg), batch_slots=2,
                page_size=8, device="cpu")
    rng = np.random.default_rng(12)
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


# -- refusals and names ---------------------------------------------------------

@pytest.mark.parametrize("knob", [dict(shared_expert_size=64),
                                  dict(attn_bias=True), dict(qk_norm=True),
                                  dict(sliding_window=16),
                                  dict(architecture="qwen2_moe")])
def test_check_supported_refuses(knob):
    cfg = tconfig.ModelConfig(**{**CFGS["tiny"], **knob})
    with pytest.raises(NotImplementedError):
        tmoe.check_supported(cfg)


def test_check_supported_config_errors():
    for kw in (dict(num_experts=0), dict(experts_per_token=5)):
        with pytest.raises(ConfigError):
            tmoe.check_supported(tconfig.ModelConfig(**{**CFGS["tiny"], **kw}))
    tmoe.check_supported(tconfig.mixtral_config())
    with pytest.raises(NotImplementedError):   # llama refuses MoE configs
        tllama.check_supported(tconfig.mixtral_config())


def test_registry_names():
    assert registry.get_model("mixtral") is tmoe
    assert registry.get_model("moe") is tmoe
    assert registry.get_model("llama") is tllama
    for name in ("qwen2_moe", "qwen3_moe", "olmoe", "deepseek", "gpt2"):
        with pytest.raises(ConfigError):
            registry.get_model(name)


def test_moe_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfig.ModelConfig(**CFGS["tiny"])
    for call in (lambda: tmoe.init_params(cfg), lambda: tmoe.init_cache(cfg, 1),
                 lambda: create_synthetic_quantized_model(cfg)):
        with pytest.raises(DeviceError):
            call()
