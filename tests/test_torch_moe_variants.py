"""The MoE variants of the port (models/moe.py: Qwen2-MoE, Qwen3-MoE,
OLMoE) against turboinfer_tpu's.

Three tiny configs (H=64, L=2, vocab 256, experts of width 64) in f32,
on the same weights bridged through numpy, every norm weight perturbed
so the q/k norms show:
  qwen2_moe  4:2 heads of 16, q/k/v biases, 4 experts top-2 with raw
             softmax gates, a 64-wide shared expert with its sigmoid gate;
  qwen3_moe  4:2 heads of 32, per-head q/k RMSNorm, 8 experts top-2,
             renormalised gates;
  olmoe      4:4 heads of 16, q/k RMSNorm over the whole projection
             ([Hq*D] / [Hkv*D] weights, as the checkpoint ships them),
             8 experts top-2, raw gates.
Logits are compared within 1e-4 of max|logit| over model caches and
1e-3 over int8/fp8 ones (a K/V code may land one step apart after f32
summation-order drift, as in tests/test_torch_kvcache.py), greedy
trajectories token for token, quantizer codes byte for byte.
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
from turboinfer_tpu.engine.scheduler import \
    PagedContinuousScheduler as JPaged
from turboinfer_tpu.loader import mapping as jmapping
from turboinfer_tpu.loader import synthetic as jsynthetic
from turboinfer_tpu.models import moe as jmoe
from turboinfer_tpu.quant import quantizer as jquantizer
from turboinfer_tpu_torch import bridge, kernels
from turboinfer_tpu_torch import config as tconfig
from turboinfer_tpu_torch.config import InferenceConfig, QuantizationConfig
from turboinfer_tpu_torch.config import QuantType
from turboinfer_tpu_torch.core.qtensor import QTensor
from turboinfer_tpu_torch.engine.engine import InferenceEngine
from turboinfer_tpu_torch.engine.scheduler import \
    PagedContinuousScheduler as TPaged
from turboinfer_tpu_torch.loader import mapping as tmapping
from turboinfer_tpu_torch.loader.synthetic import \
    create_synthetic_quantized_model
from turboinfer_tpu_torch.models import moe as tmoe
from turboinfer_tpu_torch.models import registry
from turboinfer_tpu_torch.quant import quantizer as tquantizer

from test_torch_moe import jax_to_numpy

torch.set_num_threads(2)

LOGIT_RTOL = {"model": 1e-4, "int8": 1e-3, "fp8": 1e-3}   # of max|logit|

BASE = dict(vocab_size=256, hidden_size=64, num_layers=2,
            intermediate_size=128, moe_intermediate_size=64,
            experts_per_token=2, max_seq_len=128, rms_norm_eps=1e-6)
CFGS = {
    "qwen2_moe": dict(num_heads=4, num_kv_heads=2, num_experts=4,
                      shared_expert_size=64, attn_bias=True,
                      norm_topk_prob=False, rope_theta=1e6,
                      architecture="qwen2_moe", name="tiny-qwen2-moe"),
    "qwen3_moe": dict(num_heads=4, num_kv_heads=2, head_dim=32,
                      num_experts=8, qk_norm=True, norm_topk_prob=True,
                      rope_theta=1e6, architecture="qwen3_moe",
                      name="tiny-qwen3-moe"),
    "olmoe": dict(num_heads=4, num_kv_heads=4, num_experts=8, qk_norm=True,
                  norm_topk_prob=False, architecture="olmoe",
                  name="tiny-olmoe"),
}
ARCHS = list(CFGS)
KV = {"model": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8),
      "fp8": (jnp.uint8, torch.uint8)}
_P = {}


def models(name, quant=False):
    """(JAX config, JAX params, port config, port params): JAX's
    init_params with every norm perturbed (OLMoE's q/k norms widened to
    the whole projection), fp or the JAX quantizer's int4 g=64 output."""
    if (name, quant) not in _P:
        kw = dict(BASE, **CFGS[name])
        jcfg = JModelConfig(dtype=jnp.float32, **kw)
        tcfg = tconfig.ModelConfig(dtype=torch.float32, **kw)
        jp = jmoe.init_params(jax.random.PRNGKey(0), jcfg)
        rng = np.random.default_rng(9)
        lw = dict(jp["layers"])
        L, D = jcfg.num_layers, jcfg.head_dim_
        widths = dict(q_norm=jcfg.num_heads * D, k_norm=jcfg.kv_heads * D) \
            if name == "olmoe" else {}
        for k in ("attn_norm", "ffn_norm", "q_norm", "k_norm"):
            if k in lw:
                n = widths.get(k, lw[k].shape[-1])
                lw[k] = jnp.asarray(1.0 + 0.2 * rng.normal(size=(L, n)),
                                    jnp.float32)
        jp = {**jp, "layers": lw}
        if quant:
            jp = jquantizer.quantize_params(
                jp, JQuantCfg(type=JQuantType.INT4, group_size=64))
        tp = bridge.params_from_numpy(jax_to_numpy(jp), device="cpu")
        _P[name, quant] = (jcfg, jp, tcfg, tp)
    return _P[name, quant]


_jforward = jax.jit(jmoe.forward, static_argnums=(1,),
                    static_argnames=("fresh_prefill",))
_jverify = jax.jit(jmoe.forward_paged_verify, static_argnums=(1,))
_jdecode = jax.jit(jmoe.forward_paged_decode, static_argnums=(1,))


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * np.abs(want).max())


# -- forward ------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("kv", list(KV))
def test_forward_logits_match_jax(name, kv):
    """A fresh B=2 prefill (ragged lengths, last-position head) and two
    decode steps over a model, int8 or fp8 cache."""
    jcfg, jp, tcfg, tp = models(name)
    jdt, tdt = KV[kv]
    B, S, T = 2, 11, 32
    rng = np.random.default_rng(2)
    toks = rng.integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([11, 6], np.int32)
    jc = jmoe.init_cache(jcfg, B, max_seq=T, dtype=jdt)
    jl, jc = _jforward(jp, jcfg, jnp.asarray(toks), jc,
                       seq_lens=jnp.asarray(lens),
                       logit_idx=jnp.asarray(lens - 1), fresh_prefill=True)
    tc = tmoe.init_cache(tcfg, B, max_seq=T, dtype=tdt, device="cpu")
    tl, tc = tmoe.forward(tp, tcfg, torch.from_numpy(toks), tc,
                          seq_lens=torch.from_numpy(lens),
                          logit_idx=torch.from_numpy(lens - 1),
                          fresh_prefill=True)
    _close(tl.numpy(), jl, LOGIT_RTOL[kv])
    nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)
    for _ in range(2):
        jl, jc = _jforward(jp, jcfg, jnp.asarray(nxt[:, None]), jc)
        tl, tc = tmoe.forward(tp, tcfg, torch.from_numpy(nxt[:, None]), tc)
        _close(tl.numpy(), jl, LOGIT_RTOL[kv])
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)


@pytest.mark.parametrize("name,quant", [("qwen2_moe", True),
                                        ("qwen3_moe", False),
                                        ("olmoe", True)])
def test_generate_batch_greedy_identical(name, quant):
    """B=3 ragged prompts through both engines (int4 weights: the E-loop
    at B=3), then B=1 (the grouped product) against the same rows."""
    jcfg, jp, tcfg, tp = models(name, quant)
    icfg = dict(max_seq_len=64)
    je = ti.InferenceEngine(jp, jcfg, ti.InferenceConfig(**icfg))
    te = InferenceEngine(tp, tcfg, InferenceConfig(**icfg), device="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (7, 15, 4)]
    jres = je.generate_batch(prompts, 10, temperature=0.0)
    tres = te.generate_batch(prompts, 10, temperature=0.0)
    for a, b in zip(jres, tres):
        assert b.tokens == a.tokens and b.stop_reason == a.stop_reason
    assert te.generate(prompts[1], 10, temperature=0.0).tokens == \
        jres[1].tokens


# -- paged forwards -------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("G", [1, 3])
def test_paged_decode_and_verify_match_jax(name, G):
    """One paged decode (G=1) or verify (G=3) step over random pools
    (pages out of order, an unassigned tail): logits and pools."""
    jcfg, jp, tcfg, tp = models(name)
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
        want = _jdecode(jp, jcfg, jnp.asarray(tokens[:, 0]), *args)
        got = tmoe.forward_paged_decode(tp, tcfg,
                                        torch.from_numpy(tokens[:, 0]),
                                        *targs)
    else:
        want = _jverify(jp, jcfg, jnp.asarray(tokens), *args)
        got = tmoe.forward_paged_verify(tp, tcfg, torch.from_numpy(tokens),
                                        *targs)
    _close(got[0].numpy(), want[0], LOGIT_RTOL["model"])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_paged_scheduler_int8_pools_serve_jax_tokens():
    """Qwen2-MoE (biases and the shared expert) through both paged
    schedulers over int8 pools: three requests, two sharing a 16-token
    prefix; tokens, stop reasons and prefix hits equal."""
    jcfg, jp, tcfg, tp = models("qwen2_moe")
    icfg = dict(max_seq_len=64, temperature=0.0, eos_token_id=-1, seed=0,
                kv_cache_dtype="int8")
    js = JPaged(jp, jcfg, ti.InferenceConfig(**icfg), batch_slots=2,
                page_size=8)
    ts = TPaged(tp, tcfg, InferenceConfig(**icfg), batch_slots=2,
                page_size=8, device="cpu")
    rng = np.random.default_rng(12)
    system = rng.integers(1, 256, 16).tolist()
    reqs = [system + rng.integers(1, 256, n).tolist() for n in (3, 9)] + \
        [rng.integers(1, 256, 11).tolist()]
    jids = [js.submit(r, 8) for r in reqs]
    tids = [ts.submit(r, 8) for r in reqs]
    jr, tr = js.run(), ts.run()
    for a, b in zip(jids, tids):
        assert tr[b].tokens == jr[a].tokens
        assert tr[b].stop_reason == jr[a].stop_reason
    assert ts.pool.hits == js.pool.hits > 0


# -- the shared expert ------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int4"])
@pytest.mark.parametrize("alone", [False, True], ids=["mixed", "alone"])
def test_shared_expert_matches_jax(quant, alone):
    """Qwen2-MoE's FFN of layer 1 on B=2 x S=5 and on one token (the
    grouped regime), fp and int4; "alone" zeroes the routed experts'
    down projection so only the shared expert and its gate remain."""
    jcfg, jp, tcfg, tp = models("qwen2_moe", quant)
    jl, tl = dict(jp["layers"]), dict(tp["layers"])
    if alone:
        w = jl["we_down"]
        if quant:
            jl["we_down"] = w.__class__(
                data=w.data, scales=jnp.zeros_like(w.scales),
                zero_points=w.zero_points, bits=w.bits,
                group_size=w.group_size, shape=w.shape)
            tl["we_down"] = QTensor(
                data=tl["we_down"].data,
                scales=torch.zeros_like(tl["we_down"].scales),
                zero_points=None, bits=4, group_size=64,
                shape=tl["we_down"].shape)
        else:
            jl["we_down"] = jnp.zeros_like(w)
            tl["we_down"] = torch.zeros_like(tl["we_down"])
    assert not isinstance(tl["shared_gate"], QTensor)
    assert isinstance(tl["ws_down"], QTensor) == quant
    rng = np.random.default_rng(6)
    for shape in ((2, 5, 64), (1, 1, 64)):
        h = rng.normal(size=shape).astype(np.float32)
        want = jmoe._moe_ffn(jcfg, jnp.asarray(h), jl, layer_index=1)
        got = tmoe._moe_ffn(tcfg, torch.from_numpy(h), tl, 1)
        _close(got.numpy(), want, 1e-5)
        if alone:
            s = tmoe.shared_expert(torch.from_numpy(h), tl, 1)
            _close(s.numpy(), want, 1e-5)
            assert s.abs().max() > 0


@pytest.mark.parametrize("name", ARCHS)
def test_quantizer_codes_match_jax(name):
    """int4 g=64 of the variant trees: the attention products, the
    experts and the shared expert byte for byte as JAX's; the router,
    shared_gate (N=1), biases and norms stay fp."""
    _, jp, _, tp = models(name)
    jq = jquantizer.quantize_params(jp, JQuantCfg(type=JQuantType.INT4,
                                                  group_size=64))
    tq = tquantizer.quantize_params(tp, QuantizationConfig(
        type=QuantType.INT4, group_size=64))
    assert tq["layers"].keys() == jq["layers"].keys()
    packed = set()
    for k, want in jq["layers"].items():
        got = tq["layers"][k]
        assert isinstance(got, QTensor) == hasattr(want, "bits"), k
        if isinstance(got, QTensor):
            packed.add(k)
            np.testing.assert_array_equal(got.data.numpy(),
                                          np.asarray(want.data))
            np.testing.assert_array_equal(
                got.scales.view(torch.int16).numpy(),
                np.asarray(want.scales).view(np.int16))
    want_packed = {"wq", "wk", "wv", "wo", "we_gate", "we_up", "we_down"}
    if name == "qwen2_moe":
        want_packed |= {"ws_gate", "ws_up", "ws_down"}
        assert not isinstance(tq["layers"]["shared_gate"], QTensor)
    assert packed == want_packed


# -- configs, fixture, assembler, names ---------------------------------------------

@pytest.mark.parametrize("fn,hf", [
    ("qwen1_5_moe_a2_7b_config", "QWEN1_5_MOE_A2_7B_CONFIG_JSON"),
    ("qwen3_30b_a3b_config", "QWEN3_30B_A3B_CONFIG_JSON"),
    ("olmoe_1b_7b_config", "OLMOE_1B_7B_0924_CONFIG_JSON")])
def test_published_configs_match_jax_mapping(fn, hf):
    """Each transcribed config.json through the port's HF mapping equals
    the JAX package's mapping of the same dict, field for field, and
    the model module takes it."""
    c = getattr(tconfig, fn)()
    j = jmapping.config_from_hf_dict(getattr(tconfig, hf))
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "num_kv_heads", "head_dim", "intermediate_size",
              "moe_intermediate_size", "shared_expert_size", "num_experts",
              "experts_per_token", "norm_topk_prob", "attn_bias", "qk_norm",
              "rope_theta", "rms_norm_eps", "max_seq_len", "sliding_window",
              "tie_embeddings", "architecture"):
        assert getattr(c, f) == getattr(j, f), f
    assert c.name == c.name.strip() and "/" in c.name
    assert registry.get_model(c.architecture) is tmoe
    tmoe.check_supported(c)
    assert (c.hidden_size, c.head_dim_) == (2048, 128)


def test_synthetic_shared_expert_fixture():
    """A Qwen2-MoE fixture: JAX's tree (packed attention, experts and
    shared expert, a bf16 router and a bf16 shared_gate of 0.01) plus
    the port's knob slots (the q/k/v biases); it serves on the CPU with
    no kernel launched."""
    kw = dict(BASE, **CFGS["qwen2_moe"])
    tcfg = tconfig.ModelConfig(**kw)
    t = create_synthetic_quantized_model(tcfg, device="cpu").params["layers"]
    j = jsynthetic.create_synthetic_quantized_model(
        JModelConfig(**kw)).params["layers"]
    assert set(t) - set(j) == {"b_q", "b_k", "b_v"} and set(j) <= set(t)
    for k, want in j.items():
        got = t[k]
        if hasattr(want, "bits"):
            assert isinstance(got, QTensor)
            assert tuple(got.data.shape) == want.data.shape
        else:
            assert tuple(got.shape) == want.shape
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
    assert torch.all(t["shared_gate"] == 0.01)
    eng = InferenceEngine({**create_synthetic_quantized_model(
        tcfg, device="cpu").params}, tcfg, InferenceConfig(max_seq_len=32),
        device="cpu")
    kernels.reset_launch_counts()
    assert len(eng.generate([3, 1, 4], 4, temperature=0.0).tokens) == 7
    assert all(v == 0 for v in kernels.launch_counts().values())


@pytest.mark.parametrize("name", ["qwen2_moe", "olmoe"])
def test_assembler_maps_the_variants_as_jax(name):
    """HF-named tensors of a variant (the shared expert and its gate, q/k/v
    biases, OLMoE's whole-projection q/k norms) assembled by both
    packages: every tensor bit for bit."""
    jcfg, jp, tcfg, _ = models(name)
    hf = {"model.embed_tokens.weight": jp["embed"],
          "model.norm.weight": jp["final_norm"],
          "lm_head.weight": jp["lm_head"].T}
    for k, w in jp["layers"].items():
        for i in range(jcfg.num_layers):
            if k in ("we_gate", "we_up", "we_down"):
                for e in range(jcfg.num_experts):
                    tmpl = [t for t in jmapping.SLOT_TEMPLATES[k]
                            if t.startswith("model.")][-1]
                    hf[tmpl.format(i=i, e=e)] = w[i, e].T
                continue
            tmpl = [t for t in jmapping.SLOT_TEMPLATES[k]
                    if t.startswith("model.")][-1]
            hf[tmpl.format(i=i)] = w[i].T if w.ndim == 3 else w[i]
    hf = {k: np.asarray(v, np.float32) for k, v in hf.items()}
    want = jmapping.assemble_for(jcfg)(hf.__getitem__, list(hf), jcfg)
    got = tmapping.assemble_for(tcfg)(hf.__getitem__, list(hf), tcfg,
                                      device="cpu")
    assert got["layers"].keys() == want["layers"].keys()
    for k, w in want["layers"].items():
        np.testing.assert_array_equal(got["layers"][k].numpy(),
                                      np.asarray(w), err_msg=k)
    if name == "olmoe":
        assert got["layers"]["q_norm"].shape == (2, 64)
    else:
        assert got["layers"]["shared_gate"].shape == (2, 64, 1)
