"""DeepSeek V2/V3 in the port (models/deepseek.py) against turboinfer_tpu's.

Three tiny configs (H=64, L=3 with one dense layer, 4 heads, MLA with
kv_lora_rank 32 and nope/rope/v dims 16/8/16, 8 experts top-2 of width
64 plus a 64-wide shared expert, vocab 256) in f32, on the same weights
bridged through numpy:
  v2        softmax routing, greedy top-k, raw gates;
  v2_group  softmax, group-limited greedy (4 groups, top 2);
  v3        sigmoid with a non-zero router_bias, noaux_tc group sums,
            renormalised gates times 2.5, q-LoRA, YaRN with
            mscale_all_dim (the softmax scale's mscale^2).
Logits are compared within 1e-4 of max|logit| (the same f32 arithmetic
on the CPU; summation orders differ), greedy trajectories token for
token, quantizer codes and assembled tensors byte for byte.
"""

import json
import os

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
    ContinuousBatchingScheduler as JContinuous
from turboinfer_tpu.engine.scheduler import \
    PagedContinuousScheduler as JPaged
from turboinfer_tpu.loader import mapping as jmapping
from turboinfer_tpu.loader import synthetic as jsynthetic
from turboinfer_tpu.loader.safetensors import write_safetensors
from turboinfer_tpu.models import deepseek as jds
from turboinfer_tpu.quant import quantizer as jquantizer
from turboinfer_tpu_torch import bridge, kernels
from turboinfer_tpu_torch import config as tconfig
from turboinfer_tpu_torch.config import InferenceConfig, QuantizationConfig
from turboinfer_tpu_torch.config import QuantType
from turboinfer_tpu_torch.core.qtensor import QTensor
from turboinfer_tpu_torch.engine import paged_cache as tpc
from turboinfer_tpu_torch.engine.engine import InferenceEngine
from turboinfer_tpu_torch.engine.scheduler import \
    ContinuousBatchingScheduler as TContinuous
from turboinfer_tpu_torch.engine.scheduler import \
    PagedContinuousScheduler as TPaged
from turboinfer_tpu_torch.loader import loader as tloader
from turboinfer_tpu_torch.loader import mapping as tmapping
from turboinfer_tpu_torch.loader.synthetic import \
    create_synthetic_quantized_model
from turboinfer_tpu_torch.models import deepseek as tds
from turboinfer_tpu_torch.models import registry
from turboinfer_tpu_torch.quant import calibrate as tcalibrate
from turboinfer_tpu_torch.quant import quantizer as tquantizer
from turboinfer_tpu_torch.utils.errors import ConfigError

from test_torch_moe import jax_to_numpy

torch.set_num_threads(2)

LOGIT_RTOL = 1e-4        # of max|logit|

BASE = dict(vocab_size=256, hidden_size=64, num_layers=3, num_heads=4,
            intermediate_size=128, moe_intermediate_size=64,
            shared_expert_size=64, num_experts=8, experts_per_token=2,
            first_k_dense_replace=1, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, max_seq_len=128,
            rms_norm_eps=1e-6)
CFGS = {
    "v2": dict(architecture="deepseek_v2", norm_topk_prob=False,
               name="tiny-deepseek-v2"),
    "v2_group": dict(architecture="deepseek_v2", norm_topk_prob=False,
                     topk_method="group_limited_greedy", n_group=4,
                     topk_group=2, name="tiny-deepseek-v2-group"),
    "v3": dict(architecture="deepseek_v3", scoring_func="sigmoid",
               topk_method="noaux_tc", n_group=4, topk_group=2,
               norm_topk_prob=True, routed_scaling_factor=2.5,
               q_lora_rank=64, rope_scaling=(
                   ("beta_fast", 32), ("beta_slow", 1), ("factor", 4.0),
                   ("mscale", 1.0), ("mscale_all_dim", 1.0),
                   ("original_max_position_embeddings", 32),
                   ("rope_type", "yarn")),
               name="tiny-deepseek-v3"),
}
QCFG = dict(group_size=64)
_P = {}


def models(name="v2", quant=False):
    """(JAX config, JAX params, port config, port params) on the same
    weights: fp, or the JAX quantizer's int4 g=64 output (quant)."""
    if (name, quant) not in _P:
        kw = dict(BASE, **CFGS[name])
        jcfg = JModelConfig(dtype=jnp.float32, **kw)
        tcfg = tconfig.ModelConfig(dtype=torch.float32, **kw)
        jp = jds.init_params(jax.random.PRNGKey(0), jcfg)
        if name == "v3":
            lw = dict(jp["layers"])
            lw["router_bias"] = 0.05 * jax.random.normal(
                jax.random.PRNGKey(7), lw["router_bias"].shape)
            jp = {**jp, "layers": lw}
        if quant:
            jp = jquantizer.quantize_params(
                jp, JQuantCfg(type=JQuantType.INT4, **QCFG))
        tp = bridge.params_from_numpy(jax_to_numpy(jp), device="cpu")
        _P[name, quant] = (jcfg, jp, tcfg, tp)
    return _P[name, quant]


_jforward = jax.jit(jds.forward, static_argnums=(1,))
_jpaged = jax.jit(jds.forward_paged_decode, static_argnums=(1,))


def _close(got, want, rtol=LOGIT_RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * np.abs(want).max())


_KV = {"model": (jnp.float32, torch.float32), "int8": (jnp.int8, torch.int8)}


# -- forward ------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("kv", list(_KV))
def test_forward_prefill_and_decode_match_jax(name, kv):
    """A B=2 prefill with ragged lengths, then three decode steps, over a
    model-dtype or int8 latent cache: the logits and the cache bytes (an
    int8 cache's codes and scales exactly as JAX writes them)."""
    jcfg, jp, tcfg, tp = models(name)
    jdt, tdt = _KV[kv]
    B, S, T = 2, 9, 64
    rng = np.random.default_rng(1)
    toks = rng.integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([9, 5], np.int32)
    jc = jds.init_cache(jcfg, B, max_seq=T, dtype=jdt)
    jl, jc = _jforward(jp, jcfg, jnp.asarray(toks), jc,
                       seq_lens=jnp.asarray(lens))
    tc = tds.init_cache(tcfg, B, max_seq=T, dtype=tdt, device="cpu")
    tl, tc = tds.forward(tp, tcfg, torch.from_numpy(toks), tc,
                         seq_lens=torch.from_numpy(lens))
    _close(tl.numpy(), jl)
    nxt = np.asarray(jnp.argmax(jl[np.arange(B), lens - 1], -1)
                     ).astype(np.int32)
    for _ in range(3):
        jl, jc = _jforward(jp, jcfg, jnp.asarray(nxt[:, None]), jc)
        tl, tc = tds.forward(tp, tcfg, torch.from_numpy(nxt[:, None]), tc)
        _close(tl.numpy(), jl)
        assert np.array_equal(np.argmax(tl.numpy(), -1),
                              np.asarray(jnp.argmax(jl, -1)))
        nxt = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    if kv == "int8":
        # the first prefill token's latent codes: no upstream drift yet
        np.testing.assert_array_equal(tc.k[0, :, 0, 0].numpy(),
                                      np.asarray(jc.k[0, :, 0, 0]))
        np.testing.assert_allclose(tc.k_scale.numpy(),
                                   np.asarray(jc.k_scale), rtol=1e-5)
        assert tc.k_scale.shape == (3, B, 1, T)


@pytest.mark.parametrize("T,S", [(96, 70), (192, 150), (1024, 700)])
def test_key_chunks_match_jax(T, S):
    """One block (T=96: no chunk size divides it), three chunks of 64
    (T=192) and two of 512 (T=1024, a 700-token prompt across both):
    prefill and a decode step against JAX."""
    jcfg, jp, tcfg, tp = models("v3")
    assert tds.chunk_size(T) == {96: 96, 192: 64, 1024: 512}[T]
    toks = np.random.default_rng(T).integers(
        1, jcfg.vocab_size, (1, S)).astype(np.int32)
    jl, jc = _jforward(jp, jcfg, jnp.asarray(toks),
                       jds.init_cache(jcfg, 1, max_seq=T))
    tl, tc = tds.forward(tp, tcfg, torch.from_numpy(toks),
                         tds.init_cache(tcfg, 1, max_seq=T, device="cpu"))
    _close(tl.numpy(), jl)
    nxt = np.asarray(jnp.argmax(jl[:, -1:], -1)).astype(np.int32)
    jl, _ = _jforward(jp, jcfg, jnp.asarray(nxt), jc)
    tl, _ = tds.forward(tp, tcfg, torch.from_numpy(nxt), tc)
    _close(tl.numpy(), jl)


def test_chunk_size_rule():
    assert [tds.chunk_size(t) for t in (2048, 1024, 768, 640, 576, 96, 9)] \
        == [512, 512, 256, 128, 64, 96, 9]


def test_incremental_decode_matches_full_forward():
    """A prefill of 5 tokens and one decode step at a time against the
    cacheless forward of the whole sequence (port only; the JAX package
    holds the same identity)."""
    _, _, tcfg, tp = models("v2_group")
    toks = torch.tensor([[7, 23, 201, 5, 99, 42, 8, 13]], dtype=torch.int32)
    full = tds.forward_no_cache(tp, tcfg, toks)
    cache = tds.init_cache(tcfg, 1, max_seq=32, device="cpu")
    lg, cache = tds.forward(tp, tcfg, toks[:, :5], cache)
    torch.testing.assert_close(lg, full[:, :5], rtol=0, atol=1e-4)
    for s in range(5, 8):
        lg, cache = tds.forward(tp, tcfg, toks[:, s:s + 1], cache)
        torch.testing.assert_close(lg[:, 0], full[:, s], rtol=0, atol=1e-4)


def test_fp8_request_stores_model_dtype_latents():
    """kv_cache_dtype="fp8" gives model-dtype latents in the contiguous
    cache and the page pools, as the JAX package's init_cache; the
    engine then serves what a model-dtype cache serves."""
    jcfg, _, tcfg, tp = models("v2")
    c = tds.init_cache(tcfg, 2, max_seq=16, dtype=torch.uint8, device="cpu")
    j = jds.init_cache(jcfg, 2, max_seq=16, dtype=jnp.uint8)
    assert c.k.dtype == torch.float32 == tcfg.dtype
    assert j.k.dtype == jnp.float32 and c.k_scale is None
    assert c.k.shape == j.k.shape == (3, 2, 1, 16, 32)
    assert c.v.shape == j.v.shape == (3, 2, 1, 16, 8)
    pool = tpc.init_paged_cache(tcfg, 2, num_pages=5, page_size=8,
                                max_seq=16, dtype=torch.uint8, device="cpu")
    assert pool.k_pages.dtype == torch.float32
    assert pool.k_pages.shape == (3, 5, 1, 8, 32)
    assert pool.v_pages.shape == (3, 5, 1, 8, 8)
    toks = []
    for kv in ("fp8", "model"):
        eng = InferenceEngine(tp, tcfg, InferenceConfig(
            max_seq_len=32, kv_cache_dtype=kv), device="cpu")
        toks.append(eng.generate([3, 1, 4, 1, 5], 6, temperature=0.0).tokens)
    assert toks[0] == toks[1]


# -- paged --------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["model", "int8"])
def test_paged_decode_matches_jax(kv):
    """One paged decode step over random latent pools (three rows, pages
    out of order, one unassigned tail; int8 codes with positive scales):
    the logits and the written pools, against JAX's forward_paged_decode."""
    jcfg, jp, tcfg, tp = models("v3")
    rng = np.random.default_rng(3)
    L, P, page, B = 3, 10, 8, 3
    lr, dr = 32, 8
    table = np.array([[3, 7, 1, -1], [8, 2, -1, -1], [5, 4, 6, 9]], np.int32)
    lengths = np.array([13, 6, 20], np.int32)
    tokens = rng.integers(1, jcfg.vocab_size, (B,)).astype(np.int32)
    if kv == "int8":
        kp = rng.integers(-127, 128, (L, P, 1, page, lr)).astype(np.int8)
        vp = rng.integers(-127, 128, (L, P, 1, page, dr)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (L, P, 1, page)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (L, P, 1, page)).astype(np.float32)
    else:
        kp = rng.normal(size=(L, P, 1, page, lr)).astype(np.float32)
        vp = rng.normal(size=(L, P, 1, page, dr)).astype(np.float32)
        ks = vs = None
    jscale = {} if ks is None else dict(k_scale_pages=jnp.asarray(ks),
                                        v_scale_pages=jnp.asarray(vs))
    tscale = {} if ks is None else dict(
        k_scale_pages=torch.from_numpy(ks.copy()),
        v_scale_pages=torch.from_numpy(vs.copy()))
    want = _jpaged(jp, jcfg, jnp.asarray(tokens), jnp.asarray(kp),
                   jnp.asarray(vp), jnp.asarray(table), jnp.asarray(lengths),
                   **jscale)
    got = tds.forward_paged_decode(
        tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(kp.copy()),
        torch.from_numpy(vp.copy()), torch.from_numpy(table),
        torch.from_numpy(lengths), **tscale)
    assert len(got) == len(want) == (5 if kv == "int8" else 3)
    _close(got[0].numpy(), want[0])
    for g, w in zip(got[1:], want[1:]):
        if g.dtype == torch.int8:
            # codes of the layers after the first follow f32 drift
            assert np.abs(g.numpy().astype(int)
                          - np.asarray(w).astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_paged_decode_matches_contiguous(kv):
    """A sequence decoded token by token into pages (page 8, pages out of
    order) gives the contiguous forward's logits at every step."""
    _, _, tcfg, tp = models("v2")
    dt = {"model": torch.float32, "int8": torch.int8}[kv]
    seq = torch.tensor([5, 9, 31, 2, 77, 150, 3, 8, 11, 64, 200, 17],
                       dtype=torch.int32)
    pool = tpc.init_paged_cache(tcfg, 1, num_pages=4, page_size=8,
                                max_seq=32, dtype=dt, device="cpu")
    tbl = torch.tensor([[2, 0, 3, 1]], dtype=torch.int32)
    scales = {} if dt != torch.int8 else dict(
        k_scale_pages=pool.k_scale_pages, v_scale_pages=pool.v_scale_pages)
    c = tds.init_cache(tcfg, 1, max_seq=32, dtype=dt, device="cpu")
    for pos in range(len(seq)):
        lg, c = tds.forward(tp, tcfg, seq[None, pos:pos + 1], c)
        out = tds.forward_paged_decode(
            tp, tcfg, seq[pos:pos + 1], pool.k_pages, pool.v_pages, tbl,
            torch.tensor([pos], dtype=torch.int32), **scales)
        torch.testing.assert_close(out[0], lg[:, 0], rtol=0, atol=1e-4)
    k, v = tpc.gather_sequence(pool._replace(block_table=tbl), 32)
    assert k.shape == (3, 1, 1, 32, 32) and v.shape == (3, 1, 1, 32, 8)


# -- engine and schedulers ------------------------------------------------------

_E = {}


def engines(name, quant, kv="model"):
    if (name, quant, kv) not in _E:
        jcfg, jp, tcfg, tp = models(name, quant)
        icfg = dict(max_seq_len=64, kv_cache_dtype=kv)
        _E[name, quant, kv] = (
            ti.InferenceEngine(jp, jcfg, ti.InferenceConfig(**icfg)),
            InferenceEngine(tp, tcfg, InferenceConfig(**icfg), device="cpu"))
    return _E[name, quant, kv]


@pytest.mark.parametrize("name,quant,kv", [("v3", False, "model"),
                                           ("v2", True, "model"),
                                           ("v2_group", False, "int8")])
def test_generate_batch_greedy_identical(name, quant, kv):
    """B=3 ragged prompts, 10 new tokens: int4 weights (the E-loop at
    B=3, the grouped product at B*S=1 never reached), an int8 latent
    cache."""
    je, te = engines(name, quant, kv)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(1, 256, size=n).tolist() for n in (7, 15, 4)]
    jres = je.generate_batch(prompts, 10, temperature=0.0)
    tres = te.generate_batch(prompts, 10, temperature=0.0)
    for a, b in zip(jres, tres):
        assert b.tokens == a.tokens and b.stop_reason == a.stop_reason
    one = te.generate(prompts[0], 10, temperature=0.0)
    assert one.tokens == jres[0].tokens


def test_memory_usage_counts_the_cache_as_jax_does():
    """memory_usage (what performance_stats reports) equals the JAX
    engine's on the same params and settings: weights plus a cache
    counted as kv_heads x head_dim K/V a token, int8 scales included,
    which for MLA is JAX's count, not the latent cache's (ROADMAP §3)."""
    je, te = engines("v2_group", False, "int8")
    assert te.memory_usage() == je.memory_usage()


def _requests():
    rng = np.random.default_rng(12)
    system = rng.integers(1, 256, 16).tolist()
    return [system + rng.integers(1, 256, n).tolist() for n in (3, 9)] + \
        [rng.integers(1, 256, 11).tolist()]


@pytest.mark.parametrize("paged,kv", [(False, "model"), (False, "int8"),
                                      (True, "model"), (True, "int8")])
def test_schedulers_serve_jax_tokens(paged, kv):
    """Three requests (two sharing a 16-token prefix) through two slots
    of each scheduler, model and int8 latent caches and pools: the
    tokens and stop reasons of the JAX package's schedulers, the same
    prefix hits."""
    jcfg, jp, tcfg, tp = models("v2_group")
    icfg = dict(max_seq_len=64, temperature=0.0, eos_token_id=-1, seed=0,
                kv_cache_dtype=kv)
    page = dict(page_size=8) if paged else {}
    J, T = (JPaged, TPaged) if paged else (JContinuous, TContinuous)
    js = J(jp, jcfg, ti.InferenceConfig(**icfg), batch_slots=2, **page)
    ts = T(tp, tcfg, InferenceConfig(**icfg), batch_slots=2, device="cpu",
           **page)
    reqs = _requests()
    jids = [js.submit(r, 8) for r in reqs]
    tids = [ts.submit(r, 8) for r in reqs]
    jr, tr = js.run(), ts.run()
    for a, b in zip(jids, tids):
        assert tr[b].tokens == jr[a].tokens
        assert tr[b].stop_reason == jr[a].stop_reason
    if paged:
        assert ts.pool.hits == js.pool.hits > 0
        assert ts.cache.k_pages.shape[2:] == (1, 8, 32)
        assert ts.cache.v_pages.shape[2:] == (1, 8, 8)


def test_engine_paths_over_the_latent_cache():
    """Beam search of width 1 is greedy; use_cache=False recomputes the
    cached tokens; reset_cache zeroes every plane; param_count is JAX's;
    the report carries the rating line."""
    jcfg, jp, tcfg, tp = models("v3")
    eng = InferenceEngine(tp, tcfg, InferenceConfig(max_seq_len=32),
                          device="cpu")
    greedy = eng.generate([9, 8, 7, 6], 6, temperature=0.0).tokens
    beam = eng.generate_beam_search([9, 8, 7, 6], 6, beam_size=1)
    assert beam.tokens == greedy
    beams = eng.generate_beam_search([9, 8, 7, 6], 6, beam_size=3,
                                     return_all_beams=True)
    assert len(beams) == 3 and beams[0].tokens[:4] == [9, 8, 7, 6]
    nocache = InferenceEngine(tp, tcfg, InferenceConfig(
        max_seq_len=32, use_cache=False), device="cpu")
    assert nocache.generate([9, 8, 7, 6], 6, temperature=0.0).tokens == greedy
    c = tds.init_cache(tcfg, 1, max_seq=16, dtype=torch.int8, device="cpu")
    _, c = tds.forward(tp, tcfg, torch.tensor([[1, 2, 3]]).int(), c)
    z = tds.reset_cache(c)
    assert all(int(t.count_nonzero()) == 0
               for t in (z.k, z.v, z.k_scale, z.v_scale, z.length))
    assert z.k_scale.data_ptr() != z.v_scale.data_ptr()
    assert tds.param_count(tp) == jds.param_count(jp)
    assert "Efficiency rating:" in eng.performance_stats()


def test_paged_scheduler_refuses_a_draft():
    """DeepSeek has no forward_paged_verify (as in the JAX package): a
    paged scheduler with a draft raises at construction."""
    _, _, tcfg, tp = models("v2")
    assert not hasattr(tds, "forward_paged_verify")
    with pytest.raises(NotImplementedError, match="forward_paged_verify"):
        TPaged(tp, tcfg, InferenceConfig(max_seq_len=32), batch_slots=1,
               page_size=8, draft_params=tp, draft_config=tcfg,
               device="cpu")


# -- routing ------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CFGS))
def test_routing_breaks_ties_as_jax(name):
    """Router weights built so that experts tie in pairs (columns
    duplicated) and groups tie too: the selected experts and gates equal
    JAX's _route, which takes the lower index first."""
    jcfg, _, tcfg, _ = models(name)
    rng = np.random.default_rng(4)
    H, E = 64, 8
    half = rng.normal(size=(H, E // 2)).astype(np.float32)
    router = np.repeat(half, 2, axis=1)           # experts 2i, 2i+1 tie
    router[:, 4:] = router[:, :4]                 # groups 0/2 and 1/3 tie
    bias = np.zeros((E,), np.float32)
    h = rng.normal(size=(3, 5, H)).astype(np.float32)
    jg, ji = jds._route(jcfg, jnp.asarray(h), jnp.asarray(router),
                        jnp.asarray(bias))
    tg, tI = tds._route(tcfg, torch.from_numpy(h), torch.from_numpy(router),
                        torch.from_numpy(bias))
    np.testing.assert_array_equal(tI.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    # every row picked a tied pair in index order
    assert (tI[..., 0] < tI[..., 1]).all()


def test_routing_masks_left_out_groups_to_zero():
    """V3 with negative selection scores: a group left out is 0.0, not
    -inf, so it can outrank the kept experts (HF's fill), as in JAX."""
    jcfg, _, tcfg, _ = models("v3")
    rng = np.random.default_rng(5)
    router = rng.normal(size=(64, 8)).astype(np.float32)
    bias = np.full((8,), -2.0, np.float32)
    h = rng.normal(size=(2, 3, 64)).astype(np.float32)
    jg, ji = jds._route(jcfg, jnp.asarray(h), jnp.asarray(router),
                        jnp.asarray(bias))
    tg, tI = tds._route(tcfg, torch.from_numpy(h), torch.from_numpy(router),
                        torch.from_numpy(bias))
    np.testing.assert_array_equal(tI.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)


# -- quantizer, fixture, assembler, calibration ---------------------------------

@pytest.mark.parametrize("name", ["v2", "v3"])
def test_quantizer_codes_match_jax(name):
    """int4 g=64 of every DeepSeek slot JAX quantizes (wq or wq_a/wq_b,
    wkv_a, wo, the experts, the shared experts, the dense group but its
    wkv_b), byte for byte; wkv_b, router and router_bias stay fp."""
    jcfg, jp, tcfg, tp = models(name)
    jq = jquantizer.quantize_params(jp, JQuantCfg(type=JQuantType.INT4,
                                                  **QCFG))
    tq = tquantizer.quantize_params(tp, QuantizationConfig(
        type=QuantType.INT4, **QCFG))
    for group in ("layers", "dense_layers"):
        for k, want in jq[group].items():
            got = tq[group][k]
            assert isinstance(got, QTensor) == hasattr(want, "bits"), k
            if isinstance(got, QTensor):
                np.testing.assert_array_equal(got.data.numpy(),
                                              np.asarray(want.data))
                np.testing.assert_array_equal(
                    got.scales.view(torch.int16).numpy(),
                    np.asarray(want.scales).view(np.int16))
        assert tq[group].keys() == jq[group].keys()
    for k in ("wkv_b", "router", "router_bias"):
        assert not isinstance(tq["layers"][k], QTensor)
    assert not isinstance(tq["dense_layers"]["wkv_b"], QTensor)
    assert isinstance(tq["dense_layers"]["w_down"], QTensor)


def test_quantized_forward_matches_jax():
    """The int4 model's logits, B=1 (the grouped product) and B=2 (the
    E-loop), against JAX's on the bridged codes."""
    jcfg, jp, tcfg, tp = models("v2", True)
    assert isinstance(tp["layers"]["we_down"], QTensor)
    for B in (1, 2):
        toks = np.random.default_rng(B).integers(1, 256, (B, 6)).astype(
            np.int32)
        jl, jc = _jforward(jp, jcfg, jnp.asarray(toks),
                           jds.init_cache(jcfg, B, max_seq=16))
        tl, tc = tds.forward(tp, tcfg, torch.from_numpy(toks),
                             tds.init_cache(tcfg, B, max_seq=16,
                                            device="cpu"))
        _close(tl.numpy(), jl)
        nxt = np.asarray(jnp.argmax(jl[:, -1:], -1)).astype(np.int32)
        jl, _ = _jforward(jp, jcfg, jnp.asarray(nxt), jc)
        tl, _ = tds.forward(tp, tcfg, torch.from_numpy(nxt), tc)
        _close(tl.numpy(), jl)


def test_synthetic_fixture_tree_matches_jax():
    """create_synthetic_quantized_model on an MLA config: JAX's tree, key
    for key, with the same shapes, dtypes and packed slots."""
    cfg_kw = dict(BASE, **CFGS["v3"])
    tcfg = tconfig.ModelConfig(**cfg_kw)
    jcfg = JModelConfig(**cfg_kw)
    t = create_synthetic_quantized_model(tcfg, device="cpu").params
    j = jsynthetic.create_synthetic_quantized_model(jcfg).params
    assert set(t) == set(j) == {"embed", "layers", "final_norm", "lm_head",
                                "dense_layers"}
    for group in ("layers", "dense_layers"):
        assert t[group].keys() == j[group].keys()
        for k, want in j[group].items():
            got = t[group][k]
            if hasattr(want, "bits"):
                assert isinstance(got, QTensor) and got.bits == want.bits
                assert tuple(got.data.shape) == want.data.shape
                assert tuple(got.scales.shape) == want.scales.shape
                assert got.data.dtype == torch.uint8
            else:
                assert tuple(got.shape) == want.shape, k
                assert str(got.dtype).split(".")[-1] == str(want.dtype), k
    eng = InferenceEngine(t, tcfg, InferenceConfig(max_seq_len=32),
                          device="cpu")
    kernels.reset_launch_counts()
    assert len(eng.generate([3, 1, 4], 4, temperature=0.0).tokens) == 7
    assert all(v == 0 for v in kernels.launch_counts().values())


def _hf_tensors(jcfg, jp):
    """The JAX params as an HF DeepSeek checkpoint's tensors ([out, in])."""
    t = {"model.embed_tokens.weight": jp["embed"],
         "model.norm.weight": jp["final_norm"],
         "lm_head.weight": jp["lm_head"].T}
    kd = jcfg.first_k_dense_replace
    names = {"wq_a": "self_attn.q_a_proj", "wq_b": "self_attn.q_b_proj",
             "wq": "self_attn.q_proj", "wkv_a": "self_attn.kv_a_proj_with_mqa",
             "wkv_b": "self_attn.kv_b_proj", "wo": "self_attn.o_proj",
             "router": "mlp.gate", "ws_gate": "mlp.shared_experts.gate_proj",
             "ws_up": "mlp.shared_experts.up_proj",
             "ws_down": "mlp.shared_experts.down_proj",
             "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
             "w_down": "mlp.down_proj"}
    norms = {"attn_norm": "input_layernorm",
             "ffn_norm": "post_attention_layernorm",
             "kv_a_norm": "self_attn.kv_a_layernorm",
             "q_a_norm": "self_attn.q_a_layernorm"}
    for group, off in (("dense_layers", 0), ("layers", kd)):
        for k, w in jp[group].items():
            for i in range(w.shape[0]):
                p = f"model.layers.{off + i}"
                if k in names:
                    t[f"{p}.{names[k]}.weight"] = w[i].T
                elif k in norms:
                    t[f"{p}.{norms[k]}.weight"] = w[i]
                elif k == "router_bias":
                    t[f"{p}.mlp.gate.e_score_correction_bias"] = w[i]
                else:
                    nm = {"we_gate": "gate_proj", "we_up": "up_proj",
                          "we_down": "down_proj"}[k]
                    for e in range(w.shape[1]):
                        t[f"{p}.mlp.experts.{e}.{nm}.weight"] = w[i, e].T
    return {k: np.asarray(v, np.float32) for k, v in t.items()}


@pytest.mark.parametrize("name", ["v2", "v3"])
def test_assemble_params_deepseek_matches_jax(name, tmp_path):
    """An HF checkpoint written by the JAX package's safetensors writer,
    assembled by both packages (dispatched by assemble_for) and loaded
    from the file with its config.json by the port's loader: every
    tensor bit for bit, the router bias f32 (zeros when the checkpoint
    has none, V2)."""
    jcfg, jp, tcfg, tp = models(name)
    t = _hf_tensors(jcfg, jp)
    if name == "v2":
        t = {k: v for k, v in t.items() if "e_score" not in k}
    path = str(tmp_path / "model.safetensors")
    write_safetensors(path, t)
    names = list(t)
    want = jmapping.assemble_for(jcfg)(t.__getitem__, names, jcfg)
    got = tmapping.assemble_for(tcfg)(t.__getitem__, names, tcfg,
                                      device="cpu")
    assert tmapping.assemble_for(tcfg).__name__ == \
        jmapping.assemble_for(jcfg).__name__ == "assemble_params_deepseek"

    def same(a, b):
        if isinstance(b, dict):
            assert a.keys() == b.keys()
            for k in b:
                same(a[k], b[k])
            return
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
    same(got, want)
    hf = {"model_type": jcfg.architecture, "vocab_size": 256,
          "hidden_size": 64, "num_hidden_layers": 3,
          "num_attention_heads": 4, "intermediate_size": 128,
          "moe_intermediate_size": 64, "n_shared_experts": 1,
          "n_routed_experts": 8, "num_experts_per_tok": 2,
          "first_k_dense_replace": 1, "kv_lora_rank": 32,
          "q_lora_rank": 64 if name == "v3" else None,
          "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
          "max_position_embeddings": 128, "torch_dtype": "float32"}
    with open(os.path.join(str(tmp_path), "config.json"), "w") as f:
        json.dump(hf, f)
    data = tloader.load_model_data(path, dtype=torch.float32, device="cpu")
    assert data.config.architecture == jcfg.architecture
    assert data.config.shared_expert_size == 64
    same(data.params, want)


def test_calibrated_quantize_falls_back_as_jax():
    """Calibration covers the llama family only: DeepSeek's MLA slots
    fall back to uncalibrated quantization, the bytes of quantize_params,
    as the JAX package's calibrated_quantize_params does."""
    _, jp, tcfg, tp = models("v2")
    qcfg = QuantizationConfig(type=QuantType.INT4, **QCFG)
    got = tcalibrate.calibrated_quantize_params(tp, qcfg, tcfg,
                                                sample_tokens=[[1, 2, 3]])
    want = tquantizer.quantize_params(tp, qcfg)
    for k in ("wq", "wkv_a", "wo", "we_down"):
        assert torch.equal(got["layers"][k].data, want["layers"][k].data)


# -- names, refusals, configs ------------------------------------------------------

def test_registry_and_refusals():
    assert registry.get_model("deepseek_v2") is tds
    assert registry.get_model("deepseek_v3") is tds
    with pytest.raises(ConfigError):
        registry.get_model("deepseek")
    base = tconfig.ModelConfig(**dict(BASE, **CFGS["v2"]))
    tds.check_supported(base)
    for kw in (dict(kv_lora_rank=None), dict(num_experts=0),
               dict(first_k_dense_replace=3), dict(experts_per_token=9),
               dict(n_group=3, topk_method="noaux_tc")):
        with pytest.raises(ConfigError):
            tds.check_supported(base.replace(**kw))
    with pytest.raises(NotImplementedError):
        tds.check_supported(base.replace(architecture="mixtral"))


def test_deepseek_v2_lite_config_matches_jax():
    c = tconfig.deepseek_v2_lite_config()
    j = ti.config.deepseek_v2_lite_config()
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "intermediate_size", "moe_intermediate_size",
              "shared_expert_size", "num_experts", "experts_per_token",
              "norm_topk_prob", "scoring_func", "topk_method",
              "routed_scaling_factor", "first_k_dense_replace",
              "kv_lora_rank", "q_lora_rank", "qk_nope_head_dim",
              "qk_rope_head_dim", "v_head_dim", "max_seq_len", "rope_theta",
              "architecture", "rms_norm_eps", "rope_scaling"):
        assert getattr(c, f) == getattr(j, f), f
    # the cache bytes a token the card run reports: (512 + 64) x 2 x 27
    # in bf16, (576 + 8) x 27 in int8 with its two f32 scales
    lr, dr, L = c.kv_lora_rank, c.qk_rope_head_dim, c.num_layers
    assert (lr + dr) * 2 * L == 31104 and (lr + dr + 8) * L == 15768
