"""int8 and fp8 KV caches of the port against the JAX package.

- the codecs: int8 codes and scales and fp8 bytes equal the JAX package's
  as it writes them (its compiled encode: the f32 reciprocal of 127 times
  the absmax, then a true division), fp8 across the +-464 saturation
  trap, inf and NaN; the e4m3 decode equals the Pallas kernels'
  e4m3_to_bf16 on all 256 codes;
- the plain kernel versions (what the wrappers run on the CPU) against
  the Pallas kernels in interpret mode: decode (window too), the stacked
  prefill read at q_start > 0, paged decode and verify;
- llama and MoE forwards (fresh prefill, chunked prefill, decode, paged
  decode and verify): the K/V they encode come out of f32 sums taken in
  another order, so a value one ulp apart may round to the neighbouring
  code: at most 0.1% of the codes differ, each by one step, int8 scales
  within 1e-5, and logits within 1e-3 of max|logit| (one int8 step is
  1/127 of its row's absmax);
- greedy trajectories of generate_batch, both schedulers (prefix-pool
  hits included) and paged speculative serving equal the JAX package's;
- GPT-OSS takes int8 and fp8 caches and fp8 pools, and refuses int8
  pools (its forwards are held in test_torch_gptoss.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

import turboinfer_tpu as ti
from turboinfer_tpu.config import ModelConfig as JModelConfig
from turboinfer_tpu.engine import paged_cache as jpc
from turboinfer_tpu.engine.scheduler import \
    ContinuousBatchingScheduler as JContinuous
from turboinfer_tpu.engine.scheduler import \
    PagedContinuousScheduler as JPaged
from turboinfer_tpu.kernels.pallas import decode_attention as jda
from turboinfer_tpu.kernels.pallas import flash_attention as jfa
from turboinfer_tpu.kernels.pallas import paged_attention as jpa
from turboinfer_tpu.models import common as jcommon
from turboinfer_tpu.models import llama as jllama
from turboinfer_tpu.models import moe as jmoe
from turboinfer_tpu_torch import bridge
from turboinfer_tpu_torch import config as tconfig
from turboinfer_tpu_torch.engine import paged_cache as tpc
from turboinfer_tpu_torch.engine.engine import InferenceEngine
from turboinfer_tpu_torch.engine.scheduler import \
    ContinuousBatchingScheduler as TContinuous
from turboinfer_tpu_torch.engine.scheduler import \
    PagedContinuousScheduler as TPaged
from turboinfer_tpu_torch.kernels import decode_attention as tda
from turboinfer_tpu_torch.kernels import flash_attention as tfa
from turboinfer_tpu_torch.kernels import ops
from turboinfer_tpu_torch.kernels import paged_attention as tpa
from turboinfer_tpu_torch.models import common as tcommon
from turboinfer_tpu_torch.models import gptoss as tgptoss
from turboinfer_tpu_torch.models import llama as tllama
from turboinfer_tpu_torch.models import moe as tmoe

torch.set_num_threads(2)

# kv_cache_dtype -> (JAX storage dtype, port storage dtype)
KV = {"int8": (jnp.int8, torch.int8), "fp8": (jnp.uint8, torch.uint8)}
# The Pallas kernels feed the matrix unit bf16 operands even for f32
# inputs; the JAX package's own kernel tests use the same relative bound.
KERNEL_RTOL = 2e-2
LOGIT_RTOL = 1e-3        # of max|logit|: codes one step apart (see above)
SCALE_RTOL = 1e-5        # int8 scales: absmax of K/V from those sums
CODE_FLIPS = 1e-3        # share of codes allowed one step apart

_jit_encode = jax.jit(jcommon.encode_kv_scaled, static_argnums=1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-9)


def _bf16_pair(bits16):
    """The same bf16 bit patterns as a JAX array and a torch tensor."""
    bits16 = np.asarray(bits16, np.uint16)
    return (jnp.asarray(bits16.view(ml_dtypes.bfloat16)),
            torch.from_numpy(bits16.view(np.int16).copy()).view(torch.bfloat16))


# -- codecs -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_codes_and_scales_match_jax(dtype):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 5, 700, 64))
         * rng.uniform(1e-3, 50.0, size=(3, 5, 700, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0                       # absmax 0: the 1e-12 floor
    if dtype == "f32":
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    else:
        bits = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint16)
        jx, tx = _bf16_pair(bits)
    jq, js = _jit_encode(jx, jnp.int8)
    tq, ts = tcommon.encode_kv_scaled(tx, torch.int8)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    # decode: int8 codes times the scale in f32, as the JAX package's
    np.testing.assert_array_equal(
        tcommon.decode_kv(tq, torch.float32, ts).numpy(),
        np.asarray(jcommon.decode_kv(jq, jnp.float32, js)))
    # an un-jitted JAX call divides by 127: one f32 ulp apart at most
    _, js_eager = jcommon.encode_kv_scaled(jx, jnp.int8)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js_eager), rtol=2e-7,
                               atol=0)


# Row absmax values whose int8 rows sit on rounding ties (as the `cuda`
# tests of the encode-and-write kernel build them): at 127 the scale is
# exactly 1.0 and at 63.5 exactly 0.5, so every bf16 value with a .5 (or
# .25) fraction divides to a half-integer; 3e-13 is under the 1e-12
# scale floor, 2^-130 a subnormal, 1.5e38 near the top of the range.
TIE_ABSMAX = (127.0, 63.5, 1.0, 448.0, 100.5, 3e-13, 2.0 ** -130, 1.5e38)


def _tie_row_bits(D):
    """bf16 bit patterns [R, D]: for each absmax a of TIE_ABSMAX, every
    bf16 value of magnitude <= a, both signs, D - 1 a row beside a."""
    out = []
    for a in TIE_ABSMAX:
        a16 = int(np.float32(a).view(np.uint32)) >> 16
        mags = np.arange(a16 + 1, dtype=np.uint16)
        vals = np.concatenate([mags, mags[1:] | 0x8000])
        vals = np.concatenate([vals, np.zeros((-len(vals)) % (D - 1),
                                              np.uint16)]).reshape(-1, D - 1)
        out.append(np.concatenate(
            [np.full((len(vals), 1), a16, np.uint16), vals], axis=1))
    return np.concatenate(out)


@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_int8_tie_rows_match_jitted_jax(D):
    """The rows the encode-and-write kernel's tie test feeds it: the port's
    plain int8 encode (the kernel's reference on the card) equals the
    JAX package's compiled encode_kv_scaled, codes byte for byte and
    scales bit for bit, on exact and near .5 ties."""
    jx, tx = _bf16_pair(_tie_row_bits(D))
    jq, js = _jit_encode(jx, jnp.int8)
    tq, ts = tcommon.encode_kv_scaled(tx, torch.int8)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    # the rows do reach exact ties: x / scale == k + 0.5 at scale 1.0
    x = tx.float()
    assert bool(((x[:, 0] == 127) & (x[:, 1:].frac().abs() == 0.5)
                 .any(dim=1)).any())


def test_fp8_bytes_match_jax_across_the_saturation_trap():
    """torch's float8_e4m3fn cast saturates |x| > 464 to +-448 where the
    JAX package writes the NaN codes 0x7F/0xFF; the port's encode masks
    them in. f32 over [-600, 600] with the boundaries, inf, NaN of both
    signs and subnormals, and every one of the 65536 bf16 bit patterns."""
    special = np.array([448, -448, 464, -464, 464.00003, -464.00003, 465,
                        -465, 480, np.inf, -np.inf, 2.0 ** -9, -2.0 ** -9,
                        2.0 ** -10, 3 * 2.0 ** -11, 2.0 ** -12, 0.0, -0.0],
                       np.float32)
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7F800001], np.uint32).view(
        np.float32)
    x = np.concatenate([np.linspace(-600, 600, 200001, dtype=np.float32),
                        special, nans])
    want = np.asarray(jcommon.encode_kv(jnp.asarray(x), jnp.uint8))
    got = tcommon.encode_kv_scaled(torch.from_numpy(x),
                                   torch.uint8)[0].numpy()
    np.testing.assert_array_equal(got, want)
    sat = x[np.abs(x) > 464]
    assert len(sat) > 40000 and set(want[np.abs(x) > 464]) == {0x7F, 0xFF}
    assert set(torch.from_numpy(sat).to(torch.float8_e4m3fn).view(
        torch.uint8).tolist()) == {0x7E, 0xFE}          # the trap itself
    jb, tb = _bf16_pair(np.arange(65536))
    np.testing.assert_array_equal(
        tcommon.encode_kv_scaled(tb, torch.uint8)[0].numpy(),
        np.asarray(jcommon.encode_kv(jb, jnp.uint8)))


def test_e4m3_decode_matches_pallas_on_all_codes():
    codes = np.arange(256, dtype=np.uint8)
    want = np.asarray(jda.e4m3_to_bf16(jnp.asarray(codes), jnp.float32))
    got = ops.e4m3_to_float(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    assert got[0x7F] == 480.0 and got[0xFF] == -480.0
    # the JAX package's plain decode_kv reads those two codes as NaN, and
    # agrees with the kernels on the other 254
    plain = np.asarray(jcommon.decode_kv(jnp.asarray(codes), jnp.float32))
    finite = np.isfinite(plain)
    assert list(np.nonzero(~finite)[0]) == [0x7F, 0xFF]
    np.testing.assert_array_equal(got[finite], plain[finite])
    np.testing.assert_array_equal(
        tcommon.decode_kv(torch.from_numpy(codes), torch.bfloat16).float(),
        got)


def test_resolve_kv_dtype():
    for name, (jd, td) in KV.items():
        assert jcommon.resolve_kv_dtype(name, jnp.float32) == jd
        assert tcommon.resolve_kv_dtype(name, torch.float32) == td
    assert tcommon.resolve_kv_dtype("bf16", torch.float32) == torch.bfloat16
    for name in ("model", "", None):
        assert tcommon.resolve_kv_dtype(name, torch.float32) == torch.float32
    with pytest.raises(ValueError):
        tcommon.resolve_kv_dtype("fp4", torch.float32)


# -- plain kernel versions against the Pallas kernels in interpret mode --------

def _store(rng, shape, kind, big=False):
    """Random K/V encoded to `kind` -> (JAX storage, JAX scales, port
    storage, port scales), the same bytes. big: a few values past 464
    (fp8 0x7F/0xFF codes, which both sides read as +-480)."""
    x = rng.normal(size=shape).astype(np.float32)
    if big:
        x.reshape(-1, shape[-1])[::7, :3] *= 300.0
    q, s = tcommon.encode_kv_scaled(torch.from_numpy(x), KV[kind][1])
    js = None if s is None else jnp.asarray(s.numpy())
    return jnp.asarray(q.numpy()), js, q, s


@pytest.mark.parametrize("kind", list(KV))
@pytest.mark.parametrize("D,gh,window", [(64, 4, None), (128, 1, None),
                                         (64, 2, 40), (256, 2, None),
                                         (256, 1, 40)])
def test_decode_plain_matches_pallas(kind, D, gh, window):
    rng = np.random.default_rng(D + gh)
    L, B, Hkv, T = 2, 3, 2, 128
    Hq = Hkv * gh
    jk, jks, tk, tks = _store(rng, (L, B, Hkv, T, D), kind)
    jv, jvs, tv, tvs = _store(rng, (L, B, Hkv, T, D), kind, big=True)
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    kv = np.array([0, 70, 128], np.int32)
    want = jda.decode_pallas(jnp.asarray(q), jk, jv, jnp.asarray(kv),
                             layer_index=jnp.int32(1), window=window,
                             k_scale=jks, v_scale=jvs, interpret=True)
    got = tda.decode_attention(torch.from_numpy(q), tk, tv,
                               torch.from_numpy(kv), 1, window, None, tks,
                               tvs)
    assert _rel(got.numpy(), np.asarray(want)) < KERNEL_RTOL


@pytest.mark.parametrize("kind", list(KV))
def test_stacked_prefill_plain_matches_pallas(kind):
    """The chunked-prefill read: layer li of a compressed stack, queries
    at q_start > 0, keys masked at kv_len."""
    rng = np.random.default_rng(5)
    L, B, S, Hq, Hkv, T, D = 2, 2, 16, 4, 2, 64, 64
    jk, jks, tk, tks = _store(rng, (L, B, Hkv, T, D), kind)
    jv, jvs, tv, tvs = _store(rng, (L, B, Hkv, T, D), kind)
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    q_start = np.array([30, 5], np.int32)
    kv = np.array([46, 13], np.int32)
    want = jfa.prefill_pallas(jnp.asarray(q), jk, jv, causal=True,
                              kv_len=jnp.asarray(kv),
                              q_start=jnp.asarray(q_start),
                              layer_index=jnp.int32(1), k_scale=jks,
                              v_scale=jvs, interpret=True)
    sc = (None, None) if tks is None else (tks[1], tvs[1])
    got = tfa.flash_prefill(torch.from_numpy(q), tk[1], tv[1],
                            torch.from_numpy(kv), torch.from_numpy(q_start),
                            *sc)
    assert _rel(got.numpy(), np.asarray(want)) < KERNEL_RTOL


@pytest.mark.parametrize("kind", list(KV))
@pytest.mark.parametrize("gh", [3, 8])
def test_stacked_prefill_plain_matches_pallas_gqa_chunk(kind, gh):
    """The compressed stacked read at the GQA groups the CUDA kernel packs
    into a tile's rows (gh = 3 and 8), for a chunk with kv_len < q_start
    + S on both rows: the rows past kv_len see every key."""
    rng = np.random.default_rng(40 + gh)
    L, B, S, Hkv, T, D = 2, 2, 24, 2, 64, 64
    jk, jks, tk, tks = _store(rng, (L, B, Hkv, T, D), kind)
    jv, jvs, tv, tvs = _store(rng, (L, B, Hkv, T, D), kind, big=True)
    q = rng.normal(size=(B, S, gh * Hkv, D)).astype(np.float32)
    q_start = np.array([20, 3], np.int32)
    kv = np.array([37, 19], np.int32)
    want = jfa.prefill_pallas(jnp.asarray(q), jk, jv, causal=True,
                              kv_len=jnp.asarray(kv),
                              q_start=jnp.asarray(q_start),
                              layer_index=jnp.int32(1), k_scale=jks,
                              v_scale=jvs, interpret=True)
    assert want is not None
    sc = (None, None) if tks is None else (tks[1], tvs[1])
    got = tfa.flash_prefill(torch.from_numpy(q), tk[1], tv[1],
                            torch.from_numpy(kv), torch.from_numpy(q_start),
                            *sc)
    assert _rel(got.numpy(), np.asarray(want)) < KERNEL_RTOL


@pytest.mark.parametrize("kind", list(KV))
@pytest.mark.parametrize("G", [1, 4])
def test_paged_plain_matches_pallas(kind, G):
    """Paged decode and verify over int8 pages (scale pages through the
    same clamped table entry) and fp8 pages."""
    rng = np.random.default_rng(G + 11)
    L, P, Hkv, page, D, B, max_pages, gh = 2, 12, 2, 16, 64, 3, 5, 2
    jk, jks, tk, tks = _store(rng, (L, P, Hkv, page, D), kind)
    jv, jvs, tv, tvs = _store(rng, (L, P, Hkv, page, D), kind, big=True)
    q = rng.normal(size=(B, G, Hkv * gh, D)).astype(np.float32)
    lens = [5, 2 * page + 3, max_pages * page]
    table = rng.integers(0, P, (B, max_pages)).astype(np.int32)
    for b, n in enumerate(lens):
        table[b, -(-n // page):] = -1
    kv = np.asarray(lens, np.int32)
    args = (jk, jv, jnp.asarray(table), jnp.asarray(kv))
    kw = dict(layer_index=jnp.int32(1), k_scale=jks, v_scale=jvs,
              interpret=True)
    if G == 1:
        want = jpa.paged_decode_pallas(jnp.asarray(q[:, 0]), *args,
                                       **kw)[:, None]
    else:
        want = jpa.paged_verify_pallas(jnp.asarray(q), *args, **kw)
    got = tpa.paged_attention(torch.from_numpy(q), tk, tv,
                              torch.from_numpy(table), torch.from_numpy(kv),
                              1, tks, tvs)
    assert _rel(got.numpy(), np.asarray(want)) < KERNEL_RTOL


# -- models --------------------------------------------------------------------

_P = {}

LLAMA = dict(hidden_size=256, num_heads=4, num_kv_heads=2,
             intermediate_size=256, vocab_size=300)
MOE = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
           num_kv_heads=2, intermediate_size=256, num_experts=4,
           experts_per_token=2, max_seq_len=128, architecture="mixtral",
           name="tiny-mixtral")


def _port(tree):
    return bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                    device="cpu")


def models(family):
    """(JAX module, JAX config, JAX params, port module, port config, port
    params) on the same f32 weights."""
    if family not in _P:
        if family == "llama":
            jcfg = ti.tiny_config(dtype=jnp.float32, **LLAMA)
            tcfg = tconfig.tiny_config(dtype=torch.float32, **LLAMA)
            jp = jllama.init_params(jax.random.PRNGKey(2), jcfg)
            _P[family] = (jllama, jcfg, jp, tllama, tcfg, _port(jp))
        else:
            jcfg = JModelConfig(dtype=jnp.float32, **MOE)
            tcfg = tconfig.ModelConfig(dtype=torch.float32, **MOE)
            jp = jmoe.init_params(jax.random.PRNGKey(0), jcfg)
            _P[family] = (jmoe, jcfg, jp, tmoe, tcfg, _port(jp))
    return _P[family]


def _close(got, want, rtol=LOGIT_RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * np.abs(want).max())


def _codes_close(got, want):
    """At most CODE_FLIPS of the codes differ, each by one step (int8: one
    code; fp8: the neighbouring e4m3 value of the same sign)."""
    got = np.asarray(got).astype(np.int16)
    want = np.asarray(want).astype(np.int16)
    diff = got != want
    assert diff.mean() <= CODE_FLIPS, diff.mean()
    assert (np.abs(got[diff] - want[diff]) == 1).all()


def _same_store(got, want_codes, want_scales):
    """Codes within _codes_close, int8 scales within SCALE_RTOL."""
    _codes_close(got[0].numpy(), want_codes)
    if want_scales is not None:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want_scales),
                                   rtol=SCALE_RTOL, atol=0)


def _same_cache(tc, jc):
    _same_store((tc.k, tc.k_scale), jc.k, jc.k_scale)
    _same_store((tc.v, tc.v_scale), jc.v, jc.v_scale)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


@pytest.mark.parametrize("kind", list(KV))
@pytest.mark.parametrize("family", ["llama", "moe"])
def test_forward_fresh_chunked_decode_match_jax(family, kind):
    """Fresh prefill into the compressed cache (both packages attend the
    quantized K/V read back from it), a chunked prefill at start > 0,
    then a decode step: logits and the caches after every call."""
    jm, jcfg, jp, tm, tcfg, tp = models(family)
    jd, td = KV[kind]
    rng = np.random.default_rng(3)
    B, S, C, T = 2, 16, 8, 48
    toks = rng.integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([16, 11], np.int32)
    jc = jm.init_cache(jcfg, B, max_seq=T, dtype=jd, fused=False)
    tc = tm.init_cache(tcfg, B, max_seq=T, dtype=td, device="cpu")
    jl, jc = jm.forward(jp, jcfg, jnp.asarray(toks), jc,
                        seq_lens=jnp.asarray(lens), fresh_prefill=True)
    tl, tc = tm.forward(tp, tcfg, torch.from_numpy(toks), tc,
                        seq_lens=torch.from_numpy(lens), fresh_prefill=True)
    _close(tl.numpy(), jl)
    _same_cache(tc, jc)
    chunk = rng.integers(1, jcfg.vocab_size, (B, C)).astype(np.int32)
    clens = np.array([8, 5], np.int32)
    jl, jc = jm.forward(jp, jcfg, jnp.asarray(chunk), jc,
                        seq_lens=jnp.asarray(clens))
    tl, tc = tm.forward(tp, tcfg, torch.from_numpy(chunk), tc,
                        seq_lens=torch.from_numpy(clens))
    _close(tl.numpy(), jl)
    _same_cache(tc, jc)
    nxt = np.argmax(np.asarray(jl[:, -1]), -1).astype(np.int32)[:, None]
    jl, jc = jm.forward(jp, jcfg, jnp.asarray(nxt), jc)
    tl, tc = tm.forward(tp, tcfg, torch.from_numpy(nxt), tc)
    _close(tl.numpy(), jl)
    _same_cache(tc, jc)


@pytest.mark.parametrize("kind", list(KV))
@pytest.mark.parametrize("G", [1, 3])
def test_forward_paged_matches_jax(kind, G):
    """forward_paged_decode / _verify over int8 (scale pools passed and
    returned) and fp8 pools: logits and every pool after the write; the
    inactive row 2 (table -1, length 0) writes trash page 0 only."""
    jm, jcfg, jp, tm, tcfg, tp = models("llama")
    jd, td = KV[kind]
    rng = np.random.default_rng(G + 20)
    L, P, page, B = jcfg.num_layers, 10, 8, 3
    Hkv, D = jcfg.kv_heads, jcfg.head_dim_
    jk, jks, tk, tks = _store(rng, (L, P, Hkv, page, D), kind)
    jv, jvs, tv, tvs = _store(rng, (L, P, Hkv, page, D), kind)
    table = np.array([[3, 7, 1, -1], [8, 2, -1, -1], [-1, -1, -1, -1]],
                     np.int32)
    lengths = np.array([13, 6, 0], np.int32)
    tokens = rng.integers(1, jcfg.vocab_size, (B, G)).astype(np.int32)
    jscale = {} if jks is None else dict(k_scale_pages=jks,
                                         v_scale_pages=jvs)
    tscale = {} if tks is None else dict(k_scale_pages=tks,
                                         v_scale_pages=tvs)
    jargs = (jk, jv, jnp.asarray(table), jnp.asarray(lengths))
    targs = (tk, tv, torch.from_numpy(table), torch.from_numpy(lengths))
    if G == 1:
        want = jm.forward_paged_decode(jp, jcfg, jnp.asarray(tokens[:, 0]),
                                       *jargs, **jscale)
        got = tm.forward_paged_decode(tp, tcfg, torch.from_numpy(tokens[:, 0]),
                                      *targs, **tscale)
    else:
        want = jm.forward_paged_verify(jp, jcfg, jnp.asarray(tokens), *jargs,
                                       **jscale)
        got = tm.forward_paged_verify(tp, tcfg, torch.from_numpy(tokens),
                                      *targs, **tscale)
    assert len(got) == len(want) == (5 if kind == "int8" else 3)
    _close(got[0].numpy()[:2], np.asarray(want[0])[:2])
    for i in (1, 2):
        _codes_close(got[i].numpy(), want[i])
    for i in range(3, len(got)):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=SCALE_RTOL, atol=0)
    assert not torch.equal(got[1][:, P - 1].clone(), got[1][:, 0])
    np.testing.assert_array_equal(got[1][:, P - 1].numpy(),
                                  np.asarray(jk)[:, P - 1])


@pytest.mark.parametrize("kind", list(KV))
def test_append_token_and_gather_sequence_match_jax(kind):
    """append_token encodes into the pool (int8 scale pages too);
    gather_sequence returns int8 dequantized to f32 and fp8 as bits."""
    jm, jcfg, _, _, tcfg, _ = models("llama")
    jd, td = KV[kind]
    rng = np.random.default_rng(9)
    L, Hkv, D, B, page = jcfg.num_layers, jcfg.kv_heads, jcfg.head_dim_, 2, 8
    table = np.array([[2, 5, -1, -1], [4, 3, 6, 7]], np.int32)
    lengths = np.array([9, 23], np.int32)
    jc = jpc.init_paged_cache(jcfg, B, num_pages=8, page_size=page,
                              max_seq=32, dtype=jd)._replace(
        block_table=jnp.asarray(table), lengths=jnp.asarray(lengths))
    tc = tpc.init_paged_cache(tcfg, B, num_pages=8, page_size=page,
                              max_seq=32, dtype=td, device="cpu")._replace(
        block_table=torch.from_numpy(table),
        lengths=torch.from_numpy(lengths))
    for _ in range(2):
        k = rng.normal(size=(L, B, Hkv, D)).astype(np.float32)
        v = rng.normal(size=(L, B, Hkv, D)).astype(np.float32)
        jc = jpc.append_token(jc, jnp.asarray(k), jnp.asarray(v))
        tc = tpc.append_token(tc, torch.from_numpy(k), torch.from_numpy(v))
    _same_store((tc.k_pages, tc.k_scale_pages), jc.k_pages, jc.k_scale_pages)
    _same_store((tc.v_pages, tc.v_scale_pages), jc.v_pages, jc.v_scale_pages)
    for g, w in zip(tpc.gather_sequence(tc, 32), jpc.gather_sequence(jc, 32)):
        assert g.dtype == (torch.float32 if kind == "int8" else torch.uint8)
        np.testing.assert_allclose(g.numpy().astype(np.float32),
                                   np.asarray(w).astype(np.float32),
                                   rtol=SCALE_RTOL, atol=0)


def test_bridge_takes_jax_fp8_arrays_and_int8_scales():
    """cache_from_numpy / paged_cache_from_numpy: a JAX float8_e4m3fn
    array becomes the uint8 bits, int8 caches keep their scale planes."""
    x = np.linspace(-500, 500, 2 * 1 * 2 * 4 * 32, dtype=np.float32).reshape(
        2, 1, 2, 4, 32)
    f8 = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn))
    c = bridge.cache_from_numpy(f8, f8, [3], device="cpu")
    np.testing.assert_array_equal(c.k.numpy(), f8.view(np.uint8))
    assert c.k.dtype == torch.uint8 and c.k_scale is None
    q, s = _jit_encode(jnp.asarray(x), jnp.int8)
    p = bridge.paged_cache_from_numpy(np.asarray(q), np.asarray(q),
                                      [[0, 1]], [5], np.asarray(s),
                                      np.asarray(s), device="cpu")
    assert p.k_pages.dtype == torch.int8 and p.v_scale_pages.shape == (2, 1,
                                                                       2, 4)
    got = bridge.to_numpy(c)
    assert set(got) == {"k", "v", "length", "k_scale", "v_scale"}


# -- engine and schedulers -------------------------------------------------------

def _prompts(n, seed, base=9, step=5, vocab=900):
    return [[int(t) for t in np.random.default_rng(seed + i).integers(
        1, vocab, base + step * i)] for i in range(n)]


_TINY = {}


def tiny():
    """(JAX config, params, port config, params): tiny f32 (D=32)."""
    if not _TINY:
        jcfg = ti.tiny_config(dtype=jnp.float32)
        jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
        _TINY.update(jcfg=jcfg, jp=jp,
                     tcfg=tconfig.tiny_config(dtype=torch.float32),
                     tp=_port(jp))
    return _TINY


@pytest.mark.parametrize("kind", list(KV))
def test_generate_batch_greedy_matches_jax(kind):
    m = tiny()
    icfg = dict(max_seq_len=64, temperature=0.0, eos_token_id=-1, seed=0,
                kv_cache_dtype=kind)
    je = ti.InferenceEngine(m["jp"], m["jcfg"], ti.InferenceConfig(**icfg))
    te = InferenceEngine(m["tp"], m["tcfg"], tconfig.InferenceConfig(**icfg),
                         device="cpu")
    prompts = _prompts(3, 60)
    jr = je.generate_batch(prompts, 12, temperature=0.0)
    tr = te.generate_batch(prompts, 12, temperature=0.0)
    assert [r.tokens for r in tr] == [r.tokens for r in jr]
    assert [r.stop_reason for r in tr] == [r.stop_reason for r in jr]
    cache = next(iter(te._cache_pool.values()))
    assert cache.k.dtype == KV[kind][1]
    assert (cache.k_scale is not None) == (kind == "int8")


def _run(sched, reqs):
    ids = [sched.submit(p, n) for p, n in reqs]
    res = sched.run()
    return [res[i].tokens for i in ids], [res[i].stop_reason for i in ids]


@pytest.mark.parametrize("kind", list(KV))
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_scheduler_greedy_matches_jax(kind, paged):
    """More requests than slots, so admission is continuous; the paged
    scheduler's pool is int8 (with scale pages) or fp8, and the last
    requests share a two-page prefix with an earlier one, so admissions
    reuse its pages (and scale pages) from the prefix pool."""
    m = tiny()
    icfg = dict(max_seq_len=96, temperature=0.0, eos_token_id=-1, seed=0,
                kv_cache_dtype=kind)
    extra = dict(page_size=8) if paged else {}
    J, T = (JPaged, TPaged) if paged else (JContinuous, TContinuous)
    js = J(m["jp"], m["jcfg"], ti.InferenceConfig(**icfg), batch_slots=2,
           **extra)
    ts = T(m["tp"], m["tcfg"], tconfig.InferenceConfig(**icfg),
           batch_slots=2, device="cpu", **extra)
    ps = _prompts(3, 40, base=12)
    shared = ps[2][:16]
    ps += [shared + [7, 8, 9], shared + [11]]
    reqs = [(p, 6) for p in ps]
    assert _run(ts, reqs) == _run(js, reqs)
    if paged:
        assert ts.cache.k_pages.dtype == KV[kind][1]
        assert (ts.cache.k_scale_pages is not None) == (kind == "int8")
        assert (ts.pool.hits, ts.pool.misses) == (js.pool.hits,
                                                  js.pool.misses)
        assert ts.pool.hits >= 2


@pytest.mark.parametrize("kind", list(KV))
def test_paged_speculative_matches_jax(kind):
    """Paged speculative rounds over an int8 / fp8 pool with a one-layer
    draft (its contiguous cache at the same kv_cache_dtype): tokens and
    the exact proposal and acceptance counts equal the JAX package's."""
    m = tiny()
    jd = {"embed": m["jp"]["embed"],
          "layers": {k: v[:1] for k, v in m["jp"]["layers"].items()},
          "final_norm": m["jp"]["final_norm"], "lm_head": m["jp"]["lm_head"]}
    icfg = dict(max_seq_len=96, temperature=0.0, eos_token_id=-1, seed=0,
                kv_cache_dtype=kind)
    kw = dict(batch_slots=2, page_size=8, spec_k=3)
    js = JPaged(m["jp"], m["jcfg"], ti.InferenceConfig(**icfg),
                draft_params=jd, draft_config=m["jcfg"].replace(num_layers=1),
                **kw)
    ts = TPaged(m["tp"], m["tcfg"], tconfig.InferenceConfig(**icfg),
                draft_params=_port(jd),
                draft_config=m["tcfg"].replace(num_layers=1), device="cpu",
                **kw)
    reqs = [(p, 9) for p in _prompts(2, 80)]
    assert _run(ts, reqs) == _run(js, reqs)
    assert ts.dcache.k.dtype == KV[kind][1]
    assert (ts.spec_proposed, ts.spec_accepted) == (js.spec_proposed,
                                                    js.spec_accepted)
    assert 0 < ts.spec_accepted < ts.spec_proposed


# -- refusal -----------------------------------------------------------------

@pytest.mark.parametrize("kind", list(KV))
def test_gptoss_refuses_compressed_caches(kind):
    """GPT-OSS takes int8 and fp8 contiguous caches and fp8 page pools,
    and refuses int8 pools, as the JAX package does (SUPPORTS_INT8_KV,
    SUPPORTS_INT8_KV_PAGED = False; its tests are test_torch_gptoss.py)."""
    cfg = tconfig.gptoss20b_config(vocab_size=64, hidden_size=64,
                                   num_layers=2, num_heads=4, num_kv_heads=2,
                                   intermediate_size=32, num_experts=4,
                                   experts_per_token=2, sliding_window=8,
                                   max_seq_len=32, dtype=torch.float32)
    c = tgptoss.init_cache(cfg, 1, dtype=KV[kind][1], device="cpu")
    assert c.k.dtype == KV[kind][1] and (c.k_scale is not None) == (
        kind == "int8")
    params = tgptoss.init_params(cfg, device="cpu")
    icfg = tconfig.InferenceConfig(max_seq_len=32, kv_cache_dtype=kind)
    InferenceEngine(params, cfg, icfg, device="cpu")
    TContinuous(params, cfg, icfg, batch_slots=1, device="cpu")
    if kind == "int8":
        with pytest.raises(NotImplementedError, match="int8"):
            TPaged(params, cfg, icfg, batch_slots=1, page_size=8,
                   device="cpu")
    else:
        assert TPaged(params, cfg, icfg, batch_slots=1, page_size=8,
                      device="cpu").cache.k_pages.dtype == torch.uint8
