"""Each kernel module of the port against the JAX Pallas kernel it replaces.

On the CPU a wrapper runs its kernel's plain PyTorch version; here it is
held against the Pallas kernel run with interpret=True (as
tests/test_kernels.py runs it), on the same seeded numpy inputs. The
CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from turboinfer_tpu.config import QuantType as JQuantType
from turboinfer_tpu.config import RopeMode as JRopeMode
from turboinfer_tpu.core.qtensor import quantize as j_quantize
from turboinfer_tpu.core.qtensor import quantize_embed as j_quantize_embed
from turboinfer_tpu.kernels import ops as jops
from turboinfer_tpu.kernels.pallas import cache_write as jcw
from turboinfer_tpu.kernels.pallas import decode_attention as jda
from turboinfer_tpu.kernels.pallas import flash_attention as jfa
from turboinfer_tpu.kernels.pallas import qmm as jqmm
from turboinfer_tpu_torch import kernels
from turboinfer_tpu_torch.config import QuantType, RopeMode
from turboinfer_tpu_torch.core.qtensor import QTensor, quantize, quantize_embed
from turboinfer_tpu_torch.kernels import (cache_write, decode_attention,
                                          dispatch, flash_attention, ops, qmm)

torch.set_num_threads(2)

# Pallas kernels feed the TPU matrix unit bf16 operands even for f32
# inputs (qmm, flash, decode), so they sit ~1e-2 relative from the f32
# plain versions; the JAX package's own kernel tests use the same bound.
KERNEL_RTOL = 2e-2


def _rng(seed):
    return np.random.default_rng(seed)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-9)


def _stacked_int4(rng, L, K, N, g=64):
    ws = rng.normal(size=(L, K, N)).astype(np.float32)
    jqts = [j_quantize(jnp.asarray(w), JQuantType.INT4, group_size=g)
            for w in ws]
    data = np.stack([np.asarray(q.data) for q in jqts])
    scales = np.stack([np.asarray(q.scales) for q in jqts])
    from turboinfer_tpu.core.qtensor import QTensor as JQ
    jqt = JQ(data=jnp.asarray(data), scales=jnp.asarray(scales),
             zero_points=None, bits=4, group_size=g, shape=(K, N))
    tqt = QTensor(data=torch.from_numpy(data),
                  scales=torch.from_numpy(scales.view(np.int16)).view(
                      torch.bfloat16),
                  zero_points=None, bits=4, group_size=g, shape=(K, N))
    return jqt, tqt


@pytest.mark.parametrize("M", [1, 8])
def test_qmm_stacked_plain_matches_pallas(M):
    rng = _rng(M)
    jqt, tqt = _stacked_int4(rng, 2, 256, 256)
    x = rng.normal(size=(M, 256)).astype(np.float32)
    for li in (0, 1):
        want = jqmm.qmatmul_pallas_stacked(jnp.asarray(x), jqt, li,
                                           interpret=True)
        got = qmm.qmm_int4(torch.from_numpy(x), tqt, li)
        assert got.shape == (M, 256) and got.dtype == torch.float32
        assert _rel(got.numpy(), want) < KERNEL_RTOL


@pytest.mark.parametrize("M", [1, 8])
def test_qmm_2d_plain_matches_pallas(M):
    rng = _rng(10 + M)
    w = rng.normal(size=(256, 256)).astype(np.float32)
    x = rng.normal(size=(2, M, 256)).astype(np.float32)
    jqt = j_quantize(jnp.asarray(w), JQuantType.INT4, group_size=64)
    tqt = quantize(torch.from_numpy(w), QuantType.INT4, group_size=64)
    want = jqmm.qmatmul_pallas(jnp.asarray(x), jqt, interpret=True)
    got = dispatch.qmatmul(torch.from_numpy(x), tqt)
    assert got.shape == (2, M, 256)
    assert _rel(got.numpy(), want) < KERNEL_RTOL
    # and exactly the JAX jnp golden form (same f32 arithmetic)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jops.qmatmul_ref(jnp.asarray(x), jqt)),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("slots", [[4, 0, 2], [3, 3, 1]])
def test_qmm_grouped_plain_matches_pallas(slots):
    """qmatmul_grouped_plain (what qmm_int4_grouped runs on the CPU)
    against qmatmul_pallas_grouped in interpret mode, as
    tests/test_kernels.py runs it: G=3 slots of a 5-plane int4 stack,
    different activations per group, then with a repeated slot."""
    rng = _rng(sum(slots))
    L, K, N, G = 5, 512, 384, 3
    jqt, tqt = _stacked_int4(rng, L, K, N)
    xg = rng.normal(size=(G, 1, K)).astype(np.float32)
    s = np.asarray(slots, np.int32)
    want = jqmm.qmatmul_pallas_grouped(jnp.asarray(xg), jqt, jnp.asarray(s),
                                       interpret=True)
    got = qmm.qmm_int4_grouped(torch.from_numpy(xg), tqt, torch.from_numpy(s))
    assert got.shape == (G, 1, N) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < KERNEL_RTOL
    for g, sl in enumerate(slots):         # and each group on its own plane
        np.testing.assert_allclose(
            got[g].numpy(), qmm.qmatmul_plain(torch.from_numpy(xg[g]), tqt,
                                              sl).numpy(), rtol=1e-5,
            atol=1e-4)


def test_qmatmul_grouped_fp_and_dispatch_match_jax():
    """ops.qmatmul_grouped: the fp gather-and-batch path, and QTensors
    through the dispatch, against the JAX package's ops.qmatmul_grouped."""
    rng = _rng(71)
    jqt, tqt = _stacked_int4(rng, 4, 256, 128)
    w = rng.normal(size=(4, 256, 128)).astype(np.float32)
    xg = rng.normal(size=(2, 3, 256)).astype(np.float32)
    s = np.asarray([3, 1], np.int32)
    for jw, tw in ((jnp.asarray(w), torch.from_numpy(w)), (jqt, tqt)):
        want = jops.qmatmul_grouped(jnp.asarray(xg), jw, jnp.asarray(s))
        got = ops.qmatmul_grouped(torch.from_numpy(xg), tw,
                                  torch.from_numpy(s))
        assert got.shape == (2, 3, 128)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-4)


def test_prefill_plain_matches_pallas():
    rng = _rng(20)
    B, S, Hq, Hkv, D = 2, 16, 4, 2, 64
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    kv_len = np.array([16, 9], np.int32)
    q_start = np.zeros((B,), np.int32)
    want = jfa.prefill_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, kv_len=jnp.asarray(kv_len),
                              q_start=jnp.asarray(q_start), interpret=True)
    assert want is not None
    got = flash_attention.flash_prefill(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(kv_len), torch.from_numpy(q_start))
    assert _rel(got.numpy(), want) < KERNEL_RTOL


def test_prefill_stacked_layer_read_matches_pallas():
    """The stacked-cache read (chunked prefill): queries at q_start > 0
    attend layer li of [L, B, Hkv, T, D] in place."""
    rng = _rng(21)
    L, B, S, Hq, Hkv, D, T = 2, 2, 8, 4, 4, 64, 16
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(L, B, Hkv, T, D)).astype(np.float32)
    v = rng.normal(size=(L, B, Hkv, T, D)).astype(np.float32)
    q_start = np.array([8, 4], np.int32)
    kv_len = np.array([16, 10], np.int32)
    for li in (0, 1):
        want = jfa.prefill_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            kv_len=jnp.asarray(kv_len), q_start=jnp.asarray(q_start),
            layer_index=jnp.int32(li), interpret=True)
        got = dispatch.attention_prefill(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            kv_len=torch.from_numpy(kv_len), q_start=torch.from_numpy(q_start),
            layer_index=li)
        assert _rel(got.numpy(), want) < KERNEL_RTOL


@pytest.mark.parametrize("Hq,Hkv", [(6, 2), (16, 2)], ids=["gh3", "gh8"])
@pytest.mark.parametrize("stacked", [False, True], ids=["fresh", "stacked"])
def test_prefill_plain_matches_pallas_gqa_groups(Hq, Hkv, stacked):
    """The GQA groups the CUDA kernel packs into a tile's rows, gh = 3
    (not a divisor of its 64 rows) and 8: the fresh read with kv_len < S
    on one row, and the stacked read of a chunk with kv_len < q_start + S
    (rows past kv_len see every key), the reference the card holds the
    kernel against at those edges."""
    rng = _rng(22 + Hq)
    L, B, S, D = 2, 2, 24, 64
    T = 64 if stacked else S
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    lead = (L, B) if stacked else (B,)
    k = rng.normal(size=lead + (Hkv, T, D)).astype(np.float32)
    v = rng.normal(size=lead + (Hkv, T, D)).astype(np.float32)
    q_start = np.array([20, 3] if stacked else [0, 0], np.int32)
    kv_len = np.array([37, 19] if stacked else [24, 17], np.int32)
    want = jfa.prefill_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        kv_len=jnp.asarray(kv_len), q_start=jnp.asarray(q_start),
        layer_index=jnp.int32(1) if stacked else None, interpret=True)
    assert want is not None
    got = dispatch.attention_prefill(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_len=torch.from_numpy(kv_len), q_start=torch.from_numpy(q_start),
        layer_index=1 if stacked else None)
    assert _rel(got.numpy(), want) < KERNEL_RTOL


def test_cache_write_plain_matches_pallas():
    rng = _rng(30)
    L, B, Hkv, T, D, S = 2, 2, 4, 16, 128, 8
    cache = rng.normal(size=(L, B, Hkv, T, D)).astype(np.float32)
    new_k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    new_v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    for li in (0, L - 1):
        want_k = jcw.cache_write_fresh(jnp.asarray(cache),
                                       jnp.asarray(new_k.transpose(0, 2, 1, 3)),
                                       li, interpret=True)
        want_v = jcw.cache_write_fresh(jnp.asarray(cache),
                                       jnp.asarray(new_v.transpose(0, 2, 1, 3)),
                                       li, interpret=True)
        kc, vc = torch.from_numpy(cache.copy()), torch.from_numpy(cache.copy())
        cache_write.cache_write_fresh(kc, vc, torch.from_numpy(new_k),
                                      torch.from_numpy(new_v), li)
        np.testing.assert_array_equal(kc.numpy(), np.asarray(want_k))
        np.testing.assert_array_equal(vc.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("D", [64, 128, 256])
def test_decode_plain_matches_pallas(D):
    rng = _rng(40 + D)
    L, B, Hq, Hkv, T = 2, 4, 8, 4, 64
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    k = rng.normal(size=(L, B, Hkv, T, D)).astype(np.float32)
    v = rng.normal(size=(L, B, Hkv, T, D)).astype(np.float32)
    kv_len = np.array([0, 1, 33, 64], np.int32)        # 0 is clamped to 1
    for li in (0, 1):
        want = jda.decode_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(kv_len),
                                 layer_index=jnp.int32(li), interpret=True)
        got = decode_attention.decode_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(kv_len), li)
        assert _rel(got.numpy(), want) < KERNEL_RTOL
    # the empty row reads row 0 only, as the clamp demands
    np.testing.assert_allclose(got[0].numpy(), np.repeat(
        v[1, 0, :, 0], Hq // Hkv, axis=0), rtol=1e-5, atol=1e-6)


# (window, kv_len per row): kv_len 1, 255, 256 and 257 around the
# kernel's 256-row slices; a window start lo = kv_len - window exactly on
# a slice boundary (384 - 128); window 1; a window >= kv_len.
_SINK_CASES = {"full": (None, [1, 255, 256, 257]),
               "w128": (128, [1, 255, 384, 257]),
               "w1": (1, [1, 256, 257, 512]),
               "wide": (600, [1, 255, 256, 512])}


@pytest.mark.parametrize("sinks", [True, False], ids=["sinks", "nosinks"])
@pytest.mark.parametrize("case", list(_SINK_CASES))
def test_decode_plain_window_sinks_match_fused_pallas(case, sinks):
    """decode_plain with a window and per-head sinks (what
    decode_attention runs on the CPU) against decode_fused_pallas in
    interpret mode, whose fused-head cache [L, B, T, Hkv*D] is the
    head-major one transposed: GPT-OSS's Gh=8, D=64, at T=512."""
    window, lens = _SINK_CASES[case]
    rng = _rng(60 + len(case) + sinks)
    L, B, Hq, Hkv, D, T = 2, 4, 16, 2, 64, 512
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    k = rng.normal(size=(L, B, Hkv, T, D)).astype(np.float32)
    v = rng.normal(size=(L, B, Hkv, T, D)).astype(np.float32)
    snk = rng.normal(scale=2.0, size=(Hq,)).astype(np.float32) \
        if sinks else None
    kv_len = np.asarray(lens, np.int32)

    def fused(c):
        return jnp.asarray(c.transpose(0, 1, 3, 2, 4).reshape(L, B, T, Hkv * D))
    for li in (0, 1):
        want = jda.decode_fused_pallas(
            jnp.asarray(q), fused(k), fused(v), jnp.asarray(kv_len),
            layer_index=jnp.int32(li), window=window,
            sinks=None if snk is None else jnp.asarray(snk), interpret=True)
        got = decode_attention.decode_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(kv_len), li, window=window,
            sinks=None if snk is None else torch.from_numpy(snk))
        assert _rel(got.numpy(), want) < KERNEL_RTOL
        # and exactly the JAX jnp golden form on the fused layout
        np.testing.assert_allclose(got.numpy(), np.asarray(
            jops.attention_decode_fused_ref(
                jnp.asarray(q), fused(k)[li], fused(v)[li],
                jnp.asarray(kv_len), window=window,
                sinks=None if snk is None else jnp.asarray(snk))),
            rtol=1e-5, atol=1e-5)
    if window == 1 and snk is None:     # each row reads its last key only
        last = v[1, np.arange(B), :, kv_len - 1]            # [B, Hkv, D]
        np.testing.assert_allclose(got.numpy(), np.repeat(
            last, Hq // Hkv, axis=1), rtol=1e-5, atol=1e-6)
        with pytest.raises(ValueError):                     # no empty window
            decode_attention.decode_attention(
                torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                torch.from_numpy(kv_len), 0, window=0)


# -- softcap and sliding windows (Gemma-2, Mistral) ---------------------------

# (window, softcap): windows that are no tile multiple, caps the scores
# (drawn at ~2x their usual spread) pass by 2-3x, and a cap they stay
# below
_MASKS = {"w13_cap2": (13, 2.0), "cap2": (None, 2.0), "w5": (5, None),
          "w600_cap50": (600, 50.0)}


def _kv_store(rng, shape, kind):
    """Random K/V, as f32 or encoded to kind "int8"/"fp8" by the port's
    codec -> (JAX storage, JAX scales, port storage, port scales), the
    same bytes."""
    from turboinfer_tpu_torch.models.common import encode_kv_scaled
    x = rng.normal(size=shape).astype(np.float32)
    if kind is None:
        return jnp.asarray(x), None, torch.from_numpy(x), None
    q, s = encode_kv_scaled(torch.from_numpy(x),
                            {"int8": torch.int8, "fp8": torch.uint8}[kind])
    return (jnp.asarray(q.numpy()), None if s is None else
            jnp.asarray(s.numpy()), q, s)


@pytest.mark.parametrize("mask", list(_MASKS))
@pytest.mark.parametrize("stacked,kind", [(False, None), (True, None),
                                          (True, "int8"), (True, "fp8")],
                         ids=["fresh", "stacked", "stacked_int8",
                              "stacked_fp8"])
def test_prefill_plain_window_softcap_matches_pallas(mask, stacked, kind):
    """prefill_plain with a window and a softcap against prefill_pallas
    in interpret mode: the fresh read (f32 K/V) and the stacked read of a
    chunk at q_start > 0 (f32, int8 with its scales, fp8). Rows past
    kv_len may see no key in their window (undefined: each side averages
    another key set) and are left out."""
    _prefill_window_softcap_case(mask, stacked, kind, 64, 4, 2)


@pytest.mark.parametrize("mask", list(_MASKS))
@pytest.mark.parametrize("stacked,kind", [(False, None), (True, None),
                                          (True, "int8"), (True, "fp8")],
                         ids=["fresh", "stacked", "stacked_int8",
                              "stacked_fp8"])
def test_prefill_plain_window_softcap_matches_pallas_head_dim_256(
        mask, stacked, kind):
    """The same at Gemma's head dim 256 (GQA 2:1)."""
    _prefill_window_softcap_case(mask, stacked, kind, 256, 2, 1)


def _prefill_window_softcap_case(mask, stacked, kind, D, Hq, Hkv):
    window, cap = _MASKS[mask]
    rng = _rng(70 + len(mask) + 3 * stacked + (D - 64))
    L, B, S = 2, 2, 24
    T = 64 if stacked else S
    q = (2.0 * rng.normal(size=(B, S, Hq, D))).astype(np.float32)
    lead = (L, B) if stacked else (B,)
    jk, jks, tk, tks = _kv_store(rng, lead + (Hkv, T, D), kind)
    jv, jvs, tv, tvs = _kv_store(rng, lead + (Hkv, T, D), kind)
    q_start = np.array([30, 7] if stacked else [0, 0], np.int32)
    kv_len = np.array([54, 20] if stacked else [24, 15], np.int32)
    want = jfa.prefill_pallas(
        jnp.asarray(q), jk, jv, causal=True, kv_len=jnp.asarray(kv_len),
        q_start=jnp.asarray(q_start), window=window, softcap=cap,
        layer_index=jnp.int32(1) if stacked else None, k_scale=jks,
        v_scale=jvs, interpret=True)
    assert want is not None
    got = dispatch.attention_prefill(
        torch.from_numpy(q), tk, tv, kv_len=torch.from_numpy(kv_len),
        q_start=torch.from_numpy(q_start),
        layer_index=1 if stacked else None, k_scale=tks, v_scale=tvs,
        window=window, softcap=cap)
    valid = (q_start[:, None] + np.arange(S)[None, :]) < kv_len[:, None]
    assert _rel(got.numpy()[valid], np.asarray(want)[valid]) < KERNEL_RTOL
    # and the JAX jnp golden form, on the same decoded K/V, exactly
    from turboinfer_tpu_torch.models.common import decode_kv
    kf = decode_kv(tk[1] if stacked else tk, torch.float32,
                   None if tks is None else tks[1])
    vf = decode_kv(tv[1] if stacked else tv, torch.float32,
                   None if tvs is None else tvs[1])
    pos = q_start[:, None] + np.arange(S)[None, :]
    ref = jops.attention_prefill_ref(
        jnp.asarray(q), jnp.asarray(kf.numpy()), jnp.asarray(vf.numpy()),
        positions=jnp.asarray(pos), kv_len=jnp.asarray(kv_len),
        window=window, softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mask", list(_MASKS))
@pytest.mark.parametrize("kind", [None, "int8", "fp8"],
                         ids=["f32", "int8", "fp8"])
def test_decode_plain_softcap_matches_pallas(mask, kind):
    """decode_plain with a softcap (and a window) against decode_pallas
    in interpret mode, over f32, int8 and fp8 caches; kv_len 1 and a
    window start past 0."""
    _decode_softcap_case(mask, kind, 64, 8, 2)


@pytest.mark.parametrize("mask", list(_MASKS))
@pytest.mark.parametrize("kind", [None, "int8", "fp8"],
                         ids=["f32", "int8", "fp8"])
def test_decode_plain_softcap_matches_pallas_head_dim_256(mask, kind):
    """The same at Gemma's head dim 256 (GQA 2:1)."""
    _decode_softcap_case(mask, kind, 256, 2, 1)


def _decode_softcap_case(mask, kind, D, Hq, Hkv):
    window, cap = _MASKS[mask]
    rng = _rng(80 + len(mask) + (D - 64))
    L, B, T = 2, 3, 128
    jk, jks, tk, tks = _kv_store(rng, (L, B, Hkv, T, D), kind)
    jv, jvs, tv, tvs = _kv_store(rng, (L, B, Hkv, T, D), kind)
    q = (2.0 * rng.normal(size=(B, Hq, D))).astype(np.float32)
    kv_len = np.array([1, 70, 128], np.int32)
    want = jda.decode_pallas(jnp.asarray(q), jk, jv, jnp.asarray(kv_len),
                             layer_index=jnp.int32(1), window=window,
                             softcap=cap, k_scale=jks, v_scale=jvs,
                             interpret=True)
    got = dispatch.attention_decode(torch.from_numpy(q), tk, tv,
                                    torch.from_numpy(kv_len), layer_index=1,
                                    window=window, k_scale=tks, v_scale=tvs,
                                    softcap=cap)
    assert _rel(got.numpy(), np.asarray(want)) < KERNEL_RTOL


def test_decode_plain_softcap_sinks_match_fused_pallas():
    """A softcap beside sinks and a window (decode_fused_pallas takes all
    three): the sink logit enters the softmax uncapped."""
    rng = _rng(90)
    L, B, Hq, Hkv, D, T = 2, 3, 16, 2, 64, 256
    q = (2.0 * rng.normal(size=(B, Hq, D))).astype(np.float32)
    k = rng.normal(size=(L, B, Hkv, T, D)).astype(np.float32)
    v = rng.normal(size=(L, B, Hkv, T, D)).astype(np.float32)
    snk = rng.normal(scale=2.0, size=(Hq,)).astype(np.float32)
    kv_len = np.array([1, 129, 256], np.int32)

    def fused(c):
        return jnp.asarray(c.transpose(0, 1, 3, 2, 4).reshape(L, B, T, Hkv * D))
    want = jda.decode_fused_pallas(
        jnp.asarray(q), fused(k), fused(v), jnp.asarray(kv_len),
        layer_index=jnp.int32(1), window=100, softcap=3.0,
        sinks=jnp.asarray(snk), interpret=True)
    got = decode_attention.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(kv_len), 1, window=100,
        sinks=torch.from_numpy(snk), softcap=3.0)
    assert _rel(got.numpy(), want) < KERNEL_RTOL
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jops.attention_decode_fused_ref(
            jnp.asarray(q), fused(k)[1], fused(v)[1], jnp.asarray(kv_len),
            window=100, softcap=3.0, sinks=jnp.asarray(snk))),
        rtol=1e-5, atol=1e-5)
    for bad in (dict(softcap=0.0), dict(softcap=-1.0), dict(window=0)):
        with pytest.raises(ValueError):
            decode_attention.decode_attention(
                torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                torch.from_numpy(kv_len), 1, **bad)


def test_cpu_wrappers_never_launch():
    kernels.reset_launch_counts()
    x = torch.randn(3, 128)
    qt = quantize(torch.randn(128, 16), QuantType.INT4)
    qmm.qmm_int4(x, qt)
    stack = QTensor(data=qt.data[None].expand(2, -1, -1),
                    scales=qt.scales[None].expand(2, -1, -1),
                    zero_points=None, bits=4, group_size=64, shape=qt.shape)
    qmm.qmm_int4_grouped(x[:2, None], stack, torch.tensor([1, 0]))
    q8 = quantize(torch.randn(128, 16), QuantType.INT8, symmetric=False)
    qmm.qmm_int8(x, q8)
    qmm.qmm_int8_grouped(x[:2, None], QTensor(
        data=q8.data[None].expand(2, -1, -1),
        scales=q8.scales[None].expand(2, -1, -1),
        zero_points=q8.zero_points[None].expand(2, -1, -1), bits=8,
        group_size=64, shape=q8.shape), torch.tensor([1, 0]))
    kc = torch.zeros((1, 2, 2, 4, 32), dtype=torch.uint8)
    new = torch.randn(3, 2, 32)
    cache_write.kv_encode_write(new, new, kc, kc.clone(), None, None,
                                torch.tensor([0, 9, -1]), 0, 4)
    q256 = quantize(torch.randn(256, 16), QuantType.INT4, group_size=256)
    qmm.qmm_int4_a8(torch.randn(9, 256), q256)
    qmm.a8_quantize_rows(torch.randn(9, 256))
    assert kernels.launch_counts() == {"qmm_int4": 0, "qmm_int4_grouped": 0,
                                       "qmm_int8": 0, "qmm_int8_grouped": 0,
                                       "a8_quantize_rows": 0,
                                       "qmm_int4_a8": 0,
                                       "flash_prefill": 0,
                                       "cache_write_fresh": 0,
                                       "kv_encode_write": 0,
                                       "decode_attention": 0,
                                       "paged_attention": 0}


# -- plain ops against turboinfer_tpu/kernels/ops.py --------------------------

def test_rms_norm_glu_softcap_match_jax():
    rng = _rng(50)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        ops.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jops.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        rtol=1e-5, atol=1e-6)
    g, u = x[..., :32], x[..., 32:]
    for act in ("silu", "gelu"):
        np.testing.assert_allclose(
            ops.glu(torch.from_numpy(g), torch.from_numpy(u), act).numpy(),
            np.asarray(jops.glu(jnp.asarray(g), jnp.asarray(u), act)),
            rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        ops.apply_softcap(torch.from_numpy(x), 5.0).numpy(),
        np.asarray(jops.apply_softcap(jnp.asarray(x), 5.0)), rtol=1e-5,
        atol=1e-6)


@pytest.mark.parametrize("mode,jmode", [(RopeMode.HALF, JRopeMode.HALF),
                                        (RopeMode.INTERLEAVED,
                                         JRopeMode.INTERLEAVED)])
@pytest.mark.parametrize("scaling", [(), (("rope_type", "linear"),
                                          ("factor", 2.0)),
                                     (("rope_type", "llama3"), ("factor", 8.0),
                                      ("original_max_position_embeddings", 64)),
                                     (("factor", 4.0),
                                      ("original_max_position_embeddings", 16),
                                      ("rope_type", "yarn"), ("truncate", False)),
                                     (("beta_fast", 16.0), ("factor", 32.0),
                                      ("original_max_position_embeddings", 64),
                                      ("rope_type", "yarn"))])
def test_apply_rope_matches_jax(mode, jmode, scaling):
    rng = _rng(51)
    x = rng.normal(size=(2, 6, 3, 32)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4, 5], [7, 8, 9, 10, 11, 300]], np.int32)
    want = jops.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, jmode,
                           scaling=scaling)
    got = ops.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0,
                         mode, scaling)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_embed_lookup_matches_jax():
    rng = _rng(52)
    table = rng.normal(size=(40, 16)).astype(np.float32)
    toks = np.array([[0, 3, 39], [5, 5, 1]], np.int32)
    np.testing.assert_array_equal(
        ops.embed_lookup(torch.from_numpy(table), torch.from_numpy(toks),
                         torch.float32).numpy(),
        np.asarray(jops.embed_lookup(jnp.asarray(table), jnp.asarray(toks),
                                     jnp.float32)))
    je = j_quantize_embed(jnp.asarray(table))
    te = quantize_embed(torch.from_numpy(table))
    np.testing.assert_array_equal(
        ops.embed_lookup(te, torch.from_numpy(toks), torch.float32).numpy(),
        np.asarray(jops.embed_lookup(je, jnp.asarray(toks), jnp.float32)))


def test_attention_refs_match_jax():
    rng = _rng(53)
    B, S, Hq, Hkv, D, T = 2, 5, 4, 2, 16, 12
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, T, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, T, D)).astype(np.float32)
    pos = np.array([[3, 4, 5, 6, 7], [0, 1, 2, 3, 4]], np.int32)
    kv_len = np.array([8, 4], np.int32)
    np.testing.assert_allclose(
        ops.attention_prefill_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v),
                                  positions=torch.from_numpy(pos),
                                  kv_len=torch.from_numpy(kv_len)).numpy(),
        np.asarray(jops.attention_prefill_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            positions=jnp.asarray(pos), kv_len=jnp.asarray(kv_len))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        ops.attention_decode_ref(torch.from_numpy(q[:, 0]),
                                 torch.from_numpy(k), torch.from_numpy(v),
                                 torch.from_numpy(kv_len)).numpy(),
        np.asarray(jops.attention_decode_ref(
            jnp.asarray(q[:, 0]), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(kv_len))), rtol=1e-5, atol=1e-5)
