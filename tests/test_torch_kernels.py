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


@pytest.mark.parametrize("D", [64, 128])
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


def test_cpu_wrappers_never_launch():
    kernels.reset_launch_counts()
    x = torch.randn(3, 128)
    qt = quantize(torch.randn(128, 16), QuantType.INT4)
    qmm.qmm_int4(x, qt)
    assert kernels.launch_counts() == {"qmm_int4": 0, "flash_prefill": 0,
                                       "cache_write_fresh": 0,
                                       "decode_attention": 0}


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
                                      ("original_max_position_embeddings", 64))])
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
