"""int8 and zero-point (asymmetric) weights: the port's qmm wrappers
against the JAX package's Pallas qmm kernels in interpret mode.

On the CPU each wrapper runs its plain version (qmatmul_plain,
qmatmul_grouped_plain); here it is held against qmatmul_pallas,
qmatmul_pallas_stacked and qmatmul_pallas_grouped (the _kernel_int8*
bodies and the asym branches of the int4 ones) on the same seeded numpy
weights, quantized by the JAX package and bridged byte for byte. The
int4 cases run at the M and group sizes that make JAX pick each of its
_fact_mode bodies (masked, wide, folded, and the plain per-weight
dequant), so the zero-point algebra of each is covered.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from turboinfer_tpu.config import QuantType as JQuantType
from turboinfer_tpu.core.qtensor import QTensor as JQTensor
from turboinfer_tpu.core.qtensor import quantize as j_quantize
from turboinfer_tpu.kernels import ops as jops
from turboinfer_tpu.kernels.pallas import qmm as jqmm
from turboinfer_tpu_torch import bridge, kernels
from turboinfer_tpu_torch.kernels import dispatch, qmm

torch.set_num_threads(2)

KERNEL_RTOL = 2e-2      # bf16 operands on the TPU matrix unit, as there

# (bits, symmetric) of each weight kind
KINDS = {"int8": (8, True), "int8_asym": (8, False), "int4_asym": (4, False)}
_JTYPE = {8: JQuantType.INT8, 4: JQuantType.INT4}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-9)


def _weights(seed, L, K, N):
    """Offset, skewed weights, so asymmetric zero points are far from 0
    and int8 codes reach -128."""
    rng = np.random.default_rng(seed)
    return (rng.gamma(2.0, size=(L, K, N)) - 0.5).astype(np.float32)


def _stack(ws, kind, g):
    """JAX-quantized [L, K, N] stack and its bridged port QTensor."""
    bits, sym = KINDS[kind]
    jqts = [j_quantize(jnp.asarray(w), _JTYPE[bits], group_size=g,
                       symmetric=sym) for w in ws]

    def stack(name):
        if getattr(jqts[0], name) is None:
            return None
        return np.stack([np.asarray(getattr(q, name)) for q in jqts])
    K, N = ws.shape[1:]
    arrays = {k: stack(k) for k in ("data", "scales", "zero_points")}
    jqt = JQTensor(**{k: None if v is None else jnp.asarray(v)
                      for k, v in arrays.items()},
                   bits=bits, group_size=g, shape=(K, N))
    tqt = bridge.params_from_numpy(dict(arrays, bits=bits, group_size=g,
                                        shape=(K, N)), device="cpu")
    assert (tqt.zero_points is None) == sym
    return jqt, tqt


def _two_d(qt, cls):
    """Layer 0 of a stack as a 2-D QTensor (JAX or port)."""
    return cls(data=qt.data[0], scales=qt.scales[0],
               zero_points=None if qt.zero_points is None
               else qt.zero_points[0], bits=qt.bits,
               group_size=qt.group_size, shape=qt.shape)


# (kind, M, group size, the int4 _fact_mode JAX picks, prefill-kernel env)
CASES = [("int8", 1, 64, None, None), ("int8", 8, 64, None, None),
         ("int8", 24, 64, None, None), ("int8", 8, 512, None, None),
         ("int8_asym", 1, 64, None, None), ("int8_asym", 24, 64, None, None),
         ("int4_asym", 8, 64, "masked", None),
         ("int4_asym", 1, 256, "wide", None),
         ("int4_asym", 24, 64, None, None),
         ("int4_asym", 24, 64, "folded", "folded")]


def _case_id(c):
    return f"{c[0]}-M{c[1]}-g{c[2]}-{c[3] or 'plain'}"


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_qmm_plain_matches_pallas_2d_and_stacked(case, monkeypatch):
    kind, M, g, mode, env = case
    K, N = 512, 256
    if env:
        monkeypatch.setenv("TURBOINFER_QMM_PREFILL_KERNEL", env)
        jax.clear_caches()              # the env is read at trace time
    bits = KINDS[kind][0]
    assert jqmm._fact_mode(bits, g, M, K) == mode
    jqt, tqt = _stack(_weights(M + g, 2, K, N), kind, g)
    x = np.random.default_rng(M).normal(size=(M, K)).astype(np.float32)
    wrapper = qmm.qmm_int8 if bits == 8 else qmm.qmm_int4
    for li in (0, 1):
        want = jqmm.qmatmul_pallas_stacked(jnp.asarray(x), jqt, li,
                                           interpret=True)
        got = wrapper(torch.from_numpy(x), tqt, li)
        assert got.shape == (M, N) and got.dtype == torch.float32
        assert _rel(got.numpy(), want) < KERNEL_RTOL
    j2, t2 = _two_d(jqt, JQTensor), _two_d(tqt, type(tqt))
    want = jqmm.qmatmul_pallas(jnp.asarray(x), j2, interpret=True)
    got = dispatch.qmatmul(torch.from_numpy(x), t2)
    assert _rel(got.numpy(), want) < KERNEL_RTOL
    # and the JAX jnp golden form (same f32 arithmetic)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jops.qmatmul_ref(jnp.asarray(x), j2)),
        rtol=1e-5, atol=1e-4)
    if env:
        jax.clear_caches()


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("slots", [[4, 0, 2], [3, 3, 1]])
def test_qmm_grouped_plain_matches_pallas(kind, slots):
    """qmatmul_grouped_plain (what the grouped wrappers run on the CPU)
    against qmatmul_pallas_grouped in interpret mode: G=3 slots of a
    5-plane stack, different activations per group, a repeated slot."""
    L, K, N, G = 5, 512, 384, 3
    jqt, tqt = _stack(_weights(sum(slots), L, K, N), kind, 64)
    xg = np.random.default_rng(7).normal(size=(G, 1, K)).astype(np.float32)
    s = np.asarray(slots, np.int32)
    want = jqmm.qmatmul_pallas_grouped(jnp.asarray(xg), jqt, jnp.asarray(s),
                                       interpret=True)
    got = dispatch.qmatmul_grouped(torch.from_numpy(xg), tqt,
                                   torch.from_numpy(s))
    assert got.shape == (G, 1, N) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < KERNEL_RTOL
    for g, sl in enumerate(slots):         # each group on its own plane
        np.testing.assert_allclose(
            got[g].numpy(), qmm.qmatmul_plain(torch.from_numpy(xg[g]), tqt,
                                              sl).numpy(), rtol=1e-5,
            atol=1e-4)


def test_dispatch_routes_by_bits():
    """int8 weights reach qmm_int8 and qmm_int8_grouped, int4 (with zero
    points too) qmm_int4 and qmm_int4_grouped; the CPU wrappers run the
    plain versions and count no launch."""
    calls = []
    names = ("qmm_int4", "qmm_int8", "qmm_int4_grouped", "qmm_int8_grouped")
    saved = {n: getattr(qmm, n) for n in names}

    def spy(n):
        def f(*a):
            calls.append(n)
            return saved[n](*a)
        return f
    x = torch.randn(2, 512)
    kernels.reset_launch_counts()
    try:
        for n in names:
            setattr(qmm, n, spy(n))
        for kind in KINDS:
            _, tqt = _stack(_weights(3, 2, 512, 64), kind, 64)
            dispatch.qmatmul(x, tqt, 1)
            dispatch.qmatmul_grouped(x[:, None], tqt, torch.tensor([1, 0]))
    finally:
        for n, f in saved.items():
            setattr(qmm, n, f)
    assert calls == ["qmm_int8", "qmm_int8_grouped"] * 2 + [
        "qmm_int4", "qmm_int4_grouped"]
    assert all(v == 0 for v in kernels.launch_counts().values())
