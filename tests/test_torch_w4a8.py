"""W4A8 (TURBOINFER_QMM_A8=1): the port against the JAX package.

With the env set, the JAX package runs some int4 products with per-row
int8 activations (_kernel_int4_a8[_idx] in turboinfer_tpu/kernels/
pallas/qmm.py), which changes their numbers. The port's
kernels/qmm.a8_applies takes the same decision and its dispatch sends
those products to qmm_int4_a8, whose plain version runs here on the CPU.
Held here: the decision over a grid of shapes, the activation codes and
scales bit for bit against the jitted JAX quantizer, the product against
the Pallas W4A8 body in interpret mode, and a two-layer model's logits
and greedy tokens against a JAX side whose dispatch sends what a TPU
runs as W4A8 to the Pallas entry points (interpret mode).
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import turboinfer_tpu as ti
from turboinfer_tpu.config import InferenceConfig as JInferenceConfig
from turboinfer_tpu.config import QuantizationConfig as JQuantCfg
from turboinfer_tpu.config import QuantType as JQuantType
from turboinfer_tpu.core.qtensor import QEmbed as JQEmbed
from turboinfer_tpu.core.qtensor import QTensor as JQTensor
from turboinfer_tpu.core.qtensor import quantize as j_quantize
from turboinfer_tpu.kernels import dispatch as jdispatch
from turboinfer_tpu.kernels import ops as jops
from turboinfer_tpu.kernels.pallas import qmm as jqmm
from turboinfer_tpu.models import llama as jllama
from turboinfer_tpu.models.common import fuse_projections as j_fuse
from turboinfer_tpu.quant.quantizer import quantize_params as j_quantize_params
from turboinfer_tpu_torch import bridge
from turboinfer_tpu_torch import config as tconfig
from turboinfer_tpu_torch.config import InferenceConfig
from turboinfer_tpu_torch.core.qtensor import QTensor
from turboinfer_tpu_torch.engine.engine import InferenceEngine
from turboinfer_tpu_torch.kernels import dispatch, qmm
from turboinfer_tpu_torch.kernels.dispatch import prepare_params
from turboinfer_tpu_torch.models import llama as tllama

torch.set_num_threads(2)

PRODUCT_RTOL = 1e-5     # of max|out|: the same f32 arithmetic, summed apart
LOGIT_RTOL = 1e-3       # of max|logit|: two layers of such products


def jax_to_numpy(tree):
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


def _jax_a8_decision(bits, sym, M, K, N, g, plane_bytes):
    """The JAX package's own W4A8 decision (dispatch.qmatmul, then
    _qmm_2d/_qmm_stacked) on a TPU with TURBOINFER_QMM_A8=1."""
    if plane_bytes < jdispatch._QMM_MIN_BYTES:
        return False
    if jqmm._pick_tiles(M, K, N, bits, g) is None:
        return False
    mode = jqmm._fact_mode(bits, g, M, K, a8=sym)
    return bits == 4 and sym and M > 8 and mode == "wide"


def _meta_qt(bits, sym, K, N, g, lead):
    """A port QTensor of the right shapes and no storage."""
    kd = 2 if bits == 4 else 1
    data = torch.empty(lead + (K // kd, N), dtype=torch.uint8, device="meta")
    scales = torch.empty(lead + (K // g, N), dtype=torch.bfloat16,
                         device="meta")
    return QTensor(data=data, scales=scales,
                   zero_points=None if sym else scales, bits=bits,
                   group_size=g, shape=(K, N))


def test_a8_applies_is_the_jax_decision(monkeypatch):
    """Over bits, symmetry, M, g, N, K (plane bytes on both sides of
    262144, 2-D and stacked weights): a8_applies equals the JAX decision
    with the env set, and is False everywhere without it."""
    monkeypatch.setenv("TURBOINFER_QMM_A8", "1")
    seen = set()
    for bits, sym, M, g, N, K, stacked in itertools.product(
            (4, 8), (True, False), (1, 8, 9, 16, 40), (64, 128, 256, 512),
            (256, 2880, 5120), (512, 2048), (False, True)):
        qt = _meta_qt(bits, sym, K, N, g, (3,) if stacked else ())
        plane = qt.data.numel() // (3 if stacked else 1)
        want = _jax_a8_decision(bits, sym, M, K, N, g, plane)
        got = qmm.a8_applies(M, qt, 1 if stacked else None)
        assert got == want, (bits, sym, M, g, N, K, stacked)
        seen.add((want, plane >= 262144))
    assert seen == {(True, True), (False, True), (False, False)}
    qt = _meta_qt(4, True, 2048, 5120, 256, ())
    assert qmm.a8_applies(16, qt)
    monkeypatch.setenv("TURBOINFER_QMM_MIN_BYTES", str(1 << 23))
    assert not qmm.a8_applies(16, qt)            # read at each call
    monkeypatch.delenv("TURBOINFER_QMM_MIN_BYTES")
    monkeypatch.setenv("TURBOINFER_QMM_NO_FACT", "1")
    assert not qmm.a8_applies(16, qt)
    monkeypatch.delenv("TURBOINFER_QMM_NO_FACT")
    monkeypatch.delenv("TURBOINFER_QMM_A8")
    assert not qmm.a8_applies(16, qt)


def _rows(seed, M, K, dtype):
    """Seeded rows with a zero row and values on .5 ties after the
    division by the row scale (as the compiled scale computes it)."""
    x = (np.random.default_rng(seed).standard_normal((M, K)) * 3).astype(
        np.float32)
    x[2] = 0.0
    sx = np.abs(x).max(-1) * np.float32(1 / 127)
    x[:, 1] = ((np.arange(M) % 50) + 0.5).astype(np.float32) * sx
    x[:, 2] = -x[:, 1]
    if dtype == "bf16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_a8_quantize_rows_matches_jitted_jax_bits(dtype):
    """Codes and f32 row scales of a8_quantize_rows (the plain version on
    the CPU) bit for bit against the jitted _a8_quantize_rows, ties at
    .5 and an all-zero row included."""
    x = _rows(3, 257, 1024, dtype)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    jq, js = jax.jit(jqmm._a8_quantize_rows)(jnp.asarray(x, jdt))
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    tq, ts = qmm.a8_quantize_rows(torch.from_numpy(x.copy()).to(tdt))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    assert (np.abs(np.asarray(jq)) == 127).any() and not tq[2].any()


def _qt_pair(seed, L, K, N, g):
    """JAX-quantized int4 symmetric [L, K, N] stack and its bridge."""
    w = np.random.default_rng(seed).standard_normal((L, K, N)).astype(
        np.float32) * 0.1
    jqts = [j_quantize(jnp.asarray(wl), JQuantType.INT4, group_size=g,
                       symmetric=True) for wl in w]
    arrays = {k: np.stack([np.asarray(getattr(q, k)) for q in jqts])
              for k in ("data", "scales")}
    jqt = JQTensor(data=jnp.asarray(arrays["data"]),
                   scales=jnp.asarray(arrays["scales"]), zero_points=None,
                   bits=4, group_size=g, shape=(K, N))
    tqt = bridge.params_from_numpy(dict(arrays, zero_points=None, bits=4,
                                        group_size=g, shape=(K, N)),
                                   device="cpu")
    return jqt, tqt


@pytest.mark.parametrize("M", [9, 16, 24, 40, 64])
@pytest.mark.parametrize("stacked", [False, True], ids=["2d", "stacked"])
def test_qmatmul_a8_plain_matches_pallas_body(monkeypatch, M, stacked):
    """qmatmul_a8_plain (what dispatch.qmatmul runs on the CPU with the
    env set) against qmatmul_pallas / qmatmul_pallas_stacked in interpret
    mode (_kernel_int4_a8[_idx]) in f32, within PRODUCT_RTOL; apart from
    the bf16-activation product by more than that (the A8 body ran), and
    within 2e-2 of the int8-simulated product of the JAX package's own
    W4A8 test. M = 9 (the fewest rows that take W4A8), 16 (a B=16
    decode), 24, 40 (a verify) and 64 take the CUDA kernel's small token
    tiles of 16, 32, 48 and 64 rows."""
    monkeypatch.setenv("TURBOINFER_QMM_A8", "1")
    K, N, g, L = 1024, 512, 256, 2
    jqt, tqt = _qt_pair(M, L, K, N, g)
    x = (np.random.default_rng(M + 1).standard_normal((M, K)) * 0.5
         ).astype(np.float32)
    if stacked:
        want = jqmm.qmatmul_pallas_stacked(jnp.asarray(x), jqt, 1,
                                           interpret=True)
        li, jw = 1, JQTensor(data=jqt.data[1], scales=jqt.scales[1],
                             zero_points=None, bits=4, group_size=g,
                             shape=(K, N))
    else:
        jqt = JQTensor(data=jqt.data[0], scales=jqt.scales[0],
                       zero_points=None, bits=4, group_size=g, shape=(K, N))
        tqt = tqt.layer(0)
        want = jqmm.qmatmul_pallas(jnp.asarray(x), jqt, interpret=True)
        li, jw = None, jqt
    want = np.asarray(want)
    assert qmm.a8_applies(M, tqt, li)
    before = qmm.qmm_int4.launches
    got = dispatch.qmatmul(torch.from_numpy(x), tqt, li).numpy()
    ref = np.abs(want).max()
    assert np.abs(got - want).max() <= PRODUCT_RTOL * ref
    plain = qmm.qmatmul_plain(torch.from_numpy(x), tqt, li).numpy()
    assert np.abs(plain - want).max() > PRODUCT_RTOL * ref
    sx = np.maximum(np.abs(x).max(-1), 1e-8) / 127.0
    xq = np.clip(np.round(x / sx[:, None]), -127, 127)
    sim = (xq @ np.asarray(jops._dequant_ref(jw, jnp.float32))) * sx[:, None]
    assert np.abs(got - sim).max() <= 2e-2 * np.abs(sim).max()
    assert qmm.qmm_int4.launches == before      # CPU: no kernel counted


# hidden 512, D=128 (4 heads, 2 KV heads), intermediate 1024, 2 layers,
# vocab 1024, int4 g=256: per-layer planes wqkv 262144 bytes (fused),
# wo 131072 (under the JAX threshold: jnp, never W4A8), w_gateup 524288,
# w_down 262144, lm_head 262144
MODEL = dict(hidden_size=512, num_heads=4, num_kv_heads=2,
             intermediate_size=1024, num_layers=2, vocab_size=1024,
             max_seq_len=64)


def _tpu_qmatmul(x, qt, preferred_dtype=jnp.float32, layer_index=None):
    """The JAX package's dispatch.qmatmul with every product that a TPU
    runs as W4A8 sent to the Pallas entry points in interpret mode (its
    _kernel_int4_a8[_idx] body), and every other product to its jnp
    reference: the other Pallas int4 bodies round f32 activations to
    bf16 on the matrix unit (held against the port's plain qmm at 2e-2
    in test_torch_qmm.py), which would hide this file's f32 tolerance."""
    stacked = layer_index is not None and qt.data.ndim == 3
    plane = qt.data.size // (qt.data.shape[0] if stacked else 1)
    K, N = qt.shape
    M = x.size // x.shape[-1]
    if _jax_a8_decision(qt.bits, qt.zero_points is None, M, K, N,
                        qt.group_size, plane):
        if stacked:
            return jqmm.qmatmul_pallas_stacked(x, qt, layer_index,
                                               preferred_dtype,
                                               interpret=True)
        return jqmm.qmatmul_pallas(x, qt, preferred_dtype, interpret=True)
    return jdispatch._qmm_small(x, qt, preferred_dtype, layer_index, stacked)


@pytest.fixture(scope="module")
def a8_model():
    jcfg = ti.tiny_config(dtype=jnp.float32, **MODEL)
    tcfg = tconfig.tiny_config(dtype=torch.float32, **MODEL)
    jp = j_quantize_params(jllama.init_params(jax.random.PRNGKey(5), jcfg),
                           JQuantCfg(type=JQuantType.INT4, group_size=256))
    tp = bridge.params_from_numpy(jax_to_numpy(jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture
def tpu_dispatch(monkeypatch):
    """TURBOINFER_QMM_A8=1 and the JAX side's dispatch as on a TPU;
    compiled JAX functions traced before the patch are dropped."""
    monkeypatch.setenv("TURBOINFER_QMM_A8", "1")
    monkeypatch.setattr(jdispatch, "qmatmul", _tpu_qmatmul)
    jax.clear_caches()
    yield
    jax.clear_caches()


# A W4A8 product quantizes its input rows, so an f32 rounding difference
# upstream (the attention and norms sum in another order than XLA's) moves
# a code by one where x / sx sits on a .5 tie, and that batch row's later
# logits move with it (a 1% change was seen at this size). A row may miss
# LOGIT_RTOL only if one of its A8 inputs lay within TIE_DIST of a tie on
# the port's side, and at most MAX_TIE_ROWS rows a call may do so.
TIE_DIST = 2e-5
MAX_TIE_ROWS = 1


def _tie_rows(inputs, B):
    """Batch rows b with an A8 input element (rows [M, K] in b-major
    order, M a multiple of B) within TIE_DIST of a rounding tie."""
    rows = set()
    for x in inputs:
        xq, sx = qmm.a8_quantize_rows_plain(x)
        r = (x.to(torch.float32) / sx[:, None]).abs()
        near = ((r - r.floor() - 0.5).abs() < TIE_DIST).any(-1)
        rows |= {int(m) // (x.shape[0] // B) for m in near.nonzero()[:, 0]}
    return rows


def _close_but_ties(got, want, tie_rows):
    """Per batch row: within LOGIT_RTOL of max|logit|, or a tie row."""
    err = np.abs(got - want).reshape(got.shape[0], -1).max(-1)
    bad = {b for b in range(got.shape[0])
           if err[b] > LOGIT_RTOL * np.abs(want).max()}
    assert bad <= tie_rows and len(bad) <= MAX_TIE_ROWS, (bad, tie_rows, err)


@pytest.mark.parametrize("B", [2, 12])
def test_model_logits_match_jax_on_its_a8_routes(a8_model, tpu_dispatch, B):
    """The two-layer g=256 model, fused as the engines fuse it: prefill
    (M = B*S) and decode (M = B; W4A8 at B=12) logits within LOGIT_RTOL
    of max|logit| of the JAX package's, whose W4A8 products run the
    Pallas body, but in a tie row (see TIE_DIST); the port's W4A8
    products are counted."""
    jcfg, tcfg, jp, tp = a8_model
    jp, tp = j_fuse(jp), prepare_params(tp)
    inputs = []
    real = qmm.qmatmul_a8_plain

    def recording(x, qt, li=None):
        inputs.append(x.reshape(-1, x.shape[-1]).clone())
        return real(x, qt, li)
    qmm.qmatmul_a8_plain = recording
    try:
        rng = np.random.default_rng(B)
        S, T = 12, 32
        toks = rng.integers(1, jcfg.vocab_size, size=(B, S)).astype(np.int32)
        lens = np.full((B,), S, np.int32)
        lens[0] = 7
        jc = jllama.init_cache(jcfg, B, max_seq=T, fused=False)
        jl, jc = jllama.forward(jp, jcfg, jnp.asarray(toks), jc,
                                seq_lens=jnp.asarray(lens),
                                logit_idx=jnp.asarray(lens - 1),
                                fresh_prefill=True)
        tc = tllama.init_cache(tcfg, B, max_seq=T, device="cpu")
        tl, tc = tllama.forward(tp, tcfg, torch.from_numpy(toks), tc,
                                seq_lens=torch.from_numpy(lens),
                                logit_idx=torch.from_numpy(lens - 1),
                                fresh_prefill=True)
        jl = np.asarray(jl)
        # wqkv, w_gateup, w_down per layer at M = B*S; the head at M = B
        assert [x.shape[0] for x in inputs] == \
            [B * S] * 6 + ([B] if B > 8 else [])
        ties = _tie_rows(inputs, B)
        _close_but_ties(tl.numpy(), jl, ties)
        inputs.clear()
        nxt = jl[:, 0].argmax(-1).astype(np.int32)[:, None]
        jl, _ = jllama.forward(jp, jcfg, jnp.asarray(nxt), jc)
        tl, _ = tllama.forward(tp, tcfg, torch.from_numpy(nxt), tc)
        assert [x.shape[0] for x in inputs] == ([B] * 7 if B > 8 else [])
        _close_but_ties(tl.numpy(), np.asarray(jl),
                        ties | _tie_rows(inputs, B))
    finally:
        qmm.qmatmul_a8_plain = real


def test_greedy_generate_batch_matches_jax(a8_model, tpu_dispatch):
    """generate_batch at B=12 (W4A8 in the prefill, every decode step and
    the last-position head): greedy tokens identical to the JAX
    engine's."""
    jcfg, tcfg, jp, tp = a8_model
    je = ti.InferenceEngine(jp, jcfg, JInferenceConfig(max_seq_len=64))
    te = InferenceEngine(tp, tcfg, InferenceConfig(max_seq_len=64),
                         device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, jcfg.vocab_size, size=n).tolist()
               for n in (5, 9, 12, 3, 7, 11, 6, 8, 10, 4, 12, 2)]
    jres = je.generate_batch(prompts, 6, temperature=0.0)
    tres = te.generate_batch(prompts, 6, temperature=0.0)
    assert [r.tokens for r in tres] == [r.tokens for r in jres]


def test_env_unset_keeps_todays_numbers(a8_model, monkeypatch):
    """Without TURBOINFER_QMM_A8 no W4A8 path runs: dispatch.qmatmul is
    qmatmul_plain bit for bit at every M, and a forward never reaches
    the W4A8 functions."""
    monkeypatch.delenv("TURBOINFER_QMM_A8", raising=False)
    _, tcfg, _, tp = a8_model
    tp = prepare_params(tp)
    w = tp["layers"]["w_gateup"]
    for M in (1, 9, 40):
        x = torch.from_numpy(np.random.default_rng(M).standard_normal(
            (M, 512)).astype(np.float32))
        assert torch.equal(dispatch.qmatmul(x, w, 1),
                           qmm.qmatmul_plain(x, w, 1))

    def refuse(*a, **k):
        raise AssertionError("a W4A8 path ran without TURBOINFER_QMM_A8")
    monkeypatch.setattr(qmm, "qmatmul_a8_plain", refuse)
    monkeypatch.setattr(qmm, "qmm_int4_a8", refuse)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, 1024, size=(12, 10)).astype(np.int32))
    cache = tllama.init_cache(tcfg, 12, max_seq=32, device="cpu")
    logits, cache = tllama.forward(tp, tcfg, toks, cache, fresh_prefill=True)
    tllama.forward(tp, tcfg, logits[:, -1].argmax(-1)[:, None].to(
        torch.int32), cache)


def test_g256_weights_are_the_jax_bytes():
    """int4 g=256, the weights W4A8 needs: quantize_params (the JAX
    quantizer's bytes and bf16 scales, bit for bit) and the synthetic
    loader's QTensors (their bytes, read by the JAX package's dequant,
    give the port's dequantized weight)."""
    from turboinfer_tpu_torch.config import QuantizationConfig, QuantType
    from turboinfer_tpu_torch.core.qtensor import dequantize
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    from turboinfer_tpu_torch.quant.quantizer import quantize_params
    rng = np.random.default_rng(21)
    tree = {"wq": rng.normal(size=(2, 512, 256)).astype(np.float32),
            "w_down": rng.normal(size=(2, 1024, 512)).astype(np.float32)}
    head = rng.normal(size=(512, 384)).astype(np.float32)
    jout = j_quantize_params(
        {"layers": {k: jnp.asarray(v) for k, v in tree.items()},
         "lm_head": jnp.asarray(head)},
        JQuantCfg(type=JQuantType.INT4, group_size=256))
    tout = quantize_params(
        {"layers": bridge.params_from_numpy(tree, device="cpu"),
         "lm_head": torch.from_numpy(head)},
        QuantizationConfig(type=QuantType.INT4, group_size=256))
    for t, j in [(tout["layers"][k], jout["layers"][k]) for k in tree] + [
            (tout["lm_head"], jout["lm_head"])]:
        assert (t.bits, t.group_size, t.zero_points) == (4, 256, None)
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
        np.testing.assert_array_equal(
            t.scales.view(torch.int16).numpy(),
            np.asarray(j.scales).view(np.int16))
    cfg = tconfig.tiny_config(dtype=torch.float32, **MODEL)
    qt = create_synthetic_quantized_model(cfg, bits=4, group_size=256,
                                          device="cpu").params["lm_head"]
    jqt = JQTensor(**{k: v if k in ("bits", "group_size", "shape", "zero_points")
                      else jnp.asarray(v)
                      for k, v in jax_to_numpy_qt(qt).items()})
    np.testing.assert_array_equal(
        dequantize(qt, torch.float32).numpy(),
        np.asarray(jops._dequant_ref(jqt, jnp.float32)))


def jax_to_numpy_qt(qt):
    """A port QTensor as the numpy dict the JAX QTensor takes (bf16 as
    ml_dtypes bfloat16, bit for bit)."""
    import ml_dtypes
    return {"data": qt.data.numpy(),
            "scales": qt.scales.view(torch.int16).numpy().view(
                ml_dtypes.bfloat16),
            "zero_points": None, "bits": qt.bits,
            "group_size": qt.group_size, "shape": tuple(qt.shape)}
