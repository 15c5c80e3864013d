"""The port's quantized formats against turboinfer_tpu's, byte for byte.

Same f32 inputs (seeded numpy) go through core/qtensor.py of both
packages; packed bytes, scales and quantized tables must be identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from turboinfer_tpu.config import QuantizationConfig as JQuantCfg
from turboinfer_tpu.config import QuantType as JQuantType
from turboinfer_tpu.core import qtensor as jq
from turboinfer_tpu.quant.quantizer import quantize_params as j_quantize_params
from turboinfer_tpu_torch import bridge
from turboinfer_tpu_torch.config import QuantizationConfig, QuantType
from turboinfer_tpu_torch.core import qtensor as tq
from turboinfer_tpu_torch.quant.quantizer import quantize_params

torch.set_num_threads(2)


def _np(a):
    return bridge.to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)


def _bf16_bits(a):
    """Raw bf16 bits of a JAX or torch bf16 array, for exact comparison."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


@pytest.mark.parametrize("K,N,g", [(128, 24, 64), (256, 8, 32), (64, 5, 64)])
def test_pack_int4_byte_identical(K, N, g):
    q = np.random.default_rng(K + N).integers(-8, 8, size=(K, N), dtype=np.int8)
    want = np.asarray(jq.pack_int4(jnp.asarray(q), g))
    got = tq.pack_int4(torch.from_numpy(q), g)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tq.unpack_int4(got, g).numpy(), q)


@pytest.mark.parametrize("qtype,jtype", [(QuantType.INT4, JQuantType.INT4),
                                         (QuantType.INT8, JQuantType.INT8)])
@pytest.mark.parametrize("g", [32, 64])
def test_quantize_byte_identical(qtype, jtype, g):
    w = np.random.default_rng(g).normal(size=(256, 40)).astype(np.float32)
    w[:64, 3] = 0.0                        # an all-zero group: scale 1.0
    jqt = jq.quantize(jnp.asarray(w), jtype, group_size=g)
    tqt = tq.quantize(torch.from_numpy(w), qtype, group_size=g)
    assert (tqt.bits, tqt.group_size, tqt.shape) == \
        (jqt.bits, jqt.group_size, jqt.shape)
    np.testing.assert_array_equal(tqt.data.numpy(), np.asarray(jqt.data))
    np.testing.assert_array_equal(_bf16_bits(tqt.scales),
                                  _bf16_bits(jqt.scales))
    np.testing.assert_array_equal(
        tq.dequantize(tqt).numpy(), np.asarray(jq.dequantize(jqt)))


def test_quantize_embed_identical():
    w = np.random.default_rng(7).normal(size=(50, 32)).astype(np.float32)
    je = jq.quantize_embed(jnp.asarray(w))
    te = tq.quantize_embed(torch.from_numpy(w))
    np.testing.assert_array_equal(te.data.numpy(), np.asarray(je.data))
    np.testing.assert_array_equal(te.scales.numpy(), np.asarray(je.scales))
    np.testing.assert_array_equal(tq.dequantize_embed(te).numpy(),
                                  np.asarray(jq.dequantize_embed(je)))


def test_concat_n_matches_jax():
    rng = np.random.default_rng(3)
    ws = [rng.normal(size=(128, n)).astype(np.float32) for n in (16, 8, 8)]
    jcat = jq.concat_n([jq.quantize(jnp.asarray(w), JQuantType.INT4)
                        for w in ws])
    tcat = tq.concat_n([tq.quantize(torch.from_numpy(w), QuantType.INT4)
                        for w in ws])
    assert tcat.shape == jcat.shape
    np.testing.assert_array_equal(tcat.data.numpy(), np.asarray(jcat.data))


def test_quantize_rejects_bad_groups():
    with pytest.raises(ValueError):
        tq.quantize(torch.zeros(96, 4), QuantType.INT4, group_size=64)
    with pytest.raises(ValueError):
        tq.pack_int4(torch.zeros(10, 2, dtype=torch.int8), 4)


@pytest.mark.parametrize("qtype,jtype", [(QuantType.INT4, JQuantType.INT4),
                                         (QuantType.INT8, JQuantType.INT8)])
def test_quantize_params_identical(qtype, jtype):
    """quantize_params on the same fp tree: every stacked weight, the
    int4 lm_head and the per-row int8 embedding are identical."""
    rng = np.random.default_rng(11)
    L, H, F, V = 2, 64, 128, 96
    tree = {"embed": rng.normal(size=(V, H)).astype(np.float32),
            "layers": {n: rng.normal(size=s).astype(np.float32) for n, s in (
                ("wq", (L, H, H)), ("wk", (L, H, H)), ("wv", (L, H, H)),
                ("wo", (L, H, H)), ("w_gate", (L, H, F)),
                ("w_up", (L, H, F)), ("w_down", (L, F, H)))},
            "final_norm": np.ones((H,), np.float32),
            "lm_head": rng.normal(size=(H, V)).astype(np.float32)}
    tree["layers"]["attn_norm"] = np.ones((L, H), np.float32)
    jtree = {"embed": jnp.asarray(tree["embed"]),
             "layers": {k: jnp.asarray(v) for k, v in tree["layers"].items()},
             "final_norm": jnp.asarray(tree["final_norm"]),
             "lm_head": jnp.asarray(tree["lm_head"])}
    jout = j_quantize_params(jtree, JQuantCfg(type=jtype, group_size=64))
    tout = quantize_params(bridge.params_from_numpy(tree, device="cpu"),
                           QuantizationConfig(type=qtype, group_size=64))
    for name in ("wq", "wo", "w_gate", "w_down"):
        np.testing.assert_array_equal(tout["layers"][name].data.numpy(),
                                      np.asarray(jout["layers"][name].data))
        np.testing.assert_array_equal(
            _bf16_bits(tout["layers"][name].scales),
            _bf16_bits(jout["layers"][name].scales))
    np.testing.assert_array_equal(tout["lm_head"].data.numpy(),
                                  np.asarray(jout["lm_head"].data))
    np.testing.assert_array_equal(tout["embed"].data.numpy(),
                                  np.asarray(jout["embed"].data))
    np.testing.assert_array_equal(tout["layers"]["attn_norm"].numpy(),
                                  tree["layers"]["attn_norm"])


def test_bridge_round_trip_bf16_and_qtensor():
    w = np.random.default_rng(5).normal(size=(128, 16)).astype(np.float32)
    jqt = jq.quantize(jnp.asarray(w), JQuantType.INT4)
    tree = {"w": {"data": np.asarray(jqt.data), "scales": np.asarray(jqt.scales),
                  "zero_points": None, "bits": 4, "group_size": 64,
                  "shape": (128, 16)},
            "n": np.asarray(jnp.asarray(w[:4], jnp.bfloat16))}
    got = bridge.params_from_numpy(tree, device="cpu")
    assert isinstance(got["w"], tq.QTensor) and got["n"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_bits(got["w"].scales),
                                  _bf16_bits(jqt.scales))
    back = bridge.to_numpy(got)
    np.testing.assert_array_equal(back["w"]["data"], tree["w"]["data"])
    np.testing.assert_array_equal(back["n"],
                                  np.asarray(tree["n"], np.float32))


# -- asymmetric (zero points) and mse scales ---------------------------------

# Share of scale groups whose mse shrink factor may differ from JAX's: an
# f32 error sum in another order can flip a near-tie between two factors
# (none flipped on these inputs when written).
MSE_TIE_SHARE = 0.01


def _skewed(seed, K, N):
    """Offset, heavy-tailed weights with an all-zero and a constant group,
    so zero points spread and int8 codes reach -128."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_t(3, size=(K, N)) + 0.7).astype(np.float32)
    w[:64, 3] = 0.0
    w[64:128, 5] = 1.5
    return w


@pytest.mark.parametrize("qtype,jtype", [(QuantType.INT4, JQuantType.INT4),
                                         (QuantType.INT8, JQuantType.INT8)])
@pytest.mark.parametrize("g", [32, 64, 0])
def test_quantize_asymmetric_byte_identical(qtype, jtype, g):
    w = _skewed(g + 1, 256, 40)
    jqt = jq.quantize(jnp.asarray(w), jtype, group_size=g, symmetric=False)
    tqt = tq.quantize(torch.from_numpy(w), qtype, group_size=g,
                      symmetric=False)
    assert tqt.zero_points is not None and tqt.zero_points.dtype == \
        torch.bfloat16 and tqt.zero_points.shape == tqt.scales.shape
    assert (tqt.bits, tqt.group_size, tqt.shape) == \
        (jqt.bits, jqt.group_size, jqt.shape)
    np.testing.assert_array_equal(tqt.data.numpy(), np.asarray(jqt.data))
    for a, b in ((tqt.scales, jqt.scales), (tqt.zero_points, jqt.zero_points)):
        np.testing.assert_array_equal(_bf16_bits(a), _bf16_bits(b))
    if qtype == QuantType.INT8:                 # the full code range
        assert int(tqt.data.min()) == -128 and int(tqt.data.max()) == 127
    np.testing.assert_array_equal(
        tq.dequantize(tqt).numpy(), np.asarray(jq.dequantize(jqt)))


@pytest.mark.parametrize("qtype,jtype", [(QuantType.INT4, JQuantType.INT4),
                                         (QuantType.INT8, JQuantType.INT8)])
@pytest.mark.parametrize("g", [32, 64, 0])
def test_quantize_mse_scales_match_jax(qtype, jtype, g):
    w = _skewed(g + 2, 256, 40)
    jqt = jq.quantize(jnp.asarray(w), jtype, group_size=g, scale_method="mse")
    tqt = tq.quantize(torch.from_numpy(w), qtype, group_size=g,
                      scale_method="mse")
    assert tqt.zero_points is None
    differ = _bf16_bits(tqt.scales) != _bf16_bits(jqt.scales)
    assert differ.mean() <= MSE_TIE_SHARE
    # groups whose scale agrees hold the same codes
    gk = tqt.group_size if qtype == QuantType.INT8 else tqt.group_size // 2
    same_rows = np.repeat(~differ, gk, axis=0)
    np.testing.assert_array_equal(tqt.data.numpy()[same_rows],
                                  np.asarray(jqt.data)[same_rows])
    # at 15 levels the search shrinks some heavy-tailed groups below
    # absmax (int8's 255 levels rarely gain from clipping)
    if qtype == QuantType.INT4:
        absmax = tq.quantize(torch.from_numpy(w), qtype, group_size=g)
        assert (tqt.scales.float() < absmax.scales.float()).any()


def test_linspace_matches_jax_bits():
    np.testing.assert_array_equal(
        tq._linspace_f32(1.0, 0.30, 16).numpy().view(np.int32),
        np.asarray(jnp.linspace(1.0, 0.30, 16)).view(np.int32))


def test_quantize_refuses_what_jax_refuses():
    w = torch.randn(128, 8)
    with pytest.raises(ValueError):             # mse needs symmetric
        tq.quantize(w, QuantType.INT8, symmetric=False, scale_method="mse")
    with pytest.raises(ValueError):
        jq.quantize(jnp.asarray(w.numpy()), JQuantType.INT8, symmetric=False,
                    scale_method="mse")
    with pytest.raises(ValueError):
        tq.quantize(w, QuantType.INT8, scale_method="hessian")


def _llama_tree(rng, L=2, H=64, F=128, V=96):
    tree = {"embed": rng.normal(size=(V, H)).astype(np.float32),
            "layers": {n: (rng.normal(size=s) + 0.4).astype(np.float32)
                       for n, s in (
                ("wq", (L, H, H)), ("wk", (L, H, H)), ("wv", (L, H, H)),
                ("wo", (L, H, H)), ("w_gate", (L, H, F)),
                ("w_up", (L, H, F)), ("w_down", (L, F, H)))},
            "final_norm": np.ones((H,), np.float32),
            "lm_head": rng.normal(size=(H, V)).astype(np.float32)}
    tree["layers"]["attn_norm"] = np.ones((L, H), np.float32)
    return tree


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _assert_qtensors_identical(got, want):
    assert got.data.shape == want.data.shape
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(_bf16_bits(got.scales),
                                  _bf16_bits(want.scales))
    assert (got.zero_points is None) == (want.zero_points is None)
    if got.zero_points is not None:
        assert got.zero_points.shape == got.scales.shape
        np.testing.assert_array_equal(_bf16_bits(got.zero_points),
                                      _bf16_bits(want.zero_points))


@pytest.mark.parametrize("qtype,jtype", [(QuantType.INT4, JQuantType.INT4),
                                         (QuantType.INT8, JQuantType.INT8)])
def test_quantize_params_asymmetric_identical_and_bridged(qtype, jtype):
    """quantize_params with zero points: every stacked weight and the head
    keep them, byte-identical to JAX's; through the numpy bridge both
    ways they stay; fusion (prepare_params) concatenates them with the
    data."""
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    tree = _llama_tree(np.random.default_rng(12))
    jout = j_quantize_params(_to_jax(tree), JQuantCfg(
        type=jtype, group_size=64, symmetric=False))
    tout = quantize_params(bridge.params_from_numpy(tree, device="cpu"),
                           QuantizationConfig(type=qtype, group_size=64,
                                              symmetric=False))
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        _assert_qtensors_identical(tout["layers"][name], jout["layers"][name])
    _assert_qtensors_identical(tout["lm_head"], jout["lm_head"])
    # JAX's tree through the bridge, and the port's back out
    def jnp_tree(t):
        if isinstance(t, dict):
            return {k: jnp_tree(v) for k, v in t.items()}
        if isinstance(t, jq.QTensor):
            return {"data": np.asarray(t.data), "scales": np.asarray(t.scales),
                    "zero_points": np.asarray(t.zero_points), "bits": t.bits,
                    "group_size": t.group_size, "shape": t.shape}
        if isinstance(t, jq.QEmbed):
            return {"data": np.asarray(t.data),
                    "row_scales": np.asarray(t.scales)}
        return np.asarray(t)
    bridged = bridge.params_from_numpy(jnp_tree(jout), device="cpu")
    _assert_qtensors_identical(bridged["layers"]["w_down"],
                               jout["layers"]["w_down"])
    back = bridge.to_numpy(tout)["layers"]["wo"]
    np.testing.assert_array_equal(back["zero_points"],
                                  np.asarray(jout["layers"]["wo"].zero_points,
                                             np.float32))
    fused = prepare_params(tout)["layers"]
    for out, names in (("wqkv", ("wq", "wk", "wv")),
                       ("w_gateup", ("w_gate", "w_up"))):
        np.testing.assert_array_equal(
            _bf16_bits(fused[out].zero_points), np.concatenate(
                [_bf16_bits(jout["layers"][n].zero_points) for n in names],
                axis=-1))
