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
