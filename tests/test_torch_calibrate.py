"""The port's activation-calibrated quantization (quant/calibrate.py,
quantize(weight_moments=), quantize_params(moments=)) against the JAX
package on the CPU, after tests/test_calibrate.py.

Held: the weighted scale search lowers the output error where absmax
spends resolution on a dead channel; quantize(weight_moments=) gives
the JAX package's QTensor; the calibration tokens are JAX's, token for
token; collect_moments' moments within 1e-5 of JAX's (another f32
summation order); calibrated_quantize_params and the calibrated
quantize_model_file give JAX's codes, but where a moment one ulp apart
tips the choice between two shrink factors of equal error (at most
FLIP_SHARE of the groups).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from turboinfer_tpu import config as jconfig
from turboinfer_tpu.core import qtensor as jqt
from turboinfer_tpu.loader import tinq as jtinq
from turboinfer_tpu.models import llama as jllama
from turboinfer_tpu.quant import calibrate as jcal
from turboinfer_tpu_torch import bridge
from turboinfer_tpu_torch import config as tconfig
from turboinfer_tpu_torch.core import qtensor as tqt
from turboinfer_tpu_torch.loader import tinq as ttinq
from turboinfer_tpu_torch.quant import calibrate as tcal
from turboinfer_tpu_torch.quant import quantizer as tquantizer
from turboinfer_tpu_torch.utils.errors import QuantizationError

from test_torch_loader import (assert_same_params, hf_config, jax_to_numpy,
                               named_tensors, write_hf_dir)

torch.set_num_threads(2)

FLIP_SHARE = 0.01
TINY = dict(vocab_size=300, hidden_size=128, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=256, max_seq_len=64)


def _out_mse(w, qt, moments, n=512, seed=3):
    """E||x@W - x@What||^2 with x drawn channel-scaled by moments."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, w.shape[0]).astype(np.float32) * \
        np.sqrt(moments)[None, :]
    d = x @ w - x @ tqt.dequantize(qt).numpy()
    return float(np.mean(np.square(d)))


def _outlier_weight():
    rng = np.random.RandomState(0)
    K, N, g = 128, 64, 32
    w = rng.randn(K, N).astype(np.float32) * 0.05
    dead = np.arange(0, K, g)          # first channel of each group
    w[dead, :] += rng.choice([-1.0, 1.0], size=(len(dead), N)) * 1.5
    moments = np.ones(K, np.float32)
    moments[dead] = 1e-4
    return w, moments, g


def test_weighted_scale_search_reduces_output_mse():
    """Outlier weights on channels the activations never drive: absmax
    spends its resolution on them; the weighted search clips them."""
    w, moments, g = _outlier_weight()
    qa = tqt.quantize(torch.from_numpy(w), tconfig.QuantType.INT4,
                      group_size=g, scale_dtype=torch.float32)
    qc = tqt.quantize(torch.from_numpy(w), tconfig.QuantType.INT4,
                      group_size=g, scale_dtype=torch.float32,
                      weight_moments=torch.from_numpy(moments))
    assert _out_mse(w, qc, moments) < 0.5 * _out_mse(w, qa, moments)


@pytest.mark.parametrize("qtype", ["int4", "int8"])
def test_quantize_with_moments_as_jax(qtype):
    w, moments, g = _outlier_weight()
    got = tqt.quantize(torch.from_numpy(w), tconfig.QuantType(qtype),
                       group_size=g, weight_moments=torch.from_numpy(moments))
    want = jqt.quantize(jnp.asarray(w), jconfig.QuantType(qtype),
                        group_size=g, weight_moments=jnp.asarray(moments))
    assert_same_params({"w": got}, {"w": want})
    with pytest.raises(QuantizationError, match="symmetric"):
        tqt.quantize(torch.from_numpy(w), tconfig.QuantType(qtype),
                     group_size=g, symmetric=False,
                     weight_moments=torch.from_numpy(moments))
    with pytest.raises(QuantizationError, match="length"):
        tqt.quantize(torch.from_numpy(w), tconfig.QuantType(qtype),
                     group_size=g, weight_moments=torch.ones(7))


_M = {}


def models():
    if not _M:
        jcfg = jconfig.ModelConfig(dtype=jnp.float32, **TINY)
        jp = jllama.init_params(jax.random.PRNGKey(5), jcfg)
        _M["m"] = (jcfg, jp, tconfig.ModelConfig(dtype=torch.float32, **TINY),
                   bridge.params_from_numpy(jax_to_numpy(jp), device="cpu"))
    return _M["m"]


def _qcfgs(**kw):
    kw = dict(type="int4", group_size=32, calibration_samples=3,
              calibration_max_len=24, **kw)
    return (jconfig.QuantizationConfig(**{**kw, "type": jconfig.QuantType(
                kw["type"])}),
            tconfig.QuantizationConfig(**{**kw, "type": tconfig.QuantType(
                kw["type"])}))


def test_calibration_tokens_and_moments_as_jax():
    jcfg, jp, tcfg, tp = models()
    jq, tq = _qcfgs()
    toks = tcal.default_calibration_tokens(tq, tcfg, seed=2)
    assert toks == jcal.default_calibration_tokens(jq, jcfg, seed=2)
    assert len(toks) == 3 and {len(t) for t in toks} == {24}
    got = tcal.collect_moments(tp, tcfg, toks)
    want = jcal.collect_moments(jp, jcfg, toks)
    assert set(got) == set(want) == {"wq", "wk", "wv", "wo", "w_gate",
                                     "w_up", "w_down", "lm_head"}
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def _codes_agree(got, want):
    """Quantized trees: every leaf's dtype and shape equal; the codes of
    at most FLIP_SHARE of the scale groups differ (a scale tipped by an
    ulp in the moments), and so do the scales of those groups."""
    g, w = bridge.to_numpy(got), jax_to_numpy(want)
    flips = total = 0
    for slot in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        gs, ws = g["layers"][slot], w["layers"][slot]
        sg = gs["scales"].astype(np.float32)
        sw = np.asarray(ws["scales"]).astype(np.float32)
        assert sg.shape == sw.shape
        flips += int((sg != sw).sum())
        total += sg.size
    assert flips <= FLIP_SHARE * total, (flips, total)


def test_calibrated_quantize_params_as_jax():
    jcfg, jp, tcfg, tp = models()
    jq, tq = _qcfgs()
    got = tcal.calibrated_quantize_params(tp, tq, tcfg, seed=1)
    want = jcal.calibrated_quantize_params(jp, jq, jcfg, seed=1)
    _codes_agree(got, want)
    plain = tquantizer.quantize_params(tp, tq)
    assert not torch.equal(plain["layers"]["wq"].scales,
                           got["layers"]["wq"].scales)
    with pytest.raises(QuantizationError, match="symmetric"):
        tcal.calibrated_quantize_params(tp, _qcfgs(symmetric=False)[1],
                                        tcfg)
    with pytest.raises(QuantizationError, match="already"):
        tcal.collect_moments(plain, tcfg, [[1, 2, 3]])


def test_calibrated_quantize_model_file_loads_in_jax(tmp_path):
    """quantize_model_file(calibrate=True) from an HF directory: the JAX
    package loads the port's .tinq, and its scales are JAX's own
    calibrated file's but for FLIP_SHARE."""
    jcfg, jp, tcfg, tp = models()
    d = str(tmp_path / "hf")
    write_hf_dir(d, named_tensors(jp, jcfg), hf_config(jcfg))
    jq, tq = _qcfgs()
    toks = tcal.default_calibration_tokens(tq, tcfg)
    tquantizer.quantize_model_file(d, str(tmp_path / "t.tinq"), tq,
                                   calibrate=True, sample_tokens=toks,
                                   device="cpu")
    from turboinfer_tpu.quant import quantizer as jquantizer
    jquantizer.quantize_model_file(d, str(tmp_path / "j.tinq"), jq,
                                   calibrate=True, sample_tokens=toks)
    jback = jtinq.load(str(tmp_path / "t.tinq"))[0]
    want = jtinq.load(str(tmp_path / "j.tinq"))[0]
    assert_same_params(ttinq.load(str(tmp_path / "t.tinq"),
                                  device="cpu")[0], jback)
    _codes_agree(bridge.params_from_numpy(jax_to_numpy(jback),
                                          device="cpu"), want)
