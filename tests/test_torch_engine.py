"""generate_batch of the port against turboinfer_tpu's InferenceEngine.

Greedy trajectories must be identical, token for token, with the same
stop reasons, for tiny f32, tiny int4 and the D=128 GQA config. (For the
tiny head size the JAX engine keeps a fused-head cache and the port a
head-major one, so tokens are compared, not cache layouts.)
"""

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
from turboinfer_tpu.models import llama as jllama
from turboinfer_tpu.quant.quantizer import quantize_params as j_quantize_params
from turboinfer_tpu_torch import bridge
from turboinfer_tpu_torch import config as tconfig
from turboinfer_tpu_torch.config import InferenceConfig
from turboinfer_tpu_torch.engine.engine import InferenceEngine, _bucket
from turboinfer_tpu_torch.utils.errors import TokenError

torch.set_num_threads(2)


def jax_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, JQTensor):
        return {"data": np.asarray(tree.data), "scales": np.asarray(tree.scales),
                "zero_points": None, "bits": tree.bits,
                "group_size": tree.group_size, "shape": tree.shape}
    if isinstance(tree, JQEmbed):
        return {"data": np.asarray(tree.data),
                "row_scales": np.asarray(tree.scales)}
    return np.asarray(tree)


CONFIGS = {
    "tiny_f32": (dict(), False),
    "tiny_int4": (dict(), True),
    "gqa_d128": (dict(hidden_size=256, num_heads=2, num_kv_heads=1,
                      intermediate_size=512, vocab_size=512,
                      max_seq_len=128), False),
}

_CACHE = {}


def engines(name, **icfg):
    """(JAX engine, port engine) on the same weights and settings."""
    kw, quant = CONFIGS[name]
    key = (name, tuple(sorted(icfg.items())))
    if key not in _CACHE:
        jcfg = ti.tiny_config(dtype=jnp.float32, **kw)
        tcfg = tconfig.tiny_config(dtype=torch.float32, **kw)
        jp = jllama.init_params(jax.random.PRNGKey(1), jcfg)
        if quant:
            jp = j_quantize_params(jp, JQuantCfg(type=JQuantType.INT4,
                                                 group_size=64))
        tp = bridge.params_from_numpy(jax_to_numpy(jp), device="cpu")
        icfg.setdefault("max_seq_len", jcfg.max_seq_len)
        je = ti.InferenceEngine(jp, jcfg, JInferenceConfig(**icfg))
        te = InferenceEngine(tp, tcfg, InferenceConfig(**icfg), device="cpu")
        _CACHE[key] = (je, te)
    return _CACHE[key]


def _same(jres, tres):
    for a, b in zip(jres, tres):
        assert b.tokens == a.tokens
        assert b.stop_reason == a.stop_reason
        assert b.finished == a.finished


@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_trajectories_identical(name):
    je, te = engines(name)
    V = je.model_config.vocab_size
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, V, size=n).tolist() for n in (5, 17, 9)]
    _same(je.generate_batch(prompts, 24, temperature=0.0),
          te.generate_batch(prompts, 24, temperature=0.0))


def test_eos_and_max_seq_stops_match():
    """A small cache: rows finish on EOS, on length, or when their own
    headroom runs out (per-row budgets), exactly as in JAX."""
    je, te = engines("tiny_f32", max_seq_len=48)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 1000, size=n).tolist() for n in (4, 30, 40)]
    jres = je.generate_batch(prompts, 40, temperature=0.0)
    _same(jres, te.generate_batch(prompts, 40, temperature=0.0))
    assert {r.stop_reason for r in jres} >= {"max_seq"}
    # pick a token the first row emits as EOS
    eos = jres[0].tokens[len(prompts[0]) + 3]
    je2, te2 = engines("tiny_f32", eos_token_id=eos)
    jres = je2.generate_batch(prompts[:2], 12, temperature=0.0)
    _same(jres, te2.generate_batch(prompts[:2], 12, temperature=0.0))
    assert jres[0].stop_reason == "eos"


def test_host_loop_and_chunked_prefill_match_scan():
    """The host decode loop and chunked prefill (which reads the stacked
    cache at q_start > 0) each match the JAX engine in the same setting,
    and the port's scan path."""
    _, te = engines("gqa_d128")
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8]]
    want = te.generate_batch(prompts, 10, temperature=0.0)
    for icfg in (dict(decode_loop="host"), dict(prefill_chunk=4)):
        je_o, te_o = engines("gqa_d128", **icfg)
        got = te_o.generate_batch(prompts, 10, temperature=0.0)
        _same(je_o.generate_batch(prompts, 10, temperature=0.0), got)
        assert [r.tokens for r in got] == [r.tokens for r in want]


def test_sampling_reproducible_and_penalties_run():
    _, te = engines("tiny_int4")
    prompts = [[1, 17, 42, 256, 731, 5, 9, 88]]
    te.reset_state()
    a = te.generate_batch(prompts, 16, temperature=0.8, top_k=50, top_p=0.9)
    te.reset_state()
    b = te.generate_batch(prompts, 16, temperature=0.8, top_k=50, top_p=0.9)
    assert a[0].tokens == b[0].tokens and len(a[0].tokens) == 8 + 16
    c = te.generate_batch(prompts, 16, temperature=0.0,
                          repetition_penalty=1.3, presence_penalty=0.5)
    assert len(c[0].tokens) == 8 + 16


def test_stats_validation_and_bucket():
    _, te = engines("tiny_f32")
    te.reset_state()
    te.generate([1, 2, 3], 4, temperature=0.0)
    report = te.performance_stats()
    assert "Tokens generated:     4" in report and "cpu" in report
    with pytest.raises(TokenError):
        te.generate([], 4)
    with pytest.raises(TokenError):
        te.generate([5000], 4)
    assert _bucket(17, True) == 32 and _bucket(5, True) == 16
    assert _bucket(300, True, cap=320) == 320 and _bucket(9, False) == 9
    full = te.generate([1] * 255, 4, temperature=0.0)
    assert len(full.tokens) == 256 and full.stop_reason == "max_seq"
