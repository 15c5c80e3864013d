"""The port's schedulers against turboinfer_tpu's, request for request.

Both packages get the same weights (bridged through numpy) and the same
request stream; greedy trajectories and stop reasons must be identical
and out-logprobs equal within 1e-4 (f32 sums in another order). The
request streams hold more requests than slots, so admission is
continuous. Sampled tokens differ by construction (jax.random and
torch.Generator streams), so sampling is held by its filtered
distributions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import turboinfer_tpu as ti
from turboinfer_tpu.config import QuantizationConfig as JQuantCfg
from turboinfer_tpu.config import QuantType as JQuantType
from turboinfer_tpu.core.qtensor import QEmbed as JQEmbed
from turboinfer_tpu.core.qtensor import QTensor as JQTensor
from turboinfer_tpu.engine import sampling as jsampling
from turboinfer_tpu.engine.scheduler import \
    ContinuousBatchingScheduler as JContinuous
from turboinfer_tpu.engine.scheduler import \
    PagedContinuousScheduler as JPaged
from turboinfer_tpu.models import llama as jllama
from turboinfer_tpu.quant.quantizer import quantize_params as j_quantize_params
from turboinfer_tpu_torch import bridge
from turboinfer_tpu_torch import config as tconfig
from turboinfer_tpu_torch.engine import sampling
from turboinfer_tpu_torch.engine.scheduler import \
    ContinuousBatchingScheduler as TContinuous
from turboinfer_tpu_torch.engine.scheduler import \
    PagedContinuousScheduler as TPaged
from turboinfer_tpu_torch.utils.errors import SchedulerFullError

torch.set_num_threads(2)

LOGPROB_ATOL = 1e-4
KINDS = {"contiguous": (JContinuous, TContinuous, {}),
         "paged": (JPaged, TPaged, {"page_size": 8})}

_P = {}


def _jax_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, JQTensor):
        return {"data": np.asarray(tree.data), "scales": np.asarray(tree.scales),
                "zero_points": None if tree.zero_points is None
                else np.asarray(tree.zero_points), "bits": tree.bits,
                "group_size": tree.group_size, "shape": tree.shape}
    if isinstance(tree, JQEmbed):
        return {"data": np.asarray(tree.data),
                "row_scales": np.asarray(tree.scales)}
    return np.asarray(tree)


def models(quant=False):
    """(JAX config, JAX params, port config, port params): tiny f32, or
    its int4 g=64 quantization."""
    if quant not in _P:
        jcfg = ti.tiny_config(dtype=jnp.float32)
        jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
        if quant:
            jp = j_quantize_params(jp, JQuantCfg(type=JQuantType.INT4,
                                                 group_size=64))
        tp = bridge.params_from_numpy(_jax_to_numpy(jp), device="cpu")
        _P[quant] = (jcfg, jp, tconfig.tiny_config(dtype=torch.float32), tp)
    return _P[quant]


def pair(kind, batch_slots=2, quant=False, **kw):
    """The JAX and the port scheduler of `kind` with the same settings."""
    J, T, extra = KINDS[kind]
    extra = {**extra, **kw.pop("sched", {})}
    icfg = dict(max_seq_len=96, temperature=0.0, eos_token_id=-1, seed=0)
    icfg.update(kw)
    jcfg, jp, tcfg, tp = models(quant)
    return (J(jp, jcfg, ti.InferenceConfig(**icfg), batch_slots=batch_slots,
              **extra),
            T(tp, tcfg, tconfig.InferenceConfig(**icfg),
              batch_slots=batch_slots, device="cpu", **extra))


def prompts(n, seed=40, base=9, step=5):
    return [[int(t) for t in np.random.default_rng(seed + i).integers(
        1, 900, base + step * i)] for i in range(n)]


def run_both(js, ts, reqs, stagger=0):
    """Submit `reqs` ((prompt, max_new, knobs) triples) to both; with
    stagger > 0, the second half arrives after that many steps."""
    first = reqs if not stagger else reqs[: len(reqs) // 2]
    jids = [js.submit(p, n, **kw) for p, n, kw in first]
    tids = [ts.submit(p, n, **kw) for p, n, kw in first]
    if stagger:
        for _ in range(stagger):
            js.step()
            ts.step()
        jids += [js.submit(p, n, **kw) for p, n, kw in reqs[len(first):]]
        tids += [ts.submit(p, n, **kw) for p, n, kw in reqs[len(first):]]
    jr, tr = js.run(), ts.run()
    return [(jr[a], tr[b]) for a, b in zip(jids, tids)]


def same(results):
    for j, t in results:
        assert t.tokens == j.tokens
        assert t.stop_reason == j.stop_reason
        assert t.finished == j.finished
        np.testing.assert_allclose(t.logprobs, j.logprobs, atol=LOGPROB_ATOL)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int4"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_greedy_trajectories_staggered_admission(kind, quant):
    js, ts = pair(kind, quant=quant)
    reqs = [(p, 12, {}) for p in prompts(6)]
    same(run_both(js, ts, reqs, stagger=3))


@pytest.mark.parametrize("kind", list(KINDS))
def test_stop_reasons_eos_length_max_seq(kind):
    # find a token the greedy run emits, then stop on it
    js, ts = pair(kind)
    ps = prompts(3, seed=7)
    probe = run_both(js, ts, [(p, 6, {}) for p in ps])
    eos = probe[0][0].tokens[len(ps[0]) + 2]
    js, ts = pair(kind, eos_token_id=eos, max_seq_len=48)
    reqs = [(p, 20, {}) for p in ps] + [(prompts(1, seed=3, base=40)[0], 20,
                                         {})]
    res = run_both(js, ts, reqs)
    same(res)
    reasons = {t.stop_reason for _, t in res}
    assert "eos" in reasons and "max_seq" in reasons


@pytest.mark.parametrize("kind", list(KINDS))
def test_decode_burst(kind):
    js, ts = pair(kind, sched={"decode_burst": 4})
    res = run_both(js, ts, [(p, 11, {}) for p in prompts(5, seed=11)])
    same(res)
    # a burst is only a batching change: the port's plain steps agree
    _, plain = pair(kind)
    for (j, _), p in zip(res, prompts(5, seed=11)):
        rid = plain.submit(p, 11)
        assert plain.run()[rid].tokens == j.tokens


@pytest.mark.parametrize("kind", list(KINDS))
def test_per_request_knobs_greedy(kind):
    """Penalties, min_p and logit_bias per request, greedy (so the draws
    do not enter): the per-slot count and bias rows must match."""
    js, ts = pair(kind, batch_slots=3)
    ps = prompts(4, seed=21)
    reqs = [(ps[0], 10, dict(repetition_penalty=1.3)),
            (ps[1], 10, dict(presence_penalty=0.8, frequency_penalty=0.5)),
            (ps[2], 10, dict(logit_bias={5: 4.0, 17: -100.0}, min_p=0.1)),
            (ps[3], 10, {})]
    same(run_both(js, ts, reqs))


def test_paged_prefix_sharing_hits_and_resubmit():
    """12-token shared prefix (one full 8-token page shared), suffixes
    of various lengths: equal pool hit/miss counts, equal tokens, and a
    resubmitted prompt reproduces its first run."""
    js, ts = pair("paged", batch_slots=2)
    prefix = prompts(1, seed=5, base=12)[0]
    ps = [prefix + s for s in prompts(4, seed=30, base=3, step=4)]
    res = run_both(js, ts, [(p, 8, {}) for p in ps])
    same(res)
    again = run_both(js, ts, [(ps[1], 8, {})])
    same(again)
    assert again[0][1].tokens == res[1][1].tokens
    assert (ts.pool.hits, ts.pool.misses) == (js.pool.hits, js.pool.misses)
    assert ts.pool.hits > 0
    # every page but the trash page is free or evictable after the run
    assert ts.pool.live_pages == 1
    assert ts.pool.available == ts.pool.num_pages - 1


def test_paged_admission_blocks_until_pages_free():
    js, ts = pair("paged", sched={"num_pages": 1 + 5})
    reqs = [(p, 10, {}) for p in prompts(4, seed=2, base=14, step=3)]
    same(run_both(js, ts, reqs))
    # a prompt that can never fit is refused at submit, by both
    for s in (js, ts):
        with pytest.raises(ValueError):
            s.submit(list(range(1, 60)), 4)


def test_submit_validation_and_queue():
    _, ts = pair("contiguous", sched={"max_queue": 2})
    with pytest.raises(ValueError):
        ts.submit([], 4)
    with pytest.raises(ValueError):
        ts.submit(list(range(1, 97)), 4)
    with pytest.raises(ValueError, match="tokenizer"):
        ts.submit([1, 2], 4, response_format="json")
    a = ts.submit([1, 2, 3], 4)
    b = ts.submit([4, 5], 4)
    with pytest.raises(SchedulerFullError):
        ts.submit([6], 4)
    assert ts.cancel(b) and ts.get_request(b).stop_reason == "cancelled"
    assert ts.get_request(a).rid == a
    res = ts.run()
    assert res[a].stop_reason == "length" and len(res[a].tokens) == 7


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(parallel="pp")])
def test_unported_modes_raise(kw):
    jcfg, jp, tcfg, tp = models()
    with pytest.raises(NotImplementedError):
        TContinuous(tp, tcfg, device="cpu", **kw)
    with pytest.raises(NotImplementedError):
        TPaged(tp, tcfg, tconfig.InferenceConfig(prefill_chunk=16),
               device="cpu")


def _jax_empirical(logits, t, k, p, mp, n=4000):
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    draw = jax.vmap(lambda key: jsampling.sample_per_slot(
        key, jnp.asarray(logits), jnp.asarray(t), jnp.asarray(k),
        jnp.asarray(p), min_p=jnp.asarray(mp)))(keys)
    draw = np.asarray(draw)
    B, V = logits.shape
    freq = np.zeros((B, V))
    for b in range(B):
        freq[b] = np.bincount(draw[:, b], minlength=V) / n
    return freq


def test_sample_per_slot_distributions_match_jax():
    """Per-row temperature / top-k / top-p / min-p (and a greedy row):
    the port's filtered distribution against JAX's draws (4000 per row;
    |freq - prob| <= 0.03 is > 5 standard errors), the support must
    agree, and the port's own draws follow its distribution."""
    rng = np.random.default_rng(0)
    B, V = 5, 300
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    t = np.array([0.8, 1.0, 0.0, 1.5, 0.7], np.float32)
    k = np.array([50, 0, 5, 200, 10], np.int32)
    p = np.array([0.9, 0.5, 1.0, 0.95, 1.0], np.float32)
    mp = np.array([0.0, 0.0, 0.0, 0.05, 0.2], np.float32)
    args = [torch.from_numpy(a) for a in (logits, t, k, p)]
    xs, idx, _ = sampling.per_slot_candidates(*args,
                                              min_p=torch.from_numpy(mp))
    prob = np.zeros((B, V))
    for b in range(B):
        prob[b, idx[b].numpy()] = torch.softmax(xs[b], -1).numpy()
    jfreq = _jax_empirical(logits, t, k, p, mp)
    sampled = t > 0
    assert np.abs(jfreq - prob)[sampled].max() <= 0.03
    assert ((jfreq > 0) <= (prob > 0))[sampled].all()
    gen = torch.Generator().manual_seed(0)
    draws = np.stack([sampling.sample_per_slot(
        gen, *args, min_p=torch.from_numpy(mp)).numpy() for _ in range(2000)])
    for b in np.flatnonzero(sampled):
        f = np.bincount(draws[:, b], minlength=V) / len(draws)
        assert np.abs(f - prob[b]).max() <= 0.04
    # the greedy row takes the argmax, as JAX does
    assert (draws[:, 2] == logits[2].argmax()).all()
    assert (jfreq[2, logits[2].argmax()] == 1.0)
