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


def pair(kind, batch_slots=2, quant=False, window=None, **kw):
    """The JAX and the port scheduler of `kind` with the same settings;
    window: the same weights as a Mistral-style model whose every layer
    attends that many keys."""
    J, T, extra = KINDS[kind]
    extra = {**extra, **kw.pop("sched", {})}
    icfg = dict(max_seq_len=96, temperature=0.0, eos_token_id=-1, seed=0)
    icfg.update(kw)
    jcfg, jp, tcfg, tp = models(quant)
    if window is not None:
        jcfg, tcfg = (c.replace(architecture="mistral", sliding_window=window)
                      for c in (jcfg, tcfg))
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


@pytest.mark.parametrize("kw", [dict(parallel="cp", mesh=True),
                                dict(parallel="pp")])
def test_unported_modes_raise(kw):
    """Pipeline and context parallelism wait for the next slice (a
    (data, tp) mesh is served: tests/test_torch_tp_serving.py)."""
    from turboinfer_tpu_torch.parallel.mesh import single_device_mesh
    jcfg, jp, tcfg, tp = models()
    if kw.get("mesh"):
        kw = dict(kw, mesh=single_device_mesh("cpu"))
    with pytest.raises(NotImplementedError, match="next slice"):
        TContinuous(tp, tcfg, device="cpu", **kw)
    # the paged scheduler takes prefill_chunk and never chunks, as JAX's
    js, ts = pair("paged", prefill_chunk=16)
    same(run_both(js, ts, [(p, 6, {}) for p in prompts(3, seed=4, base=30)]))
    assert ts._adm is None


# -- chunked admission (prefill_chunk > 0) ---------------------------------

def _drive(sched, long_prompt, new=8):
    """Decode a short request a few steps, then admit a long prompt while
    it runs (JAX tests/test_scheduler.py's pattern) -> GenerationResults."""
    r1 = sched.submit([1, 2, 3], 24)
    for _ in range(4):
        sched.step()
    r2 = sched.submit(long_prompt, new)
    res = sched.run()
    return [res[r1], res[r2]]


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_chunked_admission_trajectory_identical(kv):
    """Greedy trajectories with chunked admission equal JAX's chunked
    scheduler and the port's own full-width admission."""
    long_prompt = list(range(1, 41))
    js, ts = pair("contiguous", prefill_chunk=8, kv_cache_dtype=kv)
    got = _drive(ts, long_prompt)
    same(list(zip(_drive(js, long_prompt), got)))
    _, full = pair("contiguous", kv_cache_dtype=kv)
    assert [r.tokens for r in _drive(full, long_prompt)] == \
        [r.tokens for r in got]


def test_chunked_admission_windowed_mixed_group():
    """Two prompts of 20 and 27 tokens admit as one group in chunks of 8
    under a 5-key window, while a decode runs: the shorter row's last
    chunk runs at length 0, its padded queries past every key of the
    window. Tokens equal JAX's, and the slot cache holds no NaN."""
    js, ts = pair("contiguous", batch_slots=3, window=5, prefill_chunk=8)
    ps = prompts(2, seed=8, base=20, step=7)
    outs = []
    for s in (js, ts):
        r0 = s.submit([4, 5, 6], 20)
        s.step()
        rids = [s.submit(p, 8) for p in ps]
        s.step()
        if s is ts:
            assert ts._adm is not None and len(ts._adm["group"]) == 2
        res = s.run()
        outs.append([res[r] for r in [r0] + rids])
    same(list(zip(*outs)))
    assert torch.isfinite(ts.cache.k).all() and torch.isfinite(ts.cache.v).all()


def test_chunked_admission_decodes_keep_flowing():
    """While a long prompt admits chunk by chunk, the live decode
    advances every step; step() counts the admitting group while it is
    the only live work."""
    _, ts = pair("contiguous", prefill_chunk=8, prefill_bucket=False)
    r1 = ts.submit([1, 2, 3], 40)
    ts.step()
    n0 = len(ts.get_request(r1).out_tokens)
    r2 = ts.submit(list(range(1, 33)), 4)          # 4 chunks
    for i in range(4):
        ts.step()
        assert ts._adm is not None or i == 3
        assert ts.pending == 2
        assert len(ts.get_request(r1).out_tokens) == n0 + i + 1
        assert ts.get_request(r2).rid == r2
    assert ts._adm is None and len(ts.get_request(r2).out_tokens) >= 1
    assert all(r.finished for r in ts.run().values())


def test_chunked_admission_cancel_mid_flight():
    """A request cancelled during its chunked admission finishes with no
    token and its slot is never activated; the other request goes on."""
    _, ts = pair("contiguous", prefill_chunk=8, prefill_bucket=False)
    r1 = ts.submit([1, 2, 3], 16)
    ts.step()
    r2 = ts.submit(list(range(1, 33)), 8)
    ts.step()
    assert ts._adm is not None
    assert ts.cancel(r2, reason="client gone")
    assert not ts.cancel(r2)
    res = ts.run()
    assert res[r2].stop_reason == "client gone"
    assert res[r2].tokens == list(range(1, 33))
    assert res[r1].finished and len(res[r1].tokens) == 3 + 16
    assert ts._free_slots() == [0, 1]


def test_chunked_admission_queue_behind():
    """Requests queued behind a chunked admission admit after it; all of
    them equal JAX's trajectories."""
    js, ts = pair("contiguous", prefill_chunk=8, prefill_bucket=False)
    outs = []
    for s in (js, ts):
        r0 = s.submit([1, 2, 3], 30)
        s.step()
        rids = [s.submit(list(range(1, 33)), 6), s.submit([7, 8], 6)]
        res = s.run()
        outs.append([res[r] for r in [r0] + rids])
    same(list(zip(*outs)))


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
