"""Speculative serving of the port against turboinfer_tpu's.

Greedy acceptance is deterministic (one-hot filtered distributions), so
the port's spec_proposed / spec_accepted counts must equal the JAX
scheduler's exactly, with a truncated draft that accepts only part of
its proposals, and the tokens must equal plain (non-speculative)
decoding. The acceptance core is held against JAX's on fixed inputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import turboinfer_tpu as ti
from turboinfer_tpu.engine import speculative as jspec
from turboinfer_tpu.engine.sampling import SamplingParams as JSamplingParams
from turboinfer_tpu.engine.scheduler import \
    ContinuousBatchingScheduler as JContinuous
from turboinfer_tpu.engine.scheduler import \
    PagedContinuousScheduler as JPaged
from turboinfer_tpu.models import llama as jllama
from turboinfer_tpu_torch import bridge
from turboinfer_tpu_torch import config as tconfig
from turboinfer_tpu_torch.engine import speculative as tspec
from turboinfer_tpu_torch.engine.sampling import SamplingParams
from turboinfer_tpu_torch.engine.scheduler import \
    ContinuousBatchingScheduler as TContinuous
from turboinfer_tpu_torch.engine.scheduler import \
    PagedContinuousScheduler as TPaged

torch.set_num_threads(2)

_P = {}


def models():
    if not _P:
        jcfg = ti.tiny_config(dtype=jnp.float32)
        jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
        # the draft: the target's first layer, embedding, norm and head
        jd = {"embed": jp["embed"],
              "layers": {k: v[:1] for k, v in jp["layers"].items()},
              "final_norm": jp["final_norm"], "lm_head": jp["lm_head"]}

        def port(tree):
            return bridge.params_from_numpy(
                jax.tree_util.tree_map(np.asarray, tree), device="cpu")
        tcfg = tconfig.tiny_config(dtype=torch.float32)
        _P.update(jcfg=jcfg, jp=jp, jd=jd, tcfg=tcfg, tp=port(jp),
                  td=port(jd))
    return _P


def prompts(n, seed):
    return [[int(t) for t in np.random.default_rng(seed + i).integers(
        1, 900, 7 + 3 * i)] for i in range(n)]


KINDS = {"contiguous": (JContinuous, TContinuous, {}),
         "paged": (JPaged, TPaged, {"page_size": 16})}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("draft", ["truncated", "same"])
def test_spec_greedy_matches_jax_and_plain(kind, draft):
    m = models()
    J, T, kw = KINDS[kind]
    icfg = dict(max_seq_len=96, temperature=0.0, eos_token_id=-1, seed=1)
    dl = 1 if draft == "truncated" else 2
    jd, td = (m["jd"], m["td"]) if draft == "truncated" else (m["jp"],
                                                              m["tp"])
    spec = dict(spec_k=3, **kw)
    js = J(m["jp"], m["jcfg"], ti.InferenceConfig(**icfg), batch_slots=2,
           draft_params=jd, draft_config=m["jcfg"].replace(num_layers=dl),
           **spec)
    ts = T(m["tp"], m["tcfg"], tconfig.InferenceConfig(**icfg),
           batch_slots=2, draft_params=td,
           draft_config=m["tcfg"].replace(num_layers=dl), device="cpu",
           **spec)
    plain = T(m["tp"], m["tcfg"], tconfig.InferenceConfig(**icfg),
              batch_slots=2, device="cpu", **kw)
    ps = prompts(5, seed=60)
    jids = [js.submit(p, 10) for p in ps]
    tids = [ts.submit(p, 10) for p in ps]
    pids = [plain.submit(p, 10) for p in ps]
    jr, tr, pr = js.run(), ts.run(), plain.run()
    for a, b, c in zip(jids, tids, pids):
        assert tr[b].tokens == jr[a].tokens == pr[c].tokens
        assert tr[b].stop_reason == jr[a].stop_reason
        np.testing.assert_allclose(tr[b].logprobs, jr[a].logprobs,
                                   atol=1e-4)
    assert (ts.spec_proposed, ts.spec_accepted) == (js.spec_proposed,
                                                    js.spec_accepted)
    if draft == "same":
        assert ts.spec_accepted == ts.spec_proposed > 0
    else:
        assert 0 < ts.spec_accepted < ts.spec_proposed


def test_spec_falls_back_for_penalised_slots_and_catches_up():
    """A slot with a penalty makes the batch take plain steps; the draft
    cache then lags and is caught up before the next round. Counts and
    tokens still equal JAX's."""
    m = models()
    icfg = dict(max_seq_len=96, temperature=0.0, eos_token_id=-1, seed=1)
    args = dict(batch_slots=2, page_size=16, spec_k=3)
    js = JPaged(m["jp"], m["jcfg"], ti.InferenceConfig(**icfg),
                draft_params=m["jd"],
                draft_config=m["jcfg"].replace(num_layers=1), **args)
    ts = TPaged(m["tp"], m["tcfg"], tconfig.InferenceConfig(**icfg),
                draft_params=m["td"],
                draft_config=m["tcfg"].replace(num_layers=1), device="cpu",
                **args)
    ps = prompts(3, seed=90)
    knobs = [{}, dict(repetition_penalty=1.2), {}]
    jids = [js.submit(p, 12, **kw) for p, kw in zip(ps, knobs)]
    tids = [ts.submit(p, 12, **kw) for p, kw in zip(ps, knobs)]
    jr, tr = js.run(), ts.run()
    for a, b in zip(jids, tids):
        assert tr[b].tokens == jr[a].tokens
    assert (ts.spec_proposed, ts.spec_accepted) == (js.spec_proposed,
                                                    js.spec_accepted)
    assert ts.spec_proposed > 0


def test_rejection_accept_and_emit_layout_one_hot():
    """One-hot distributions make acceptance deterministic: drafts are
    accepted up to the first mismatch and the correction is the target's
    argmax there; all accepted gives a == k."""
    V, k = 7, 3
    tgt = np.array([[1, 2, 3], [1, 5, 3], [4, 2, 3]])
    drafts = np.array([[1, 2, 3], [1, 2, 3], [1, 2, 3]], np.int32)
    pt = np.eye(V, dtype=np.float32)[tgt]
    qd = np.eye(V, dtype=np.float32)[drafts]
    ja, jc = jspec.rejection_accept(jnp.asarray(pt), jnp.asarray(qd),
                                    jnp.asarray(drafts),
                                    jax.random.PRNGKey(0),
                                    jax.random.PRNGKey(1))
    ta, tc = tspec.rejection_accept(torch.from_numpy(pt),
                                    torch.from_numpy(qd),
                                    torch.from_numpy(drafts),
                                    torch.Generator().manual_seed(0))
    assert ta.tolist() == np.asarray(ja).tolist() == [3, 1, 0]
    assert tc.tolist()[1:] == np.asarray(jc).tolist()[1:] == [5, 4]
    nxt = np.array([6, 5, 4], np.int32)
    want = jspec.emit_layout(jnp.asarray(drafts), jnp.asarray(nxt), ja)
    got = tspec.emit_layout(torch.from_numpy(drafts), torch.from_numpy(nxt),
                            ta)
    assert got.tolist() == np.asarray(want).tolist()
    assert got.shape == (3, k + 1)


def test_rejection_accept_rate_and_residual_match_jax():
    """Soft distributions: the accepted count's distribution and the
    correction's distribution (the residual) against JAX's, over 3000
    draws each (|Δ| <= 0.04 is > 4 standard errors)."""
    rng = np.random.default_rng(4)
    V, k, n = 6, 2, 3000
    pt = rng.dirichlet(np.ones(V), size=(1, k)).astype(np.float32)
    qd = rng.dirichlet(np.ones(V), size=(1, k)).astype(np.float32)
    drafts = np.array([[2, 4]], np.int32)
    keys = jax.random.split(jax.random.PRNGKey(0), 2 * n).reshape(n, 2, 2)
    ja, jc = jax.vmap(lambda kk: jspec.rejection_accept(
        jnp.asarray(pt), jnp.asarray(qd), jnp.asarray(drafts), kk[0],
        kk[1]))(keys)
    gen = torch.Generator().manual_seed(0)
    tr = [tspec.rejection_accept(torch.from_numpy(pt), torch.from_numpy(qd),
                                 torch.from_numpy(drafts), gen)
          for _ in range(n)]
    ta = np.array([int(a[0]) for a, _ in tr])
    tc = np.array([int(c[0]) for _, c in tr])
    ja, jc = np.asarray(ja)[:, 0], np.asarray(jc)[:, 0]
    for j, t, m in ((ja, ta, k + 1), (jc[ja < k], tc[ta < k], V)):
        fj = np.bincount(j, minlength=m) / len(j)
        ft = np.bincount(t, minlength=m) / len(t)
        assert np.abs(fj - ft).max() <= 0.04


def test_filtered_probs_match_jax():
    rng = np.random.default_rng(5)
    logits = (rng.normal(size=(3, 50)) * 2).astype(np.float32)
    for t, kk, p in ((0.8, 10, 0.9), (1.0, 0, 1.0), (1.3, 3, 0.5)):
        want = jspec._filtered_probs(jnp.asarray(logits),
                                     JSamplingParams(temperature=t, top_k=kk,
                                                     top_p=p))
        got = tspec._filtered_probs(torch.from_numpy(logits),
                                    SamplingParams(temperature=t, top_k=kk,
                                                   top_p=p))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6)
