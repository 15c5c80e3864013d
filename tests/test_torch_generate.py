"""The text paths of the port's engine and schedulers against
turboinfer_tpu's, on bridged f32 params of the tiny config.

generate_structured (json_object and a JSON Schema), generate_stream
(bursts 1 and 3), generate_beam_search over model-dtype, bf16, int8 and
fp8 caches, compute_logprobs and chat: greedy tokens identical, beam and
scoring logprobs within 1e-4. Both schedulers with response_format and
logit_bias: greedy outputs identical to the JAX schedulers'. Sampled
tokens are never compared (the two packages draw from different
generators).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import turboinfer_tpu as ti
from turboinfer_tpu.config import InferenceConfig as JInferenceConfig
from turboinfer_tpu.engine.scheduler import (
    ContinuousBatchingScheduler as JContinuous,
    PagedContinuousScheduler as JPaged)
from turboinfer_tpu.models import llama as jllama
from turboinfer_tpu.tokenizer.bpe import BuiltinTokenizer as JBuiltin
from turboinfer_tpu_torch import bridge
from turboinfer_tpu_torch import config as tconfig
from turboinfer_tpu_torch.config import InferenceConfig
from turboinfer_tpu_torch.engine.engine import (InferenceEngine,
                                                StreamChunk, _top_k,
                                                quick_generate)
from turboinfer_tpu_torch.engine.scheduler import (
    ContinuousBatchingScheduler, PagedContinuousScheduler)
from turboinfer_tpu_torch.structured import json_fsm
from turboinfer_tpu_torch.tokenizer.bpe import BuiltinTokenizer

torch.set_num_threads(2)

SCHEMA = {"type": "object",
          "properties": {"name": {"type": "string", "maxLength": 12},
                         "age": {"type": "integer", "minimum": 0,
                                 "maximum": 150},
                         "tag": {"type": "string",
                                 "enum": ["alpha", "beta", "gamma"]}},
          "required": ["name", "age", "tag"]}
RF_SCHEMA = {"type": "json_schema", "json_schema": {"schema": SCHEMA}}
PROMPT = [1, 17, 42, 256, 731, 5, 9, 88]


@pytest.fixture(scope="module")
def weights():
    jcfg = ti.tiny_config(dtype=jnp.float32)
    tcfg = tconfig.tiny_config(dtype=torch.float32)
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


_ENGINES = {}


def engines(weights, tokenizer=True, **icfg):
    """(JAX engine, port engine) on the same weights, settings and a
    BuiltinTokenizer of the model's vocab each (or none)."""
    key = (tokenizer, tuple(sorted(icfg.items())))
    if key not in _ENGINES:
        jcfg, jp, tcfg, tp = weights
        icfg.setdefault("max_seq_len", 256)
        icfg.setdefault("seed", 0)
        V = jcfg.vocab_size
        _ENGINES[key] = (
            ti.InferenceEngine(jp, jcfg, JInferenceConfig(**icfg),
                               tokenizer=JBuiltin(vocab_size=V)
                               if tokenizer else None),
            InferenceEngine(tp, tcfg, InferenceConfig(**icfg),
                            tokenizer=BuiltinTokenizer(vocab_size=V)
                            if tokenizer else None, device="cpu"))
    return _ENGINES[key]


def _legal_prefix(text: str) -> bool:
    return json_fsm.advance_bytes(json_fsm.initial(True),
                                  text.encode()) is not None


@pytest.mark.parametrize("rf", ["json_object", "schema"])
def test_generate_structured_matches_jax(weights, rf):
    je, te = engines(weights)
    fmt = RF_SCHEMA if rf == "schema" else rf
    want = je.generate_structured(PROMPT, 48, response_format=fmt,
                                  temperature=0.0)
    got = te.generate_structured(PROMPT, 48, response_format=fmt,
                                 temperature=0.0)
    assert got.tokens == want.tokens
    assert (got.text, got.finished, got.stop_reason) == (
        want.text, want.finished, want.stop_reason)
    if rf == "schema":
        assert got.stop_reason == "stop"
        doc = json.loads(got.text)
        assert set(doc) == {"name", "age", "tag"}
        assert len(doc["name"]) <= 12 and 0 <= doc["age"] <= 150
        assert doc["tag"] in ("alpha", "beta", "gamma")
    else:
        assert _legal_prefix(got.text)


@pytest.mark.parametrize("burst", [1, 3])
def test_generate_stream_matches_jax_and_generate(weights, burst):
    je, te = engines(weights)
    want = list(je.generate_stream(PROMPT, 13, burst=burst,
                                   temperature=0.0))
    got = list(te.generate_stream(PROMPT, 13, burst=burst,
                                  temperature=0.0))
    assert all(isinstance(c, StreamChunk) for c in got)
    assert [(c.token, c.text, c.index, c.finished, c.stop_reason)
            for c in got] == [(c.token, c.text, c.index, c.finished,
                               c.stop_reason) for c in want]
    gen = te.generate(PROMPT, 13, temperature=0.0)
    assert [c.token for c in got] == gen.tokens[len(PROMPT):]


def test_generate_stream_stops_on_eos_and_without_tokenizer(weights):
    _, te0 = engines(weights)
    toks = te0.generate(PROMPT, 12, temperature=0.0).tokens[len(PROMPT):]
    je, te = engines(weights, tokenizer=False, eos_token_id=toks[5])
    want = [(c.token, c.text, c.stop_reason)
            for c in je.generate_stream(PROMPT, 12, burst=4,
                                        temperature=0.0)]
    got = [(c.token, c.text, c.stop_reason)
           for c in te.generate_stream(PROMPT, 12, burst=4,
                                       temperature=0.0)]
    assert got == want
    assert got[-1] == (toks[5], None, "eos") and len(got) == 6


def _beams_agree(want, got):
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert b.tokens == a.tokens
        assert (b.finished, b.stop_reason) == (a.finished, a.stop_reason)
        np.testing.assert_allclose(b.logprobs, a.logprobs, atol=1e-4)


@pytest.mark.parametrize("kv", ["model", "bf16", "int8", "fp8"])
def test_beam_search_matches_jax(weights, kv):
    je, te = engines(weights, kv_cache_dtype=kv)
    kw = dict(beam_size=4, return_all_beams=True)
    _beams_agree(je.generate_beam_search(PROMPT, 10, **kw),
                 te.generate_beam_search(PROMPT, 10, **kw))


def test_beam_search_frozen_beams_and_filters_match_jax(weights):
    """A beam that reaches EOS proposes only EOS at 0 (-1e30 elsewhere):
    the expansion over those equal scores takes JAX's tie order. Top-k,
    top-p and temperature filter the candidates as in JAX."""
    _, te0 = engines(weights)
    beams = te0.generate_beam_search(PROMPT, 8, beam_size=4,
                                     return_all_beams=True)
    eos = beams[1].tokens[len(PROMPT) + 2]
    je, te = engines(weights, eos_token_id=eos)
    for kw in (dict(), dict(temperature=0.7, top_k=5, top_p=0.9),
               dict(length_penalty=0.6)):
        want = je.generate_beam_search(PROMPT, 8, beam_size=4,
                                       return_all_beams=True, **kw)
        got = te.generate_beam_search(PROMPT, 8, beam_size=4,
                                      return_all_beams=True, **kw)
        _beams_agree(want, got)
    assert any(r.stop_reason == "eos" for r in got)


def test_top_k_takes_the_lower_index_on_ties():
    x = torch.tensor([0.5, 2.0, -1e30, 2.0, -1e30, -1e30, 0.5])
    vals, idx = _top_k(x, 5)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    assert idx.tolist() == np.asarray(ji).tolist() == [1, 3, 0, 6, 2]
    assert vals.tolist() == np.asarray(jv).tolist()


def test_beam_gather_reorders_without_aliasing(weights):
    """Beam b takes the rows of beam parent[b] even where parents
    repeat and permute: the indexed read copies before the write."""
    _, te = engines(weights, kv_cache_dtype="int8")
    cache = te._take_cache(4)
    g = torch.Generator().manual_seed(0)
    for plane, _ in te._cache_planes(cache, cache):
        plane.copy_(torch.randint(0, 100, plane.shape, generator=g)
                    .to(plane.dtype))
    before = [p.clone() for p, _ in te._cache_planes(cache, cache)]
    parent = torch.tensor([2, 0, 2, 1])
    te._beam_gather(cache, parent, 5)
    for b0, (p, _) in zip(before, te._cache_planes(cache, cache)):
        assert torch.equal(p[:, :, :, :5], b0[:, parent, :, :5])
        assert torch.equal(p[:, :, :, 5:], b0[:, :, :, 5:])
    te._put_cache(4, cache)


def test_compute_logprobs_matches_jax(weights):
    je, te = engines(weights)
    seq = PROMPT + [3, 99, 512, 7, 64, 2]
    want = je.compute_logprobs(seq)
    got = te.compute_logprobs(seq)
    assert got[0] == 0.0 and len(got) == len(seq)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_beam_logprobs_score_their_tokens(weights):
    """Unfiltered beam logprobs are the model's: compute_logprobs of
    each beam's tokens gives the same numbers."""
    _, te = engines(weights)
    for r in te.generate_beam_search(PROMPT, 6, beam_size=3,
                                     return_all_beams=True):
        lp = te.compute_logprobs(r.tokens)[len(PROMPT):]
        np.testing.assert_allclose(r.logprobs, lp, atol=1e-4)


def test_chat_matches_jax(weights):
    je, te = engines(weights)
    msgs = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "hello"}]
    want = je.chat(msgs, 12, temperature=0.0)
    got = te.chat(msgs, 12, temperature=0.0)
    assert got.tokens == want.tokens and got.text == want.text
    assert te.encode("hello world") == je.encode("hello world")
    assert te.decode(got.tokens) == je.decode(want.tokens)
    stream = list(te.chat_stream(msgs, 12, temperature=0.0))
    assert [c.token for c in stream] == got.tokens[-12:]
    assert "".join(c.text for c in stream) == got.text


def test_text_paths_refuse_without_tokenizer(weights, monkeypatch):
    _, te = engines(weights, tokenizer=False)
    msgs = [{"role": "user", "content": "hi"}]
    with pytest.raises(RuntimeError, match="tokenizer"):
        te.chat(msgs, 4)
    with pytest.raises(RuntimeError, match="tokenizer"):
        te.generate_structured(PROMPT, 4)
    with pytest.raises(RuntimeError, match="tokenizer"):
        te.encode("hi")
    _, te = engines(weights)
    monkeypatch.setitem(__import__("sys").modules, "jinja2", None)
    monkeypatch.setitem(__import__("sys").modules, "jinja2.sandbox", None)
    with pytest.raises(ImportError):
        te.chat(msgs, 4)


def test_quick_generate(weights):
    _, _, tcfg, tp = weights
    je, te = engines(weights)
    assert quick_generate(tp, tcfg, PROMPT, 6, device="cpu",
                          temperature=0.0) == \
        te.generate(PROMPT, 6, temperature=0.0).tokens


def _serve(sched, reqs):
    rids = [sched.submit(p, n, temperature=0.0, **kw) for p, n, kw in reqs]
    res = sched.run()
    return [(res[r].tokens, res[r].stop_reason) for r in rids]


REQS = [(PROMPT, 24, dict(response_format="json_object",
                          logit_bias={34: 2.5, 123: 1.0})),
        ([2, 8, 11], 40, dict(response_format=RF_SCHEMA)),
        ([1, 5, 42, 7], 16, dict(logit_bias={9: 3.0})),
        ([3, 3, 4], 20, dict())]


@pytest.mark.parametrize("paged,burst", [(False, 1), (False, 4), (True, 4)])
def test_schedulers_response_format_match_jax(weights, paged, burst):
    jcfg, jp, tcfg, tp = weights
    kw = dict(batch_slots=2, decode_burst=burst)
    if paged:
        kw["page_size"] = 8
    icfg = dict(max_seq_len=128, temperature=0.0, seed=0)
    V = jcfg.vocab_size
    js = (JPaged if paged else JContinuous)(
        jp, jcfg, JInferenceConfig(**icfg), tokenizer=JBuiltin(vocab_size=V),
        **kw)
    ts = (PagedContinuousScheduler if paged else ContinuousBatchingScheduler)(
        tp, tcfg, InferenceConfig(**icfg),
        tokenizer=BuiltinTokenizer(vocab_size=V), device="cpu", **kw)
    want, got = _serve(js, REQS), _serve(ts, REQS)
    assert got == want
    tok = BuiltinTokenizer(vocab_size=V)
    doc = json.loads(tok.decode(got[1][0][3:]))
    assert got[1][1] == "stop" and set(doc) == {"name", "age", "tag"}
    assert _legal_prefix(tok.decode(got[0][0][len(PROMPT):]))


def test_constrained_slots_step_singly(weights):
    """With decode_burst=4 a live constrained slot forces single decode
    steps; once it finishes the plain slots burst again."""
    _, _, tcfg, tp = weights
    V = tcfg.vocab_size
    s = ContinuousBatchingScheduler(
        tp, tcfg, InferenceConfig(max_seq_len=128, temperature=0.0, seed=0),
        batch_slots=2, decode_burst=4,
        tokenizer=BuiltinTokenizer(vocab_size=V), device="cpu")
    calls = []
    for name in ("_step_plain", "_step_burst"):
        orig = getattr(s, name)

        def wrapped(orig=orig, name=name):
            calls.append((name, s._has_structured()))
            return orig()
        setattr(s, name, wrapped)
    s.submit([2, 8, 11], 40, response_format=RF_SCHEMA)
    s.submit([3, 3, 4], 60)
    s.run()
    assert all(name == "_step_plain" for name, live in calls if live)
    assert ("_step_burst", False) in calls


def test_response_format_refusals(weights):
    _, _, tcfg, tp = weights
    s = ContinuousBatchingScheduler(tp, tcfg, InferenceConfig(max_seq_len=64),
                                    batch_slots=2, device="cpu")
    with pytest.raises(ValueError, match="tokenizer"):
        s.submit([1, 2], 4, response_format="json_object")
    s.tokenizer = BuiltinTokenizer(vocab_size=tcfg.vocab_size)
    with pytest.raises(ValueError, match="response_format"):
        s.submit([1, 2], 4, response_format="xml")
    with pytest.raises(ValueError):             # SchemaError at submit
        s.submit([1, 2], 4, response_format={
            "type": "json_schema", "json_schema": {"schema": {"$ref": "#/x"}}})
    assert not s.pending
