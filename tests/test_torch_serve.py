"""The port's serving layer (ServingEngine, the OpenAI-compatible HTTP
server) against turboinfer_tpu's.

The cases of tests/test_serve.py run against a port server on the CPU
(tiny f32 model, the JAX package's weights bridged through numpy). Its
greedy outputs are pinned to the port scheduler's and engine's, and
those to the JAX engine's; one completion and one chat response are
held field by field against a JAX server on the same weights (ids and
times aside).
"""

import http.client
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import turboinfer_tpu as jti
from turboinfer_tpu.engine.scheduler import \
    ContinuousBatchingScheduler as JContinuous
from turboinfer_tpu.models import llama as jllama
from turboinfer_tpu.serve import ServingEngine as JServing
from turboinfer_tpu.serve import make_server as j_make_server
from turboinfer_tpu.tokenizer.bpe import BuiltinTokenizer as JBuiltin
from turboinfer_tpu_torch import bridge
from turboinfer_tpu_torch import config as tconfig
from turboinfer_tpu_torch.engine.engine import InferenceEngine
from turboinfer_tpu_torch.engine.scheduler import ContinuousBatchingScheduler
from turboinfer_tpu_torch.serve import ServingEngine, StreamEnd, make_server
from turboinfer_tpu_torch.tokenizer.bpe import BuiltinTokenizer
from turboinfer_tpu_torch.utils.errors import SchedulerFullError

torch.set_num_threads(2)

_M = {}


def models():
    """(JAX config, JAX params, port config, port params): tiny f32."""
    if not _M:
        jcfg = jti.tiny_config(dtype=jnp.float32)
        jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
        tp = bridge.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        _M.update(jcfg=jcfg, jp=jp, tcfg=tconfig.tiny_config(
            dtype=torch.float32), tp=tp)
    return _M["jcfg"], _M["jp"], _M["tcfg"], _M["tp"]


def icfg(**kw):
    _, _, tcfg, _ = models()
    base = dict(max_seq_len=tcfg.max_seq_len, eos_token_id=-1)
    base.update(kw)
    return tconfig.InferenceConfig(**base)


def _start(eng, maker=make_server):
    srv = maker(eng, host="127.0.0.1", port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture(scope="module")
def served():
    _, _, tcfg, tp = models()
    tok = BuiltinTokenizer(vocab_size=tcfg.vocab_size)
    cfg = icfg(temperature=0.8)
    sched = ContinuousBatchingScheduler(tp, tcfg, cfg, batch_slots=4,
                                        tokenizer=tok, device="cpu")
    beam_eng = InferenceEngine(sched.params, tcfg, cfg, tokenizer=tok,
                               device="cpu", params_are_prepared=True)
    eng = ServingEngine(sched, tokenizer=tok, model_name="tiny-test",
                        beam_engine=beam_eng)
    srv = _start(eng)
    yield eng, srv.server_address[1], tok, cfg
    srv.shutdown()
    eng.shutdown()


def _post(port, path, obj):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, json.dumps(obj),
                 {"Content-Type": "application/json"})
    return conn.getresponse(), conn


def _post_json(port, path, obj):
    resp, conn = _post(port, path, obj)
    body = json.loads(resp.read())
    conn.close()
    return resp.status, body


def _sse_events(resp):
    events, buf = [], b""
    while True:
        chunk = resp.read(1)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            ev, buf = buf.split(b"\n\n", 1)
            if ev.startswith(b"data: "):
                events.append(ev[6:].decode())
        if events and events[-1] == "[DONE]":
            break
    return events


def _engine_greedy(prompt, n):
    """The port engine's and the JAX engine's greedy continuation of the
    same ids (asserted equal)."""
    jcfg, jp, tcfg, tp = models()
    want = InferenceEngine(tp, tcfg, icfg(), device="cpu").generate(
        prompt, n, temperature=0.0).tokens
    jwant = jti.InferenceEngine(jp, jcfg, jti.InferenceConfig(
        max_seq_len=jcfg.max_seq_len, eos_token_id=-1)).generate(
        prompt, n, temperature=0.0).tokens
    assert list(want) == list(jwant)
    return list(want)


def test_serving_engine_matches_generate():
    _, _, tcfg, tp = models()
    want = _engine_greedy([1, 5, 42, 7], 8)
    sched = ContinuousBatchingScheduler(tp, tcfg, icfg(), batch_slots=2,
                                        device="cpu")
    eng = ServingEngine(sched)
    rid = eng.submit([1, 5, 42, 7], 8, temperature=0.0)
    toks, end = eng.result(rid)
    eng.shutdown()
    assert [1, 5, 42, 7] + toks == want
    assert isinstance(end, StreamEnd)
    assert end.completion_tokens == 8 and end.prompt_tokens == 4


def test_health_and_models(served):
    _, port, _, _ = served
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/health")
    r = conn.getresponse()
    assert r.status == 200 and json.loads(r.read())["status"] == "ok"
    conn.request("GET", "/v1/models")
    r = conn.getresponse()
    data = json.loads(r.read())
    conn.close()
    assert data["data"][0]["id"] == "tiny-test"


def test_completions_text_prompt(served):
    from turboinfer_tpu_torch.tokenizer.stream import IncrementalDecoder
    _, port, tok, _ = served
    status, body = _post_json(port, "/v1/completions", {
        "prompt": "hello world", "max_tokens": 8, "temperature": 0})
    assert status == 200
    assert body["object"] == "text_completion"
    assert body["usage"]["completion_tokens"] == 8
    ids = tok.encode("hello world", add_bos=True)
    want = _engine_greedy(ids, 8)[len(ids):]
    dec = IncrementalDecoder(tok)
    assert body["choices"][0]["text"] == "".join(dec.push(t) for t in want)
    assert body["choices"][0]["finish_reason"] == "length"


def test_completions_token_ids_prompt(served):
    _, port, _, _ = served
    status, body = _post_json(port, "/v1/completions", {
        "prompt": [1, 5, 42, 7], "max_tokens": 4, "temperature": 0})
    assert status == 200
    assert body["usage"]["prompt_tokens"] == 4


def test_chat_completions(served):
    _, port, _, _ = served
    status, body = _post_json(port, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi there"}],
        "max_tokens": 6, "temperature": 0})
    assert status == 200
    assert body["object"] == "chat.completion"
    msg = body["choices"][0]["message"]
    assert msg["role"] == "assistant" and isinstance(msg["content"], str)


def test_streaming_sse(served):
    _, port, _, _ = served
    resp, conn = _post(port, "/v1/completions", {
        "prompt": "hello world", "max_tokens": 6, "temperature": 0,
        "stream": True})
    assert resp.status == 200
    assert resp.headers["Content-Type"].startswith("text/event-stream")
    events = _sse_events(resp)
    conn.close()
    assert events[-1] == "[DONE]"
    parsed = [json.loads(e) for e in events[:-1]]
    text = "".join(p["choices"][0]["text"] for p in parsed)
    assert len(text) > 0
    assert parsed[-1]["choices"][0]["finish_reason"] == "length"
    _, body = _post_json(port, "/v1/completions", {
        "prompt": "hello world", "max_tokens": 6, "temperature": 0})
    assert text == body["choices"][0]["text"]


def test_chat_streaming_delta_format(served):
    _, port, _, _ = served
    resp, conn = _post(port, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}],
        "max_tokens": 4, "temperature": 0, "stream": True})
    raw = resp.read().decode()
    conn.close()
    events = [e[6:] for e in raw.split("\n\n") if e.startswith("data: ")]
    assert events[-1] == "[DONE]"
    first = json.loads(events[0])
    assert first["choices"][0]["delta"]["role"] == "assistant"
    assert json.loads(events[-2])["choices"][0]["finish_reason"] \
        in ("stop", "length")


def test_stop_sequence(served):
    _, port, _, _ = served
    _, full = _post_json(port, "/v1/completions", {
        "prompt": "hello world", "max_tokens": 8, "temperature": 0})
    target = full["choices"][0]["text"]
    assert target, "greedy output decodes to empty text"
    _, body = _post_json(port, "/v1/completions", {
        "prompt": "hello world", "max_tokens": 8, "temperature": 0,
        "stop": target[0]})
    assert body["choices"][0]["text"] == ""
    assert body["choices"][0]["finish_reason"] == "stop"


def test_errors(served):
    _, port, _, _ = served
    status, body = _post_json(port, "/v1/completions", {"prompt": ""})
    assert status == 400 and "error" in body
    status, body = _post_json(port, "/v1/chat/completions", {"messages": []})
    assert status == 400
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("POST", "/v1/completions", "{not json",
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    assert r.status == 400
    r.read()
    conn.request("GET", "/nope")
    r = conn.getresponse()
    assert r.status == 404
    r.read()
    conn.close()


def test_concurrent_requests(served):
    _, port, _, _ = served
    results = {}

    def one(i):
        _, body = _post_json(port, "/v1/completions", {
            "prompt": [1 + i, 5, 9], "max_tokens": 6, "temperature": 0})
        results[i] = body

    threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert len(results) == 6
    for body in results.values():
        assert body["usage"]["completion_tokens"] == 6


def test_concurrent_submits_equal_the_scheduler_alone():
    """Eight threads submit at once to a ServingEngine; every token
    stream equals the same requests through the scheduler alone."""
    _, _, tcfg, tp = models()
    ps = [[1 + i, 5, 9, 11 + 3 * i][: 2 + i % 3] for i in range(8)]
    alone = ContinuousBatchingScheduler(tp, tcfg, icfg(), batch_slots=4,
                                        device="cpu")
    rids = [alone.submit(p, 6, temperature=0.0) for p in ps]
    res = alone.run()
    want = [res[r].tokens[len(p):] for r, p in zip(rids, ps)]
    sched = ContinuousBatchingScheduler(tp, tcfg, icfg(), batch_slots=4,
                                        device="cpu")
    eng = ServingEngine(sched)
    got = {}

    def one(i):
        got[i] = eng.result(eng.submit(ps[i], 6, temperature=0.0))[0]

    threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)          # interleave the threads finely
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
    finally:
        sys.setswitchinterval(switch)
    eng.shutdown()
    assert not any(t.is_alive() for t in threads)
    assert [got[i] for i in range(8)] == want
    assert eng.stats()["requests"] == 8 and eng.stats()["tokens"] == 48


def test_metrics_endpoint(served):
    _, port, _, _ = served
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/metrics")
    r = conn.getresponse()
    body = r.read().decode()
    conn.close()
    assert r.status == 200
    assert "turboinfer_requests_total" in body
    assert "turboinfer_pending_requests" in body


def test_logprobs_field(served):
    _, port, _, _ = served
    status, body = _post_json(port, "/v1/completions", {
        "prompt": [1, 5, 9], "max_tokens": 5, "temperature": 0,
        "logprobs": True})
    assert status == 200
    lp = body["choices"][0]["logprobs"]
    assert len(lp["token_logprobs"]) == 5
    assert all(v <= 0.0 for v in lp["token_logprobs"])
    status, body = _post_json(port, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}],
        "max_tokens": 4, "temperature": 0, "logprobs": True})
    assert len(body["choices"][0]["logprobs"]["content"]) == 4


def test_logit_bias_forces_token(served):
    """+100 bias on one token makes greedy pick it every step."""
    _, port, tok, _ = served
    forced = 123
    status, body = _post_json(port, "/v1/completions", {
        "prompt": [1, 5, 9], "max_tokens": 5, "temperature": 0,
        "logit_bias": {str(forced): 100.0}})
    assert status == 200
    assert body["choices"][0]["text"] == tok.decode([forced] * 5)


def test_n_choices(served):
    _, port, _, _ = served
    status, body = _post_json(port, "/v1/completions", {
        "prompt": [1, 5, 9], "max_tokens": 4, "temperature": 1.0, "n": 3})
    assert status == 200
    assert [c["index"] for c in body["choices"]] == [0, 1, 2]
    assert body["usage"]["completion_tokens"] == 12
    status, body = _post_json(port, "/v1/completions", {
        "prompt": [1], "max_tokens": 2, "n": 2, "stream": True})
    assert status == 400


def test_invalid_token_ids_rejected(served):
    _, port, _, _ = served
    for bad in ([-5], [10**9], [1, "x"]):
        status, body = _post_json(port, "/v1/completions", {
            "prompt": bad, "max_tokens": 4})
        assert status == 400, bad
    status, _ = _post_json(port, "/v1/completions", {
        "prompt": [1, 2], "max_tokens": 4, "repetition_penalty": 0})
    assert status == 400


def test_serving_thread_survives_step_exception():
    """A failing step() fails the affected requests with an error
    StreamEnd and the serving thread goes on serving."""
    _, _, tcfg, tp = models()
    sched = ContinuousBatchingScheduler(tp, tcfg, icfg(), batch_slots=2,
                                        device="cpu")
    eng = ServingEngine(sched)
    real_step = sched.step
    calls = {"n": 0}

    def flaky_step():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected failure")
        return real_step()

    sched.step = flaky_step
    rid = eng.submit([1, 2, 3], 4, temperature=0.0)
    _, end = eng.result(rid, timeout=60)
    assert end.stop_reason.startswith("error")
    rid2 = eng.submit([1, 2, 3], 4, temperature=0.0)
    toks2, end2 = eng.result(rid2, timeout=60)
    assert len(toks2) == 4 and end2.stop_reason in ("length", "eos")
    eng.shutdown()


class _FollowerMesh:
    """Rank 0's view of a two-rank mesh for ServingEngine (its plans go
    to comm.broadcast_plan, patched in the tests below)."""
    size, rank = 2, 0


def test_sharded_server_ends_the_run_on_a_step_error(monkeypatch):
    """On a mesh a failed step may leave the followers inside a
    collective: rank 0 answers the open requests with an error, stops
    serving, and serve_forever raises, so the process exits non-zero."""
    from turboinfer_tpu_torch.serve import engine as serve_engine
    from turboinfer_tpu_torch.serve import http_server
    plans = []
    monkeypatch.setattr(serve_engine.comm, "broadcast_plan",
                        lambda ops, mesh: plans.append(ops))
    _, _, tcfg, tp = models()
    sched = ContinuousBatchingScheduler(tp, tcfg, icfg(), batch_slots=2,
                                        device="cpu")

    def broken_step():
        raise RuntimeError("injected failure")

    sched.step = broken_step
    eng = ServingEngine(sched, mesh=_FollowerMesh())
    raised = []

    def serve():
        try:
            http_server.serve_forever(eng, "127.0.0.1", 0)
        except RuntimeError as e:
            raised.append(e)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    while eng.on_error is None:
        time.sleep(0.01)
    _, end = eng.result(eng.submit([1, 2, 3], 4, temperature=0.0),
                        timeout=60)
    t.join(60)
    assert not t.is_alive() and not eng._thread.is_alive()
    assert end.stop_reason == "error: injected failure"
    assert "injected failure" in str(raised[0])
    assert str(eng.error) == "injected failure"
    assert any(("step",) in ops for ops in plans)


def test_a_follower_error_leaves_follow(monkeypatch):
    """A follower whose step raises does not reset and wait for the next
    plan (rank 0 may be inside a collective with it): the error leaves
    follow and ends the process."""
    from turboinfer_tpu_torch.serve import engine as serve_engine
    monkeypatch.setattr(serve_engine.comm, "broadcast_plan",
                        lambda ops, mesh: [("submit", [1, 2, 3], 4, {}),
                                           ("step",)])
    _, _, tcfg, tp = models()
    sched = ContinuousBatchingScheduler(tp, tcfg, icfg(), batch_slots=2,
                                        device="cpu")

    def broken_step():
        raise RuntimeError("injected failure")

    sched.step = broken_step
    with pytest.raises(RuntimeError, match="injected failure"):
        serve_engine.follow(sched, _FollowerMesh())


def test_fail_all_abandons_a_chunked_admission():
    """A step() that fails while a chunked admission is in flight fails
    the admitting request and the live one; the slots it held free up and
    the next requests are served."""
    _, _, tcfg, tp = models()
    cfg = icfg(prefill_chunk=8, prefill_bucket=False)
    sched = ContinuousBatchingScheduler(tp, tcfg, cfg, batch_slots=2,
                                        device="cpu")
    eng = ServingEngine(sched)
    real_step = sched.step
    state = {"fail": True}

    def step():
        if state["fail"] and sched._adm is not None:
            state["fail"] = False
            raise RuntimeError("injected failure mid admission")
        return real_step()

    sched.step = step
    # r2 admits in 5 chunks while r1 (admitted first, 200 tokens) decodes
    r1 = eng.submit([1, 2, 3], 200, temperature=0.0)
    r2 = eng.submit(list(range(1, 41)), 4, temperature=0.0)
    toks1, end1 = eng.result(r1, timeout=60)
    toks2, end2 = eng.result(r2, timeout=60)
    assert not state["fail"]
    assert end1.stop_reason.startswith("error") and len(toks1) < 200
    assert end2.stop_reason.startswith("error") and toks2 == []
    with eng._work:            # the serving thread has left _fail_all
        assert sched._adm is None and not sched._active
        assert sched._free_slots() == [0, 1]
    toks, end = eng.result(eng.submit(list(range(1, 41)), 4,
                                      temperature=0.0), timeout=60)
    assert len(toks) == 4 and end.stop_reason == "length"
    eng.shutdown()


def test_abandoned_stream_cancels_and_reclaims():
    _, _, tcfg, tp = models()
    sched = ContinuousBatchingScheduler(tp, tcfg, icfg(), batch_slots=2,
                                        device="cpu")
    eng = ServingEngine(sched)
    rid = eng.submit([1, 2, 3], 200, temperature=0.0)
    it = eng.stream(rid, timeout=60)
    next(it)                      # consume one token, then walk away
    it.close()                    # generator finalizer -> cancel
    deadline = time.time() + 30
    while time.time() < deadline and (sched._active or sched._done):
        time.sleep(0.2)
    assert not sched._active
    assert not sched._done
    eng.shutdown()


def test_queue_full_raises():
    _, _, tcfg, tp = models()
    sched = ContinuousBatchingScheduler(tp, tcfg, icfg(), batch_slots=1,
                                        max_queue=1, device="cpu")
    sched.submit([1, 2, 3], 4)
    with pytest.raises(SchedulerFullError):
        sched.submit([1, 2, 3], 4)


def test_queue_full_maps_to_429(served):
    eng, port, _, _ = served
    real = eng.submit

    def full(*a, **k):
        raise SchedulerFullError("request queue full (test)")

    eng.submit = full
    try:
        status, body = _post_json(port, "/v1/completions", {
            "prompt": [1, 2], "max_tokens": 4})
    finally:
        eng.submit = real
    assert status == 429
    assert body["error"]["type"] == "rate_limit_exceeded"


def test_echo_prepends_prompt(served):
    _, port, tok, _ = served
    ids = [1, 5, 42, 7]
    _, plain = _post_json(port, "/v1/completions", {
        "prompt": ids, "max_tokens": 4, "temperature": 0})
    _, echoed = _post_json(port, "/v1/completions", {
        "prompt": ids, "max_tokens": 4, "temperature": 0, "echo": True})
    assert echoed["choices"][0]["text"] == \
        tok.decode(ids) + plain["choices"][0]["text"]


def test_completions_response_format_json(served):
    from turboinfer_tpu_torch.structured import json_fsm
    _, port, _, _ = served
    status, body = _post_json(port, "/v1/completions", {
        "prompt": "give me json", "max_tokens": 48, "temperature": 0,
        "response_format": {"type": "json_object"}})
    assert status == 200
    choice = body["choices"][0]
    st = json_fsm.advance_bytes(json_fsm.initial(True),
                                choice["text"].encode())
    assert st is not None, f"illegal prefix: {choice['text']!r}"
    if choice["finish_reason"] == "stop":
        assert isinstance(json.loads(choice["text"]), dict)


def test_completions_response_format_validation(served):
    _, port, _, _ = served
    status, _ = _post_json(port, "/v1/completions", {
        "prompt": "x", "max_tokens": 4,
        "response_format": {"type": "xml"}})
    assert status == 400
    status, _ = _post_json(port, "/v1/completions", {
        "prompt": "x", "max_tokens": 4,
        "response_format": {"type": "text"}})
    assert status == 200


def test_beam_search_http(served):
    """use_beam_search: the n best beams come back as choices, equal to
    the beam engine's own search."""
    eng, port, tok, _ = served
    status, body = _post_json(port, "/v1/completions", {
        "prompt": [1, 5, 9], "max_tokens": 8, "use_beam_search": True,
        "best_of": 4, "n": 2, "logprobs": True})
    assert status == 200
    assert len(body["choices"]) == 2
    assert body["choices"][0]["finish_reason"] in ("stop", "length")
    want = eng.beam_engine.generate_beam_search(
        [1, 5, 9], 8, beam_size=4, return_all_beams=True)
    assert body["choices"][0]["text"] == tok.decode(want[0].tokens[3:])
    lp = body["choices"][0]["logprobs"]["token_logprobs"]
    assert len(lp) == len(want[0].tokens) - 3


def test_beam_search_http_streaming_rejected(served):
    _, port, _, _ = served
    status, _ = _post_json(port, "/v1/completions", {
        "prompt": [1, 5, 9], "max_tokens": 8, "use_beam_search": True,
        "stream": True})
    assert status == 400


def test_beam_engine_shares_the_scheduler_params(served):
    """params_are_prepared=True: the beam engine holds the scheduler's
    own tensors, no copy."""
    eng, _, _, _ = served
    a, b = eng.sched.params["layers"], eng.beam_engine.params["layers"]
    assert eng.beam_engine.params is eng.sched.params
    assert all(a[k] is b[k] for k in a)


def test_best_of_ranking(served):
    _, port, _, _ = served
    status, body = _post_json(port, "/v1/completions", {
        "prompt": [1, 5, 9], "max_tokens": 8, "best_of": 4, "n": 2,
        "temperature": 0.9})
    assert status == 200
    assert len(body["choices"]) == 2
    assert [c["index"] for c in body["choices"]] == [0, 1]
    assert body["usage"]["completion_tokens"] == 32


def test_response_format_json_schema_http(served):
    _, port, _, _ = served
    schema = {"type": "object",
              "properties": {"n": {"type": "integer"},
                             "ok": {"type": "boolean"}},
              "required": ["n", "ok"]}
    status, body = _post_json(port, "/v1/completions", {
        "prompt": "data please", "max_tokens": 64, "temperature": 0.9,
        "response_format": {"type": "json_schema",
                            "json_schema": {"schema": schema}}})
    assert status == 200
    doc = json.loads(body["choices"][0]["text"])
    assert list(doc) == ["n", "ok"]
    assert isinstance(doc["n"], int) and isinstance(doc["ok"], bool)
    status, _ = _post_json(port, "/v1/completions", {
        "prompt": "x", "max_tokens": 8,
        "response_format": {"type": "json_schema",
                            "json_schema": {"schema": {"$ref": "#/x"}}}})
    assert status == 400


def test_best_of_validation(served):
    _, port, _, _ = served
    status, _ = _post_json(port, "/v1/completions", {
        "prompt": [1, 5], "max_tokens": 4, "best_of": 2, "n": 3})
    assert status == 400
    status, _ = _post_json(port, "/v1/completions", {
        "prompt": [1, 5], "max_tokens": 4, "best_of": 2, "stream": True})
    assert status == 400


def test_request_validation_hardening(served):
    _, port, _, _ = served
    status, body = _post_json(port, "/v1/completions", [1, 2, 3])
    assert status == 400 and "error" in body
    status, _ = _post_json(port, "/v1/completions", "hi")
    assert status == 400
    status, body = _post_json(
        port, "/v1/completions", {"prompt": [1, 5], "max_tokens": 0})
    assert status == 400 and "max_tokens" in body["error"]["message"]


def test_structured_stream_finish_reason_stop(served):
    _, port, _, _ = served
    schema = {"type": "object", "required": ["ok"],
              "properties": {"ok": {"type": "boolean"}}}
    resp, conn = _post(port, "/v1/completions", {
        "prompt": [1, 5, 7], "max_tokens": 64, "stream": True,
        "temperature": 0.0,
        "response_format": {"type": "json_schema",
                            "json_schema": {"schema": schema}}})
    assert resp.status == 200
    events = _sse_events(resp)
    conn.close()
    finishes = [json.loads(e)["choices"][0]["finish_reason"]
                for e in events if e != "[DONE]"]
    assert finishes[-1] == "stop"


def test_partial_pool_submit_cleans_up():
    """n > 1 hitting a full queue cancels the part of the pool already
    submitted instead of leaving streams that generate forever."""
    _, _, tcfg, tp = models()
    tok = BuiltinTokenizer(vocab_size=tcfg.vocab_size)
    sched = ContinuousBatchingScheduler(tp, tcfg, icfg(), batch_slots=1,
                                        max_queue=2, tokenizer=tok,
                                        device="cpu")
    eng = ServingEngine(sched, tokenizer=tok, model_name="t")
    srv = _start(eng)
    try:
        status, _ = _post_json(srv.server_address[1], "/v1/completions", {
            "prompt": [1, 5], "max_tokens": 4, "n": 8})
        assert status == 429
        deadline = time.time() + 30
        while time.time() < deadline and eng._streams:
            time.sleep(0.2)
        assert not eng._streams
    finally:
        srv.shutdown()
        eng.shutdown()


@pytest.fixture(scope="module")
def jax_served():
    """A JAX server over the same weights and the same settings as
    `served` (tiny-test, 4 slots, the built-in tokenizer)."""
    jcfg, jp, _, _ = models()
    tok = JBuiltin(vocab_size=jcfg.vocab_size)
    cfg = jti.InferenceConfig(max_seq_len=jcfg.max_seq_len, eos_token_id=-1,
                              temperature=0.8)
    sched = JContinuous(jp, jcfg, cfg, batch_slots=4, tokenizer=tok)
    eng = JServing(sched, tokenizer=tok, model_name="tiny-test")
    srv = _start(eng, j_make_server)
    yield srv.server_address[1]
    srv.shutdown()
    eng.shutdown()


def _same_fields(got, want, path="body"):
    """Equal JSON apart from ids, times and float rounding (1e-4)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            if k not in ("id", "created"):
                _same_fields(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_fields(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-4, (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("route,req", [
    ("/v1/completions", {"prompt": "hello world", "max_tokens": 8,
                         "temperature": 0, "logprobs": True}),
    ("/v1/chat/completions", {"messages": [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": "hi there"}],
        "max_tokens": 6, "temperature": 0, "logprobs": True})],
    ids=["completion", "chat"])
def test_response_matches_a_jax_server_field_by_field(served, jax_served,
                                                      route, req):
    _, port, _, _ = served
    status, got = _post_json(port, route, req)
    jstatus, want = _post_json(jax_served, route, req)
    assert status == jstatus == 200
    _same_fields(got, want)
