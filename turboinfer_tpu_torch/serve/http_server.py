"""OpenAI-compatible HTTP server, standard library only (counterpart of
turboinfer_tpu/serve/http_server.py).

Endpoints:
  GET  /health               liveness + scheduler stats
  GET  /metrics              Prometheus text counters
  GET  /v1/models            model listing
  POST /v1/completions       prompt completion (optional SSE streaming)
  POST /v1/chat/completions  chat completion via the checkpoint's chat
                             template (optional SSE streaming)

Request and response shapes follow the OpenAI API closely enough that
standard clients work (`openai.OpenAI(base_url="http://host:port/v1")`).
Streaming uses `text/event-stream` with `data: {...}` chunks and a
final `data: [DONE]`. Stop sequences are honored server-side: the
stream is cut at the match and the scheduler request cancelled so the
slot frees at once. Handler threads never touch the device: they talk
to the ServingEngine's serving thread (serve/engine.py) through queues.
"""

from __future__ import annotations

import json
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from turboinfer_tpu_torch.serve.engine import ServingEngine, StreamEnd


def _now() -> int:
    return int(time.time())


class _TextAssembler:
    """Incremental UTF-8-safe detokenizer: O(1) per token (see
    tokenizer/stream.py — full re-decode per token is quadratic in
    stream length)."""

    def __init__(self, tokenizer):
        from turboinfer_tpu_torch.tokenizer.stream import IncrementalDecoder
        self._dec = IncrementalDecoder(tokenizer)

    @property
    def ids(self):
        return self._dec.ids

    def push(self, token: int) -> str:
        return self._dec.push(token)


def _find_stop(text: str, stops: List[str],
               scanned: int = 0) -> Optional[int]:
    """Earliest index of any stop string in text, or None. `scanned`:
    characters already checked on previous calls — the scan restarts at
    scanned - (longest stop - 1) so a stop straddling the boundary is
    still caught, keeping per-token work O(len(delta)) instead of
    rescanning the whole completion every token."""
    if not stops:
        return None
    lo = max(0, scanned - (max(len(x) for x in stops) - 1))
    hits = [h for h in (text.find(x, lo) for x in stops if x) if h >= 0]
    return min(hits) if hits else None


class Handler(BaseHTTPRequestHandler):
    server_version = "turboinfer-tpu"
    protocol_version = "HTTP/1.1"
    engine: ServingEngine = None      # set by make_server

    # -- plumbing -----------------------------------------------------------

    def log_message(self, fmt, *args):          # quiet by default
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _json(self, code: int, obj: Dict[str, Any]):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str, etype: str = "invalid_request_error"):
        self._json(code, {"error": {"message": message, "type": etype}})

    def _read_body(self) -> Optional[Dict[str, Any]]:
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError):
            self._error(400, "request body is not valid JSON")
            return None
        if not isinstance(body, dict):
            # a bare array/string/number parses as JSON but crashed the
            # handler at body.get(...) with AttributeError
            self._error(400, "request body must be a JSON object")
            return None
        return body

    # -- routes ---------------------------------------------------------------

    def do_GET(self):
        eng = self.engine
        if self.path == "/health":
            self._json(200, {"status": "ok", **eng.stats()})
        elif self.path == "/metrics":
            st = eng.stats()
            lines = [
                "# TYPE turboinfer_requests_total counter",
                f"turboinfer_requests_total {st['requests']}",
                "# TYPE turboinfer_tokens_generated_total counter",
                f"turboinfer_tokens_generated_total {st['tokens']}",
                "# TYPE turboinfer_pending_requests gauge",
                f"turboinfer_pending_requests {st['pending']}",
                "# TYPE turboinfer_uptime_seconds gauge",
                f"turboinfer_uptime_seconds {st['uptime_s']:.1f}",
            ]
            body = ("\n".join(lines) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path in ("/v1/models", "/models"):
            self._json(200, {"object": "list", "data": [
                {"id": eng.model_name, "object": "model",
                 "created": _now(), "owned_by": "turboinfer-tpu"}]})
        else:
            self._error(404, f"no route {self.path}")

    def do_POST(self):
        if self.path in ("/v1/completions", "/completions"):
            self._completions(chat=False)
        elif self.path in ("/v1/chat/completions", "/chat/completions"):
            self._completions(chat=True)
        else:
            self._error(404, f"no route {self.path}")

    # -- completion core -----------------------------------------------------

    def _encode_prompt(self, body: Dict[str, Any], chat: bool
                       ) -> Optional[Tuple[List[int], str]]:
        tok = self.engine.tokenizer
        if chat:
            messages = body.get("messages")
            if not isinstance(messages, list) or not messages:
                self._error(400, "'messages' must be a non-empty list")
                return None
            if tok is None:
                self._error(400, "server has no tokenizer; chat endpoint "
                                 "unavailable")
                return None
            ids = tok.apply_chat_template(messages, tokenize=True)
            return ids, "chat.completion"
        prompt = body.get("prompt")
        if isinstance(prompt, list) and all(isinstance(t, int)
                                            for t in prompt) and prompt:
            return list(prompt), "text_completion"
        if isinstance(prompt, str) and prompt:
            if tok is None:
                self._error(400, "server has no tokenizer; send token-id "
                                 "prompts")
                return None
            return tok.encode(prompt, add_bos=True), "text_completion"
        self._error(400, "'prompt' must be a non-empty string or "
                         "list of token ids")
        return None

    def _completions(self, chat: bool):
        body = self._read_body()
        if body is None:
            return
        enc = self._encode_prompt(body, chat)
        if enc is None:
            return
        prompt_ids, obj_kind = enc
        eng = self.engine
        mt = body.get("max_tokens")
        max_new = 128 if mt is None else int(mt)
        if max_new < 1:
            self._error(400, "max_tokens must be >= 1")
            return

        def fget(key):
            v = body.get(key)
            return None if v is None else float(v)
        top_k = body.get("top_k")
        stops = body.get("stop") or []
        if isinstance(stops, str):
            stops = [stops]
        stream = bool(body.get("stream"))
        n = max(1, int(body.get("n") or 1))
        if stream and n > 1:
            self._error(400, "streaming with n>1 is not supported")
            return
        lb = body.get("logit_bias") or None
        if lb is not None:
            try:
                lb = {int(k): float(v) for k, v in lb.items()}
            except (ValueError, AttributeError):
                self._error(400, "'logit_bias' must map token ids to "
                                 "biases")
                return
        rf = body.get("response_format") or None
        if rf is not None:
            t = rf.get("type") if isinstance(rf, dict) else str(rf)
            if t in (None, "text"):
                rf = None
            elif t in ("json", "json_object"):
                rf = t
            elif t == "json_schema":
                pass                    # dict passes through; the
                #                         scheduler compiles + validates
            else:
                self._error(400, f"unsupported response_format '{t}'")
                return
            if rf is not None and self.engine.sched.tokenizer is None:
                self._error(400, "response_format needs a tokenizer-"
                                 "backed server")
                return
        kw = dict(temperature=fget("temperature"),
                  top_k=None if top_k is None else int(top_k),
                  top_p=fget("top_p"), min_p=fget("min_p"),
                  repetition_penalty=fget("repetition_penalty"),
                  presence_penalty=fget("presence_penalty"),
                  frequency_penalty=fget("frequency_penalty"),
                  logit_bias=lb, response_format=rf)
        cid = f"cmpl-{uuid.uuid4().hex[:24]}"
        want_lp = bool(body.get("logprobs"))
        echo = bool(body.get("echo")) and not chat
        best_of = int(body.get("best_of") or 0)
        if bool(body.get("use_beam_search")):
            # n-best BEAM search (vLLM-style flag): one fused beam
            # program on the shared-params beam engine; returns the n
            # best length-normalized beams.
            if stream:
                self._error(400, "use_beam_search does not support "
                                 "streaming")
                return
            if eng.beam_engine is None:
                self._error(400, "server has no beam engine")
                return
            beam_size = max(best_of, n, 2)
            try:
                rid = eng.submit_beam(
                    prompt_ids, max_new, beam_size,
                    temperature=fget("temperature"),
                    top_k=None if top_k is None else int(top_k),
                    top_p=fget("top_p"),
                    length_penalty=fget("length_penalty"))
                results = eng.beam_result(rid)
            except ValueError as e:
                self._error(400, str(e))
                return
            self._beam_response(results[:n], cid, obj_kind, chat,
                                len(prompt_ids), want_lp)
            return
        if best_of:
            # OpenAI semantics: best_of must be >= n and is invalid
            # with streaming (matching their 400s, not silent drops).
            if best_of < n:
                self._error(400, "best_of must be greater than or "
                                 "equal to n")
                return
            if stream and best_of > 1:
                self._error(400, "best_of is not supported with "
                                 "streaming")
                return
        rank_pool = best_of if best_of > n else n
        rids = []
        try:
            for _ in range(rank_pool):
                rids.append(eng.submit(prompt_ids, max_new, **kw))
        except ValueError as e:
            for r in rids:        # partial pool: don't leak the rest
                eng.cancel(r)
            self._error(400, str(e))
            return
        except Exception as e:
            from turboinfer_tpu_torch.utils.errors import SchedulerFullError
            for r in rids:
                # without this, a mid-pool SchedulerFullError left the
                # already-submitted requests generating to completion
                # into stream queues nobody would ever drain
                eng.cancel(r)
            if isinstance(e, SchedulerFullError):
                self._error(429, str(e), etype="rate_limit_exceeded")
                return
            raise
        if stream:
            self._stream_response(rids[0], cid, obj_kind, stops, chat)
        else:
            self._block_response(rids, cid, obj_kind, stops, chat,
                                 len(prompt_ids), want_lp,
                                 prompt_ids if echo else None,
                                 keep_n=n)

    def _beam_response(self, results, cid, kind, chat, n_prompt,
                       want_lp):
        """Render n-best beam GenerationResults as OpenAI choices."""
        eng = self.engine
        tok = eng.tokenizer
        choices = []
        completion = 0
        for index, res in enumerate(results):
            ids = res.tokens[n_prompt:]
            completion += len(ids)
            text = tok.decode(ids) if tok is not None else ""
            reason = {"eos": "stop"}.get(res.stop_reason, "length")
            choice = ({"index": index,
                       "message": {"role": "assistant", "content": text},
                       "finish_reason": reason} if chat else
                      {"index": index, "text": text,
                       "finish_reason": reason})
            if want_lp and res.logprobs is not None:
                toks = [tok.decode([t]) if tok else str(t) for t in ids]
                lps = res.logprobs[:len(ids)]
                if chat:
                    choice["logprobs"] = {"content": [
                        {"token": t, "logprob": l}
                        for t, l in zip(toks, lps)]}
                else:
                    choice["logprobs"] = {"tokens": toks,
                                          "token_logprobs": lps}
            choices.append(choice)
        self._json(200, {
            "id": cid, "object": kind, "created": _now(),
            "model": eng.model_name, "choices": choices,
            "usage": {"prompt_tokens": n_prompt,
                      "completion_tokens": completion,
                      "total_tokens": n_prompt + completion}})

    def _block_response(self, rids, cid, kind, stops, chat, n_prompt,
                        want_lp=False, echo_ids=None, keep_n=None):
        eng = self.engine
        choices = []
        mean_lps = []
        usage = {"prompt_tokens": 0, "completion_tokens": 0}
        for index, rid in enumerate(rids):
            asm = _TextAssembler(eng.tokenizer)
            text, end = "", None
            for item in eng.stream(rid):
                if isinstance(item, StreamEnd):
                    end = item
                    break
                scanned = len(text)
                text += asm.push(item)
                cut = _find_stop(text, stops, scanned)
                if cut is not None:
                    text = text[:cut]
                    eng.cancel(rid)
                    end = StreamEnd("stop", n_prompt, len(asm.ids))
                    break
            if end.stop_reason.startswith("error"):
                # a step() failure must surface as an error, not a 200
                # that looks like a length-capped completion
                self._error(500, end.stop_reason, etype="server_error")
                return
            reason = {"eos": "stop", "stop": "stop"}.get(end.stop_reason,
                                                         "length")
            if echo_ids is not None and eng.tokenizer is not None:
                text = eng.tokenizer.decode(echo_ids) + text
            choice = ({"index": index,
                       "message": {"role": "assistant", "content": text},
                       "finish_reason": reason} if chat else
                      {"index": index, "text": text,
                       "finish_reason": reason})
            if want_lp and end.logprobs is not None:
                tok = eng.tokenizer
                toks = [tok.decode([t]) if tok else str(t)
                        for t in asm.ids]
                lps = end.logprobs[:len(asm.ids)]
                if chat:
                    choice["logprobs"] = {"content": [
                        {"token": t, "logprob": l}
                        for t, l in zip(toks, lps)]}
                else:
                    choice["logprobs"] = {"tokens": toks,
                                          "token_logprobs": lps}
            choices.append(choice)
            lps = (end.logprobs or [])[:len(asm.ids)]
            mean_lps.append(sum(lps) / max(len(lps), 1))
            usage["prompt_tokens"] = end.prompt_tokens
            usage["completion_tokens"] += end.completion_tokens
        if keep_n is not None and keep_n < len(choices):
            # OpenAI best_of ranking: keep the n best candidates by
            # mean token logprob
            order = sorted(range(len(choices)),
                           key=lambda i: -mean_lps[i])[:keep_n]
            choices = [choices[i] for i in order]
            for i, c in enumerate(choices):
                c["index"] = i
        self._json(200, {
            "id": cid, "object": kind, "created": _now(),
            "model": eng.model_name, "choices": choices,
            "usage": {**usage,
                      "total_tokens": usage["prompt_tokens"]
                      + usage["completion_tokens"]}})

    def _sse(self, obj: Dict[str, Any]):
        self.wfile.write(b"data: " + json.dumps(obj).encode() + b"\n\n")
        self.wfile.flush()

    def _stream_response(self, rid, cid, kind, stops, chat):
        eng = self.engine
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        # chunked framing helper (we declared HTTP/1.1 + chunked)
        raw = self.wfile

        class _Chunked:
            def write(self, b):
                raw.write(f"{len(b):X}\r\n".encode() + b + b"\r\n")

            def flush(self):
                raw.flush()
        self.wfile = _Chunked()

        obj_kind = "chat.completion.chunk" if chat else "text_completion"

        def chunk(delta_obj, finish=None):
            choice = {"index": 0, "finish_reason": finish}
            if chat:
                choice["delta"] = delta_obj
            else:
                choice["text"] = delta_obj
            return {"id": cid, "object": obj_kind, "created": _now(),
                    "model": eng.model_name, "choices": [choice]}

        try:
            if chat:
                self._sse(chunk({"role": "assistant", "content": ""}))
            asm = _TextAssembler(eng.tokenizer)
            emitted = ""
            finish = "stop"
            for item in eng.stream(rid):
                if isinstance(item, StreamEnd):
                    finish = {"eos": "stop", "stop": "stop"}.get(
                        item.stop_reason,
                        "error" if item.stop_reason.startswith("error")
                        else "length")
                    break
                delta = asm.push(item)
                if not delta:
                    continue
                total = emitted + delta
                cut = _find_stop(total, stops, len(emitted))
                if cut is not None:
                    delta = total[len(emitted):cut]
                    if delta:
                        self._sse(chunk({"content": delta} if chat
                                        else delta))
                    eng.cancel(rid)
                    finish = "stop"
                    break
                emitted = total
                self._sse(chunk({"content": delta} if chat else delta))
            self._sse(chunk({} if chat else "", finish=finish))
            self.wfile.write(b"data: [DONE]\n\n")
            raw.write(b"0\r\n\r\n")       # chunked EOF
            raw.flush()
        except (BrokenPipeError, ConnectionResetError):
            eng.cancel(rid)
        finally:
            self.wfile = raw


def make_server(engine: ServingEngine, host: str = "0.0.0.0",
                port: int = 8000, verbose: bool = False
                ) -> ThreadingHTTPServer:
    handler = type("BoundHandler", (Handler,), {"engine": engine})
    srv = ThreadingHTTPServer((host, port), handler)
    srv.verbose = verbose
    return srv


def serve_forever(engine: ServingEngine, host: str = "0.0.0.0",
                  port: int = 8000, verbose: bool = False):
    """Serve until interrupted; raises the engine's error when a failure
    ended a sharded run (serve/engine.py)."""
    srv = make_server(engine, host, port, verbose)
    engine.on_error = srv.shutdown
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        engine.shutdown()
    if engine.error is not None:
        raise RuntimeError(f"serving stopped: {engine.error}") from \
            engine.error
