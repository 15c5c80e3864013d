"""ServingEngine: a thread-safe streaming front over the continuous
batching schedulers (counterpart of turboinfer_tpu/serve/engine.py).

One background thread owns the scheduler and drives step(); HTTP
handler threads submit requests and read per-request token queues.

  - ONE serving thread makes every device call: the scheduler's steps,
    the deferred cancels that finish a slot, and the beam engine's jobs.
    The decode-attention, paged-attention and GEMV kernels share one
    arrival-counter buffer a device (kernels/_build.counters), which is
    right only for launches in order on one stream, and each engine's
    torch.Generator is used only there. Handler threads touch host state
    and queues only.
  - Tokens flow out through one queue.Queue per request as soon as the
    step that produced them completes, so SSE streaming latency is one
    scheduler step.
  - The serving thread sleeps on a condition variable while there is nothing to
    do; a step() that raises fails the affected requests with an
    "error: ..." finish reason and the serving thread lives on.
  - On a mesh (`serve --tp N`), rank 0 holds this engine and every other
    rank runs `follow`. Before each device action the serving thread
    broadcasts the plan since the last one (new requests, cancels, a
    beam job, a step; parallel/comm.broadcast_plan, a gloo group) and
    the followers replay it on their own scheduler, so every rank's
    scheduler takes the same decisions and launches the same
    collectives. An idle server broadcasts an empty plan each second,
    inside the groups' timeout.
  - On a mesh a failure ends the run: a rank that raised may have left
    its peers inside a collective. A follower's error leaves `follow`;
    on rank 0 a step or beam job that raises (or a broadcast to a dead
    follower) fails every open request, sets `error`, stops the serving
    thread and calls `on_error` (serve_forever's shutdown), and
    serve_forever raises. The process exits non-zero and torchrun stops
    the others; a rank that waits on a dead peer raises at the groups'
    timeout.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence

from turboinfer_tpu_torch.parallel import comm


@dataclasses.dataclass
class StreamEnd:
    """Sentinel closing a token stream."""
    stop_reason: str
    prompt_tokens: int
    completion_tokens: int
    logprobs: Optional[List[float]] = None


class ServingEngine:
    """Drives a ContinuousBatchingScheduler from a background thread."""

    def __init__(self, scheduler, tokenizer=None, model_name: str = "model",
                 beam_engine=None, mesh=None):
        """beam_engine: optional InferenceEngine SHARING the scheduler's
        prepared params (InferenceEngine(sched.params,
        params_are_prepared=True)) — backs n-best beam-search requests
        (`use_beam_search` on the HTTP batch path). Beam jobs run on
        the serving thread between scheduler steps, so every device call
        stays on one thread. mesh: the scheduler's mesh on rank 0 of a
        sharded server; the other ranks run follow()."""
        self.sched = scheduler
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._plan: List[tuple] = []
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.beam_engine = beam_engine
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._streams: Dict[int, queue.Queue] = {}
        self._emitted: Dict[int, int] = {}
        self._beam_jobs: Dict[int, Dict[str, Any]] = {}
        self._beam_order: List[int] = []
        self._cancels: List[int] = []
        self._next_beam_id = -1
        self._stats = {"requests": 0, "tokens": 0, "started_at": time.time()}
        self._shutdown = False
        # the failure that ended a sharded run, and who to tell (module
        # docstring)
        self.error: Optional[BaseException] = None
        self.on_error = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="turboinfer-serving")
        self._thread.start()

    # -- request lifecycle -------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               **sampling_kw) -> int:
        V = self.sched.model_config.vocab_size
        bad = [t for t in prompt if not (isinstance(t, int)
                                         and 0 <= t < V)]
        if bad:
            raise ValueError(f"prompt token ids out of vocab range "
                             f"[0,{V}): {bad[:5]}")
        rp = sampling_kw.get("repetition_penalty")
        if rp is not None and rp <= 0:
            raise ValueError("repetition_penalty must be > 0")
        with self._work:
            rid = self.sched.submit(prompt, max_new_tokens, **sampling_kw)
            if self.mesh is not None:
                self._plan.append(("submit", list(prompt), max_new_tokens,
                                   dict(sampling_kw)))
            self._streams[rid] = queue.Queue()
            self._emitted[rid] = 0
            self._stats["requests"] += 1
            self._work.notify()
        return rid

    def submit_beam(self, prompt: Sequence[int], max_new_tokens: int,
                    beam_size: int, **beam_kw) -> int:
        """Queue an n-best beam-search job (needs a beam_engine).
        Returns a (negative) request id; fetch with beam_result()."""
        if self.beam_engine is None:
            raise ValueError("server has no beam engine "
                             "(beam search unavailable)")
        with self._work:
            rid = self._next_beam_id
            self._next_beam_id -= 1
            self._beam_jobs[rid] = dict(prompt=list(prompt),
                                        max_new=max_new_tokens,
                                        beam_size=beam_size, kw=beam_kw)
            self._beam_order.append(rid)
            self._streams[rid] = queue.Queue()
            self._stats["requests"] += 1
            self._work.notify()
        return rid

    def beam_result(self, rid: int, timeout: float = 300.0):
        """Block until the beam job finishes; returns the sorted list of
        GenerationResult (best first, one per beam)."""
        q = self._streams[rid]
        try:
            item = q.get(timeout=timeout)
        finally:
            self._streams.pop(rid, None)
        if isinstance(item, Exception):
            raise item
        return item

    def cancel(self, rid: int):
        with self._work:
            if rid < 0:
                self._beam_jobs.pop(rid, None)
                if rid in self._beam_order:
                    self._beam_order.remove(rid)
                self._streams.pop(rid, None)
                return
            # DEFER to the serving thread: scheduler.cancel writes the
            # device `active` flag, and a beam job may be launching on
            # the serving thread OUTSIDE this lock — calling it here would
            # break the one-thread rule of the module header. Drop the
            # stream at once: a cancelled request has no consumer, and a
            # lingering queue would hold its tokens forever.
            self._streams.pop(rid, None)
            self._emitted.pop(rid, None)
            self._cancels.append(rid)
            self._work.notify()

    def _drain_cancels_locked(self):
        """Serving-thread only (holds the lock): apply deferred
        cancels."""
        for rid in self._cancels:
            if self.mesh is not None:
                self._plan.append(("cancel", rid))
            if self.sched.cancel(rid) and rid in self.sched._done:
                # the serving thread only pumps inside step(); a cancel with an
                # otherwise idle scheduler must deliver StreamEnd itself
                self._pump(rid, self.sched._done.pop(rid))
        self._cancels.clear()

    def stream(self, rid: int, timeout: float = 300.0) -> Iterator[Any]:
        """Yield token ids as they are produced, then one StreamEnd.
        Abandoning the iterator (client disconnect, queue timeout)
        cancels the request so its slot frees immediately."""
        q = self._streams[rid]
        finished = False
        try:
            while True:
                item = q.get(timeout=timeout)
                yield item
                if isinstance(item, StreamEnd):
                    finished = True
                    return
        finally:
            self._streams.pop(rid, None)
            self._emitted.pop(rid, None)
            if not finished:
                self.cancel(rid)

    def result(self, rid: int, timeout: float = 300.0):
        """Block until the request finishes; returns (tokens, StreamEnd)."""
        toks: List[int] = []
        end = None
        for item in self.stream(rid, timeout=timeout):
            if isinstance(item, StreamEnd):
                end = item
            else:
                toks.append(item)
        return toks, end

    def stats(self) -> Dict[str, Any]:
        dt = time.time() - self._stats["started_at"]
        with self._lock:
            return {**self._stats, "uptime_s": dt,
                    "pending": self.sched.pending}

    def shutdown(self):
        with self._work:
            self._shutdown = True
            self._work.notify()
        self._thread.join(timeout=30)

    # -- serving thread -------------------------------------------------------

    def _publish(self, action: Optional[tuple] = None) -> None:
        """Serving thread, lock held: broadcast the plan since the last
        one, then `action`, to the followers (no-op off a mesh)."""
        if self.mesh is None:
            return
        ops = self._plan + ([action] if action is not None else [])
        self._plan = []
        comm.broadcast_plan(ops, self.mesh)

    def _pump(self, rid: int, req) -> None:
        """Push any not-yet-emitted tokens of `req` into its stream."""
        q = self._streams.get(rid)
        if q is None:
            return
        n = self._emitted.get(rid, 0)
        for tok in req.out_tokens[n:]:
            q.put(int(tok))
            self._stats["tokens"] += 1
        self._emitted[rid] = len(req.out_tokens)
        if req.finished:
            q.put(StreamEnd(stop_reason=req.stop_reason,
                            prompt_tokens=len(req.prompt),
                            completion_tokens=len(req.out_tokens),
                            logprobs=list(req.out_logprobs)))

    def _fail_all(self, message: str):
        """Deliver an error StreamEnd to every open stream (a step()
        exception must fail the affected requests, not brick the
        server)."""
        for rid, q in list(self._streams.items()):
            if rid < 0:
                # beam streams: beam_result() re-raises Exceptions; a
                # StreamEnd there would be RETURNED as if it were the
                # results list (TypeError in the handler)
                q.put(RuntimeError(message))
                self._beam_jobs.pop(rid, None)
                if rid in self._beam_order:
                    self._beam_order.remove(rid)
                continue
            q.put(StreamEnd(stop_reason=f"error: {message}",
                            prompt_tokens=0, completion_tokens=0))
        reset_scheduler(self.sched)

    def _run_beam_job(self, rid: int):
        job = self._beam_jobs.pop(rid, None)
        if job is None:
            return
        q = self._streams.get(rid)
        try:
            results = self.beam_engine.generate_beam_search(
                job["prompt"], job["max_new"],
                beam_size=job["beam_size"], return_all_beams=True,
                **job["kw"])
            self._stats["tokens"] += sum(
                len(r.tokens) - len(job["prompt"]) for r in results)
            if q is not None:
                q.put(results)
        except Exception as e:             # noqa: BLE001
            if q is not None:
                q.put(e)
            if self.mesh is not None:
                raise

    def _run(self):
        try:
            self._loop()
        except Exception as e:             # noqa: BLE001 — ends the run
            with self._work:
                self.error = e
                self._fail_all(str(e))
            if self.on_error is not None:
                self.on_error()

    def _loop(self):
        sched = self.sched
        while True:
            with self._work:
                while (not self._shutdown and not sched.pending
                       and not self._beam_order and not self._cancels):
                    if not self._work.wait(timeout=1.0):
                        self._publish()         # the followers' heartbeat
                if self._shutdown:
                    self._publish(("shutdown",))
                    return
                self._drain_cancels_locked()
                beam_rid = (self._beam_order.pop(0)
                            if self._beam_order else None)
                if beam_rid in self._beam_jobs:
                    job = self._beam_jobs[beam_rid]
                    self._publish(("beam", job["prompt"], job["max_new"],
                                   job["beam_size"], job["kw"]))
            if beam_rid is not None:
                # one queued beam job per loop turn, interleaved with
                # scheduler steps. Runs OUTSIDE the condition lock: only
                # same-thread launches are required, and holding the
                # lock for a whole beam generation would block every
                # concurrent submit()/result()/cancel() for its
                # duration.
                self._run_beam_job(beam_rid)
            with self._work:
                if self._shutdown:
                    self._publish(("shutdown",))
                    return
                self._drain_cancels_locked()
                if not sched.pending:
                    continue
                self._publish(("step",))
                try:
                    sched.step()
                except Exception as e:     # noqa: BLE001 — the serving thread must
                    if self.mesh is not None:
                        raise              # (off a mesh) survive any
                    self._fail_all(str(e))  # request error
                    continue
                # pump active slots, then finished requests
                for req in list(sched._active.values()):
                    self._pump(req.rid, req)
                for rid in [r for r in self._streams if r in sched._done]:
                    self._pump(rid, sched._done.pop(rid))
                # finished requests nobody is listening to: drop (their
                # stream was abandoned/timed out)
                for rid in [r for r in sched._done
                            if r not in self._streams]:
                    sched._done.pop(rid)


def reset_scheduler(sched) -> None:
    """Drop every request of a scheduler whose step raised: the active
    slots are cancelled, the queue, an in-flight admission and the
    finished results cleared."""
    for req in list(sched._active.values()):
        sched.cancel(req.rid, reason="error")
    sched._queue.clear()
    sched._adm = None              # abandon an in-flight admission
    sched._done.clear()


def follow(scheduler, mesh, beam_engine=None) -> None:
    """A follower rank of a sharded server: replay rank 0's plans
    (ServingEngine._publish) on this rank's scheduler and beam engine
    until rank 0 shuts down. Results stay here; rank 0 answers. An error
    propagates and ends the run (module docstring)."""
    while True:
        for op in comm.broadcast_plan(None, mesh):
            kind = op[0]
            if kind == "submit":
                scheduler.submit(op[1], op[2], **op[3])
            elif kind == "cancel":
                scheduler.cancel(op[1])
            elif kind == "step":
                scheduler.step()
            elif kind == "beam" and beam_engine is not None:
                beam_engine.generate_beam_search(
                    op[1], op[2], beam_size=op[3], return_all_beams=True,
                    **op[4])
            elif kind == "shutdown":
                return
        scheduler._done.clear()
