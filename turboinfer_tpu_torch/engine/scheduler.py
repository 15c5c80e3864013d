"""Continuous batching over a fixed pool of batch slots (counterpart of
turboinfer_tpu/engine/scheduler.py).

ContinuousBatchingScheduler keeps one contiguous KV cache of B slots:
requests queue, admit into free slots with a batched prefill, and every
step decodes all B slots at once (inactive slots run at a frozen length
and are discarded), so a finished request's slot takes the next request
at once. PagedContinuousScheduler keeps the cache in a page pool instead
(engine/paged_cache.py): memory follows the tokens in use, and prompt
pages are shared between requests with a common prefix.

Each request carries its own sampling knobs (temperature, top-k, top-p,
min-p, penalties, logit_bias) in per-slot device tensors. A
response_format (JSON object or JSON Schema; needs the scheduler's
tokenizer) constrains a request by its grammar: after each token the
host advances the grammar state and writes the next state's mask (with
the request's logit_bias) into the slot's bias row, so bursts fall back
to single steps while a constrained slot is live. With a draft
model every step can be a speculative round: the draft proposes spec_k
tokens per slot, one target pass verifies them, and rejection sampling
accepts a prefix; greedy slots keep the plain trajectory exactly.

With config.prefill_chunk > 0 and decodes live, the contiguous
scheduler admits a long prompt in chunks: one prefill_chunk-wide
forward into a small cache per step(), each followed by the live slots'
decode step, so running requests never stall for a whole prompt; the
last chunk samples the first tokens and copies the small cache into the
slots. An idle scheduler, a scheduler with a draft model, and the paged
scheduler (which takes prefill_chunk and never chunks, as JAX's) prefill
at full width.

The JAX package's jitted programs are plain methods here, run eagerly
on the scheduler's device. A step moves its results to the host with
ONE device-to-host copy; the paged block table is uploaded only when
the host changed it. On a (data, tp) mesh (parallel/mesh.py) every rank
runs the same scheduler over its slice of the weights and of the KV
heads (parallel/shardings.py: the family's spec set, the draft's
family's for a draft model); the slots and page tables are host state
that every rank keeps alike, so the slot caches replicate over the data
axis. Not ported yet: pipeline and context parallelism (ROADMAP §1 item
13).
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from turboinfer_tpu_torch.config import InferenceConfig, ModelConfig
from turboinfer_tpu_torch.engine import paged_cache as pc
from turboinfer_tpu_torch.engine import sampling
from turboinfer_tpu_torch.engine.engine import (GenerationResult, _bucket,
                                               _to_host)
from turboinfer_tpu_torch.engine.speculative import (emit_layout,
                                                     rejection_accept)
from turboinfer_tpu_torch.kernels.dispatch import prepare_params
from turboinfer_tpu_torch.models import registry
from turboinfer_tpu_torch.models.common import (KVCache, check_kv_dtype,
                                                params_to, resolve_kv_dtype)
from turboinfer_tpu_torch.parallel import shardings
from turboinfer_tpu_torch.structured import TokenMaskCache
from turboinfer_tpu_torch.structured.schema_fsm import SchemaFSM
from turboinfer_tpu_torch.utils.device import resolve_device
from turboinfer_tpu_torch.utils.errors import SchedulerFullError


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: List[int]
    max_new: int
    submitted_at: float
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    out_logprobs: List[float] = dataclasses.field(default_factory=list)
    slot: int = -1
    prefill_ms: float = 0.0
    finished: bool = False
    finished_at: float = 0.0             # perf_counter at completion
    stop_reason: str = "length"
    # per-request sampling overrides (None -> InferenceConfig defaults)
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    min_p: Optional[float] = None
    repetition_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    frequency_penalty: Optional[float] = None
    logit_bias: Optional[Dict[int, float]] = None
    # constrained decoding: "json" | "json_object" |
    # ("schema", <canonical schema json>) | None
    response_format: object = None
    struct_state: object = None          # live grammar state (FSM)
    user_bias: Optional[np.ndarray] = None   # logit_bias row under a grammar


def _normalize_response_format(rf):
    """The API forms of a response_format -> a hashable normal form:
    None | "json" | "json_object" | ("schema", canonical json). Raises
    ValueError for anything else; a schema compiles here, so its errors
    surface at submit time, not mid-decode (JAX
    _normalize_response_format)."""
    if rf in (None, "json", "json_object"):
        return rf
    if isinstance(rf, dict):
        t = rf.get("type")
        if t in ("json", "json_object"):
            return t
        if t == "json_schema":
            js = rf.get("json_schema") or {}
            schema = js.get("schema") if isinstance(js, dict) else None
            if schema is None and isinstance(rf.get("schema"), dict):
                schema = rf["schema"]
            if not isinstance(schema, dict):
                raise ValueError(
                    "response_format json_schema needs "
                    "{'type':'json_schema','json_schema':{'schema': {...}}}")
            SchemaFSM(schema)          # compile now; raises
            # no sort_keys: property ORDER is semantic (emitted keys
            # follow the schema's declaration order)
            return ("schema", json.dumps(schema, separators=(",", ":")))
    raise ValueError(f"unsupported response_format '{rf}'")


class ContinuousBatchingScheduler:
    """Slot-pool scheduler driving one shared KV cache.

        sched = ContinuousBatchingScheduler(params, model_config, config,
                                            batch_slots=8)
        ids = [sched.submit(p, max_new) for p in prompts]
        results = sched.run()     # {rid: GenerationResult}

    device: "cuda" (default) runs the Hopper kernels; "cpu" runs their
    plain PyTorch versions and must be asked for.
    """

    def __init__(self, params: Dict[str, Any], model_config: ModelConfig,
                 config: Optional[InferenceConfig] = None,
                 batch_slots: int = 8, decode_burst: int = 1,
                 max_queue: Optional[int] = None, mesh=None,
                 parallel: str = "tp",
                 draft_params: Optional[Dict[str, Any]] = None,
                 draft_config: Optional[ModelConfig] = None,
                 spec_k: int = 4, tokenizer=None, device="cuda"):
        """decode_burst > 1 runs that many decode steps per host round
        trip (admission happens between bursts; a slot that finishes
        mid-burst idles for the rest of it). draft_params/draft_config
        attach a draft model for speculative rounds of spec_k tokens.
        tokenizer: the vocab the response_format grammars mask.
        mesh: a parallel.mesh.Mesh; the scheduler then runs on mesh.device
        with this rank's slice of the weights under its family's spec set
        (module docstring)."""
        if parallel != "tp":
            raise NotImplementedError(
                f"parallel={parallel!r} (pipeline / context parallelism) is "
                "not ported yet: ROADMAP §1 item 13, the next slice")
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(
            device)
        module = registry.get_model(model_config.architecture)
        module.check_supported(model_config)
        self._model = shardings.rank_model(module, model_config, mesh)
        # the config this rank's caches and page pools are shaped by
        self._rank_config = shardings.rank_config(model_config, mesh)
        self.model_config = model_config
        self.config = config or InferenceConfig(
            max_seq_len=model_config.max_seq_len)
        # cache storage dtype (models/common.resolve_kv_dtype); the draft
        # cache takes the same setting at the draft's dtype
        self._kv_dtype = resolve_kv_dtype(self.config.kv_cache_dtype,
                                          model_config.dtype)
        check_kv_dtype(module, model_config.architecture, self._kv_dtype)
        self.params = prepare_params(params_to(shardings.rank_params(
            params, model_config, mesh), self.device))
        self.B = batch_slots
        self.T = self.config.max_seq_len
        self.decode_burst = max(1, int(decode_burst))
        self.max_queue = max_queue
        self._gen = torch.Generator(device=self.device).manual_seed(
            self.config.seed)
        self._queue: Deque[_Request] = deque()
        self._active: Dict[int, _Request] = {}       # slot -> request
        self._done: Dict[int, _Request] = {}
        self._next_id = 0
        self._adm: Optional[Dict[str, Any]] = None   # chunked admission
        # constrained decoding: one TokenMaskCache (token trie + per-state
        # masks) per normalized response_format, built at first use
        self.tokenizer = tokenizer
        self._maskers: Dict[Any, TokenMaskCache] = {}
        self.cache = self._make_cache()
        dev, B, c = self.device, self.B, self.config

        def full(v, dtype):
            return torch.full((B,), v, dtype=dtype, device=dev)
        self.tokens = full(0, torch.int32)
        self.active = full(False, torch.bool)
        self.budget = full(0, torch.int32)           # remaining tokens
        # per-slot sampling knobs (requests may override the defaults)
        self.slot_temp = full(c.temperature, torch.float32)
        self.slot_topk = full(c.top_k, torch.int32)
        self.slot_topp = full(c.top_p, torch.float32)
        self.slot_minp = full(c.min_p, torch.float32)
        self.slot_rep = full(c.repetition_penalty, torch.float32)
        self.slot_pres = full(c.presence_penalty, torch.float32)
        self.slot_freq = full(c.frequency_penalty, torch.float32)
        V = model_config.vocab_size
        # per-slot seen-token counts for the penalties (prompt / output)
        self.counts_prompt = torch.zeros((B, V), dtype=torch.int32, device=dev)
        self.counts_out = torch.zeros((B, V), dtype=torch.int32, device=dev)
        self.slot_bias = torch.zeros((B, V), dtype=torch.float32, device=dev)
        # -- speculative decoding state --------------------------------
        self.spec_k = int(spec_k)
        self._dmodel = None
        self.spec_proposed = 0
        self.spec_accepted = 0
        # host mirror of how many confirmed tokens each slot's DRAFT cache
        # holds: plain and burst steps advance only the target cache, and
        # _spec_catchup feeds the draft the gap before the next round
        self._spec_dlen: Dict[int, int] = {}
        # slot samples with temperature/top-k/top-p only (a spec round
        # covers those; penalties and bias need plain steps)
        self._slot_plain = [True] * B
        if draft_params is not None:
            if draft_config is None:
                raise ValueError("draft_params requires draft_config")
            dmodule = registry.get_model(draft_config.architecture)
            dmodule.check_supported(draft_config)
            self._dmodel = shardings.rank_model(dmodule, draft_config, mesh)
            self._dkv_dtype = resolve_kv_dtype(self.config.kv_cache_dtype,
                                               draft_config.dtype)
            check_kv_dtype(dmodule, draft_config.architecture,
                           self._dkv_dtype)
            self.draft_config = draft_config
            self.draft_params = prepare_params(params_to(
                shardings.rank_params(draft_params, draft_config, mesh),
                dev))
            self.dcache = self._dmodel.init_cache(draft_config, B,
                                                  max_seq=self.T,
                                                  dtype=self._dkv_dtype,
                                                  device=dev)

    def _make_cache(self):
        """The shared slot-pool cache (the paged scheduler overrides)."""
        return self._model.init_cache(self.model_config, self.B,
                                      max_seq=self.T, dtype=self._kv_dtype,
                                      device=self.device)

    def _hit_max_seq(self, req) -> bool:
        return len(req.prompt) + len(req.out_tokens) >= self.T

    # -- device programs ------------------------------------------------

    def _sample(self, logits, counts_out):
        """Per-slot sample of logits [B, V] (bias already added) ->
        (nxt, lp)."""
        nxt = sampling.sample_per_slot(
            self._gen, logits, self.slot_temp, self.slot_topk,
            self.slot_topp, min_p=self.slot_minp,
            repetition_penalty=self.slot_rep,
            presence_penalty=self.slot_pres,
            frequency_penalty=self.slot_freq,
            counts=self.counts_prompt + counts_out, out_counts=counts_out)
        return nxt, sampling.token_logprob(logits, nxt)

    def _count(self, nxt, active) -> None:
        """counts_out[b, nxt[b]] += active[b]."""
        rows = torch.arange(self.B, device=self.device)
        self.counts_out[rows, nxt.long()] += active.to(torch.int32)

    def _decode_fn(self):
        """One decode step for every slot; inactive slots run at a frozen
        cache length. -> (nxt, lp, hit_eos)."""
        old_len = self.cache.length
        logits, cache = self._model.forward(
            self.params, self.model_config, self.tokens[:, None], self.cache)
        nxt, lp = self._sample(logits[:, 0] + self.slot_bias,
                               self.counts_out)
        self._count(nxt, self.active)
        self.cache = cache._replace(
            length=torch.where(self.active, cache.length, old_len))
        return nxt, lp, self.active & (nxt == self.config.eos_token_id)

    def _decode_burst_fn(self, n: int):
        """n decode steps with no host round trip: each slot samples,
        spends budget and deactivates on EOS, budget or a full cache on
        the device. -> per-step (token, was_active, hit_eos, logprob)
        stacked [n, B]."""
        eos, T = self.config.eos_token_id, self.T
        toks, was, eoss, lps = [], [], [], []
        for _ in range(n):
            old_len = self.cache.length
            logits, cache = self._model.forward(
                self.params, self.model_config, self.tokens[:, None],
                self.cache)
            nxt, lp = self._sample(logits[:, 0] + self.slot_bias,
                                   self.counts_out)
            self._count(nxt, self.active)
            new_len = torch.where(self.active, cache.length, old_len)
            self.cache = cache._replace(length=new_len)
            hit = self.active & (nxt == eos)
            self.budget = self.budget - self.active.to(torch.int32)
            toks.append(nxt)
            was.append(self.active)
            eoss.append(hit)
            lps.append(lp)
            self.tokens = torch.where(self.active, nxt, self.tokens)
            self.active = (self.active & ~hit & (self.budget > 0)
                           & (new_len < T))
        return [torch.stack(a) for a in (toks, was, eoss, lps)]

    def _prefill_small(self, model, cfg, params, tokens, seq_lens, dtype):
        """Cold prefill of m prompts [m, S] into a fresh S-wide cache of
        `dtype` -> (last-position logits [m, V], small cache)."""
        small = model.init_cache(cfg, tokens.shape[0], max_seq=tokens.shape[1],
                                 dtype=dtype, device=self.device)
        idx = (seq_lens - 1).clamp(min=0)
        logits, small = model.forward(params, cfg, tokens, small,
                                      seq_lens=seq_lens, logit_idx=idx,
                                      fresh_prefill=True)
        return logits[:, 0], small

    @staticmethod
    def _scatter_into_slots(cache: KVCache, small: KVCache, slots,
                            seq_lens) -> KVCache:
        """Copy a freshly prefilled small cache's rows (and an int8
        cache's scales) into their slots. Only the first S positions are
        written; a slot's positions past its length are never read."""
        S = small.k.shape[3]
        cache.k[:, slots, :, :S] = small.k
        cache.v[:, slots, :, :S] = small.v
        if cache.k_scale is not None:
            cache.k_scale[:, slots, :, :S] = small.k_scale
            cache.v_scale[:, slots, :, :S] = small.v_scale
        length = cache.length.clone()
        length[slots] = seq_lens
        return cache._replace(length=length)

    def _sample_first(self, last, knobs):
        """Each admitted row's first token from its last-position logits
        [m, V] under its own knobs -> (first, lp, the biased logits)."""
        (t, k, p), (minp, rep, pres, freq), pc_rows, bias_rows = knobs
        last = last + bias_rows
        first = sampling.sample_per_slot(
            self._gen, last, t, k, p, min_p=minp, repetition_penalty=rep,
            presence_penalty=pres, frequency_penalty=freq, counts=pc_rows,
            out_counts=torch.zeros_like(pc_rows))
        return first, sampling.token_logprob(last, first), last

    def _prefill_fn(self, tokens, seq_lens, slots, knobs):
        """Batched admission prefill of m prompts [m, S] into `slots`;
        samples each row's first token with its own knobs. With a draft
        model the draft cache is prefilled on the same prompts."""
        last, small = self._prefill_small(self._model, self.model_config,
                                          self.params, tokens, seq_lens,
                                          self._kv_dtype)
        first, first_lp, _ = self._sample_first(last, knobs)
        self.cache = self._scatter_into_slots(self.cache, small, slots,
                                              seq_lens)
        if self._dmodel is not None:
            _, dsmall = self._prefill_small(self._dmodel, self.draft_config,
                                            self.draft_params, tokens,
                                            seq_lens, self._dkv_dtype)
            self.dcache = self._scatter_into_slots(self.dcache, dsmall, slots,
                                                   seq_lens)
        return first, first_lp

    # -- public API ------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 50, *,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               min_p: Optional[float] = None,
               repetition_penalty: Optional[float] = None,
               presence_penalty: Optional[float] = None,
               frequency_penalty: Optional[float] = None,
               logit_bias: Optional[Dict[int, float]] = None,
               response_format=None) -> int:
        if len(prompt) == 0:
            raise ValueError("prompt must be non-empty")
        response_format = _normalize_response_format(response_format)
        if response_format is not None and self.tokenizer is None:
            raise ValueError("response_format needs a scheduler tokenizer "
                             "(ContinuousBatchingScheduler(tokenizer=...))")
        if len(prompt) >= self.T:
            raise ValueError(f"prompt length {len(prompt)} >= max_seq_len")
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            raise SchedulerFullError(
                f"request queue full ({self.max_queue} waiting)")
        rid = self._next_id
        self._next_id += 1
        self._queue.append(_Request(
            rid=rid, prompt=list(prompt), max_new=max_new_tokens,
            submitted_at=time.perf_counter(), temperature=temperature,
            top_k=top_k, top_p=top_p, min_p=min_p,
            repetition_penalty=repetition_penalty,
            presence_penalty=presence_penalty,
            frequency_penalty=frequency_penalty, logit_bias=logit_bias,
            response_format=response_format))
        return rid

    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        """Abort a queued or running request (its slot frees for the next
        admission)."""
        for i, req in enumerate(self._queue):
            if req.rid == rid:
                del self._queue[i]
                req.finished = True
                req.finished_at = time.perf_counter()
                req.stop_reason = reason
                self._done[rid] = req
                return True
        for slot, req in list(self._active.items()):
            if req.rid == rid:
                self._finish(slot, reason)
                return True
        for req in self._adm["group"] if self._adm is not None else ():
            if req.rid == rid and not req.finished:
                # mid chunked admission: the group's chunks keep running
                # at their shapes, but _activate_prefilled skips the row
                req.finished = True
                req.finished_at = time.perf_counter()
                req.stop_reason = reason
                self._done[rid] = req
                return True
        return False

    def get_request(self, rid: int):
        """Live view of a submitted request."""
        if rid in self._done:
            return self._done[rid]
        adm = self._adm["group"] if self._adm is not None else []
        for req in list(self._active.values()) + list(self._queue) + adm:
            if req.rid == rid:
                return req
        return None

    def _set_slot_sp(self, slot: int, req: _Request):
        """Write the request's sampling knobs, prompt token counts and
        logit bias into the slot's rows and return them as one-row
        tensors for the prefill sample."""
        c, dev = self.config, self.device

        def pick(v, d):
            return d if v is None else v
        t = pick(req.temperature, c.temperature)
        k = pick(req.top_k, c.top_k)
        p = pick(req.top_p, c.top_p)
        mp = pick(req.min_p, c.min_p)
        rep = pick(req.repetition_penalty, c.repetition_penalty)
        pres = pick(req.presence_penalty, c.presence_penalty)
        freq = pick(req.frequency_penalty, c.frequency_penalty)
        for arr, v in ((self.slot_temp, t), (self.slot_topk, k),
                       (self.slot_topp, p), (self.slot_minp, mp),
                       (self.slot_rep, rep), (self.slot_pres, pres),
                       (self.slot_freq, freq)):
            arr[slot] = v
        V = self.model_config.vocab_size
        row = torch.from_numpy(np.bincount(
            np.asarray(req.prompt, np.int64), minlength=V).astype(np.int32))
        bias = np.zeros((V,), np.float32)
        for tid, b in (req.logit_bias or {}).items():
            if 0 <= int(tid) < V:
                bias[int(tid)] = float(b)
        if req.response_format is not None:
            # the grammar's initial state masks the FIRST token (the
            # admission prefill samples it); the user's bias rides every
            # later grammar row too (_struct_after_token)
            req.user_bias = bias.copy() if req.logit_bias else None
            mk = self._masker(req.response_format)
            req.struct_state = mk.initial()
            bias = bias + mk.bias_row(req.struct_state,
                                      self.config.eos_token_id)
        row, bias = row.to(dev), torch.from_numpy(bias).to(dev)
        self.counts_prompt[slot] = row
        self.counts_out[slot] = 0
        self.slot_bias[slot] = bias
        self._slot_plain[slot] = (mp == 0.0 and rep == 1.0 and pres == 0.0
                                  and freq == 0.0 and not req.logit_bias
                                  and req.response_format is None)

        def one(v, dtype):
            return torch.tensor([v], dtype=dtype, device=dev)
        f32 = torch.float32
        return ((one(t, f32), one(k, torch.int32), one(p, f32)),
                (one(mp, f32), one(rep, f32), one(pres, f32), one(freq, f32)),
                row[None], bias[None])

    @property
    def pending(self) -> int:
        adm = len(self._adm["group"]) if self._adm is not None else 0
        return len(self._queue) + len(self._active) + adm

    def _free_slots(self) -> List[int]:
        held = self._adm["slots"] if self._adm is not None else ()
        return [s for s in range(self.B)
                if s not in self._active and s not in held]

    def _admit(self):
        """Fill free slots from the queue. Consecutive queued requests
        with the same bucketed prompt width prefill as ONE batched
        forward of a power-of-two count (strict FIFO: only a same-width
        run at the head of the queue batches). With prefill_chunk > 0, a
        group wider than a chunk admits chunk by chunk while decodes are
        live (one chunk per step(), _adm_advance)."""
        if self._adm is not None:
            self._adm_advance()
            return
        while self._queue:
            free = self._free_slots()
            if not free:
                break
            m_cap = 1
            while m_cap * 2 <= len(free):
                m_cap *= 2
            S = _bucket(len(self._queue[0].prompt), self.config.prefill_bucket,
                        cap=self.T)
            group: List[_Request] = []
            while self._queue and len(group) < m_cap and _bucket(
                    len(self._queue[0].prompt), self.config.prefill_bucket,
                    cap=self.T) == S:
                group.append(self._queue.popleft())
            m = 1
            while m * 2 <= len(group):
                m *= 2
            for req in reversed(group[m:]):
                self._queue.appendleft(req)
            group = group[:m]
            t0 = time.perf_counter()
            slots = free[:m]
            arr = np.full((m, S), self.config.pad_token_id, np.int32)
            for i, req in enumerate(group):
                arr[i, : len(req.prompt)] = req.prompt
            sps = [self._set_slot_sp(slots[i], req)
                   for i, req in enumerate(group)]
            knobs = (tuple(torch.cat([s[0][j] for s in sps]) for j in range(3)),
                     tuple(torch.cat([s[1][j] for s in sps]) for j in range(4)),
                     torch.cat([s[2] for s in sps]),
                     torch.cat([s[3] for s in sps]))
            C = self.config.prefill_chunk
            if 0 < C < S and self._active and self._dmodel is None:
                # chunked only while decodes are live (an idle scheduler
                # prefills at full width, which is faster) and without a
                # draft (its cache prefill is not chunked)
                self._adm = dict(
                    group=group, slots=slots, arr=arr, S=S, C=C, pos=0,
                    t0=t0, knobs=knobs, small=None, out_logits=None,
                    lens=np.asarray([len(r.prompt) for r in group], np.int64))
                self._adm_advance()
                return
            first, first_lp = self._prefill_fn(
                torch.from_numpy(arr).to(self.device),
                torch.tensor([len(r.prompt) for r in group], dtype=torch.int32,
                             device=self.device),
                torch.tensor(slots, dtype=torch.long, device=self.device),
                knobs)
            self._activate_prefilled(group, slots, first, first_lp, t0)

    def _activate(self, slot: int, req: _Request, first: int, lp: float,
                  prefill_ms: float) -> None:
        """Record a freshly prefilled request's first token and make its
        slot live, or finish it at once on eos or budget."""
        req.prefill_ms = prefill_ms
        req.slot = slot
        req.out_tokens.append(first)
        req.out_logprobs.append(lp)
        self.counts_out[slot, first] += 1
        self.tokens[slot] = first
        self.active[slot] = True
        self.budget[slot] = req.max_new - len(req.out_tokens)
        self._active[slot] = req
        done_struct = self._struct_after_token(slot, req, first)
        if first == self.config.eos_token_id:
            self._finish(slot, "eos")
        elif done_struct:
            self._finish(slot, "stop")
        elif len(req.out_tokens) >= req.max_new:
            self._finish(slot, "length")

    def _activate_prefilled(self, group, slots, first, first_lp, t0: float):
        first_np, lp_np = _to_host(first, first_lp)   # one batched fetch
        dt_ms = (time.perf_counter() - t0) * 1e3
        for i, req in enumerate(group):
            if req.finished:              # cancelled mid chunked admission
                continue
            if self._dmodel is not None:
                # admission prefilled the draft cache on the prompt
                self._spec_dlen[slots[i]] = len(req.prompt)
            self._activate(slots[i], req, int(first_np[i]), float(lp_np[i]),
                           dt_ms)

    # -- chunked admission -----------------------------------------------

    def _adm_advance(self):
        """One prompt chunk of the in-flight admission (once per step(),
        before the decode step): the m rows' next C tokens go into their
        small cache, and a row whose prompt ends inside the chunk keeps
        its last position's logits. A row whose prompt ended earlier
        runs at chunk length 0: its padded queries sit past its length
        and their K/V land past it, where nothing reads them. After the
        last chunk the first tokens are sampled and the small cache is
        copied into the slots."""
        a = self._adm
        group, slots, S, C, pos = a["group"], a["slots"], a["S"], a["C"], \
            a["pos"]
        dev, m = self.device, len(group)
        if a["small"] is None:
            a["small"] = self._model.init_cache(
                self.model_config, m, max_seq=S, dtype=self._kv_dtype,
                device=dev)
            a["out_logits"] = torch.zeros(
                (m, self.model_config.vocab_size), dtype=torch.float32,
                device=dev)
        c1 = min(pos + C, S)
        chunk = np.full((m, C), self.config.pad_token_id, np.int32)
        chunk[:, : c1 - pos] = a["arr"][:, pos:c1]
        lens = a["lens"]
        chunk_lens = torch.from_numpy(
            np.clip(lens - pos, 0, C).astype(np.int32)).to(dev)
        sel = torch.from_numpy((lens - 1 >= pos) & (lens - 1 < c1)).to(dev)
        logits, a["small"] = self._model.forward(
            self.params, self.model_config, torch.from_numpy(chunk).to(dev),
            a["small"], seq_lens=chunk_lens,
            logit_idx=(chunk_lens - 1).clamp(min=0), fresh_prefill=pos == 0)
        a["out_logits"] = torch.where(sel[:, None], logits[:, 0].float(),
                                      a["out_logits"])
        a["pos"] = c1
        if c1 < S:
            return
        first, first_lp, _ = self._sample_first(a["out_logits"], a["knobs"])
        self.cache = self._scatter_into_slots(
            self.cache, a["small"], torch.tensor(slots, dtype=torch.long,
                                                 device=dev),
            torch.from_numpy(lens.astype(np.int32)).to(dev))
        self._adm = None
        self._activate_prefilled(group, slots, first, first_lp, a["t0"])

    def _finish(self, slot: int, reason: str):
        req = self._active.pop(slot)
        req.finished = True
        req.finished_at = time.perf_counter()
        req.stop_reason = reason
        self.active[slot] = False
        self._done[req.rid] = req

    def _record(self, slot: int, req: _Request, tok: int, lp: float,
                hit_eos: bool) -> bool:
        """Append one emitted token; finish the request on eos, a
        completed grammar, budget or a full cache. Returns True if it
        finished."""
        req.out_tokens.append(tok)
        req.out_logprobs.append(lp)
        done_struct = self._struct_after_token(slot, req, tok)
        if hit_eos:
            self._finish(slot, "eos")
        elif done_struct:
            self._finish(slot, "stop")
        elif len(req.out_tokens) >= req.max_new:
            self._finish(slot, "length")
        elif self._hit_max_seq(req):
            self._finish(slot, "max_seq")
        else:
            return False
        return True

    # -- constrained decoding -------------------------------------------

    def _masker(self, rf) -> TokenMaskCache:
        """TokenMaskCache of a normalized response_format: "json" /
        "json_object" use the generic JSON pushdown; ("schema", <json>)
        compiles the schema to its own byte program (schema_fsm)."""
        m = self._maskers.get(rf)
        if m is None:
            fsm = (SchemaFSM(json.loads(rf[1])) if isinstance(rf, tuple)
                   else None)
            m = TokenMaskCache(self.tokenizer,
                               require_object=(rf == "json_object"),
                               vocab_size=self.model_config.vocab_size,
                               fsm=fsm)
            self._maskers[rf] = m
        return m

    def _struct_after_token(self, slot: int, req: _Request,
                            tid: int) -> bool:
        """After a constrained slot emitted `tid`: advance its grammar
        state and write the next state's mask (plus the request's
        logit_bias) into the slot's bias row, which the next decode step
        adds before sampling. Returns True when the grammar completed
        (the caller finishes the slot with stop_reason "stop", as
        generate_structured stops)."""
        if req.response_format is None:
            return False
        if tid == self.config.eos_token_id:
            return False                  # the eos branch finishes it
        mk = self._masker(req.response_format)
        nxt = mk.advance(req.struct_state, tid)
        if nxt is None:
            # unreachable: the mask admits only legal tokens; end the
            # request rather than emit text outside the grammar
            return True
        req.struct_state = nxt
        if mk.done(nxt):
            return True
        row = mk.bias_row(nxt, self.config.eos_token_id)
        if req.user_bias is not None:
            row = row + req.user_bias      # OpenAI logit_bias persists
        self.slot_bias[slot] = torch.from_numpy(row).to(self.device)
        return False

    def _has_structured(self) -> bool:
        return any(r.response_format is not None
                   for r in self._active.values())

    def _spec_ready(self) -> bool:
        """Whether this step can be a speculative round: a draft model,
        every live slot plain-sampled, and spec_k + 1 positions of
        headroom in every slot (a round's (k+1)-wide write near the cache
        end would clamp onto valid positions)."""
        return (self._dmodel is not None
                and all(self._slot_plain[s] for s in self._active)
                and all(len(r.prompt) + len(r.out_tokens) + self.spec_k + 1
                        <= self.T for r in self._active.values()))

    def step(self) -> int:
        """Admit (or run one chunk of a chunked admission), then one
        decode step (or one burst, or one speculative round). Returns the
        number of live slots, or the admitting group's size while only a
        chunked admission is live."""
        self._admit()
        if not self._active:
            return 0 if self._adm is None else len(self._adm["group"])
        if self._spec_ready():
            self._spec_catchup()
            return self._step_spec()
        if self.decode_burst > 1 and not self._has_structured():
            # a constrained slot needs its mask refreshed every token:
            # single steps while one is live
            return self._step_burst()
        return self._step_plain()

    def _step_plain(self) -> int:
        nxt, lp, hit_eos = self._decode_fn()
        self.tokens = nxt
        nxt_np, lp_np, eos_np = _to_host(nxt, lp, hit_eos)  # ONE fetch
        for slot in list(self._active):
            self._advance_length(slot, 1)
            self._record(slot, self._active[slot], int(nxt_np[slot]),
                         float(lp_np[slot]), bool(eos_np[slot]))
        self._resync_budget()
        return len(self._active)

    def _resync_budget(self):
        """Plain steps and spec rounds do not carry the device budget;
        refresh it from the host before a later burst reads it."""
        if (self.decode_burst <= 1 and self._dmodel is None) \
                or not self._active:
            return
        slots = list(self._active)
        self.budget[torch.tensor(slots, device=self.device)] = torch.tensor(
            [self._active[s].max_new - len(self._active[s].out_tokens)
             for s in slots], dtype=torch.int32, device=self.device)

    def _step_burst(self) -> int:
        n = self.decode_burst
        toks, was, eoss, lps = _to_host(*self._decode_burst_fn(n))
        self._record_burst(n, toks, was, eoss, lps)
        return len(self._active)

    def _record_burst(self, n, toks, was, eoss, lps) -> None:
        for slot in list(self._active):
            req = self._active[slot]
            for i in range(n):
                if not was[i, slot]:
                    break
                self._advance_length(slot, 1)
                if self._record(slot, req, int(toks[i, slot]),
                                float(lps[i, slot]), bool(eoss[i, slot])):
                    break

    def _advance_length(self, slot: int, n: int) -> None:
        """Host bookkeeping of a slot's cache length after n tokens landed
        (the contiguous cache keeps its lengths on the device)."""

    # -- speculative rounds ---------------------------------------------

    def _spec_propose(self, lg0, k):
        """The draft proposes k tokens per slot under each slot's filter.
        -> (drafts [B, k] int32, dlogits [B, k, V])."""
        drafts, dlogits = [], []
        lg_prev = lg0
        for _ in range(k):
            dist = sampling.filtered_dist_per_slot(
                lg_prev, self.slot_temp, self.slot_topk, self.slot_topp)
            d = sampling.categorical(
                self._gen, torch.log(dist.clamp(min=1e-30))).to(torch.int32)
            lg, self.dcache = self._dmodel.forward(
                self.draft_params, self.draft_config, d[:, None], self.dcache)
            drafts.append(d)
            dlogits.append(lg_prev)
            lg_prev = lg[:, 0]
        return torch.stack(drafts, 1), torch.stack(dlogits, 1)

    def _spec_accept(self, tlg, dlogits, drafts):
        """Per-slot rejection-sampling acceptance of the drafts against
        the target logits tlg [B, k+1, V]. -> (out [B, k+1], lps
        [B, k+1], n_emit [B], a [B])."""
        k = self.spec_k
        temp, topk, topp = self.slot_temp, self.slot_topk, self.slot_topp
        pt = sampling.filtered_dist_per_slot(tlg[:, :k], temp, topk, topp)
        qd = sampling.filtered_dist_per_slot(dlogits, temp, topk, topp)
        a, corr = rejection_accept(pt, qd, drafts, self._gen)
        bonus_dist = sampling.filtered_dist_per_slot(
            tlg[:, k:k + 1], temp, topk, topp)[:, 0]
        bonus = sampling.categorical(
            self._gen, torch.log(bonus_dist.clamp(min=1e-30))).to(torch.int32)
        nxt = torch.where(a == k, bonus, corr)
        out = emit_layout(drafts, nxt, a)
        lps = sampling.token_logprob(tlg, out)
        n_emit = torch.where(self.active, a + 1, torch.zeros_like(a))
        self.tokens = torch.where(self.active, nxt, self.tokens)
        return out, lps, n_emit, a

    def _spec_draft(self):
        """Draft ingest of each slot's current token, then k proposals.
        -> (drafts, dlogits, draft lengths before the round)."""
        len_d0 = self.dcache.length
        lg, self.dcache = self._dmodel.forward(
            self.draft_params, self.draft_config, self.tokens[:, None],
            self.dcache)
        drafts, dlogits = self._spec_propose(lg[:, 0], self.spec_k)
        return drafts, dlogits, len_d0

    def _spec_round(self):
        """One speculative round over the contiguous cache: draft ingest
        and proposals, one (k+1)-wide target pass, per-slot acceptance,
        then each cache's length rolls back to its confirmed tokens
        (rejected positions stay as masked garbage, overwritten later).
        Inactive slots run at frozen lengths."""
        drafts, dlogits, len_d0 = self._spec_draft()
        len_t0 = self.cache.length
        chunk = torch.cat([self.tokens[:, None], drafts], dim=1)
        tlg, cache = self._model.forward(self.params, self.model_config,
                                         chunk, self.cache)
        out, lps, n_emit, a = self._spec_accept(tlg, dlogits, drafts)
        self.cache = cache._replace(
            length=torch.where(self.active, len_t0 + 1 + a, len_t0))
        self.dcache = self.dcache._replace(
            length=torch.where(self.active, len_d0 + 1 + a, len_d0))
        return out, lps, n_emit

    def _spec_catchup(self):
        """Feed the draft cache the tokens it missed while plain or burst
        steps ran (they advance only the target cache): one ragged draft
        forward per pass, in-sync slots at seq_len 0. The width is capped
        so every row's write stays inside the cache; wider gaps drain
        over several passes."""
        while True:
            gaps = {}
            for slot, req in self._active.items():
                confirmed = len(req.prompt) + len(req.out_tokens) - 1
                d = self._spec_dlen.get(slot, confirmed)
                if confirmed > d:
                    gaps[slot] = (d, confirmed)
            if not gaps:
                return
            G = max(c - d for d, c in gaps.values())
            max_dlen = max(
                self._spec_dlen.get(s, len(r.prompt) + len(r.out_tokens) - 1)
                for s, r in self._active.items())
            # step() leaves spec_k + 1 >= 2 positions of headroom, so every
            # pass makes progress
            W = min(_bucket(G, True, minimum=8), self.T - max_dlen)
            arr = np.zeros((self.B, W), np.int32)
            lens = np.zeros((self.B,), np.int32)
            for slot, (d, c) in gaps.items():
                req = self._active[slot]
                toks = (req.prompt + req.out_tokens)[d: min(c, d + W)]
                arr[slot, : len(toks)] = toks
                lens[slot] = len(toks)
                self._spec_dlen[slot] = d + len(toks)
            _, self.dcache = self._dmodel.forward(
                self.draft_params, self.draft_config,
                torch.from_numpy(arr).to(self.device), self.dcache,
                seq_lens=torch.from_numpy(lens).to(self.device),
                logit_idx=torch.zeros((self.B,), dtype=torch.long,
                                      device=self.device))

    def _step_spec(self) -> int:
        out_np, lps_np, n_np = _to_host(*self._spec_round())
        self.spec_proposed += self.spec_k * len(self._active)
        self.spec_accepted += int(sum(max(int(n_np[s]) - 1, 0)
                                      for s in self._active))
        eos = self.config.eos_token_id
        for slot in list(self._active):
            req = self._active[slot]
            n = int(n_np[slot])
            # the round confirmed everything but the new current token
            # into both caches
            self._spec_dlen[slot] = (len(req.prompt) + len(req.out_tokens)
                                     + max(n, 1) - 1)
            self._advance_length(slot, n)
            for i in range(n):
                tok = int(out_np[slot, i])
                if self._record(slot, req, tok, float(lps_np[slot, i]),
                                tok == eos):
                    break        # the rest of the round is discarded
        self._resync_budget()
        return len(self._active)

    def run(self, max_steps: Optional[int] = None
            ) -> Dict[int, GenerationResult]:
        """Drive until every submitted request completes."""
        steps = 0
        while self.pending:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        t1 = time.perf_counter()
        out: Dict[int, GenerationResult] = {}
        for rid, req in self._done.items():
            dt_ms = ((req.finished_at or t1) - req.submitted_at) * 1e3
            n = len(req.out_tokens)
            out[rid] = GenerationResult(
                tokens=req.prompt + req.out_tokens,
                logprobs=list(req.out_logprobs),
                total_time_ms=dt_ms,
                tokens_per_second=n / max(dt_ms / 1e3, 1e-9),
                prefill_time_ms=req.prefill_ms,
                # submission to the first token on the host: a real TTFT
                ttft_measured=True,
                finished=req.finished,
                stop_reason=req.stop_reason)
        self._done.clear()
        return out


class PagedContinuousScheduler(ContinuousBatchingScheduler):
    """Continuous batching over the PAGED KV cache (engine/paged_cache.py).

    Same request API as ContinuousBatchingScheduler, but sequences borrow
    page_size-token pages from a shared pool as they grow and return them
    when they finish. num_pages may be smaller than batch_slots x
    max_pages: admission then waits (the request stays queued) until the
    pool covers its prompt, and decode raises if the pool runs dry.

    Page 0 is a trash page held forever: released table rows are -1, the
    paged forward clamps them to 0, so writes of inactive slots land
    there instead of in a live sequence.

    prefix_caching: full prompt pages are keyed by the token prefix up to
    their end, so requests with a common prefix share pages, and pages
    whose last user finished stay cached (evictable) for later requests.
    Admission then runs the forward over the uncached suffix only.
    Decode runs forward_paged_decode (the paged kernel); a speculative
    round verifies with forward_paged_verify.
    """

    def __init__(self, params: Dict[str, Any], model_config: ModelConfig,
                 config: Optional[InferenceConfig] = None,
                 batch_slots: int = 8, page_size: int = 256,
                 num_pages: Optional[int] = None,
                 prefix_caching: bool = True, decode_burst: int = 1,
                 max_queue: Optional[int] = None, mesh=None,
                 parallel: str = "tp",
                 draft_params: Optional[Dict[str, Any]] = None,
                 draft_config: Optional[ModelConfig] = None,
                 spec_k: int = 4, tokenizer=None, device="cuda"):
        model = registry.get_model(model_config.architecture)
        if draft_params is not None and not hasattr(model,
                                                    "forward_paged_verify"):
            raise NotImplementedError(
                f"{model_config.architecture} has no forward_paged_verify "
                "(speculative paged serving)")
        if not hasattr(model, "forward_paged_decode"):
            # GPT-2 and the NeoX family have no paged body, as in the JAX
            # package (its scheduler refuses them at construction too)
            raise NotImplementedError(
                f"{model_config.architecture} has no forward_paged_decode")
        cfg = config or InferenceConfig(max_seq_len=model_config.max_seq_len)
        check_kv_dtype(model, model_config.architecture, resolve_kv_dtype(
            cfg.kv_cache_dtype, model_config.dtype), paged=True)
        super().__init__(params, model_config, config, batch_slots,
                         decode_burst=decode_burst, max_queue=max_queue,
                         mesh=mesh, parallel=parallel,
                         draft_params=draft_params, draft_config=draft_config,
                         spec_k=spec_k, tokenizer=tokenizer, device=device)
        self.page = page_size
        max_pages = -(-self.T // page_size)
        if num_pages is None:
            num_pages = 1 + self.B * max_pages      # +1: the trash page
        self.cache = pc.init_paged_cache(self._rank_config, self.B,
                                         num_pages=num_pages,
                                         page_size=page_size, max_seq=self.T,
                                         dtype=self._kv_dtype,
                                         device=self.device)
        self.pool = pc.PrefixPagePool(num_pages)
        self.prefix_caching = prefix_caching
        if self.pool.acquire() != 0:                # held forever
            raise RuntimeError("page 0 must be the trash page")
        # host block table and lengths are authoritative; the device
        # table is uploaded only after the host changed it
        self._table = np.full((self.B, max_pages), -1, np.int32)
        self._table_dirty = True
        self._table_dev: Optional[torch.Tensor] = None
        self._lengths = np.zeros((self.B,), np.int64)

    def _make_cache(self):
        # the page pool replaces this right after super().__init__; a
        # contiguous slot cache first would double the memory at 7B
        return None

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 50,
               **kw) -> int:
        # Reject a prompt that could never admit, even into an empty pool
        # with no prefix sharing: it would wait in the queue forever.
        W = -(-_bucket(len(prompt), self.config.prefill_bucket,
                       cap=self.T) // self.page) * self.page
        need = max(W // self.page, -(-(len(prompt) + 1) // self.page))
        if need > self.pool.num_pages - 1:
            raise ValueError(
                f"prompt needs {need} pages but the pool has only "
                f"{self.pool.num_pages - 1} (page_size={self.page}; "
                f"raise num_pages)")
        return super().submit(prompt, max_new_tokens, **kw)

    # -- device programs --------------------------------------------------

    def _lengths_dev(self) -> torch.Tensor:
        return torch.from_numpy(self._lengths.astype(np.int32)).to(
            self.device)

    def _device_table(self) -> torch.Tensor:
        if self._table_dirty or self._table_dev is None:
            self._table_dev = torch.from_numpy(self._table).to(self.device)
            self._table_dirty = False
        return self._table_dev

    def _paged_step(self, lengths):
        """One paged decode step for every slot at `lengths` [B] ->
        (nxt, lp, hit_eos)."""
        logits = self._model.forward_paged_decode(
            self.params, self.model_config, self.tokens, self.cache.k_pages,
            self.cache.v_pages, self._device_table(), lengths,
            **self._scale_pools())[0]
        nxt, lp = self._sample(logits + self.slot_bias, self.counts_out)
        self._count(nxt, self.active)
        return nxt, lp, self.active & (nxt == self.config.eos_token_id)

    def _scale_pools(self):
        """The int8 pool's scale pages as the paged forwards take them."""
        if self.cache.k_scale_pages is None:
            return {}
        return dict(k_scale_pages=self.cache.k_scale_pages,
                    v_scale_pages=self.cache.v_scale_pages)

    def _decode_fn(self):
        return self._paged_step(self._lengths_dev())

    def _decode_burst_fn(self, n: int):
        """n paged decode steps with no host round trip; step() assigned
        every live slot's pages for positions [len, len + n) first, and
        inactive slots write the trash page through their -1 rows."""
        eos, T = self.config.eos_token_id, self.T
        lengths = self._lengths_dev()
        toks, was, eoss, lps = [], [], [], []
        for _ in range(n):
            nxt, lp, hit = self._paged_step(lengths)
            self.budget = self.budget - self.active.to(torch.int32)
            new_len = torch.where(self.active, lengths + 1, lengths)
            toks.append(nxt)
            was.append(self.active)
            eoss.append(hit)
            lps.append(lp)
            self.tokens = torch.where(self.active, nxt, self.tokens)
            self.active = (self.active & ~hit & (self.budget > 0)
                           & (new_len < T))
            lengths = new_len
        return [torch.stack(a) for a in (toks, was, eoss, lps)]

    def _paged_prefill(self, req: _Request, m: int, S_suf: int, slot: int,
                       knobs):
        """Admission prefill of one prompt whose first m pages are shared:
        their K/V (and an int8 pool's scales) is copied into a small
        head-major cache of the pool's dtype as its prefix and the
        forward runs over the suffix only, so time to first token follows
        the uncached part. The small cache is as wide as a cold
        admission's (pre + S_suf = the bucketed prompt in whole pages),
        so cached and cold admissions attend the same widths. The suffix
        K/V (and scales) then goes to the slot's fresh pages.
        Returns (first token, its logprob, the biased logits row)."""
        cfg, page, dev = self.model_config, self.page, self.device
        L, _, Hkv, _, D = self.cache.k_pages.shape
        pre, n_new = m * page, S_suf // page
        plen = len(req.prompt)
        shared = torch.from_numpy(self._table[slot, :m].astype(np.int64)).to(dev)
        fresh = torch.from_numpy(
            self._table[slot, m:m + n_new].astype(np.int64)).to(dev)
        small = self._model.init_cache(cfg, 1, max_seq=pre + S_suf,
                                       dtype=self._kv_dtype, device=dev)
        c = self.cache
        # (pool, small-cache buffer) pairs: K, V and an int8 pool's scales
        pairs = [(c.k_pages, small.k), (c.v_pages, small.v)]
        if c.k_scale_pages is not None:
            pairs += [(c.k_scale_pages, small.k_scale),
                      (c.v_scale_pages, small.v_scale)]
        if m:
            for pages, buf in pairs:
                # [L, m, Hkv, page(, D)] -> [L, Hkv, pre(, D)]
                buf[:, 0, :, :pre] = pages[:, shared].transpose(1, 2).reshape(
                    L, Hkv, pre, *pages.shape[4:])
            small = small._replace(length=torch.full_like(small.length, pre))
        arr = np.full((1, S_suf), self.config.pad_token_id, np.int32)
        arr[0, : plen - pre] = req.prompt[pre:]
        suf_len = torch.tensor([plen - pre], dtype=torch.int32, device=dev)
        logits, small = self._model.forward(
            self.params, cfg, torch.from_numpy(arr).to(dev), small,
            seq_lens=suf_len, logit_idx=(suf_len - 1).clamp(min=0))
        first, first_lp, last = self._sample_first(logits[:, 0], knobs)
        # [L, 1, Hkv, n_new * page(, D)] suffix -> [L, n_new, Hkv, page(, D)]
        for pages, buf in pairs:
            pages[:, fresh] = buf[:, 0, :, pre:].reshape(
                L, Hkv, n_new, page, *pages.shape[4:]).transpose(1, 2)
        return first, first_lp, last

    # -- host-side page bookkeeping ---------------------------------------

    def _ensure_pages(self, slot: int, upto_len: int) -> bool:
        """Assign pages so positions [0, upto_len) are backed; False (and
        no change) if the pool cannot cover it. Clamped to the table
        width: a slot deactivates at T before it could write past it."""
        need = min(-(-upto_len // self.page), self._table.shape[1])
        have = int((self._table[slot] >= 0).sum())
        if need <= have:
            return True
        if need - have > self.pool.available:
            return False
        for i in range(have, need):
            self._table[slot, i] = self.pool.acquire()
        self._table_dirty = True
        return True

    # -- lifecycle --------------------------------------------------------

    def _admit(self):
        for slot in self._free_slots():
            if not self._queue:
                break
            req = self._queue[0]
            t0 = time.perf_counter()
            plen = len(req.prompt)
            # Reuse the longest run of full prompt pages already pooled,
            # never the page of the LAST prompt token (its hidden state
            # must be computed for the first logits).
            keys = (pc.prefix_page_keys(req.prompt, self.page)
                    if self.prefix_caching else [])
            shared: List[int] = []
            for key in keys[: (plen - 1) // self.page]:
                pid = self.pool.lookup(key)
                if pid is None:
                    break
                shared.append(pid)
            m = len(shared)
            W = -(-_bucket(plen, self.config.prefill_bucket, cap=self.T)
                  // self.page) * self.page
            S_suf = W - m * self.page
            # back the suffix and the first generated token; later pages
            # come on demand in step()
            need = max(m + S_suf // self.page, -(-(plen + 1) // self.page))
            if need - m > self.pool.available:
                self.pool.release(shared)   # pool full: stay queued
                break
            self._queue.popleft()
            self._table[slot, :m] = shared
            for i in range(m, need):
                self._table[slot, i] = self.pool.acquire(
                    keys[i] if i < len(keys) else None)
            self._table_dirty = True
            first, first_lp, _ = self._paged_prefill(
                req, m, S_suf, slot, self._set_slot_sp(slot, req))
            self._lengths[slot] = plen
            if self._dmodel is not None:
                # paged admission does not prefill the draft cache:
                # _spec_catchup feeds it the prompt before the first round
                self._spec_dlen[slot] = 0
                self.dcache.length[slot] = 0
            first_np, lp_np = _to_host(first, first_lp)   # one fetch
            self._activate(slot, req, int(first_np[0]), float(lp_np[0]),
                           (time.perf_counter() - t0) * 1e3)

    def _finish(self, slot: int, reason: str):
        self.pool.release(self._table[slot])
        self._table[slot] = -1
        self._table_dirty = True
        self._lengths[slot] = 0
        super()._finish(slot, reason)

    def _advance_length(self, slot: int, n: int) -> None:
        # the host lengths ARE the paged cache's lengths
        self._lengths[slot] += n

    def step(self) -> int:
        self._admit()
        if not self._active:
            return 0
        if self._spec_ready() and all(
                self._ensure_pages(s, int(self._lengths[s]) + self.spec_k + 1)
                for s in self._active):
            # every live slot's next spec_k + 1 positions are backed; a
            # slot the pool cannot cover falls the batch back to plain
            # steps this iteration
            self._spec_catchup()
            return self._step_spec()
        if (self.decode_burst > 1 and not self._has_structured()
                and all(self._ensure_pages(
                    s, int(self._lengths[s]) + self.decode_burst)
                    for s in self._active)):
            # constrained slots refresh their masks every token: single
            # steps while one is live, as when the pool cannot back a burst
            return self._step_burst()
        # each live slot writes its next token at position _lengths[slot]
        for slot in self._active:
            if not self._ensure_pages(slot, int(self._lengths[slot]) + 1):
                raise RuntimeError(
                    "KV page pool exhausted mid-decode; raise num_pages or "
                    "lower batch_slots")
        return self._step_plain()

    def _spec_round(self):
        """A speculative round over the page pool: the (k+1)-wide verify
        writes the chunk's K/V into the pages step() assigned and the
        paged kernel reads each slot's prefix once. The target's rollback
        is free: host lengths advance only by the accepted count."""
        drafts, dlogits, len_d0 = self._spec_draft()
        chunk = torch.cat([self.tokens[:, None], drafts], dim=1)
        tlg = self._model.forward_paged_verify(
            self.params, self.model_config, chunk, self.cache.k_pages,
            self.cache.v_pages, self._device_table(), self._lengths_dev(),
            **self._scale_pools())[0]
        out, lps, n_emit, a = self._spec_accept(tlg, dlogits, drafts)
        self.dcache = self.dcache._replace(
            length=torch.where(self.active, len_d0 + 1 + a, len_d0))
        return out, lps, n_emit
