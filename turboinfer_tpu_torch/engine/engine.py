"""InferenceEngine in PyTorch: counterpart of
turboinfer_tpu/engine/engine.py for prefill + decode generation.

generate_batch keeps the JAX engine's semantics: prompts right-padded to
a power-of-two bucket width (capped at max_seq_len), one cold prefill
with a last-position head, then a decode loop whose length is the
budget rounded up to a multiple of 32 (the slack is discarded), per-row
budgets bounded by each row's own headroom, EOS and stop reasons, and
rows that fill the cache finishing on their own. Where JAX fuses the
decode loop into one program, this engine steps an eager per-token loop
on the device with no host synchronisation inside it. With
use_cache=False it recomputes the whole sequence for every token through
the model's forward_no_cache, as the JAX engine does.

The text paths: generate_structured (a grammar-masked host loop, one
decode step per token), generate_stream (`burst` eager decode steps
between host reads, one sync per burst), generate_beam_search (beams on
the batch axis, the cache prefix gathered by parent each step),
compute_logprobs (one forward_no_cache), and chat/chat_stream/encode/
decode over the engine's tokenizer.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from turboinfer_tpu_torch.config import InferenceConfig, ModelConfig
from turboinfer_tpu_torch.engine import sampling
from turboinfer_tpu_torch.engine.sampling import SamplingParams
from turboinfer_tpu_torch.kernels.dispatch import prepare_params
from turboinfer_tpu_torch.models import registry
from turboinfer_tpu_torch.models.common import (KVCache, check_kv_dtype,
                                                param_bytes, params_to,
                                                resolve_kv_dtype)
from turboinfer_tpu_torch.utils.device import resolve_device
from turboinfer_tpu_torch.utils.errors import TokenError
from turboinfer_tpu_torch.utils.metrics import EngineStats


@dataclasses.dataclass
class StreamChunk:
    """One token from generate_stream. `text` is the newly decodable
    text delta (None when the engine has no tokenizer, "" while a
    multi-token UTF-8 sequence is still incomplete)."""
    token: int
    text: Optional[str] = None
    index: int = 0                        # 0-based position in the output
    finished: bool = False
    stop_reason: Optional[str] = None     # set on the final chunk


@dataclasses.dataclass
class GenerationResult:
    tokens: List[int]
    logprobs: Optional[List[float]] = None
    total_time_ms: float = 0.0
    tokens_per_second: float = 0.0
    prefill_time_ms: float = 0.0
    ttft_measured: bool = False
    finished: bool = True
    stop_reason: str = "length"           # "eos" | "length" | "max_seq"
    text: Optional[str] = None            # decoded output (chat() sets it)


def _bucket(n: int, enable: bool, minimum: int = 16,
            cap: Optional[int] = None) -> int:
    """Round a prompt length up to a power of two, capped at the cache
    width so a long-but-valid prompt never gets a slab wider than it."""
    if not enable:
        return n
    b = minimum
    while b < n:
        b *= 2
    if cap is not None and b > cap >= n:
        b = cap
    return b


def _top_k(x: torch.Tensor, k: int):
    """The k largest entries of a 1-D tensor with jax.lax.top_k's order:
    descending, the lower index first among equal values (torch.topk
    promises no order on ties; beam expansion over a frozen beam, -1e30
    everywhere but EOS, depends on it)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _to_host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """One device-to-host copy of several small tensors (float64 holds
    their ids, flags and f32 values exactly)."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    host = flat.cpu().numpy()
    out, i = [], 0
    for t in tensors:
        out.append(host[i:i + t.numel()].reshape(tuple(t.shape)))
        i += t.numel()
    return out


class InferenceEngine:
    """Holds params and configs on one device and drives prefill/decode.

    device: "cuda" (default) runs the Hopper kernels; "cpu" runs the
    plain PyTorch versions and must be asked for. Params are moved to
    the device and fused once (kernels.dispatch.prepare_params). The
    cache stores config.kv_cache_dtype (models/common.resolve_kv_dtype:
    "model", "bf16", "int8" with scale planes, "fp8"). tokenizer: the
    text methods' (chat, encode/decode, stream text, structured masks);
    loader.load_engine passes the file's."""

    def __init__(self, params: Dict[str, Any], model_config: ModelConfig,
                 config: Optional[InferenceConfig] = None,
                 tokenizer=None, device="cuda"):
        self.device = resolve_device(device)
        self._model = registry.get_model(model_config.architecture)
        self._model.check_supported(model_config)
        self.model_config = model_config
        self.config = config or InferenceConfig(
            max_seq_len=model_config.max_seq_len)
        self.tokenizer = tokenizer
        self._kv_dtype = resolve_kv_dtype(self.config.kv_cache_dtype,
                                          model_config.dtype)
        check_kv_dtype(self._model, model_config.architecture,
                       self._kv_dtype)
        if self.config.decode_loop not in ("scan", "host"):
            raise ValueError(f"decode_loop must be 'scan' or 'host', got "
                             f"{self.config.decode_loop!r}")
        self.params = prepare_params(params_to(params, self.device))
        self.stats = EngineStats()
        self._gen = self._new_generator()
        self._cache_pool: Dict[Tuple[int, int], KVCache] = {}

    def _new_generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.config.seed)

    # -- KV-cache buffer pool -------------------------------------------

    def _take_cache(self, batch_size: int) -> KVCache:
        """Reuse the cache buffers of an earlier call of the same shape:
        every attention path masks by length, so zeroing `length` is a
        full reset."""
        key = (batch_size, self.config.max_seq_len)
        cache = self._cache_pool.pop(key, None)
        if cache is None:
            return self._model.init_cache(self.model_config, batch_size,
                                          max_seq=self.config.max_seq_len,
                                          dtype=self._kv_dtype,
                                          device=self.device)
        return cache._replace(length=torch.zeros_like(cache.length))

    def _put_cache(self, batch_size: int, cache: KVCache) -> None:
        self._cache_pool[(batch_size, self.config.max_seq_len)] = cache

    # -- forward programs -------------------------------------------------

    def _prefill(self, tokens, seq_lens, cache, fresh: bool):
        """Prefill with a last-position head -> (logits [B, V], cache)."""
        idx = (seq_lens - 1).clamp(min=0)
        logits, cache = self._model.forward(
            self.params, self.model_config, tokens, cache, seq_lens=seq_lens,
            logit_idx=idx, fresh_prefill=fresh)
        return logits[:, 0], cache

    def _run_prefill(self, tokens, seq_lens, cache):
        """Prefill, in fixed chunks when config.prefill_chunk > 0."""
        B, S = tokens.shape
        C = self.config.prefill_chunk
        if C <= 0 or S <= C:
            return self._prefill(tokens, seq_lens, cache, fresh=True)
        out = None
        for c0 in range(0, S, C):
            c1 = min(c0 + C, S)
            chunk = tokens[:, c0:c1]
            if chunk.shape[1] < C:
                chunk = torch.nn.functional.pad(
                    chunk, (0, C - chunk.shape[1]),
                    value=self.config.pad_token_id)
            chunk_lens = (seq_lens - c0).clamp(0, C)
            logits, cache = self._prefill(chunk, chunk_lens, cache,
                                          fresh=False)
            sel = ((seq_lens - 1 >= c0) & (seq_lens - 1 < c1))[:, None]
            out = logits if out is None else torch.where(sel, logits, out)
        return out, cache

    def _decode_step(self, token, cache):
        logits, cache = self._model.forward(self.params, self.model_config,
                                            token[:, None], cache)
        return logits[:, 0], cache

    # -- helpers --------------------------------------------------------

    def _pad_batch(self, prompts: Sequence[Sequence[int]]):
        lens = [len(p) for p in prompts]
        S = _bucket(max(lens), self.config.prefill_bucket,
                    cap=self.config.max_seq_len)
        arr = torch.full((len(prompts), S), self.config.pad_token_id,
                         dtype=torch.int32)
        for i, p in enumerate(prompts):
            arr[i, :len(p)] = torch.as_tensor(list(p), dtype=torch.int32)
        return (arr.to(self.device),
                torch.as_tensor(lens, dtype=torch.int32, device=self.device), S)

    def _validate(self, tokens: Sequence[int]):
        if len(tokens) == 0:
            raise TokenError("input tokens must be non-empty")
        if len(tokens) >= self.config.max_seq_len:
            raise TokenError(f"prompt length {len(tokens)} exceeds "
                             f"max_seq_len {self.config.max_seq_len}")
        V = self.model_config.vocab_size
        bad = [t for t in tokens if not (0 <= t < V)]
        if bad:
            raise TokenError(f"token ids out of vocab range [0,{V}): {bad[:5]}")

    def _sampling_params(self, temperature=None, top_k=None, top_p=None,
                         min_p=None, repetition_penalty=None,
                         presence_penalty=None, frequency_penalty=None
                         ) -> SamplingParams:
        c = self.config

        def pick(v, d):
            return d if v is None else v
        return SamplingParams(
            temperature=pick(temperature, c.temperature),
            top_k=pick(top_k, c.top_k), top_p=pick(top_p, c.top_p),
            min_p=pick(min_p, c.min_p),
            repetition_penalty=pick(repetition_penalty, c.repetition_penalty),
            presence_penalty=pick(presence_penalty, c.presence_penalty),
            frequency_penalty=pick(frequency_penalty, c.frequency_penalty))

    def _prompt_counts(self, tokens, seq_lens):
        """[B, V] int32 occurrence counts of the unpadded prompts."""
        B, S = tokens.shape
        valid = (torch.arange(S, device=self.device)[None, :]
                 < seq_lens[:, None]).to(torch.int32)
        counts = torch.zeros((B, self.model_config.vocab_size),
                             dtype=torch.int32, device=self.device)
        return counts.scatter_add_(1, tokens.long(), valid)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- generation -------------------------------------------------------

    def generate(self, input_tokens: Sequence[int], max_new_tokens: int = 50,
                 **sampling_kw) -> GenerationResult:
        return self.generate_batch([input_tokens], max_new_tokens,
                                   **sampling_kw)[0]

    def generate_batch(self, prompts: Sequence[Sequence[int]],
                       max_new_tokens: int = 50, *,
                       return_logprobs: bool = False,
                       **sampling_kw) -> List[GenerationResult]:
        """One prefill and one decode step per token for ALL rows."""
        for p in prompts:
            self._validate(p)
        sp = self._sampling_params(**sampling_kw)
        eos, pad = self.config.eos_token_id, self.config.pad_token_id
        max_seq = self.config.max_seq_len
        t0 = time.perf_counter()
        if not self.config.use_cache:
            return self._generate_batch_nocache(prompts, max_new_tokens, sp,
                                                eos, t0, return_logprobs)

        tokens, seq_lens, S = self._pad_batch(prompts)
        B = len(prompts)
        lens_lim = min(len(p) for p in prompts)
        max_new = min(max_new_tokens, max_seq - lens_lim)
        if max_new <= 0:
            return [GenerationResult(tokens=list(p), logprobs=[] if
                                     return_logprobs else None,
                                     finished=True, stop_reason="length")
                    for p in prompts]
        cache = self._take_cache(B)
        last_logits, cache = self._run_prefill(tokens, seq_lens, cache)
        pc = self._prompt_counts(tokens, seq_lens) if sp.needs_counts else None
        host_loop = self.config.decode_loop != "scan"
        if self.config.measure_ttft or host_loop:
            self._sync()
        t_prefill = time.perf_counter()

        toks, lps, finished, cache = self._decode(
            last_logits, cache, sp, pc, max_new, lens_lim, eos, pad,
            host_loop, return_logprobs)
        toks_np, lps_np, fin_np = (toks.cpu(), lps.cpu(), finished.cpu())
        self._put_cache(B, cache)
        t1 = time.perf_counter()

        results, new_total = [], 0
        for b in range(B):
            cap_b = min(max_new, max_seq - len(prompts[b]))
            row = toks_np[b][:max(cap_b, 0)].tolist()
            if eos in row:
                n, stop = row.index(eos) + 1, "eos"
            else:
                n = len(row)
                stop = ("max_seq" if len(prompts[b]) + n >= max_seq
                        else "length")
            new_total += n
            results.append(GenerationResult(
                tokens=list(prompts[b]) + row[:n],
                logprobs=(lps_np[b][:n].tolist() if return_logprobs else None),
                total_time_ms=(t1 - t0) * 1e3,
                tokens_per_second=n / max(t1 - t0, 1e-9),
                prefill_time_ms=(t_prefill - t0) * 1e3,
                ttft_measured=self.config.measure_ttft or host_loop,
                finished=bool(fin_np[b]) or stop == "eos",
                stop_reason=stop))
        self.stats.record_generation(new_tokens=new_total,
                                     elapsed_s=t1 - t0,
                                     prefill_s=t_prefill - t0, batch=B)
        return results

    def _decode(self, first_logits, cache, sp, pc, max_new, lens_lim, eos,
                pad, host_loop, want_logprobs):
        """Sample the first token from the prefill logits, then step.

        scan semantics (default): max_new rounded up to a multiple of 32
        (bounded by the shortest row's headroom) steps with no host sync,
        rows stop when their cache fills. host loop: max_new steps with
        an early exit once every row finished."""
        B = first_logits.shape[0]
        rows = torch.arange(B, device=self.device)
        n_steps = max_new
        if not host_loop and max_new > 1 and self.config.prefill_bucket:
            n_steps = min(-(-max_new // 32) * 32,
                          self.config.max_seq_len - lens_lim)
        row_limit = None if host_loop else self.config.max_seq_len - 1
        out_counts = torch.zeros_like(pc) if sp.needs_counts else None

        def counts():
            return (pc + out_counts, out_counts) if sp.needs_counts else None

        token = sampling.sample(self._gen, first_logits, sp, counts())
        toks = [token]
        lps = [sampling.token_logprob(first_logits, token) if want_logprobs
               else torch.zeros((B,), device=self.device)]
        if sp.needs_counts:
            out_counts[rows, token.long()] += 1
        finished = token == eos
        for _ in range(n_steps - 1):
            logits, cache = self._decode_step(token, cache)
            nxt = sampling.sample(self._gen, logits, sp, counts())
            lp = (torch.where(finished, 0.0, sampling.token_logprob(logits, nxt))
                  if want_logprobs else torch.zeros((B,), device=self.device))
            nxt = torch.where(finished, torch.full_like(nxt, pad), nxt)
            if sp.needs_counts:
                out_counts[rows, nxt.long()] += (~finished).to(torch.int32)
            finished = finished | (nxt == eos)
            if row_limit is not None:
                finished = finished | (cache.length >= row_limit)
            toks.append(nxt)
            lps.append(lp)
            token = nxt
            if host_loop and bool(finished.all()):
                break
        return (torch.stack(toks, dim=1), torch.stack(lps, dim=1), finished,
                cache)

    def _generate_batch_nocache(self, prompts, max_new_tokens, sp, eos, t0,
                                want_logprobs):
        """use_cache=False (JAX _generate_batch_nocache): every new token
        recomputes the whole padded sequence through the model's
        forward_no_cache and samples from its last valid position; the
        tokens come back to the host each step. Stop reasons as the JAX
        engine's: "eos", "max_seq" when a row reaches max_seq_len, else
        "length"."""
        B, V = len(prompts), self.model_config.vocab_size
        seqs = [list(p) for p in prompts]
        lps: List[List[float]] = [[] for _ in prompts]
        finished, stop = [False] * B, ["length"] * B
        rows = torch.arange(B, device=self.device)
        for _ in range(max_new_tokens):
            if all(finished):
                break
            tokens, seq_lens, _ = self._pad_batch(seqs)
            logits = self._model.forward_no_cache(
                self.params, self.model_config, tokens, seq_lens=seq_lens)
            last = logits[rows, (seq_lens - 1).clamp(min=0).long()]
            counts = None
            if sp.needs_counts:
                ids = [torch.as_tensor(s, dtype=torch.long) for s in seqs]
                every = torch.stack([torch.bincount(i, minlength=V)
                                     for i in ids])
                out = torch.stack([torch.bincount(i[len(p):], minlength=V)
                                   for i, p in zip(ids, prompts)])
                counts = (every.to(self.device, torch.int32),
                          out.to(self.device, torch.int32))
            nxt = sampling.sample(self._gen, last, sp, counts)
            lp = sampling.token_logprob(last, nxt)
            for b, (t, p) in enumerate(zip(nxt.tolist(), lp.tolist())):
                if finished[b]:
                    continue
                seqs[b].append(t)
                lps[b].append(p)
                if t == eos:
                    finished[b], stop[b] = True, "eos"
                elif len(seqs[b]) >= self.config.max_seq_len:
                    finished[b], stop[b] = True, "max_seq"
        t1 = time.perf_counter()
        results = []
        for b, s in enumerate(seqs):
            n = len(s) - len(prompts[b])
            results.append(GenerationResult(
                tokens=s, logprobs=lps[b] if want_logprobs else None,
                total_time_ms=(t1 - t0) * 1e3,
                tokens_per_second=n / max(t1 - t0, 1e-9),
                finished=finished[b] or n >= max_new_tokens,
                stop_reason=stop[b]))
        self.stats.record_generation(
            new_tokens=sum(len(s) - len(p) for s, p in zip(seqs, prompts)),
            elapsed_s=t1 - t0, prefill_s=0.0, batch=B)
        return results

    # -- structured (grammar-constrained) generation -------------------------

    def generate_structured(self, input_tokens: Sequence[int],
                            max_new_tokens: int = 256, *,
                            response_format="json_object",
                            temperature: Optional[float] = None,
                            token_filter=None) -> GenerationResult:
        """Grammar-constrained generation (JAX generate_structured): every
        emitted token is a legal continuation of the grammar, so the
        output parses. response_format="json_object" constrains to one
        top-level JSON object; {"type": "json_schema", "json_schema":
        {"schema": {...}}} to a compiled JSON Schema
        (structured/schema_fsm.py); `token_filter` takes any other
        grammar (structured/filter.py). A host loop: the logits of each
        step come to the host, the filter picks, one decode step runs.
        Sampling draws from a numpy generator seeded from the engine's
        torch.Generator."""
        self._validate(input_tokens)
        if token_filter is None:
            if self.tokenizer is None:
                raise RuntimeError("structured generation requires a "
                                   "tokenizer (or an explicit "
                                   "token_filter)")
            token_filter = self._json_filter(response_format)
        temp = (self.config.temperature if temperature is None
                else temperature)
        t0 = time.perf_counter()
        tokens, seq_lens, _ = self._pad_batch([input_tokens])
        budget = min(max_new_tokens,
                     self.config.max_seq_len - len(input_tokens))
        cache = self._take_cache(1)
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=self._gen,
                                 device=self.device).item())
        rng_np = np.random.default_rng(seed)
        eos = self.config.eos_token_id
        out: List[int] = []
        try:
            last_logits, cache = self._run_prefill(tokens, seq_lens, cache)
            logits_np = last_logits[0].float().cpu().numpy()
            t_prefill = time.perf_counter()
            while len(out) < budget and not token_filter.done:
                tid = token_filter.pick(logits_np, temperature=temp,
                                        rng=rng_np)
                if tid is None:
                    break
                if token_filter.done and tid == eos:
                    # a MAY-finish grammar chose to stop (top-level
                    # number schemas): the EOS itself is not emitted
                    break
                out.append(tid)
                if token_filter.done or len(out) >= budget:
                    break
                logits, cache = self._decode_step(
                    torch.tensor([tid], dtype=torch.int32,
                                 device=self.device), cache)
                logits_np = logits[0].float().cpu().numpy()
        finally:
            self._put_cache(1, cache)
        t1 = time.perf_counter()
        self.stats.record_generation(new_tokens=len(out), elapsed_s=t1 - t0,
                                     prefill_s=t_prefill - t0, batch=1)
        return GenerationResult(
            tokens=list(input_tokens) + out,
            total_time_ms=(t1 - t0) * 1e3,
            tokens_per_second=len(out) / max(t1 - t0, 1e-9),
            prefill_time_ms=(t_prefill - t0) * 1e3,
            ttft_measured=True,               # the host loop syncs per step
            finished=token_filter.done,
            stop_reason="stop" if token_filter.done else "length",
            text=(self.tokenizer.decode(out)
                  if self.tokenizer is not None else None))

    def _json_filter(self, response_format):
        """The JsonTokenFilter of a response_format ("json_object",
        "json", or a json_schema dict)."""
        from turboinfer_tpu_torch.structured import JsonTokenFilter
        fsm = None
        if isinstance(response_format, dict):
            from turboinfer_tpu_torch.engine.scheduler import \
                _normalize_response_format
            rf = _normalize_response_format(response_format)
            if isinstance(rf, tuple):
                from turboinfer_tpu_torch.structured.schema_fsm import \
                    SchemaFSM
                fsm = SchemaFSM(json.loads(rf[1]))
            response_format = rf
        return JsonTokenFilter(self.tokenizer,
                               require_object=(response_format
                                               == "json_object"),
                               fsm=fsm, eos_id=self.config.eos_token_id)

    # -- streaming ---------------------------------------------------------

    def generate_stream(self, input_tokens: Sequence[int],
                        max_new_tokens: int = 50, *,
                        burst: int = 8, **sampling_kw):
        """Yield a StreamChunk per generated token (JAX generate_stream).
        Tokens come in bursts of `burst` decode steps run on the device
        with no host read inside; each burst ends with one
        device-to-host copy. burst=1 gives the lowest latency a token,
        larger bursts fewer syncs. Greedy output is token-identical to
        generate()."""
        self._validate(input_tokens)
        sp = self._sampling_params(**sampling_kw)
        eos, pad = self.config.eos_token_id, self.config.pad_token_id
        burst = max(1, int(burst))
        tokens, seq_lens, _ = self._pad_batch([input_tokens])
        budget = min(max_new_tokens,
                     self.config.max_seq_len - len(input_tokens))
        if budget <= 0:
            return
        cache = self._take_cache(1)
        t0 = time.perf_counter()
        from turboinfer_tpu_torch.tokenizer.stream import IncrementalDecoder
        decoder = IncrementalDecoder(self.tokenizer)
        out: List[int] = []

        def chunk(tok: int) -> StreamChunk:
            out.append(tok)
            # O(1) incremental detokenization (a UTF-8 char can span
            # several tokens; the decoder withholds incomplete tails)
            text = (decoder.push(tok) if self.tokenizer is not None
                    else None)
            done = tok == eos or len(out) >= budget
            reason = None
            if done:
                reason = "eos" if tok == eos else (
                    "max_seq" if len(input_tokens) + len(out) >=
                    self.config.max_seq_len else "length")
            return StreamChunk(token=tok, text=text, index=len(out) - 1,
                               finished=done, stop_reason=reason)

        try:
            last_logits, cache = self._run_prefill(tokens, seq_lens, cache)
            pc = (self._prompt_counts(tokens, seq_lens) if sp.needs_counts
                  else None)
            oc = torch.zeros_like(pc) if sp.needs_counts else None
            token = sampling.sample(self._gen, last_logits, sp,
                                    (pc, oc) if sp.needs_counts else None)
            if sp.needs_counts:
                oc[0, token.long()] += 1
            first = chunk(int(token[0]))
            yield first
            if first.finished:
                return
            finished = token == eos
            while len(out) < budget:
                toks = []
                # a burst never steps past the budget (nor the cache end)
                for _ in range(min(burst, budget - len(out))):
                    logits, cache = self._decode_step(token, cache)
                    nxt = sampling.sample(self._gen, logits, sp,
                                          (pc + oc, oc) if sp.needs_counts
                                          else None)
                    nxt = torch.where(finished, torch.full_like(nxt, pad),
                                      nxt)
                    if sp.needs_counts:
                        oc[0, nxt.long()] += (~finished).to(torch.int32)
                    finished = finished | (nxt == eos)
                    toks.append(nxt)
                    token = nxt
                for tok in torch.cat(toks).tolist():     # one sync a burst
                    c = chunk(int(tok))
                    yield c
                    if c.finished:
                        return
        finally:
            self._put_cache(1, cache)
            self.stats.record_generation(new_tokens=len(out),
                                         elapsed_s=time.perf_counter() - t0,
                                         prefill_s=0.0, batch=1)

    # -- beam search ------------------------------------------------------

    def generate_beam_search(self, input_tokens: Sequence[int],
                             max_new_tokens: int = 50, beam_size: int = 4,
                             *, length_penalty: Optional[float] = None,
                             temperature: Optional[float] = None,
                             top_k: Optional[int] = None,
                             top_p: Optional[float] = None,
                             return_all_beams: bool = False):
        """Beam search with the beams on the batch axis (JAX
        generate_beam_search): one prefill, the first expansion from its
        logits, then one decode step of all beams a token, after which
        the cache is gathered by each new beam's parent. Scores are the
        summed logs of the filtered distribution (temperature, then
        top-k, then top-p, renormalized; None leaves it unfiltered);
        finished beams propose only EOS at 0. Ranking is by
        `logp / len^length_penalty`.

        Returns the best beam as a GenerationResult with per-token
        `logprobs`, or all beams sorted by normalized score when
        return_all_beams=True."""
        self._validate(input_tokens)
        if max_new_tokens <= 0:
            raise TokenError("beam search needs max_new_tokens >= 1")
        lp_pen = (self.config.length_penalty if length_penalty is None
                  else length_penalty)
        eos = self.config.eos_token_id
        temp = 1.0 if temperature is None else float(temperature)
        tk = 0 if top_k is None else int(top_k)
        tp = 1.0 if top_p is None else float(top_p)
        t0 = time.perf_counter()

        def filt(logits):
            """The masked log_softmax IS the log of the filtered,
            renormalized distribution."""
            x = sampling.apply_temperature(logits, temp)
            x = sampling.apply_top_k(x, tk)
            x = sampling.apply_top_p(x, tp)
            return sampling.log_softmax(x)

        tokens, seq_lens, _ = self._pad_batch([input_tokens])
        plen = len(input_tokens)
        max_new = min(max_new_tokens, self.config.max_seq_len - plen)
        cache = self._take_cache(1)
        beams = self._take_cache(beam_size)
        try:
            first_logits, cache = self._prefill(tokens, seq_lens, cache,
                                                fresh=True)
            first_lp, first_ix = _top_k(filt(first_logits[0]), beam_size)
            scores = first_lp
            finished = first_ix == eos
            token = first_ix.to(torch.int32)
            # every beam starts from the prompt's cache rows
            for dst, src in self._cache_planes(beams, cache):
                dst[:, :, :, :plen] = src[:, :1, :, :plen]
            beams = beams._replace(length=torch.full_like(beams.length,
                                                          plen))
            V = first_logits.shape[-1]
            frozen = torch.full((beam_size, V), sampling.NEG_INF,
                                device=self.device)
            frozen[:, eos] = 0.0
            toks, parents, lps = [], [], []
            for t in range(max_new - 1):
                logits, beams = self._decode_step(token, beams)
                logp = torch.where(finished[:, None], frozen, filt(logits))
                total = scores[:, None] + logp                 # [beam, V]
                top_s, top_i = _top_k(total.reshape(-1), beam_size)
                parent = top_i // V
                tok = (top_i % V).to(torch.int32)
                lps.append(top_s - scores[parent])
                finished = finished[parent] | (tok == eos)
                self._beam_gather(beams, parent, plen + t + 1)
                toks.append(tok)
                parents.append(parent)
                scores, token = top_s, tok
            host = _to_host(first_ix, first_lp, scores, finished,
                             *toks, *parents, *lps)
        finally:
            self._put_cache(1, cache)
            self._put_cache(beam_size, beams)
        first_np, first_lp_np, scores_np, finished_np = host[:4]
        n_steps = max_new - 1
        toks_np = host[4:4 + n_steps]
        parents_np = host[4 + n_steps:4 + 2 * n_steps]
        lps_np = host[4 + 2 * n_steps:]
        beam_tokens = np.zeros((beam_size, n_steps + 1), np.int64)
        beam_lps = np.zeros((beam_size, n_steps + 1), np.float64)
        for b in range(beam_size):
            cur = b
            for t in range(n_steps - 1, -1, -1):
                beam_tokens[b, t + 1] = toks_np[t][cur]
                beam_lps[b, t + 1] = lps_np[t][cur]
                cur = int(parents_np[t][cur])
            beam_tokens[b, 0] = first_np[cur]
            beam_lps[b, 0] = first_lp_np[cur]

        lengths = np.array([self._beam_len(beam_tokens[b], eos)
                            for b in range(beam_size)])
        norm = scores_np / np.maximum(lengths, 1) ** lp_pen
        order = np.argsort(-norm, kind="stable")
        t1 = time.perf_counter()
        results = []
        for b in order:
            row = beam_tokens[b].tolist()
            n = self._beam_len(row, eos)
            results.append(GenerationResult(
                tokens=list(input_tokens) + row[:n],
                logprobs=beam_lps[b, :n].tolist(),
                total_time_ms=(t1 - t0) * 1e3,
                tokens_per_second=n / max(t1 - t0, 1e-9),
                finished=bool(finished_np[b]),
                stop_reason="eos" if eos in row[:n] else "length"))
        best_n = len(results[0].tokens) - len(input_tokens)
        self.stats.record_generation(new_tokens=best_n, elapsed_s=t1 - t0,
                                     prefill_s=0.0, batch=1)
        return results if return_all_beams else results[0]

    @staticmethod
    def _beam_len(row, eos) -> int:
        row = list(row)
        return row.index(eos) + 1 if eos in row else len(row)

    @staticmethod
    def _cache_planes(a: KVCache, b: KVCache):
        """(a, b) pairs of the cache tensors that carry positions: K, V
        and an int8 cache's scale planes (an fp8 cache's bytes are uint8
        and move like any other)."""
        pairs = [(a.k, b.k), (a.v, b.v)]
        if a.k_scale is not None:
            pairs += [(a.k_scale, b.k_scale), (a.v_scale, b.v_scale)]
        return pairs

    def _beam_gather(self, cache: KVCache, parent: torch.Tensor,
                     n: int) -> None:
        """Reorder the beam cache by parent, in place: beam b takes the
        rows of beam parent[b]. Only the first n positions (the longest
        live length) carry data, so only they move. The indexed read
        makes a copy before the write, so no beam reads a row another
        beam has already overwritten."""
        for plane, _ in self._cache_planes(cache, cache):
            plane[:, :, :, :n] = plane[:, parent, :, :n]

    # -- logprobs ---------------------------------------------------------

    def compute_logprobs(self, tokens: Sequence[int]) -> List[float]:
        """Log-prob of each token given its prefix (JAX
        compute_logprobs): one forward_no_cache over the bucketed
        sequence. The first token gets 0.0 (no context)."""
        self._validate(tokens)
        S = _bucket(len(tokens), self.config.prefill_bucket,
                    cap=self.config.max_seq_len)
        arr = torch.full((1, S), self.config.pad_token_id, dtype=torch.int32)
        arr[0, :len(tokens)] = torch.as_tensor(list(tokens),
                                               dtype=torch.int32)
        arr = arr.to(self.device)
        logits = self._model.forward_no_cache(
            self.params, self.model_config, arr,
            seq_lens=torch.tensor([len(tokens)], dtype=torch.int32,
                                  device=self.device))
        lp = sampling.log_softmax(logits[0].float())             # [S, V]
        token_lp = lp[:-1].gather(-1, arr[0, 1:, None].long())[:, 0]
        return [0.0] + token_lp[:len(tokens) - 1].tolist()

    # -- chat ---------------------------------------------------------------

    def _chat_prompt(self, messages) -> List[int]:
        if self.tokenizer is None:
            raise RuntimeError("chat requires a tokenizer (load the model "
                               "from a checkpoint with a vocab)")
        return self.tokenizer.apply_chat_template(messages, tokenize=True)

    def chat(self, messages, max_new_tokens: int = 256,
             **sampling_kw) -> GenerationResult:
        """One assistant turn: render `messages` with the checkpoint's
        chat template, generate, and return the result with `.text` set
        to the decoded reply."""
        ids = self._chat_prompt(messages)
        res = self.generate(ids, max_new_tokens, **sampling_kw)
        res.text = self.tokenizer.decode(res.tokens[len(ids):])
        return res

    def chat_stream(self, messages, max_new_tokens: int = 256, *,
                    burst: int = 8, **sampling_kw):
        """Streaming chat(): yields StreamChunk with text deltas."""
        return self.generate_stream(self._chat_prompt(messages),
                                    max_new_tokens, burst=burst,
                                    **sampling_kw)

    # -- tokenizer passthrough ----------------------------------------------

    def encode(self, text: str) -> List[int]:
        if self.tokenizer is None:
            raise RuntimeError("engine has no tokenizer attached")
        return self.tokenizer.encode(text)

    def decode(self, tokens: Sequence[int]) -> str:
        if self.tokenizer is None:
            raise RuntimeError("engine has no tokenizer attached")
        return self.tokenizer.decode(tokens)

    # -- introspection ------------------------------------------------------

    def reset_state(self):
        self.stats = EngineStats()
        self._gen = self._new_generator()
        self._cache_pool.clear()

    def memory_usage(self) -> int:
        """Bytes for weights + one max-shape KV cache (with an int8
        cache's f32 scale planes)."""
        c = self.model_config
        rows = (c.num_layers * self.config.max_batch_size
                * self.config.max_seq_len * c.kv_heads)
        itemsize = torch.empty((), dtype=self._kv_dtype).element_size()
        row_bytes = c.head_dim_ * itemsize + (
            4 if self._kv_dtype == torch.int8 else 0)
        return int(param_bytes(self.params) + 2 * rows * row_bytes)

    def performance_stats(self) -> str:
        dev = (torch.cuda.get_device_name(self.device)
               if self.device.type == "cuda" else "cpu")
        return self.stats.report(model_name=self.model_config.name,
                                 memory_bytes=self.memory_usage(), device=dev)


def quick_generate(params, model_config, prompt_tokens, max_new_tokens=50,
                   device="cuda", **kw) -> List[int]:
    """One engine, one generate() -> the token list (JAX quick_generate)."""
    eng = InferenceEngine(params, model_config, device=device)
    return eng.generate(prompt_tokens, max_new_tokens, **kw).tokens
