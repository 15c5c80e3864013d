"""InferenceEngine in PyTorch: counterpart of
turboinfer_tpu/engine/engine.py for prefill + decode generation.

generate_batch keeps the JAX engine's semantics: prompts right-padded to
a power-of-two bucket width (capped at max_seq_len), one cold prefill
with a last-position head, then a decode loop whose length is the
budget rounded up to a multiple of 32 (the slack is discarded), per-row
budgets bounded by each row's own headroom, EOS and stop reasons, and
rows that fill the cache finishing on their own. Where JAX fuses the
decode loop into one program, this engine steps an eager per-token loop
on the device with no host synchronisation inside it. Beam search,
logprob scoring, streaming and chat come in later slices.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from turboinfer_tpu_torch.config import InferenceConfig, ModelConfig
from turboinfer_tpu_torch.engine import sampling
from turboinfer_tpu_torch.engine.sampling import SamplingParams
from turboinfer_tpu_torch.kernels.dispatch import prepare_params
from turboinfer_tpu_torch.models import registry
from turboinfer_tpu_torch.models.common import KVCache, param_bytes, params_to
from turboinfer_tpu_torch.utils.device import resolve_device
from turboinfer_tpu_torch.utils.errors import TokenError
from turboinfer_tpu_torch.utils.metrics import EngineStats


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


class InferenceEngine:
    """Holds params and configs on one device and drives prefill/decode.

    device: "cuda" (default) runs the Hopper kernels; "cpu" runs the
    plain PyTorch versions and must be asked for. Params are moved to
    the device and fused once (kernels.dispatch.prepare_params)."""

    def __init__(self, params: Dict[str, Any], model_config: ModelConfig,
                 config: Optional[InferenceConfig] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self._model = registry.get_model(model_config.architecture)
        self._model.check_supported(model_config)
        self.model_config = model_config
        self.config = config or InferenceConfig(
            max_seq_len=model_config.max_seq_len)
        if self.config.kv_cache_dtype not in ("model", "", None):
            raise NotImplementedError(
                f"kv_cache_dtype={self.config.kv_cache_dtype!r} is not ported"
                " yet (model-dtype caches only)")
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
        if not self.config.use_cache:
            raise NotImplementedError("use_cache=False is not ported yet")
        sp = self._sampling_params(**sampling_kw)
        eos, pad = self.config.eos_token_id, self.config.pad_token_id
        max_seq = self.config.max_seq_len
        t0 = time.perf_counter()

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

    # -- introspection ------------------------------------------------------

    def reset_state(self):
        self.stats = EngineStats()
        self._gen = self._new_generator()
        self._cache_pool.clear()

    def memory_usage(self) -> int:
        """Bytes for weights + one max-shape KV cache."""
        c = self.model_config
        cache_elems = (c.num_layers * self.config.max_batch_size
                       * self.config.max_seq_len * c.kv_heads * c.head_dim_)
        itemsize = torch.empty((), dtype=c.dtype).element_size()
        return int(param_bytes(self.params) + 2 * cache_elems * itemsize)

    def performance_stats(self) -> str:
        dev = (torch.cuda.get_device_name(self.device)
               if self.device.type == "cuda" else "cpu")
        return self.stats.report(model_name=self.model_config.name,
                                 memory_bytes=self.memory_usage(), device=dev)
