#!/usr/bin/env python3
"""Host time of a paged decode step over a model-dtype, an int8 and an
fp8 page pool, taken interleaved so that the host's drift hits all three
alike.

    python3 tools/paged_step_profile.py [--json PATH]

The 7B-shape int4 model (g=64, random weights from a seed) serves the
same 8 greedy requests through three PagedContinuousScheduler instances
(8 slots, 256-token pages, max_seq 1024), one per pool dtype, on one
card. After the admissions, plain decode steps are taken round-robin
over the three schedulers, the order rotated every round. Per pool:
- wall ms of a step (it ends in the step's one device-to-host fetch);
- enqueue ms: host time of the step's forward and sampling
  (`_paged_step`), which waits on the card only if the card is behind;
- device syncs in one step (torch.cuda.set_sync_debug_mode("warn"));
- tensor allocations and device mallocs of the caching allocator per
  step;
- a cProfile of a few steps: own host time per function and step, and
  the functions whose time differs most from the model-dtype pool's.
Runs on the GPU only; prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)          # the port's package beside tools/

KINDS = ("model", "int8", "fp8")
SLOTS, PAGE, T, NEW = 8, 256, 1024, 400
LAYERS, ROUNDS, PROFILED_STEPS = 32, 30, 8


class EnqueueTimer:
    """Stands in for a scheduler's _paged_step and records its host ms."""

    def __init__(self, sched):
        self.inner, self.ms = sched._paged_step, []
        sched._paged_step = self

    def __call__(self, lengths):
        t0 = time.perf_counter()
        out = self.inner(lengths)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


def alloc_counts(torch):
    st = torch.cuda.memory_stats()
    return (st.get("allocation.all.allocated", 0),
            st.get("num_device_alloc", 0))


def own_ms(prof: cProfile.Profile, steps: int):
    """{function: own host ms per step} of a profile."""
    out = {}
    for (path, line, fn), (_, _, tt, _, _) in pstats.Stats(prof).stats.items():
        name = f"{os.path.basename(path)}:{line}({fn})"
        out[name] = out.get(name, 0.0) + tt * 1e3 / steps
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("paged_step_profile: no GPU", file=sys.stderr)
        return 2
    from turboinfer_tpu_torch.config import InferenceConfig, llama7b_config
    from turboinfer_tpu_torch.engine.scheduler import PagedContinuousScheduler
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    cfg = llama7b_config(num_layers=LAYERS, max_seq_len=T)
    params = prepare_params(create_synthetic_quantized_model(
        cfg, bits=4, group_size=64, device="cuda", seed=0).params)
    gen = torch.Generator().manual_seed(6)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in torch.linspace(100, 600, SLOTS).long().tolist()]
    scheds, timers = {}, {}
    for kv in KINDS:
        s = PagedContinuousScheduler(
            params, cfg, InferenceConfig(max_seq_len=T, temperature=0.0,
                                         seed=0, eos_token_id=-1,
                                         kv_cache_dtype=kv),
            batch_slots=SLOTS, page_size=PAGE, device="cuda")
        for p in prompts:
            s.submit(p, NEW, temperature=0.0)
        s.step()                      # all admissions and the first step
        if len(s._active) != SLOTS or s._queue:
            raise RuntimeError(f"{kv}: {len(s._active)} slots active")
        scheds[kv], timers[kv] = s, EnqueueTimer(s)
    for _ in range(3):                # warm-up
        for kv in KINDS:
            scheds[kv].step()
    wall = {kv: [] for kv in KINDS}
    allocs = {kv: [] for kv in KINDS}
    for kv in KINDS:
        timers[kv].ms.clear()
    for r in range(ROUNDS):
        order = KINDS[r % 3:] + KINDS[:r % 3]
        for kv in (order if r % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            a0 = alloc_counts(torch)
            t0 = time.perf_counter()
            scheds[kv].step()
            wall[kv].append((time.perf_counter() - t0) * 1e3)
            a1 = alloc_counts(torch)
            allocs[kv].append((a1[0] - a0[0], a1[1] - a0[1]))
    out = {"card": card, "layers": LAYERS, "rounds": ROUNDS, "pools": {}}
    for kv in KINDS:
        w, e = wall[kv], timers[kv].ms
        out["pools"][kv] = dict(
            wall_ms_median=statistics.median(w),
            wall_ms_p10=sorted(w)[len(w) // 10],
            wall_ms_p90=sorted(w)[(9 * len(w)) // 10],
            enqueue_ms_median=statistics.median(e),
            tensor_allocs_per_step=statistics.median(a for a, _ in allocs[kv]),
            device_mallocs=sum(m for _, m in allocs[kv]))
    # device syncs in one step
    for kv in KINDS:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            scheds[kv].step()
        torch.cuda.set_sync_debug_mode("default")
        msgs = [str(c.message).splitlines()[0] for c in caught
                if "synchroniz" in str(c.message)]
        out["pools"][kv]["syncs_per_step"] = len(msgs)
        out["pools"][kv]["sync_kinds"] = sorted(set(msgs))[:4]
    # own host time per function, cProfile'd (profiling inflates Python
    # time against C time alike in every pool)
    own = {}
    for kv in KINDS:
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(PROFILED_STEPS):
            scheds[kv].step()
        prof.disable()
        own[kv] = own_ms(prof, PROFILED_STEPS)
        top = sorted(own[kv].items(), key=lambda kv_: -kv_[1])[:12]
        out["pools"][kv]["profiled_ms_per_step"] = sum(own[kv].values())
        out["pools"][kv]["top_own_ms"] = top
    for kv in KINDS[1:]:
        names = set(own[kv]) | set(own["model"])
        diff = {n: own[kv].get(n, 0.0) - own["model"].get(n, 0.0)
                for n in names}
        out["pools"][kv]["most_changed_vs_model_ms"] = sorted(
            diff.items(), key=lambda kv_: -abs(kv_[1]))[:10]
    for kv in KINDS:
        p = out["pools"][kv]
        print(f"{kv:5s} pool: wall {p['wall_ms_median']:.3f} ms/step "
              f"(p10 {p['wall_ms_p10']:.3f}, p90 {p['wall_ms_p90']:.3f}), "
              f"enqueue {p['enqueue_ms_median']:.3f}, syncs "
              f"{p['syncs_per_step']} {p['sync_kinds']}, tensor allocs "
              f"{p['tensor_allocs_per_step']}, device mallocs "
              f"{p['device_mallocs']}, profiled "
              f"{p['profiled_ms_per_step']:.3f} ms/step", flush=True)
        for name, ms in p["top_own_ms"]:
            print(f"    {ms:8.3f} ms  {name}")
        for name, ms in p.get("most_changed_vs_model_ms", []):
            print(f"    {ms:+8.3f} ms vs model  {name}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: {m: v for m, v in p.items()
                          if not isinstance(v, list)}
                      for k, p in out["pools"].items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
