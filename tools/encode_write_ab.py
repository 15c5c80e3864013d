#!/usr/bin/env python3
"""The encode-and-write kernel of two trees on one card, in turns.

    python3 tools/encode_write_ab.py --other DIR [--rounds 2] [--json PATH]

DIR is another checkout of the repository (for example the parent commit
unpacked with `git archive` into a gitignored directory). Each turn is a
fresh process that imports turboinfer_tpu_torch from one tree (its
kernels built from that tree's sources into its own build directory) and
runs this tree's chip_smoke.check_encode_writes: every kv_encode_write row
of phase 2, byte for byte against the plain version, timed beside its
byte bound. Then, as chip_smoke.py phase 10 (a) does, it builds the 7B
int4 model (L=32, synthetic weights from seed 0) and traces two
prefills of 8 prompts of 960 tokens (T=2048) over an int8 and an fp8
cache, after one untimed prefill each: the device ms a prefill and the
encode-and-write kernel's part of it. Turns go this tree, DIR, this
tree, DIR, ... (`--rounds` pairs), so both trees meet the same card and
the same drift. Prints each turn's rows, then one JSON object as its
last line: per row, the mean kernel ms of each tree and their ratio,
and the same for the traced prefills. Runs on the GPU only.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(tree: str) -> None:
    """One turn: the rows of check_encode_writes with the package of
    `tree`, as one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import turboinfer_tpu_torch
    smoke.need(os.path.dirname(os.path.dirname(turboinfer_tpu_torch.__file__))
               == os.path.abspath(tree), "imported the wrong tree")
    from turboinfer_tpu_torch.kernels import _build
    _build.library()
    rows = []
    smoke.check_encode_writes(torch, rows, {})
    rows += prefill_rows(torch, smoke)
    print(json.dumps(rows), flush=True)


def prefill_rows(torch, smoke):
    """Phase 10 (a)'s prefill over int8 and fp8 caches, traced: one row
    each, its ms the device ms a prefill."""
    from turboinfer_tpu_torch.config import InferenceConfig, llama7b_config
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    B, S, T = 8, 960, 2048
    cfg = llama7b_config(num_layers=32, max_seq_len=T)
    params = prepare_params(create_synthetic_quantized_model(
        cfg, bits=4, group_size=64, device="cuda", seed=0).params)
    gen = torch.Generator().manual_seed(10)
    prompts = torch.randint(1, cfg.vocab_size, (B, S), generator=gen).tolist()
    out = []
    for kv in smoke.KV_KINDS:
        eng = InferenceEngine(params, cfg, InferenceConfig(
            max_seq_len=T, temperature=0.0, seed=0, eos_token_id=-1,
            kv_cache_dtype=kv), device="cuda")
        tokens, seq_lens, _ = eng._pad_batch(prompts)
        cache = eng._take_cache(B)
        eng._run_prefill(tokens, seq_lens, cache)
        eng._put_cache(B, cache)
        tr = smoke.trace_prefill(torch, eng, prompts, f"{kv} prefill")
        enc = sum(v for k, v in tr["device_ms_per_step_by_kernel"].items()
                  if "kv_encode_write" in k)
        out.append(dict(shape=f"phase 10 (a) {kv} prefill B={B} S={S} T={T}, "
                              "traced device ms a prefill",
                        ms=tr["device_busy_ms_per_step"], encode_ms=enc,
                        bound_ms=None, plain_ms=None))
        del eng, cache
        torch.cuda.empty_cache()
    return out


def run_turns(script: str, other: str, rounds: int):
    """`rounds` pairs of turns, this tree then `other`, each a fresh
    process `script --other OTHER --child TREE` whose last stdout line is
    a JSON list of rows -> (card line, {"this": [...], "other": [...]}),
    or None when a turn failed (its output printed)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    trees = {"this": ROOT, "other": os.path.abspath(other)}
    turns = {"this": [], "other": []}
    for _ in range(rounds):
        for label in ("this", "other"):
            out = subprocess.run(
                [sys.executable, os.path.abspath(script), "--other", other,
                 "--child", trees[label]], capture_output=True, text=True)
            print(f"--- {label} ({trees[label]}), rc={out.returncode}")
            print(out.stdout[-20000:], out.stderr[-4000:], flush=True)
            if out.returncode != 0:
                return None
            turns[label].append(json.loads(out.stdout.strip().splitlines()[-1]))
    return smi, turns


def summarize(turns):
    """Per row of the turns: the mean kernel ms of each tree, their
    ratio, the bound and each turn's numbers."""
    summary = []
    for i, row in enumerate(turns["this"][0]):
        this = statistics.mean(t[i]["ms"] for t in turns["this"])
        other = statistics.mean(t[i]["ms"] for t in turns["other"])
        summary.append(dict(
            shape=row["shape"], ms=this, other_ms=other, ratio=this / other,
            bound_ms=row["bound_ms"],
            bound_ratio=this / row["bound_ms"] if row["bound_ms"] else None,
            encode_ms=[t[i].get("encode_ms") for t in turns["this"]],
            other_encode_ms=[t[i].get("encode_ms") for t in turns["other"]],
            host_us=[t[i].get("host_us") for t in turns["this"]],
            other_host_us=[t[i].get("host_us") for t in turns["other"]],
            yardstick_ms=row.get("yardstick_ms"),
            library_ms=row.get("library_ms"),
            plain_ms=row["plain_ms"],
            each=[t[i]["ms"] for t in turns["this"]],
            other_each=[t[i]["ms"] for t in turns["other"]]))
    return summary


def main(argv=None, child_fn=None, name="encode_write_ab") -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--json", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        (child_fn or child)(args.child)
        return 0
    import torch
    if not torch.cuda.is_available():
        print(f"{name}: no CUDA device", file=sys.stderr)
        return 2
    got = run_turns(sys.argv[0], args.other, args.rounds)
    if got is None:
        return 1
    smi, turns = got
    result = {"card": smi, "rows": summarize(turns)}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(result, turns=turns), f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
