#!/usr/bin/env python3
"""Acceptance of chip_smoke.py phase 7's speculative serving at several
draft depths, through the kernels and through their plain versions.

    python3 tools/spec_acceptance.py [--drafts 4,2] [--json PATH]

The 7B-shape int4 model of phase 7 (32 layers, g=64, random weights
from seed 0) serves phase 7's 8 greedy requests x 48 new tokens through
PagedContinuousScheduler (8 slots, 256-token pages, spec_k=4), with the
first N layers as the draft, for each N of --drafts and each path:
"kernels", as the port runs, and "plain", where every kernel wrapper
the model reaches (qmm_int4, flash_prefill, cache_write_fresh,
decode_attention, paged_attention) is swapped for its plain PyTorch
version on the same CUDA tensors. Phase 7's check needs some proposals
rejected; if the plain path accepts as many as the kernels, a draft's
acceptance comes from the synthetic weights, not from a kernel. Runs on
the GPU only; prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)          # the port's package beside tools/

L, T, SLOTS, PAGE, SPEC_K, NEW = 32, 1024, 8, 256, 4, 48


@contextlib.contextmanager
def plain_kernels():
    """Every wrapper phase 7 reaches, swapped for its plain version."""
    from turboinfer_tpu_torch.kernels import (cache_write, decode_attention,
                                              flash_attention,
                                              paged_attention, qmm)
    swaps = [
        (qmm, "qmm_int4", lambda x, qt, li=None: qmm.qmatmul_plain(x, qt, li)),
        (flash_attention, "flash_prefill", flash_attention.prefill_plain),
        (cache_write, "cache_write_fresh", cache_write.cache_write_plain),
        (decode_attention, "decode_attention", decode_attention.decode_plain),
        (paged_attention, "paged_attention",
         lambda q, kp, vp, table, kv_len, li, ks=None, vs=None:
         paged_attention.paged_plain(q, kp, vp, table, kv_len, li,
                                     q.shape[1], ks, vs)),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def serve(torch, cfg, params, draft_layers: int) -> dict:
    """Phase 7's requests through a fresh scheduler -> accepted,
    proposed and the kernels' launches."""
    from chip_smoke import first_layers
    from turboinfer_tpu_torch import kernels
    from turboinfer_tpu_torch.config import InferenceConfig
    from turboinfer_tpu_torch.engine.scheduler import PagedContinuousScheduler
    sched = PagedContinuousScheduler(
        params, cfg, InferenceConfig(max_seq_len=T, temperature=0.0, seed=0,
                                     eos_token_id=-1),
        batch_slots=SLOTS, page_size=PAGE,
        draft_params=first_layers(params, draft_layers),
        draft_config=cfg.replace(num_layers=draft_layers), spec_k=SPEC_K,
        device="cuda")
    gen = torch.Generator().manual_seed(7)
    reqs = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
            for n in torch.linspace(40, 600, SLOTS).long().tolist()]
    kernels.reset_launch_counts()
    for r in reqs:
        sched.submit(r, NEW)
    sched.run()
    torch.cuda.synchronize()
    return dict(accepted=sched.spec_accepted, proposed=sched.spec_proposed,
                launches={k: v for k, v in kernels.launch_counts().items()
                          if v})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--drafts", default="4,2",
                    help="draft depths in layers, comma-separated")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("spec_acceptance: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import serving_model
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    cfg, params = serving_model(torch, L, T)
    runs = []
    for dl in (int(v) for v in args.drafts.split(",")):
        for path in ("kernels", "plain"):
            ctx = (plain_kernels() if path == "plain"
                   else contextlib.nullcontext())
            with ctx:
                r = serve(torch, cfg, params, dl)
            r.update(draft_layers=dl, path=path)
            print(f"draft {dl} layers, {path}: accepted {r['accepted']} of "
                  f"{r['proposed']} proposals; launches {r['launches']}",
                  flush=True)
            runs.append(r)
    out = dict(card=smi, runs=runs)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
