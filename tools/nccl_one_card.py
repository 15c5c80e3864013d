#!/usr/bin/env python3
"""What NCCL says to two ranks that share one GPU (why chip_smoke.py
phase 21 runs its two ranks over gloo).

    python3 tools/nccl_one_card.py [--timeout 120]

Spawns two processes, both on cuda:0, joins them in an NCCL group
through a file:// store and has them all-reduce 4 floats. Each rank
reports what happened (the exception's type and message, or the
result); a rank still running after --timeout seconds is killed and
reported as hung. Prints one JSON object as its last line. Runs on the
GPU only.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rank_main(rank: int, store: str, q) -> None:
    import datetime
    import torch
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                world_size=2, rank=rank,
                                timeout=datetime.timedelta(seconds=60))
        x = torch.ones(4, device="cuda:0") * (rank + 1)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        q.put((rank, f"ran: {x.tolist()}"))
        dist.destroy_process_group()
    except Exception as e:                     # noqa: BLE001
        msg = f"{type(e).__name__}: {e}"
        q.put((rank, msg[:1200] or traceback.format_exc()[-1200:]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as tmp
    if not torch.cuda.is_available():
        print("nccl_one_card: no CUDA device", file=sys.stderr)
        return 2
    work = tempfile.mkdtemp(prefix="nccl_probe_", dir=ROOT)
    ctx = tmp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=rank_main, args=(r, f"{work}/store", q))
             for r in range(2)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(args.timeout)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    said = {}
    while not q.empty():
        r, msg = q.get()
        said[r] = msg
    out = {"device": torch.cuda.get_device_name(0), "ranks": said,
           "hung": hung, "exit_codes": [p.exitcode for p in procs]}
    for r in sorted(said):
        print(f"rank {r}: {said[r]}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
