#!/usr/bin/env python3
"""The attention kernels of two trees on one card, in turns, with the
window and softcap flags off.

    python3 tools/attention_ab.py --other DIR [--rounds 2] [--json PATH]

DIR is another checkout of the repository (for example the parent commit
unpacked with `git archive` into a gitignored directory). Each turn is a
fresh process that imports turboinfer_tpu_torch from one tree (its
kernels built from that tree's sources into its own build directory) and
runs this tree's chip_smoke check functions on the flash prefill, decode
and paged rows of phase 2 that take no softcap and no new window (bf16,
int8 and fp8 K/V; the 7B, Mixtral and GPT-OSS shapes, the last with the
decode kernel's window, which predates them), each against its plain
version and timed beside its bound. The check functions pass a window or
a softcap to a wrapper only when one is set, so a tree whose wrappers
predate them runs the same rows. Turns go this tree, DIR, this tree,
DIR, ... (`--rounds` pairs). Prints each turn's rows, then one JSON
object as its last line: per row, the mean kernel ms of each tree and
their ratio (tools/encode_write_ab.py's format). Runs on the GPU only.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import encode_write_ab  # noqa: E402


def child(tree: str) -> None:
    """One turn: the flag-free attention rows with the package of
    `tree`, as one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import torch.nn.functional as F
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import turboinfer_tpu_torch
    smoke.need(os.path.dirname(os.path.dirname(turboinfer_tpu_torch.__file__))
               == os.path.abspath(tree), "imported the wrong tree")
    from turboinfer_tpu_torch.kernels import _build
    _build.library()
    rows, res = [], {}
    fill = [512, 500, 384, 300, 257, 128, 64, 1]
    chunk = dict(q_start=[384, 0, 512, 256, 880, 128, 64, 700], T=1024)
    smoke.check_flash(torch, F, rows, res, 8, 32, 32, 512, 128, fill, False)
    smoke.check_flash(torch, F, rows, res, 1, 32, 8, 1024, 128, [1000], False)
    for kind in (None, *smoke.KV_KINDS):
        smoke.check_flash(torch, F, rows, res, 8, 32, 32, 128, 128,
                          [128, 128, 100, 128, 77, 5, 128, 1], False,
                          kind=kind, **chunk)
        smoke.check_decode(torch, F, rows, res, 8, 32, 32, 1024, 128,
                           [1, 513, 960, 1024, 700, 64, 300, 1000], False,
                           kind=kind)
        smoke.check_decode(torch, F, rows, res, 1, 32, 8, 2048, 128, [1128],
                           False, kind=kind)
        for G in (1, 5):
            for Hkv in (32, 8):      # the 7B (R = G) and Mixtral's GQA
                smoke.check_paged(torch, F, rows, res, 8, 32, Hkv, 128, 256,
                                  33, [1, 1000, 257, 512, 700, 64, 999, 300],
                                  G, False, kind=kind)
    smoke.check_decode(torch, F, rows, res, 8, 64, 8, 2048, 64,
                       [1128, 1, 255, 256, 257, 384, 600, 2048], False, 128,
                       True)
    print(json.dumps(rows), flush=True)


if __name__ == "__main__":
    sys.exit(encode_write_ab.main(child_fn=child, name="attention_ab"))
