#!/usr/bin/env python3
"""Rate of the flash prefill kernel on one card, beside SDPA's causal form.

    python3 tools/flash_sweep.py [--json PATH]

Times flash_attention.flash_prefill (CUDA-graph replays, CUDA events, as
chip_smoke.py phase 2 does) on random bf16 inputs from a seed, every
sequence filled from position 0 or from a q_start deep in a cache, and
reports ms and useful TFLOP/s (4 * D * Hq operations per visible
query-key pair) at long and short prompts, bf16 and 8-bit K/V. Where
every sequence fills S from position 0, SDPA with is_causal=True computes
the same function and is timed beside it. Separates the kernel's rate in
its key loop (long prompts) from its per-block costs (short ones). Runs
on the GPU only; prints the card and one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)          # the port's package beside tools/

# (B, Hq, Hkv, S, D, q_start, T, K/V storage)
SHAPES = [(1, 32, 32, 4096, 128, 0, 4096, None),
          (1, 32, 8, 4096, 128, 0, 4096, None),
          (1, 32, 32, 4096, 64, 0, 4096, None),
          (8, 32, 32, 512, 128, 0, 512, None),
          (1, 32, 8, 1024, 128, 0, 1024, None),
          (4, 32, 32, 128, 128, 3968, 4096, None),
          (4, 32, 32, 128, 128, 3968, 4096, "int8"),
          (4, 32, 32, 128, 128, 3968, 4096, "fp8")]


def run(torch, B, Hq, Hkv, S, D, q_start, T, kind):
    import torch.nn.functional as F
    from chip_smoke import cuda_ms
    from turboinfer_tpu_torch.kernels import flash_attention as fa
    from turboinfer_tpu_torch.models.common import encode_kv_scaled
    gen = torch.Generator(device="cuda").manual_seed(S + Hkv + D)

    def rnd(*shape):
        return torch.randn(shape, generator=gen,
                           device="cuda").to(torch.bfloat16)
    q = rnd(B, S, Hq, D)
    if q_start == 0 and T == S:      # the fresh prefill's transposed view
        k, v = (rnd(B, S, Hkv, D).transpose(1, 2) for _ in range(2))
    else:
        k, v = rnd(B, Hkv, T, D), rnd(B, Hkv, T, D)
    ks = vs = None
    if kind is not None:
        dt = {"int8": torch.int8, "fp8": torch.uint8}[kind]
        (k, ks), (v, vs) = encode_kv_scaled(k, dt), encode_kv_scaled(v, dt)
    qs = torch.full((B,), q_start, dtype=torch.int32, device="cuda")
    kv_len = torch.full((B,), q_start + S, dtype=torch.int32, device="cuda")
    ms = cuda_ms(torch, lambda i: fa.flash_prefill(q, k, v, kv_len, qs, ks,
                                                   vs), 10)
    flops = 4.0 * D * Hq * B * sum(q_start + s + 1 for s in range(S))
    row = dict(shape=f"B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} "
               f"q_start={q_start} T={T} kv={kind or 'bf16'}", ms=ms,
               tflops=flops / ms / 1e9, sdpa_causal_ms=None)
    if q_start == 0 and T == S and kind is None:
        row["sdpa_causal_ms"] = cuda_ms(
            torch, lambda i: F.scaled_dot_product_attention(
                q.transpose(1, 2), k, v, is_causal=True,
                enable_gqa=Hq != Hkv), 10)
        row["sdpa_causal_tflops"] = flops / row["sdpa_causal_ms"] / 1e9
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_sweep: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    from chip_smoke import nvidia_smi_line
    rows = []
    for shape in SHAPES:
        r = run(torch, *shape)
        rows.append(r)
        lib = "" if r["sdpa_causal_ms"] is None else (
            f"; SDPA is_causal {r['sdpa_causal_ms']:.4f} ms "
            f"{r['sdpa_causal_tflops']:.0f} TFLOP/s")
        print(f"{r['shape']}: {r['ms']:.4f} ms {r['tflops']:.0f} TFLOP/s{lib}",
              flush=True)
    out = dict(card=nvidia_smi_line(), rows=rows)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(out["card"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
