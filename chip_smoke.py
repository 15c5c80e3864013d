#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (turboinfer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases 1,2,3,4,5] [--json PATH]

Phases:
  1. environment: card name and power limit, torch/CUDA versions, and the
     build of the CUDA kernels from csrc/ (timed);
  2. kernels: each hand-written kernel against its plain PyTorch version
     at the main path's shapes, timed with CUDA events beside its bound
     and one PyTorch library call computing the same function;
  3. main path: the 7B-shape int4 (g=64) model, 32 layers, random weights
     from a seed, served through InferenceEngine.generate_batch for 8
     prompts of 512 tokens and 128 new tokens, greedy and sampled; every
     kernel's launch count is checked against the model's structure;
  4. kernels against plain versions on the same path: 7B shape, 2 layers,
     prefill and first decode-step logits, greedy-token agreement;
  5. the tiny int4 fixture (D=32, K=128) through generate_batch.
Exits non-zero on any failure (no CPU fallback). The last stdout line is
{"ok": true, "device": {...}}; before it come a {"kernels": [...]} line
and the nvidia-smi name/power-limit line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12         # dense bf16 tensor-core peak

ROOT_REPLACES = {
    "qmm_int4": "turboinfer_tpu/kernels/pallas/qmm.py:957",
    "flash_prefill": "turboinfer_tpu/kernels/pallas/flash_attention.py:314",
    "cache_write_fresh": "turboinfer_tpu/kernels/pallas/cache_write.py:58",
    "decode_attention": "turboinfer_tpu/kernels/pallas/decode_attention.py:447",
}
SOURCES = {
    "qmm_int4": "turboinfer_tpu_torch/csrc/qmm.cu",
    "flash_prefill": "turboinfer_tpu_torch/csrc/flash_prefill.cu",
    "cache_write_fresh": "turboinfer_tpu_torch/csrc/cache_write.cu",
    "decode_attention": "turboinfer_tpu_torch/csrc/decode_attention.cu",
}


class SmokeError(RuntimeError):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def say(*a) -> None:
    print(*a, flush=True)


def bound_ms(nbytes: float, flops: float):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / BF16_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


BF16_ULP = 2.0 ** -7   # relative spacing of bf16 values (8-bit mantissa)


def within(torch, got, want, atol: float) -> bool:
    """|got - want| <= atol + one bf16 ulp of |want|, elementwise: both
    sides round their f32 result to bf16, which may land one ulp apart."""
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= atol + BF16_ULP * w.abs()).all())


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    need(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, reps: int = 5, graph: bool = True
            ) -> float:
    """Median over `reps` of the mean device time of `iters` calls fn(i),
    from CUDA events. graph=True captures the calls once in a CUDA graph
    and times its replays, so host enqueue time stays out of short
    kernels; graph=False times an eager loop."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up, as capture requires
        fn(0)
        fn(1)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for i in range(iters):
                fn(i)
        g.replay()
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        if graph:
            g.replay()
        else:
            for i in range(iters):
                fn(i)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / iters)
    return statistics.median(times)


# -- phase 2 ---------------------------------------------------------------

def check_qmm(torch, rows, results):
    from turboinfer_tpu_torch.core.qtensor import QTensor, dequantize
    from turboinfer_tpu_torch.kernels import qmm
    gen = torch.Generator(device="cuda").manual_seed(1)
    L, g = 4, 64
    shapes = [("wqkv", 4096, 12288), ("wo", 4096, 4096),
              ("w_gateup", 4096, 22016), ("w_down", 11008, 4096),
              ("lm_head", 4096, 32000)]
    for M in (8, 4096):
        for name, K, N in shapes:
            if M > 8 and name == "lm_head":
                continue       # the prefill head runs at M = B (logit_idx)
            data = torch.randint(0, 256, (L, K // 2, N), generator=gen,
                                 dtype=torch.uint8, device="cuda")
            scales = (0.005 + 0.01 * torch.rand((L, K // g, N), generator=gen,
                                                device="cuda")).to(torch.bfloat16)
            qt = QTensor(data=data, scales=scales, zero_points=None, bits=4,
                         group_size=g, shape=(K, N))
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            got = qmm.qmm_int4(x, qt, 0)
            want = qmm.qmatmul_plain(x, qt, 0)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ref = want.float().abs().max().item()
            tol = 2e-2 * ref
            need(err <= tol, f"qmm {name} M={M}: max_abs_err {err} > {tol}")
            iters = 20 if M == 8 else 3
            ms = cuda_ms(torch, lambda i: qmm.qmm_int4(x, qt, i % L), iters)
            plain_ms = cuda_ms(torch, lambda i: qmm.qmatmul_plain(x, qt, i % L),
                               max(iters // 4, 2), reps=3)
            wd = [dequantize(qt.layer(li), torch.bfloat16)
                  for li in range(L)]
            lib_ms = cuda_ms(torch, lambda i: torch.matmul(x, wd[i % L]), iters)
            del wd
            nbytes = M * K * 2 + K // 2 * N + K // g * N * 2 + M * N * 2
            b, by = bound_ms(nbytes, 2.0 * M * K * N)
            row = dict(kernel="qmm_int4", shape=f"{name} M={M} K={K} N={N}",
                       max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b, bound_by=by)
            rows.append(row)
            say(f"  qmm_int4 {row['shape']}: max_abs_err={err:.4g} "
                f"(tol {tol:.3g}) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={b:.4f} ({by}) library_ms={lib_ms:.4f}")
            if name == "w_gateup" and M == 8:
                results["qmm_int4"] = row
            del data, scales, qt


def _attn_mask(torch, B, S, T, kv_len, q_start):
    qpos = q_start[:, None] + torch.arange(S, device="cuda")[None, :]
    kpos = torch.arange(T, device="cuda")
    return ((qpos[:, :, None] >= kpos[None, None, :])
            & (kpos[None, None, :] < kv_len[:, None, None]))[:, None]


def check_flash(torch, F, rows, results, B, Hq, Hkv, S, D, fill,
                record: bool, q_start=None, T=None):
    """Fresh prefill (q_start None): K/V are the just-computed [B, S, Hkv,
    D] read transposed, kv_len = fill. Chunked prefill: K/V are layer 1
    of a stacked [2, B, Hkv, T, D] cache, queries at q_start[b] + s,
    kv_len = q_start + fill < T."""
    from turboinfer_tpu_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    q = rnd(B, S, Hq, D)
    if q_start is None:
        q_start, T = [0] * B, S
        kt, vt = (rnd(B, S, Hkv, D).transpose(1, 2) for _ in range(2))
        what = ""
    else:
        kt, vt = (rnd(2, B, Hkv, T, D)[1] for _ in range(2))
        what = f"stacked layer 1 T={T} q_start={list(q_start)} "
    lens = [a + f for a, f in zip(q_start, fill)]
    need(max(lens) <= T, "check_flash: kv_len beyond the cache")
    qs = torch.tensor(q_start, dtype=torch.int32, device="cuda")
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = fa.flash_prefill(q, kt, vt, kv_len, qs)
    want = fa.prefill_plain(q, kt, vt, kv_len, qs)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = 2e-2        # bf16 probabilities in P V, plus one bf16 ulp
    need(within(torch, got, want, tol), f"flash_prefill {what}D={D} Hq={Hq} "
         f"Hkv={Hkv}: max_abs_err {err} beyond {tol} + 1 bf16 ulp")
    ms = cuda_ms(torch, lambda i: fa.flash_prefill(q, kt, vt, kv_len, qs), 10)
    plain_ms = cuda_ms(torch, lambda i: fa.prefill_plain(q, kt, vt, kv_len,
                                                         qs), 2, reps=3)
    mask = _attn_mask(torch, B, S, T, kv_len, qs)
    qh = q.transpose(1, 2)
    lib_ms = cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
        qh, kt, vt, attn_mask=mask, enable_gqa=Hq != Hkv), 10)
    # work this data needs: valid query rows, each against its visible keys
    pairs = sum(a + s + 1 for a, f in zip(q_start, fill) for s in range(f))
    flops = 4.0 * D * Hq * pairs
    nbytes = 2 * (2 * B * S * Hq * D + 2 * Hkv * D * sum(lens))
    b, by = bound_ms(nbytes, flops)
    row = dict(kernel="flash_prefill",
               shape=f"{what}B={B} Hq={Hq} Hkv={Hkv} S={S} D={D}",
               max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=b, bound_by=by)
    rows.append(row)
    say(f"  flash_prefill {row['shape']}: max_abs_err={err:.4g} (tol {tol}) "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b:.4f} ({by}) "
        f"library_ms={lib_ms:.4f}")
    if record:
        results["flash_prefill"] = row


def check_cache_write(torch, rows, results):
    from turboinfer_tpu_torch.kernels import cache_write as cw
    gen = torch.Generator(device="cuda").manual_seed(3)
    L, B, Hkv, T, S, D = 4, 8, 32, 1024, 512, 128
    kc = torch.full((L, B, Hkv, T, D), 7.0, dtype=torch.bfloat16, device="cuda")
    vc = kc.clone()
    qkv = torch.randn((B, S, 3 * Hkv * D), generator=gen,
                      device="cuda").to(torch.bfloat16)
    k = qkv[..., Hkv * D: 2 * Hkv * D].reshape(B, S, Hkv, D).contiguous()
    v = qkv[..., 2 * Hkv * D:].reshape(B, S, Hkv, D)   # strided view
    kc2, vc2 = kc.clone(), vc.clone()
    cw.cache_write_fresh(kc, vc, k, v, 2)
    cw.cache_write_plain(kc2, vc2, k, v, 2)
    torch.cuda.synchronize()
    same = torch.equal(kc, kc2) and torch.equal(vc, vc2)
    need(same, "cache_write_fresh differs from the plain write")
    err = max((kc.float() - kc2.float()).abs().max().item(),
              (vc.float() - vc2.float()).abs().max().item())
    ms = cuda_ms(torch, lambda i: cw.cache_write_fresh(kc, vc, k, v, i % L), 20)
    plain_ms = cuda_ms(torch, lambda i: cw.cache_write_plain(kc, vc, k, v,
                                                             i % L), 20)

    def lib(i):
        kc[i % L, :, :, :S].copy_(k.transpose(1, 2))
        vc[i % L, :, :, :S].copy_(v.transpose(1, 2))
    lib_ms = cuda_ms(torch, lib, 20)
    b, by = bound_ms(2 * 2 * B * S * Hkv * D * 2, 0.0)
    row = dict(kernel="cache_write_fresh", shape=f"B={B} Hkv={Hkv} S={S} "
               f"T={T} D={D}", max_abs_err=err, tol=0.0, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b, bound_by=by)
    rows.append(row)
    say(f"  cache_write_fresh {row['shape']}: exact={same} kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={b:.4f} ({by}) "
        f"library_ms={lib_ms:.4f} (two copy_ calls)")
    results["cache_write_fresh"] = row


def check_decode(torch, F, rows, results, B, Hq, Hkv, T, D, lens,
                 record: bool):
    from turboinfer_tpu_torch.kernels import decode_attention as da
    gen = torch.Generator(device="cuda").manual_seed(4)
    L = 4 if record else 1
    kc = torch.randn((L, B, Hkv, T, D), generator=gen,
                     device="cuda").to(torch.bfloat16)
    vc = torch.randn((L, B, Hkv, T, D), generator=gen,
                     device="cuda").to(torch.bfloat16)
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = da.decode_attention(q, kc, vc, kv_len, 0)
    want = da.decode_plain(q, kc, vc, kv_len, 0)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = 1e-2        # f32 sums in another order, plus one bf16 ulp
    need(within(torch, got, want, tol), f"decode_attention D={D} Hq={Hq} "
         f"Hkv={Hkv}: max_abs_err {err} beyond {tol} + 1 bf16 ulp")
    ms = cuda_ms(torch, lambda i: da.decode_attention(q, kc, vc, kv_len,
                                                      i % L), 20)
    plain_ms = cuda_ms(torch, lambda i: da.decode_plain(q, kc, vc, kv_len,
                                                        i % L), 5, reps=3)
    kvc = kv_len.clamp(1, T)
    mask = (torch.arange(T, device="cuda")[None, :] < kvc[:, None])[:, None, None]
    qh = q[:, :, None]
    lib_ms = cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
        qh, kc[i % L], vc[i % L], attn_mask=mask, enable_gqa=Hq != Hkv), 20)
    fill = sum(max(1, min(int(n), T)) for n in lens)
    nbytes = 2 * Hkv * fill * D * 2 + 2 * B * Hq * D * 2
    b, by = bound_ms(nbytes, 4.0 * Hq * fill * D)
    row = dict(kernel="decode_attention", shape=f"B={B} Hq={Hq} Hkv={Hkv} "
               f"T={T} D={D} kv_len={list(lens)}", max_abs_err=err, tol=tol,
               ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b,
               bound_by=by)
    rows.append(row)
    say(f"  decode_attention {row['shape']}: max_abs_err={err:.4g} "
        f"(tol {tol}) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={b:.4f} ({by}) library_ms={lib_ms:.4f}")
    if record:
        results["decode_attention"] = row


def phase_kernels(torch, report):
    import torch.nn.functional as F
    say("phase 2: kernels against their plain versions")
    rows, results = [], {}
    check_qmm(torch, rows, results)
    check_flash(torch, F, rows, results, 8, 32, 32, 512, 128,
                [512, 500, 384, 300, 257, 128, 64, 1], record=True)
    check_flash(torch, F, rows, results, 2, 8, 2, 128, 64, [128, 77],
                record=False)
    check_flash(torch, F, rows, results, 2, 4, 4, 64, 32, [64, 9],
                record=False)
    # the chunked-prefill read of the stacked cache (PERF.md row 6)
    check_flash(torch, F, rows, results, 8, 32, 32, 128, 128,
                [128, 128, 100, 128, 77, 5, 128, 1], record=False,
                q_start=[384, 0, 512, 256, 880, 128, 64, 700], T=1024)
    check_flash(torch, F, rows, results, 2, 4, 4, 32, 32, [32, 19],
                record=False, q_start=[40, 7], T=96)
    check_cache_write(torch, rows, results)
    check_decode(torch, F, rows, results, 8, 32, 32, 1024, 128,
                 [1, 513, 960, 1024, 700, 64, 300, 1000], record=True)
    check_decode(torch, F, rows, results, 2, 8, 2, 512, 64, [0, 300],
                 record=False)
    check_decode(torch, F, rows, results, 2, 4, 4, 256, 32, [1, 256],
                 record=False)
    report["kernel_rows"] = rows
    return results


# -- phase 3 ---------------------------------------------------------------

def expected_launches(L: int, decode_forwards: int, prefills: int = 1):
    per_fwd = 4 * L + 1
    return {"qmm_int4": per_fwd * (prefills + decode_forwards),
            "flash_prefill": L * prefills,
            "cache_write_fresh": L * prefills,
            "decode_attention": L * decode_forwards}


def run_counted(torch, kernels, eng, prompts, max_new, label, **kw):
    """One generate_batch with every launch count set to 0 just before
    and read just after."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    res = eng.generate_batch(prompts, max_new, **kw)
    counts = kernels.launch_counts()
    n_new = sum(len(r.tokens) - len(p) for r, p in zip(res, prompts))
    total_ms = res[0].total_time_ms
    prefill_ms = res[0].prefill_time_ms
    steps = -(-max_new // 32) * 32 - 1
    dec_ms = (total_ms - prefill_ms) / max(steps, 1)
    say(f"  {label}: prefill_ms={prefill_ms:.2f} decode_ms_per_step="
        f"{dec_ms:.3f} total_ms={total_ms:.1f} new_tokens={n_new} "
        f"tok_per_s={n_new / (total_ms / 1e3):.1f} launches={counts}")
    return res, counts, dict(prefill_ms=prefill_ms, decode_ms_per_step=dec_ms,
                             total_ms=total_ms, new_tokens=n_new,
                             tok_per_s=n_new / (total_ms / 1e3),
                             launches=counts)


def trace_decode(torch, eng, prompts, steps: int = 8):
    """Device busy share of greedy decode steps, from a torch.profiler
    trace: the summed duration of the CUDA kernels over the wall time of
    the window (kernels of one stream do not overlap). The profiler
    slows the host, so the traced share is a lower bound of the
    untraced one. Also reports the host ops that cost the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    B = len(prompts)
    tokens, seq_lens, _ = eng._pad_batch(prompts)
    cache = eng._take_cache(B)
    logits, cache = eng._run_prefill(tokens, seq_lens, cache)
    tok = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            lg, cache = eng._decode_step(tok, cache)
            tok = lg.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng._put_cache(B, cache)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU),
                 key=lambda e: e.self_cpu_time_total, reverse=True)[:6]
    res = dict(steps=steps, wall_ms_per_step=wall_ms / steps,
               device_busy_ms_per_step=busy_ms / steps,
               kernels_per_step=len(kernels) / steps,
               busy_share=busy_ms / wall_ms if kernels else None,
               top_host_ops=[(e.key, e.count / steps,
                              e.self_cpu_time_total / 1e3 / steps)
                             for e in top])
    if not kernels:
        say("  decode trace: the profiler recorded no device kernels "
            "(device busy share not measured)")
    else:
        say(f"  decode trace ({steps} greedy steps, profiler on): "
            f"wall {res['wall_ms_per_step']:.3f} ms/step, device busy "
            f"{res['device_busy_ms_per_step']:.3f} ms/step (share "
            f"{res['busy_share']:.3f}), {res['kernels_per_step']:.1f} "
            f"kernels/step")
        for key, n, ms in res["top_host_ops"]:
            say(f"    host {key}: {n:.1f} calls/step, {ms:.3f} ms/step "
                f"self CPU")
    return res


def phase_main(torch, report):
    from turboinfer_tpu_torch import kernels
    from turboinfer_tpu_torch.config import InferenceConfig, llama7b_config
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    from turboinfer_tpu_torch.models import llama
    say("phase 3: main path, 7B shape int4 g=64, L=32, B=8, prompt 512, "
        "128 new tokens")
    L, B, S, NEW, T = 32, 8, 512, 128, 1024
    cfg = llama7b_config(num_layers=L, max_seq_len=T)
    t0 = time.perf_counter()
    data = create_synthetic_quantized_model(cfg, bits=4, group_size=64,
                                            device="cuda", seed=0)
    eng = InferenceEngine(data.params, cfg, InferenceConfig(
        max_seq_len=T, temperature=0.8, top_k=50, top_p=0.9, seed=0,
        eos_token_id=-1, measure_ttft=True), device="cuda")
    del data
    torch.cuda.synchronize()
    say(f"  model built in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(1, cfg.vocab_size, (B, S), generator=gen).tolist()

    # logits of the path: prefill and one decode step, finite and shaped
    tokens, seq_lens, _ = eng._pad_batch(prompts)
    cache = eng._take_cache(B)
    logits, cache = eng._run_prefill(tokens, seq_lens, cache)
    nxt = logits.argmax(-1).to(torch.int32)
    step_logits, cache = eng._decode_step(nxt, cache)
    eng._put_cache(B, cache)
    torch.cuda.synchronize()
    need(tuple(logits.shape) == (B, cfg.vocab_size)
         and bool(torch.isfinite(logits).all())
         and bool(torch.isfinite(step_logits).all()),
         "main-path logits are not finite / not [B, V]")
    say(f"  logits finite: prefill {tuple(logits.shape)} "
        f"max|x|={logits.abs().max().item():.3f}, decode step "
        f"max|x|={step_logits.abs().max().item():.3f}")

    want = expected_launches(L, decode_forwards=NEW - 1)
    out = {}
    for label, kw in (("greedy", dict(temperature=0.0)), ("sampled", {})):
        res, counts, stats = run_counted(torch, kernels, eng, prompts, NEW,
                                         label, **kw)
        need(counts == want, f"{label}: launch counts {counts} != expected "
                             f"{want}")
        need(all(len(r.tokens) == S + NEW for r in res),
             f"{label}: wrong number of generated tokens")
        need(all(0 <= t < cfg.vocab_size for r in res for t in r.tokens),
             f"{label}: token out of range")
        out[label] = stats
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"  launches per run as expected: {want}; peak memory {peak:.2f} GiB")
    # the sampler alone, on logits of the path's shape
    from turboinfer_tpu_torch.engine import sampling
    lg = torch.randn((B, cfg.vocab_size), generator=torch.Generator(
        device="cuda").manual_seed(5), device="cuda") * 3
    g = torch.Generator(device="cuda").manual_seed(0)
    for label, sp in (("greedy", sampling.SamplingParams(temperature=0.0)),
                      ("sampled", eng._sampling_params())):
        t0 = time.perf_counter()
        ms = cuda_ms(torch, lambda i: sampling.sample(g, lg, sp), 20,
                     graph=False)
        out[label]["sample_ms"] = ms
        say(f"  sample() {label} [B={B}, V={cfg.vocab_size}]: {ms:.4f} ms "
            f"(CUDA events, eager; host {1e3 * (time.perf_counter() - t0) / 102:.4f}"
            f" ms per call)")
    report["main_path"] = dict(config="llama7b int4 g=64 L=32 B=8 S=512 "
                               "new=128 max_seq=1024", runs=out,
                               expected_launches=want, peak_gib=peak,
                               decode_trace=trace_decode(torch, eng, prompts))
    del eng
    torch.cuda.empty_cache()
    return out["greedy"]["launches"]


# -- phase 4 ---------------------------------------------------------------

def phase_path_vs_plain(torch, report):
    from turboinfer_tpu_torch.config import llama7b_config
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    from turboinfer_tpu_torch.models import llama
    from turboinfer_tpu_torch.models.common import params_to
    say("phase 4: kernels against plain versions on the path "
        "(7B shape, L=2, B=8, prompt 128)")
    L, B, S, T = 2, 8, 128, 1024
    cfg = llama7b_config(num_layers=L, max_seq_len=T)
    params = prepare_params(create_synthetic_quantized_model(
        cfg, bits=4, group_size=64, device="cuda", seed=1).params)
    cpu_params = params_to(params, "cpu")
    gen = torch.Generator().manual_seed(1)
    lens = [128, 120, 100, 77, 64, 33, 17, 5]
    tok = torch.zeros((B, S), dtype=torch.int32)
    for b, n in enumerate(lens):
        tok[b, :n] = torch.randint(1, cfg.vocab_size, (n,), generator=gen)
    seq = torch.tensor(lens, dtype=torch.int32)
    idx = (seq - 1).clamp(min=0)
    out = {}
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        cache = llama.init_cache(cfg, B, max_seq=T, device=dev)
        lg, cache = llama.forward(p, cfg, tok.to(dev), cache,
                                  seq_lens=seq.to(dev), logit_idx=idx.to(dev),
                                  fresh_prefill=True)
        out[dev] = [lg[:, 0].float().cpu(), cache]
    greedy_k = out["cuda"][0].argmax(-1)
    greedy_p = out["cpu"][0].argmax(-1)
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        lg, _ = llama.forward(p, cfg, greedy_k.to(torch.int32)[:, None].to(dev),
                              out[dev][1])
        out[dev].append(lg[:, 0].float().cpu())
    res = {}
    for i, name in ((0, "prefill"), (2, "decode_step")):
        a, b_ = out["cuda"][i], out["cpu"][i]
        err = (a - b_).abs().max().item()
        ref = b_.abs().max().item()
        tol = 5e-2 * ref
        need(bool(torch.isfinite(a).all()), f"{name}: kernel logits not finite")
        need(err <= tol, f"{name} logits: kernel vs plain max_abs_err {err} "
                         f"> {tol}")
        agree = (a.argmax(-1) == b_.argmax(-1)).float().mean().item()
        res[name] = dict(max_abs_err=err, tol=tol, max_abs_logit=ref,
                         greedy_agreement=agree)
        say(f"  {name}: logits max_abs_err={err:.4g} (tol {tol:.3g}, "
            f"max|logit|={ref:.3g}) greedy-token agreement={agree:.3f}")
    say(f"  prefill greedy tokens equal: "
        f"{int((greedy_k == greedy_p).sum())}/{B}")
    report["path_vs_plain"] = res


# -- phase 5 ---------------------------------------------------------------

def phase_tiny(torch, report):
    from turboinfer_tpu_torch import kernels
    from turboinfer_tpu_torch.config import (InferenceConfig,
                                             QuantizationConfig, QuantType,
                                             tiny_config)
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    from turboinfer_tpu_torch.models import llama
    from turboinfer_tpu_torch.models.common import params_to
    from turboinfer_tpu_torch.quant.quantizer import quantize_params
    say("phase 5: tiny int4 fixture (D=32, K=128), B=1, 1024 new tokens")
    NEW = 1024
    cfg = tiny_config(max_seq_len=1 << (NEW + 16).bit_length())
    params = quantize_params(llama.init_params(cfg, seed=0, device="cuda"),
                             QuantizationConfig(type=QuantType.INT4,
                                                group_size=64))
    eng = InferenceEngine(params, cfg, InferenceConfig(
        max_seq_len=cfg.max_seq_len, temperature=0.8, top_k=50, top_p=0.9,
        seed=0, eos_token_id=-1, measure_ttft=True), device="cuda")
    prompts = [[1, 17, 42, 256, 731, 5, 9, 88]]
    eng.generate_batch(prompts, NEW)                       # warm
    res, counts, stats = run_counted(torch, kernels, eng, prompts, NEW,
                                     "tiny sampled")
    want = expected_launches(cfg.num_layers, decode_forwards=NEW - 1)
    need(counts == want, f"tiny: launch counts {counts} != {want}")
    need(len(res[0].tokens) == len(prompts[0]) + NEW, "tiny: wrong length")
    # tiny prefill logits: kernels against plain versions on the CPU
    tok = torch.tensor([prompts[0] + [0] * 8], dtype=torch.int32)
    seq = torch.tensor([len(prompts[0])], dtype=torch.int32)
    lgs = []
    for dev, p in (("cuda", eng.params), ("cpu", params_to(eng.params, "cpu"))):
        cache = llama.init_cache(cfg, 1, max_seq=64, device=dev)
        lg, _ = llama.forward(p, cfg, tok.to(dev), cache, seq_lens=seq.to(dev),
                              logit_idx=(seq - 1).to(dev), fresh_prefill=True)
        lgs.append(lg.float().cpu())
    err = (lgs[0] - lgs[1]).abs().max().item()
    tol = 5e-2 * lgs[1].abs().max().item()
    need(err <= tol, f"tiny logits: kernel vs plain max_abs_err {err} > {tol}")
    say(f"  tiny prefill logits kernel vs plain: max_abs_err={err:.4g} "
        f"(tol {tol:.3g})")
    stats["logits_max_abs_err"] = err
    report["tiny"] = stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5")
    ap.add_argument("--json", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",") if p}

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on the GPU only", file=sys.stderr)
        return 2
    try:
        from turboinfer_tpu_torch import kernels
        from turboinfer_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the turboinfer_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    report = {}
    try:
        say("phase 1: environment")
        smi = nvidia_smi_line()
        say(f"  card: {smi}")
        say(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"python {sys.version.split()[0]}, device "
            f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        t0 = time.perf_counter()
        _build.library()
        build_s = time.perf_counter() - t0
        say(f"  kernel build+load: {build_s:.1f} s "
            f"(nvcc {_build.BUILD_INFO.get('nvcc', 'cached build')})")
        for name, rep in _build.BUILD_INFO.get("ptxas", {}).items():
            for line in rep.splitlines():
                if "registers" in line or "spill" in line:
                    say(f"  ptxas {name}: {line.strip()}")
        report["env"] = dict(card=smi, torch=torch.__version__,
                             cuda=torch.version.cuda, build_s=build_s)
        results = phase_kernels(torch, report) if 2 in phases else {}
        main_launches = phase_main(torch, report) if 3 in phases else {}
        if 4 in phases:
            phase_path_vs_plain(torch, report)
        if 5 in phases:
            phase_tiny(torch, report)
    except (SmokeError, RuntimeError, ValueError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(dict(report, error=str(e)), f, indent=1)
        return 1

    kern = []
    for name in kernels.wrappers():
        r = results.get(name, {})
        kern.append({"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": ROOT_REPLACES[name],
                     "launches": main_launches.get(name, 0),
                     "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
                     "plain_ms": r.get("plain_ms"),
                     "bound_ms": r.get("bound_ms"),
                     "bound_by": r.get("bound_by"),
                     "library_ms": r.get("library_ms"),
                     "shape": r.get("shape")})
    report["kernels"] = kern
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kern}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
