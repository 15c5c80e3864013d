#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (turboinfer_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases 1,2,...,21] [--json PATH]

Phases:
  1. environment: card name and power limit, torch/CUDA versions, and the
     build of the CUDA kernels from csrc/ (timed; ptxas registers, spills
     and wgmma warnings of the tensor-core qmm, flash and W4A8 kernels,
     registers and spills of each decode attention, paged attention,
     qmm GEMV and encode-and-write instance);
  2. kernels: each hand-written kernel against its plain PyTorch version
     at the shapes of the paths below (the paged kernel at decode G=1 and
     verify G=5, also at Mixtral's GQA shape over bf16, int8 and fp8
     pools, qmm also at M=40 and M=256 and, across the GEMV's
     range, at M=1 and M=16 for the 7B's int4 and int8 projections, the
     grouped qmm at
     Mixtral's expert shapes on the full 256-plane stack, the attention
     kernels also at Mixtral's GQA Hq=32 Hkv=8 D=128), timed with CUDA
     events beside its bound and one PyTorch library call computing the
     same function, with their ratio (the flash rows also beside SDPA's
     is_causal form where every sequence fills S from position 0);
  3. main path: the 7B-shape int4 (g=64) model, 32 layers, random weights
     from a seed, served through InferenceEngine.generate_batch for 8
     prompts of 512 tokens and 128 new tokens, greedy and sampled; every
     kernel's launch count is checked against the model's structure; a
     traced prefill gives the flash kernel's share of its device time;
  4. kernels against plain versions on the same path: 7B shape, 2 layers,
     prefill and first decode-step logits, greedy-token agreement;
  5. the tiny int4 fixture (D=32, K=128) through generate_batch, then
     briefly through both schedulers;
  6. paged serving at full width: the 7B-shape int4 model, L=32, through
     PagedContinuousScheduler (8 slots, 256-token pages, max_seq 1024):
     24 requests submitted at once, 12 sharing a 512-token prefix, half
     greedy and half sampled, then one shared-prefix request again;
     launch counts checked step by step; an 8-step trace of the paged
     decode step gives the paged kernel's device ms/step;
  7. paged speculative serving: the same model with its first 2 layers
     as the draft, spec_k=4 (verify G=5), 8 greedy requests; verify
     logits against 5 chained decode steps on the same pages;
  8. Mixtral-8x7B int4 g=64 at full width, 2 of its 32 layers, random
     weights from a seed: generate_batch at B=1 (prompt 1000, 128 new
     tokens; decode through the grouped kernel, traced, one step under
     torch.cuda.set_sync_debug_mode("error")) and at B=8 (prompts 512,
     64 new; the E-loop), PagedContinuousScheduler with 12 requests, and
     kernels against plain versions at L=1 (B=1 and B=2); launch counts
     checked against the structure;
  9. GPT-OSS-20B at full width, 2 of its 24 layers (a depth cut so
     phase 17 fits the time limit; both kinds of layer stay), E=32 top-4,
     V=201088, random weights from a seed, bf16 experts, attention and
     head int4
     g=64: the same four runs as phase 8 (decode through the decode
     kernel with sinks, and 128-token windows on the even layers; B=8
     reaches the dense expert mix; at L=2 and B=1 the plain forward takes
     the kernel path's experts, and the routings it would have chosen
     otherwise are counted and bounded); build peak printed and held
     < 60 GiB; (e) int8 and fp8 contiguous caches on the same weights,
     B=1 (prompt 1000, 64 new; one step sync-free) and B=8 (prompts
     512, 32 new), traced, cache bytes beside the bf16 cache's; (f)
     paged serving over an fp8 pool (12 requests), and an int8 pool
     refused at construction; (d) also over int8 and fp8 caches at B=1.
     Phase 2 also holds the decode kernel with sinks and windows at its
     shapes (Hq=64, Hkv=8, D=64, T=2048), bf16, int8 and fp8, beside
     SDPA with a sink column, and the qmm and cache write at its
     projection and prefill shapes;
 10. int8 and fp8 KV caches on the 7B int4 model at L=8 (of 32): (a)
     generate_batch at B=8, prompts of 960, 128 new tokens, max_seq 2048,
     with "model", "int8" and "fp8" caches (launch counts with the
     encode-and-write kernel, cache bytes, peak memory, an 8-step trace
     with the decode attention's device time, a traced prefill with the
     encode-and-write kernel's share); (b) paged serving as phase
     6 over an int8, then an fp8 pool (the fp8 run with half the new
     tokens; prefix hits equal to phase 6's); (c) speculative serving as
     phase 7 over int8 pages; (d) at L=2, kernels against plain versions,
     contiguous (B=1) and paged (G=1, G=5), within 5% of max|logit|
     with greedy agreement 1.0, and Mixtral's contiguous path (L=1, B=1
     grouped decode; phase 8 runs the B=2 E-loop) within 5%. Phase 2
     also holds the encode-and-write kernel byte for byte (decode,
     prefill and paged addressing, an fp8 sweep across +-464, phase 10
     (a)'s and phase 9 (e)'s prefills with the model's K/V views), each
     row beside its byte bound, the decode rows with the wrapper's host
     time a call, the fp8 rows beside a .to(float8_e4m3fn) yardstick;
     and the int8/fp8 reads of the
     decode, stacked-prefill and paged kernels, at phase 10's own
     prefill, decode and admission shapes too.
 11. int8 and zero-point weights: (a) the 7B at the default
     QuantizationConfig() (int8, symmetric, g=64), L=2 (of 32), through
     generate_batch as phase 3, every product on qmm_int8 (traced, peak
     memory); (b) paged serving of 8 requests, 4 sharing a 512-token
     prefix; (c) Mixtral-8x7B int8 g=64 at L=2 (of 32), B=1 prompt 1000,
     64 new tokens, decode through qmm_int8_grouped, one step sync-free, peak
     < 70 GiB; (d) weights quantized on the card from seeded bf16,
     kernels against plain versions: 7B int8, int8 and int4 with zero
     points (L=2), Mixtral int4 with zero points (L=1), GPT-OSS int8
     attention (L=2);
     logits within 5% of max|logit|, every greedy token equal but in at
     most one tie row per model (within one bf16 ulp of max|logit|).
     Phase 2 also holds qmm_int8 (symmetric and with zero points) at
     every 7B projection and the head at the shapes of (a), (b) and (d),
     at Mixtral's attention, head and expert planes at (c)'s shapes, at
     GPT-OSS's K=2880 and 64-column-tail shapes, qmm_int4 with zero
     points, and qmm_int8_grouped on 64-plane expert stacks.
 12. W4A8 (TURBOINFER_QMM_A8=1): the 7B with int4 symmetric g=256 weights,
     L=32: (a) generate_batch B=8, prompts 512, 64 new, greedy, 4 W4A8
     products a layer in the prefill and none in decode or the head (M=8),
     prefill (with the flash share) and decode traced; (d) the same with
     the env unset (no W4A8 launch, prefill traced too), interleaved with
     (a) so their prefill times compare; (b) B=16, prompts 128, 32 new:
     every product on qmm_int4_a8; (c) paged speculative rounds as phase
     7, the verify (M=40) on qmm_int4_a8; (e) at L=1 kernels against plain
     versions, W4A8 on both sides, within 5% of max|logit| and phase 11's
     tie rule. Phase 2 also holds a8_quantize_rows byte for byte and
     qmm_int4_a8 bit for bit against their plain versions at the 7B's
     projections (M = 16, 40, 256, 4096), repeat calls bit-identical,
     timed beside the int8 tensor-core bound, the bf16 path (qmm_int4) on
     the same plane and x, and a torch._int_mm yardstick.
 13. Gemma-2-27B (google/gemma-2-27b's published config: 46 layers,
     hidden 4608, 32:16 heads of 128, FFN 36864, vocab 256000, a 4096-key
     window on every even layer, attention and final softcaps 50 and 30),
     int4 g=64, bf16, 2 of the 46 layers (one windowed, one global), synthetic
     weights from a seed, build peak printed: (a) generate_batch B=2,
     prompts of 4500 and 5000 (past the window), 64 new tokens, max_seq
     8192 (launch counts of the run and of one decode step: L decode
     attention launches, 4L+1
     products; a traced prefill and 8 traced decode steps; peak memory);
     (b) B=8, prompts 512, 128 new; (c) the paged scheduler with 8
     requests of 600-5000 tokens, 4 sharing a 4200-token prefix (48
     prefix hits, no page leaked), with speculative rounds of a 2-layer
     draft at spec_k=4 (paged verify windowed and softcapped); (d) at L=2
     (a windowed and a global layer), kernels against plain versions: a
     4160-token prompt's prefill and decode step, paged decode and
     verify over pools filled to 4150 and 5000, within 5% of max|logit|
     and phase 11's tie rule; (e) (a) over int8 and fp8 caches. Phase 2
     also holds the flash, decode and paged kernels with the window and
     the softcap at Gemma-2-27B's shapes (flash B=1 S=5000 at windows
     4096 and 600, B=8 S=512, a chunk at q_start 4096; decode B=8
     T=8192; paged G=1 and G=5 over 256-token pages), bf16, int8 and fp8,
     the queries drawn 30x wider on the capped rows that must bite, each
     beside SDPA with the window's mask (not the same function: no
     softcap); phase 1 prints the softcap flash instances' ptxas lines.
 14. Gemma-3-12B (google/gemma-3-12b-pt's published config: 48 layers,
     hidden 3840, 16:8 heads of 256, FFN 15360, vocab 262208, q/k norms,
     a 1024-key window on five layers of six with a local RoPE base, linear
     RoPE scaling 8 on the global layers), int4 g=64, bf16, 6 of the 48
     layers (one global),
     synthetic weights from a seed, positions cut to 8192: (a)
     generate_batch B=2, prompts of 4500 and 5000, 64 new tokens (launch
     counts of the run and of one decode step, traced prefill and decode,
     cache and peak memory); (b) (a) over int8 and fp8 caches; (c) paged
     serving with speculative rounds, 4 of 8 requests on an 1100-token
     prefix (12 prefix hits, no page leaked); (d) at L=2 (one local and
     one global layer), kernels against plain versions within 5% of
     max|logit| and phase 11's tie rule. Phase 2 also holds every
     attention and cache kernel at head dim 256 (Gemma-3's 16:8 with
     its window and globally, Gemma-2-9B's window 4096 and cap 50, a lone
     head; bf16, int8, fp8), Gemma-3's products at a B=2 decode, and the
     cache write and encode-and-write at phase 14's shapes; phase 1
     prints every D=256 instance's registers and spills.
 15. Phi-3-mini-4k (microsoft/Phi-3-mini-4k-instruct's published config:
     32 layers, hidden 3072, 32:32 heads of 96, FFN 8192, vocab 32064,
     4096 positions, a 2047-key window on every layer), int4 g=64, bf16,
     16 of the 32 layers (as phase 18; phase 17 runs 8, phase 16 all 32), synthetic weights
     from a seed: (a) generate_batch
     B=2, prompts of 3000 and 3500, 64 new tokens (launch counts of the
     run and of one decode step, traced prefill and decode, cache and
     peak memory); (b) (a) over int8 and fp8 caches; (c) paged serving
     with speculative rounds, 4 of 8 requests on a 2200-token prefix (24
     prefix hits, no page leaked); (e) generate_batch with
     use_cache=False (B=2, prompts 200 and 300, 8 new: one prefill a
     token) against the cached path's tokens under phase 11's tie rule;
     (d) at L=1, kernels against plain versions within 5% of max|logit|
     and the tie rule. Phase 2 also holds every attention and cache
     kernel at head dim 96 (the lone-head decode and paged kernels,
     windowed and global, bf16, int8, fp8; a GQA decode; flash fresh,
     chunked and read back), Phi-3's products at a B=2 decode, and the
     cache write and encode-and-write at phase 15's shapes.
 16. weights in and out, files written by the port's own writers into
     _smoke_files/ beside the script (gitignored; 16 GiB free asked for
     up front, removed at the end) and loaded onto the card: (a)
     Phi-3-mini-4k's bf16 weights drawn from a seed as an HF checkpoint
     directory (two bf16 shards of at most 5 GB under Phi-3's fused HF
     names, the index, microsoft/Phi-3-mini-4k-instruct's config.json),
     load_model_data and int4 g=64 quantize_params on the card, bit for
     bit the in-memory quantization, then generate_batch B=2 (prompts
     3000/3500, 64 new) with tokens equal to the in-memory path's; write
     and load seconds and GB/s (page cache warm), quantize ms; (b)
     quantize_model_file to .tinq and load_engine of it: the same
     QTensors and tokens; (c) 4 of the 32 layers as an F16 GGUF under
     llama.cpp's names (attn_qkv, double-width ffn_up), f32 logits
     against the in-memory params within 5% of max|logit| (the last
     position under the tie rule), and the native Q4_0/Q8_0/Q4_K/Q6_K
     dequantizers against numpy at w_gateup's size; (d) the 7B int4 L=8
     as .tinq under an r=16 PEFT adapter on all seven modules through
     load_engine(lora=): decode ms/step with and without it, interleaved
     (B=8 prompts 512, 64 new), the paged scheduler's tokens against
     generate_batch's, L=2 kernels against plain with the adapter; (e)
     calibrated_quantize_params of Phi-3-mini on 8 x 512 tokens, its
     activation-weighted error beside (a)'s uncalibrated int4. (a) also
     writes Phi-3-style tokenizer.json and tokenizer_config.json beside
     the shards: load_model_data attaches an HFTokenizer with Phi-3's
     chat template, and one engine.chat turn of 8 tokens runs on the
     loaded model.
 17. text in and out at Phi-3-mini-4k's full width (int4 g=64, 8 of 32
     layers, bf16 cache, max_seq 4096), with Phi-3-style tokenizer
     files this script writes (a Llama-2-style BPE with byte_fallback
     whose merges it learns in pure Python from a fixed text, Phi-3's
     added tokens and chat template): (a) from_hf_dir reads them, a
     non-ASCII round trip; (b) chat and chat_stream, 32 greedy tokens,
     the same text; (c) generate_stream on a 3000-token prompt at bursts
     1 and 8 against generate(), ms per token beside generate_batch's
     decode ms/step, interleaved; (d) generate_structured, json_object
     and a JSON Schema (parses and conforms), host-loop ms per token and
     the first mask's build time; (e) beam search (beam 4, 32 new, 1000
     prompt tokens): scores sorted, summed logprobs against
     compute_logprobs, a width-1 beam against greedy generate, ms per
     beam step, the cache gather's device ms and bytes; (f)
     compute_logprobs of 3500 tokens against
     generate_batch(return_logprobs=True); (g) the paged scheduler with
     a tokenizer, 2 json_object, 2 schema and 4 plain requests of
     500-1000 tokens at decode_burst=4 (single steps while a
     constrained slot lives; plain rows as when alone; req/s, tok/s);
     (h) at L=1, beam search and generate_structured through the
     kernels against the plain versions.
 18. the server and the command line at Phi-3-mini-4k's full width (int4
     g=64, 16 of the 32 layers, max_seq 4096, phase 17's tokenizer files): (a)
     the OpenAI-compatible HTTP server in process (ServingEngine over
     PagedContinuousScheduler, 8 slots, 256-token pages, decode_burst=4,
     and a beam engine sharing the scheduler's weights through
     params_are_prepared=True, < 1% of their bytes added): 8 concurrent
     streamed completions of 500-1000-token prompts, 64 new, whose tokens
     equal the same requests through the scheduler alone; a chat turn
     streamed and not (the same text), json_object (parses), n=2, a
     4-beam search, /health and /metrics; no error finish, no 5xx, the
     arrival counters back at zero; req/s, tok/s, client TTFT p50/p90;
     (b) a 3500-token prompt arriving while 4 requests decode, admitted in
     chunks of 512 and at full width, at exact prompt widths (7 chunks)
     and at the default power-of-two buckets (8 chunks), every live row
     one token a step meanwhile: every step's ms, the stall, the long
     prompt's TTFT, tokens equal under the tie rule; (c) speculative_generate B=2
     (prompts 1000 and 1500, 32 new, k=4, a 2-layer draft of the same
     weights) against generate_batch: acceptance, tokens and ms a round;
     (d) the command line on Phi-3-mini at 2 of 32 layers written as an
     HF directory (bf16 shards, tokenizer files) in _smoke_files/:
     `python -m turboinfer_tpu_torch generate` prints the in-process
     engine's text, `serve --paged` answers /health within 120 s and a
     chat completion and exits 0 on SIGINT, quantize/inspect/eval through
     cli.main; (e) at L=2, chunked admission under a 50-key window (a
     padded query sees no key; slot caches finite) and
     speculative_generate against the plain versions on the CPU.
 19. the GPT-2 and NeoX families: Falcon-7B (tiiuae/falcon-7b's published
     config: 32 layers, hidden 4544, 71 query heads on one kv head of
     64, FFN 18176, vocab 65024, the parallel block) through
     models/neox.py, int4 g=64, all 32 layers, synthetic weights from a
     seed: (a) generate_batch B=2, prompts of 1024 and 1536, 128 new
     tokens (launch counts of the run and of one decode step, every
     decode step on the decode kernel at a group of 71, a traced prefill
     and 8 traced decode steps, cache bytes a token, peak memory); (b)
     the contiguous scheduler answering 8 requests (the paged one refuses
     the model: no paged forward, as in the JAX package); (c) (a) over
     int8 and fp8 caches, 32 new; (d) at L=1, kernels against plain
     versions for Falcon-7B, GPT-2-XL (its 50257-wide head fp: qmm
     takes N % 8 == 0 only), Pythia-6.9B and BLOOM-7b1 (ALiBi: no
     attention kernel) at their published widths; (e) a Phi-2-width
     model (head dim 80) refused on the card, the error naming the head
     dim. Phase 2 also holds the decode kernel at the group of 71
     (bf16, int8, fp8) and Falcon-40B's 16, the flash kernel at 71:1,
     the cache writes at one kv head, and qmm at K=4544 and 18176
     (check_falcon_shapes).
 20. the MoE variants and DeepSeek: DeepSeek-V2-Lite (the JAX package's
     deepseek_v2_lite_config: 27 layers, hidden 2048, 16 heads, MLA with
     kv_lora_rank 512, 64 experts top-6 of width 1408 and two shared
     experts, the first layer dense, vocab 102400) through
     models/deepseek.py, int4 g=64, all 27 layers, synthetic weights from
     a seed, max_seq 2048: (a) generate_batch B=1, a 1024-token prompt,
     64 new tokens (launch counts of the run and of one sync-free decode
     step: the routed experts on the grouped kernel at G=6; a traced
     decode; cache bytes a token, 31104), and a prefill and a decode
     step over an int8 latent cache (15768 bytes a token); (b) the contiguous scheduler, 4 requests
     (the E-loop); (c) the paged scheduler over int8 latent pools, a
     shared 512-token prefix (2 prefix hits); (d) at L=2 (dense + MoE)
     the kernels against the plain versions, and at L=1 and published
     widths Qwen1.5-MoE-A2.7B, Qwen3-30B-A3B and OLMoE-1B-7B, each with
     a paged decode and verify, within 5% of max|logit| and phase 11's
     tie rule. Phase 2 also holds qmm at DeepSeek-V2-Lite's products
     (wkv_a N=576 at M=1, 4 and 1024), the grouped product at G=6 on the
     1664-plane stacks (4.8 GB of codes), G=4 and G=8 (K=1408, 768), and
     the attention kernels at Qwen3's 32:4 (check_moe_shapes).
 21. tensor, data and expert parallelism (parallel/, PR 22): one spawn of
     two ranks, both on cuda:0 over gloo (NCCL takes one GPU a rank), held
     against the one-rank runs of the same seeds on this card (tokens
     equal but in at most one tie row a run, phase 11's rule): (a) the 7B
     int4 g=64 at full width and depth (L=32) under TP=2, generate_batch
     B=4 of 512-token prompts, 32 greedy new tokens: prefill logits
     against one rank's, each rank's launch counts equal to the one-rank
     structure, prefill ms and ms/step, a traced decode with its device
     ms and the host ms a step in the collectives; (b) data parallelism on
     a (2, 1) mesh at L=4 (4 rows, 2 a rank); (c) the paged scheduler
     under TP=2 over an int8 pool at L=4, 8 requests, 4 sharing a
     256-token prefix, no page leaked; (d) Mixtral-8x7B int4 under EP=2 at
     2 of 32 layers: B=1 (the grouped kernel over a rank's local slots)
     and B=4 (the E-loop over 4 local experts); (e) an NCCL group of one
     rank driving the 7B at L=2 on a (1, 1) mesh (the mesh-less tokens and
     launches, no collective; all_reduce, all_gather, barrier); (f) the
     rank-local kernel shapes: qmm at M=4 on half of each 7B projection
     (wqkv N=6144, wo K=2048, w_gateup N=11008, w_down K=5504, lm_head
     N=16000) and decode attention over 16 of 32 heads at T=1024, timed
     as phase 2's rows. No TP speed-up can be read here: both ranks share
     one card and their collectives go through the host.
Exits non-zero on any failure (no CPU fallback). The last stdout line is
{"ok": true, "device": {...}}; before it come a {"kernels": [...]} line
and the nvidia-smi name/power-limit line.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12         # dense bf16 tensor-core peak
INT8_OPS_PER_S = 1979e12         # dense int8 tensor-core peak

ROOT_REPLACES = {
    "qmm_int4": "turboinfer_tpu/kernels/pallas/qmm.py:957; "
                "turboinfer_tpu/kernels/pallas/qmm.py:76 (asym); "
                "turboinfer_tpu/kernels/pallas/qmm.py:780 (asym)",
    "flash_prefill": "turboinfer_tpu/kernels/pallas/flash_attention.py:314; "
                     "turboinfer_tpu/kernels/pallas/flash_attention.py:205",
    "cache_write_fresh": "turboinfer_tpu/kernels/pallas/cache_write.py:58",
    "kv_encode_write": "turboinfer_tpu/kernels/pallas/cache_write.py:58",
    "decode_attention": "turboinfer_tpu/kernels/pallas/decode_attention.py:447; "
                        "turboinfer_tpu/kernels/pallas/decode_attention.py:738",
    "paged_attention": "turboinfer_tpu/kernels/pallas/paged_attention.py:246; "
                       "turboinfer_tpu/kernels/pallas/paged_attention.py:302",
    "qmm_int4_grouped": "turboinfer_tpu/kernels/pallas/qmm.py:1187; "
                        "turboinfer_tpu/kernels/pallas/qmm.py:1013 (asym)",
    "qmm_int8": "turboinfer_tpu/kernels/pallas/qmm.py:43; "
                "turboinfer_tpu/kernels/pallas/qmm.py:749",
    "qmm_int8_grouped": "turboinfer_tpu/kernels/pallas/qmm.py:981",
    "a8_quantize_rows": "turboinfer_tpu/kernels/pallas/qmm.py:502 "
                        "(_a8_quantize_rows, the jnp before the pallas_call "
                        "of qmm.py:466/:484)",
    "qmm_int4_a8": "turboinfer_tpu/kernels/pallas/qmm.py:466; "
                   "turboinfer_tpu/kernels/pallas/qmm.py:484",
}
SOURCES = {
    "qmm_int4": "turboinfer_tpu_torch/csrc/qmm.cu; "
                "turboinfer_tpu_torch/csrc/qmm_tc.cu (M > 16)",
    "flash_prefill": "turboinfer_tpu_torch/csrc/flash_prefill.cuh; "
                     "turboinfer_tpu_torch/csrc/flash_prefill.cu; "
                     "turboinfer_tpu_torch/csrc/flash_prefill_int8.cu; "
                     "turboinfer_tpu_torch/csrc/flash_prefill_fp8.cu",
    "cache_write_fresh": "turboinfer_tpu_torch/csrc/cache_write.cu",
    "kv_encode_write": "turboinfer_tpu_torch/csrc/cache_write.cu",
    "decode_attention": "turboinfer_tpu_torch/csrc/decode_attention.cu",
    "paged_attention": "turboinfer_tpu_torch/csrc/paged_attention.cuh; "
                       "turboinfer_tpu_torch/csrc/paged_attention.cu; "
                       "turboinfer_tpu_torch/csrc/paged_attention_int8.cu; "
                       "turboinfer_tpu_torch/csrc/paged_attention_fp8.cu",
    "qmm_int4_grouped": "turboinfer_tpu_torch/csrc/qmm.cu",
    "qmm_int8": "turboinfer_tpu_torch/csrc/qmm.cu; "
                "turboinfer_tpu_torch/csrc/qmm_tc.cu (M > 16)",
    "qmm_int8_grouped": "turboinfer_tpu_torch/csrc/qmm.cu",
    "a8_quantize_rows": "turboinfer_tpu_torch/csrc/qmm_a8.cu",
    "qmm_int4_a8": "turboinfer_tpu_torch/csrc/qmm_a8.cu",
}


class SmokeError(RuntimeError):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def say(*a) -> None:
    print(*a, flush=True)


def bound_ms(nbytes: float, flops: float, rate: float = BF16_FLOP_PER_S):
    """The least time of the work: bytes over the memory rate against
    operations over `rate` (bf16 tensor cores unless given)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def want_counts(**nonzero):
    """Expected launch counts: every kernel wrapper 0 but those given."""
    from turboinfer_tpu_torch import kernels
    names = list(kernels.wrappers())
    need(set(nonzero) <= set(names), f"unknown kernels {set(nonzero)}")
    return {n: nonzero.get(n, 0) for n in names}


BF16_ULP = 2.0 ** -7   # relative spacing of bf16 values (8-bit mantissa)


def within(torch, got, want, atol: float) -> bool:
    """|got - want| <= atol + one bf16 ulp of |want|, elementwise: both
    sides round their f32 result to bf16, which may land one ulp apart."""
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= atol + BF16_ULP * w.abs()).all())


KV_KINDS = ("int8", "fp8")


def compress(torch, x, kind):
    """bf16 K/V -> (storage, int8 scale planes or None): kind None keeps
    bf16, "int8" and "fp8" encode with the plain codec."""
    if kind is None:
        return x, None
    from turboinfer_tpu_torch.models.common import encode_kv_scaled
    return encode_kv_scaled(x, {"int8": torch.int8, "fp8": torch.uint8}[kind])


def dequant(torch, x, scale):
    """Storage -> bf16 values, for the SDPA yardstick (built beforehand,
    never timed)."""
    from turboinfer_tpu_torch.models.common import decode_kv
    return decode_kv(x, torch.bfloat16, scale)


def kv_row_bytes(x, D: int) -> int:
    """Bytes a kernel reads per K or V row: D codes, plus an int8 row's
    f32 scale."""
    import torch
    return D * x.element_size() + (4 if x.dtype == torch.int8 else 0)


def qmm_tc_smem(bits: int, asym: bool, bt: int) -> int:
    """Dynamic shared memory of qmm_tc_kernel<bits, asym, bt>, as its
    Layout in csrc/qmm_tc.cu computes it (ptxas reports none)."""
    rows = 64 if bits == 4 else 128
    tx = 4 * bt * 64 + 2 * rows * 128 + 1024 * (2 if asym else 1)
    stage = (tx + 1023) // 1024 * 1024
    stages = min(6, (227 * 1024 - 1024 - 72) // stage)
    return stages * stage + 1024 + 12 * stages


def qmm_tc_ptxas(report: str):
    """One line per tensor-core qmm kernel of the ptxas report of
    qmm_tc.cu: registers, spills, and the dynamic shared memory."""
    out, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '.*qmm_tc_kernelILi(\d)ELb"
                      r"(\d)ELi(\d+)E", line)
        if m:
            name = (int(m.group(1)), m.group(2) == "1", int(m.group(3)))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            bits, asym, bt = name
            out.append(f"qmm_tc_kernel<int{bits}{', zp' if asym else ''}, "
                       f"{bt} tokens>: {m.group(1)} registers, {spill} bytes "
                       f"spilled, {qmm_tc_smem(bits, asym, bt)} bytes of "
                       f"dynamic shared memory")
            name = None
    return out


FLASH_KV = {"13__nv_bfloat16": "bf16", "a": "int8", "h": "fp8"}


def flash_smem(D: int, kv: str) -> int:
    """Dynamic shared memory of flash_prefill_kernel<D, kv>, as its Layout
    in csrc/flash_prefill.cuh computes it (128-key tiles, 64 at D = 256;
    D = 96's three 32-column boxes take the bytes of D columns, as every
    other D's boxes do)."""
    k8, bn = kv != "bf16", 64 if D > 128 else 128
    tile = bn * D * 2
    fill = 2 * bn * D if k8 else 2 * tile
    stage_off = 2 * 64 * D * 2 + (4 * tile + 2 * 2 * bn * 4 if k8 else 0)
    stages = min(3, (227 * 1024 - 1024 - 128 - stage_off) // fill)
    return 1024 + stage_off + stages * fill + 128


def flash_ptxas(reports):
    """One line per flash prefill kernel of the ptxas reports of
    flash_prefill*.cu: registers, spills, dynamic shared memory, and any
    wgmma warning (serialized wgmmas) ptxas printed for it."""
    out = []
    for fname in sorted(reports):
        if not fname.startswith("flash_prefill"):
            continue
        name, spill, warns = None, 0, []
        for line in reports[fname].splitlines():
            m = re.search(r"Compiling entry function '.*flash_prefill_kernel"
                          r"ILi(\d+)E(13__nv_bfloat16|a|h)Lb(\d)E", line)
            if m:
                name, spill, warns = (int(m.group(1)), FLASH_KV[m.group(2)],
                                      m.group(3) == "1"), 0, []
                continue
            if name and "wgmma" in line:
                warns.append(line.strip())
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and name:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                D, kv, cap = name
                out.append(f"flash_prefill_kernel<D={D}, {kv}"
                           f"{', softcap' if cap else ''}>: {m.group(1)} "
                           f"registers, {spill} bytes spilled, "
                           f"{flash_smem(D, kv)} bytes of dynamic shared "
                           "memory; " + ("; ".join(warns) or
                                         "no wgmma warning"))
                name = None
    return out


def qmm_a8_ptxas(report: str):
    """One line per kernel instance of the ptxas report of qmm_a8.cu:
    the W4A8 product (token tile, product instruction, warpgroups, units
    a stage, split warpgroups, nibble form) and the row quantizer
    (threads a row, values a chunk): registers, spills, and any wgmma
    warning
    (serialized wgmmas) ptxas printed for it."""
    out, name, spill, warns = [], None, 0, []
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '.*qmm_a8_kernelILi(\d+)ELi"
                      r"(\d)ELi(\d)ELi(\d)ELb(\d)E", line)
        q = re.search(r"Compiling entry function '.*a8_quantize_rows_kernel"
                      r"ILi(\d+)ELi(\d+)E", line)
        if m:
            bt, wg, ku, split, x16 = m.groups()
            mma = "mma.sync" if int(bt) <= 64 and ku == "4" else "wgmma"
            name = (f"qmm_a8_kernel<{bt} tokens, {mma}, {wg} column "
                    f"warpgroup{'s' if wg != '1' else ''}, {ku} unit"
                    f"{'s' if ku != '1' else ''} a stage, "
                    + (f"{split} warpgroups splitting the groups, "
                       if split != "1" else "")
                    + f"{'16(u-8), g <= 256' if x16 == '1' else 'u-8, g > 256'}>")
            spill, warns = 0, []
            continue
        if q:
            name, spill, warns = (f"a8_quantize_rows_kernel<{q.group(1)} "
                                  f"threads a row, {q.group(2)}-value "
                                  "chunks>"), 0, []
            continue
        if name and "wgmma" in line:
            warns.append(line.strip())
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill} bytes "
                       "spilled; " + ("; ".join(warns) or "no wgmma warning"))
            name = None
    return out


def encode_write_ptxas(report: str):
    """One line per kv_encode_write_kernel instance (D, int8 or fp8, rows
    a lane) of the ptxas report of cache_write.cu: registers and
    spills."""
    out, name, spill = [], None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '.*kv_encode_write_kernel"
                      r"ILi(\d+)ELb(\d)ELi(\d+)E", line)
        if m:
            name = (f"D={m.group(1)}, {'fp8' if m.group(2) == '1' else 'int8'}"
                    f", {m.group(3)} row{'s' if m.group(3) != '1' else ''} a "
                    "lane")
            spill = 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"kv_encode_write_kernel<{name}>: {m.group(1)} "
                       f"registers, {spill} bytes spilled")
            name = None
    return out


def merge_kernels_ptxas(reports):
    """One line per instance of the kernels that merge in their last block
    (decode attention, paged attention, the qmm GEMV) from the ptxas
    reports of decode_attention.cu, paged_attention*.cu and qmm.cu:
    template arguments (with the decode kernels' softcap flag and the
    paged kernels' window/softcap flag), registers and spills."""
    kv = {"13__nv_bfloat16": "bf16", "a": "int8", "h": "fp8"}
    paged = "\n".join(reports.get(f"paged_attention{t}.cu", "")
                    for t in ("", "_int8", "_fp8"))
    out = []
    for report, kname in ((reports.get("decode_attention.cu", ""),
                           "decode_row_kernel"),
                          (reports.get("decode_attention.cu", ""),
                           "decode_gqa_kernel"),
                          (paged, "paged_row_kernel"),
                          (paged, "paged_tc_kernel"),
                          (reports.get("qmm.cu", ""), "qmm_gemv_kernel")):
        name, spill = None, 0
        for line in report.splitlines():
            m = re.search(rf"Compiling entry function '_Z\w*?{kname}I(\w+?)"
                          r"EEv", line)
            if m:
                name, spill = m.group(1), 0
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and name:
                spill = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                t = re.match(r"(13__nv_bfloat16|a|h)?(.*)", name)
                vals = re.findall(r"L[ib](\d+)E", t.group(2) + "E")
                # the last flag: decode's softcap, paged's window/softcap
                flag = {"decode": ", softcap", "paged_": ", window/softcap"
                        }.get(kname[:6], "") if vals[-1] == "1" else ""
                if kname == "paged_tc_kernel":
                    args = (f"{kv[t.group(1)]}, D={vals[0]}, "
                            f"{8 * int(vals[1])}-row chunks{flag}")
                elif kname != "qmm_gemv_kernel":
                    args = f"{kv[t.group(1)]}, D={vals[0]}{flag}"
                else:
                    bits, asym, mt, v16, grp = vals
                    args = (f"int{bits}{', zp' if asym == '1' else ''}, "
                            f"{8 * int(mt)} tokens, "
                            f"{'16' if v16 == '1' else '8'}-byte rows"
                            f"{', grouped' if grp == '1' else ''}")
                out.append(f"{kname}<{args}>: {m.group(1)} registers, "
                           f"{spill} bytes spilled")
                name = None
    return out


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

def rand_qtensor(torch, gen, lead, K, N, bits, asym, g=64):
    """Random weights of the kernels' formats: int4 bytes or int8 codes
    (-128 included), bf16 scales in [0.005, 0.015), integer zero points
    in [-12, 12] when asym."""
    from turboinfer_tpu_torch.core.qtensor import QTensor
    if bits == 4:
        data = torch.randint(0, 256, lead + (K // 2, N), generator=gen,
                             dtype=torch.uint8, device="cuda")
    else:
        data = torch.randint(-128, 128, lead + (K, N), generator=gen,
                             dtype=torch.int8, device="cuda")
    sshape = lead + (K // g, N)
    scales = (0.005 + 0.01 * torch.rand(sshape, generator=gen,
                                        device="cuda")).to(torch.bfloat16)
    zp = torch.randint(-12, 13, sshape, generator=gen, device="cuda").to(
        torch.bfloat16) if asym else None
    return QTensor(data=data, scales=scales, zero_points=zp, bits=bits,
                   group_size=g, shape=(K, N))


def qmm_bytes(K, N, g, bits, asym):
    """Bytes of one weight plane: codes, bf16 scales, bf16 zero points."""
    return (K // 2 if bits == 4 else K) * N + K // g * N * 2 * (
        2 if asym else 1)


def check_qmm(torch, rows, results, shapes=None, Ms=(8, 40, 256, 4096),
              record=True, bits=4, asym=False):
    """qmm_int4 or qmm_int8 (bits), symmetric or with zero points (asym),
    on layers of a 4-layer stack against qmatmul_plain; timed beside its
    bound and a bf16 matmul over the weight dequantized beforehand."""
    from turboinfer_tpu_torch.core.qtensor import dequantize
    from turboinfer_tpu_torch.kernels import qmm
    gen = torch.Generator(device="cuda").manual_seed(1 + (bits - 4) + asym)
    L, g = 4, 64
    kname = f"qmm_int{bits}"
    kern = getattr(qmm, kname)
    tag = f"{kname}{' zp' if asym else ''}"
    shapes = shapes or [("wqkv", 4096, 12288), ("wo", 4096, 4096),
                        ("w_gateup", 4096, 22016), ("w_down", 11008, 4096),
                        ("lm_head", 4096, 32000)]
    # M=8: decode (B=8); M=40: a paged verify (B=8, G=5), head included;
    # M=256: a page-wide admission prefill; M=4096: the batch prefill
    for M in Ms:
        for name, K, N in shapes:
            if M >= 256 and name.endswith("lm_head"):
                continue       # the prefill head runs at M = B (logit_idx)
            qt = rand_qtensor(torch, gen, (L,), K, N, bits, asym, g)
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            got = kern(x, qt, 0)
            want = qmm.qmatmul_plain(x, qt, 0)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ref = want.float().abs().max().item()
            tol = 2e-2 * ref
            need(err <= tol, f"{tag} {name} M={M}: max_abs_err {err} > {tol}")
            iters = {1: 20, 8: 20, 40: 10, 256: 5}.get(M, 3)
            ms = cuda_ms(torch, lambda i: kern(x, qt, i % L), iters)
            plain_ms = cuda_ms(torch, lambda i: qmm.qmatmul_plain(x, qt, i % L),
                               max(iters // 4, 2), reps=3)
            wd = [dequantize(qt.layer(li), torch.bfloat16)
                  for li in range(L)]
            lib_ms = cuda_ms(torch, lambda i: torch.matmul(x, wd[i % L]), iters)
            del wd
            nbytes = M * K * 2 + qmm_bytes(K, N, g, bits, asym) + M * N * 2
            b, by = bound_ms(nbytes, 2.0 * M * K * N)
            row = dict(kernel=kname, shape=f"{name}{' zp' if asym else ''} "
                       f"M={M} K={K} N={N}",
                       max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b, bound_by=by,
                       library_ratio=ms / lib_ms)
            rows.append(row)
            say(f"  {kname} {row['shape']}: max_abs_err={err:.4g} "
                f"(tol {tol:.3g}) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={b:.4f} ({by}) library_ms={lib_ms:.4f} "
                f"kernel/library={ms / lib_ms:.2f}")
            if record and name == "w_gateup" and M == 8:
                results[kname] = row
            del qt


def a8_rows(torch, gen, M, K):
    """bf16 activation rows for the W4A8 checks: a zero row and values
    that sit on .5 ties after the division by the row scale."""
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    x[min(3, M - 1)] = 0
    sx = x.float().abs().amax(-1).clamp_min(1e-8) * (1.0 / 127.0)
    x[:, 1] = ((torch.arange(M, device="cuda") % 50 + 0.5) * sx).to(
        torch.bfloat16)
    return x


def check_a8_quantize(torch, rows, results, shapes):
    """a8_quantize_rows byte for byte (codes and the bits of the f32 row
    scales) against a8_quantize_rows_plain; timed beside its byte bound
    (bf16 in, codes and scales out). No one PyTorch call computes it."""
    from turboinfer_tpu_torch.kernels import qmm
    gen = torch.Generator(device="cuda").manual_seed(12)
    for M, K in shapes:
        x = a8_rows(torch, gen, M, K)
        xq, sx = qmm.a8_quantize_rows(x)
        wq, ws = qmm.a8_quantize_rows_plain(x)
        torch.cuda.synchronize()
        bad = int((xq != wq).sum()) + int(
            (sx.view(torch.int32) != ws.view(torch.int32)).sum())
        need(bad == 0, f"a8_quantize_rows M={M} K={K}: {bad} codes or "
                       "scales differ from the plain version")
        ms = cuda_ms(torch, lambda i: qmm.a8_quantize_rows(x), 20)
        plain_ms = cuda_ms(torch, lambda i: qmm.a8_quantize_rows_plain(x),
                           5, reps=3)
        b, by = bound_ms(M * K * 2 + M * K + M * 4, 0.0)
        row = dict(kernel="a8_quantize_rows", shape=f"M={M} K={K}",
                   max_abs_err=0.0, tol=0.0, ms=ms, plain_ms=plain_ms,
                   library_ms=None, bound_ms=b, bound_by=by)
        rows.append(row)
        say(f"  a8_quantize_rows M={M} K={K}: byte exact, kernel_ms={ms:.4f}"
            f" plain_ms={plain_ms:.4f} bound_ms={b:.4f} ({by}, x{ms / b:.2f})"
            " library_ms=none")
        if (M, K) == (4096, 4096):
            results["a8_quantize_rows"] = row


def check_qmm_a8(torch, rows, results, shapes, Ms, g=256):
    """qmm_int4_a8 (the row quantizer and the int8 tensor-core product)
    on layers of a 4-layer int4 g=256 stack against qmatmul_a8_plain, bit
    for bit (tolerance 0: the group partials are exact integers on both
    sides and every later step is one IEEE rounding in the same order);
    timed beside its bound (int8 operations or bytes), the plain version,
    the bf16 path (qmm_int4 on the same plane and x: what the product
    runs without TURBOINFER_QMM_A8) and, as a labelled yardstick only,
    torch._int_mm on the codes and the weight unpacked to int8
    beforehand: the same integer work without the group scales (no one
    PyTorch call computes a group-scaled W4A8 product, so library_ms is
    null; _int_mm takes M > 16 only)."""
    from turboinfer_tpu_torch.core.qtensor import unpack_int4
    from turboinfer_tpu_torch.kernels import qmm
    gen = torch.Generator(device="cuda").manual_seed(13)
    L = 4
    for M in Ms:
        for name, K, N in shapes:
            qt = rand_qtensor(torch, gen, (L,), K, N, 4, False, g)
            x = a8_rows(torch, gen, M, K)
            got = qmm.qmm_int4_a8(x, qt, 1)
            want = qmm.qmatmul_a8_plain(x, qt, 1)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            need(torch.equal(got, want), f"qmm_int4_a8 {name} M={M}: "
                 f"max_abs_err {err}, not bit for bit")
            need(torch.equal(qmm.qmm_int4_a8(x, qt, 1), got),
                 f"qmm_int4_a8 {name} M={M}: a repeat call differs")
            iters = {16: 20, 40: 10, 256: 5}.get(M, 3)
            ms = cuda_ms(torch, lambda i: qmm.qmm_int4_a8(x, qt, i % L),
                         iters)
            bf16_ms = cuda_ms(torch, lambda i: qmm.qmm_int4(x, qt, i % L),
                              iters)
            plain_ms = cuda_ms(torch, lambda i: qmm.qmatmul_a8_plain(
                x, qt, i % L), 2, reps=3)
            int_mm_ms = None
            if M > 16:             # torch._int_mm takes M > 16
                xq, _ = qmm.a8_quantize_rows(x)
                w8 = unpack_int4(qt.data[0], g).t().contiguous().t()
                int_mm_ms = cuda_ms(torch, lambda i: torch._int_mm(xq, w8),
                                    iters)
                del w8
            nbytes = M * K * 2 + qmm_bytes(K, N, g, 4, False) + M * N * 2
            b, by = bound_ms(nbytes, 2.0 * M * K * N, INT8_OPS_PER_S)
            row = dict(kernel="qmm_int4_a8", shape=f"{name} M={M} K={K} "
                       f"N={N} g={g}", max_abs_err=err, tol=0.0, ms=ms,
                       plain_ms=plain_ms, library_ms=None,
                       bf16_path_ms=bf16_ms, bf16_path_ratio=ms / bf16_ms,
                       int_mm_yardstick_ms=int_mm_ms, bound_ms=b,
                       bound_by=by, bound_ratio=ms / b)
            rows.append(row)
            say(f"  qmm_int4_a8 {row['shape']}: bit exact, kernel_ms="
                f"{ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b:.4f} ({by}, "
                f"x{ms / b:.2f}) library_ms=none; bf16 path (qmm_int4, same "
                f"plane) {bf16_ms:.4f} (a8/bf16 {ms / bf16_ms:.3f}); "
                f"yardstick torch._int_mm (no group scales) "
                f"{'n/a (M <= 16)' if int_mm_ms is None else f'{int_mm_ms:.4f}'}")
            if name == "w_gateup" and M == 4096:
                results["qmm_int4_a8"] = row
            del qt


def check_qmm_grouped(torch, rows, results, bits=4, asym=False, n=256,
                      names=("we_gateup", "we_gate", "we_down")):
    """qmm_int4_grouped or qmm_int8_grouped (bits), symmetric or with
    zero points (asym), against qmatmul_grouped_plain at Mixtral's expert
    shapes (G=2 routed experts, M=1) on a flat stack of n planes: the
    full L*E = 256 for int4, so slot 255 lies ~15 GB into the fused
    gate/up stack; 64 int8 planes already pass 2^31 bytes. Repeated
    slots, slot 0 and the last slot, and one G=4, M=3 case (we_gate).
    Timed beside its byte bound, the plain version, torch.bmm on the two
    planes dequantized beforehand (gather and dequant excluded), and the
    two single-plane qmm calls at M=1 that the grouped launch replaces."""
    from turboinfer_tpu_torch.core.qtensor import QTensor, dequantize
    from turboinfer_tpu_torch.kernels import qmm
    gen = torch.Generator(device="cuda").manual_seed(8 + (bits - 4) + asym)
    g = 64
    kname = f"qmm_int{bits}_grouped"
    kern, one = getattr(qmm, kname), getattr(qmm, f"qmm_int{bits}")
    tag = f"{kname}{' zp' if asym else ''}"
    shapes = {"we_gateup": (4096, 2 * 14336), "we_gate": (4096, 14336),
              "we_down": (14336, 4096)}
    for name in names:
        K, N = shapes[name]
        qt = rand_qtensor(torch, gen, (n,), K, N, bits, asym, g)
        cases = [(2, 1, [17, n - 56]), (2, 1, [0, n - 1]),
                 (2, 1, [n - 1] * 2)]
        if name == "we_gate":
            cases.append((4, 3, [5, n - 1, 0, 5]))
        worst = (0.0, 0.0)
        for G, M, sl in cases:
            x = torch.randn((G, M, K), generator=gen,
                            device="cuda").to(torch.bfloat16)
            slots = torch.tensor(sl, dtype=torch.int32, device="cuda")
            got = kern(x, qt, slots)
            want = qmm.qmatmul_grouped_plain(x, qt, slots)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = 2e-2 * want.float().abs().max().item()
            need(err <= tol, f"{tag} {name} G={G} M={M} slots "
                             f"{sl}: max_abs_err {err} > {tol}")
            worst = max(worst, (err, tol))
            say(f"  {tag} {name} K={K} N={N} G={G} M={M} slots "
                f"{sl}: max_abs_err={err:.4g} (tol {tol:.3g})")
        # timing: G=2, M=1, a different slot pair at every call
        pairs_host = [[(37 * i) % n, (37 * i + 101) % n] for i in range(20)]
        pairs = [torch.tensor(p, dtype=torch.int32, device="cuda")
                 for p in pairs_host]
        x = torch.randn((2, 1, K), generator=gen,
                        device="cuda").to(torch.bfloat16)
        ms = cuda_ms(torch, lambda i: kern(x, qt, pairs[i]), 20)
        plain_ms = cuda_ms(torch, lambda i: qmm.qmatmul_grouped_plain(
            x, qt, pairs[i]), 4, reps=3)
        loop_ms = cuda_ms(torch, lambda i: [
            one(x[j], qt, pairs_host[i][j]) for j in range(2)], 20)
        idx = torch.tensor([17, n - 56], device="cuda")
        wd = dequantize(QTensor(
            data=qt.data[idx], scales=qt.scales[idx],
            zero_points=None if qt.zero_points is None
            else qt.zero_points[idx], bits=bits, group_size=g,
            shape=(K, N)), torch.bfloat16)
        lib_ms = cuda_ms(torch, lambda i: torch.bmm(x, wd), 20)
        G, M = 2, 1
        nbytes = G * qmm_bytes(K, N, g, bits, asym) + G * M * (K + N) * 2
        b, by = bound_ms(nbytes, 2.0 * G * M * K * N)
        row = dict(kernel=kname, shape=f"{name}{' zp' if asym else ''} G=2 "
                   f"M=1 K={K} N={N} (stack of {n})",
                   max_abs_err=worst[0], tol=worst[1], ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, per_slot_loop_ms=loop_ms, bound_ms=b,
                   bound_by=by, library_ratio=ms / lib_ms)
        rows.append(row)
        say(f"  {kname} {row['shape']}: kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={b:.4f} ({by}) library_ms="
            f"{lib_ms:.4f} (bmm, dequantized planes) two_qmm_int{bits}_ms="
            f"{loop_ms:.4f} kernel/library={ms / lib_ms:.2f}")
        if name == "we_gateup" and not asym:
            results[kname] = row
        del qt, wd
        torch.cuda.empty_cache()


def _attn_mask(torch, B, S, T, kv_len, q_start, window=None):
    qpos = q_start[:, None] + torch.arange(S, device="cuda")[None, :]
    kpos = torch.arange(T, device="cuda")
    mask = ((qpos[:, :, None] >= kpos[None, None, :])
            & (kpos[None, None, :] < kv_len[:, None, None]))
    if window is not None:
        mask &= kpos[None, None, :] > qpos[:, :, None] - window
    return mask[:, None]


def mask_kw(window, softcap):
    """The window/softcap keywords of an attention wrapper call, none
    when both are off (so the check functions also drive a tree whose
    wrappers predate them, as tools/attention_ab.py does)."""
    return {k: v for k, v in (("window", window), ("softcap", softcap))
            if v is not None}


def mask_label(window, softcap, qscale=1.0):
    return "".join([f" window={window}" if window else "",
                    f" softcap={softcap}" if softcap else "",
                    f" q x{qscale:g}" if qscale != 1.0 else ""])


def check_flash(torch, F, rows, results, B, Hq, Hkv, S, D, fill,
                record: bool, q_start=None, T=None, kind=None, window=None,
                softcap=None, qscale=1.0):
    """Fresh prefill (q_start None): K/V are the just-computed [B, S, Hkv,
    D] read transposed, kv_len = fill. Chunked prefill: K/V are layer 1
    of a stacked [2, B, Hkv, T, D] cache, queries at q_start[b] + s,
    kv_len = q_start + fill < T; kind "int8"/"fp8" compresses that
    cache (the library yardstick then reads it dequantized beforehand).
    window/softcap: the masks of Gemma-2's local and global layers, with
    the queries drawn qscale wider so the scores reach past the cap;
    rows at or past kv_len (which a window may leave without a key) are
    left out of the comparison. The yardstick is SDPA with the window's
    bool mask: with a softcap it is not the same function."""
    from turboinfer_tpu_torch.kernels import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    q = rnd(B, S, Hq, D)
    if qscale != 1.0:
        q = (q.float() * qscale).to(torch.bfloat16)
    mk = mask_kw(window, softcap)
    if q_start is None:
        q_start, T = [0] * B, S
        kt, vt = (rnd(B, S, Hkv, D).transpose(1, 2) for _ in range(2))
        what = ""
    else:
        kt, vt = (rnd(2, B, Hkv, T, D)[1] for _ in range(2))
        what = (f"stacked layer 1 T={T} q_start={list(q_start)} "
                f"{'' if kind is None else f'kv={kind} '}")
    (kt, ks), (vt, vs) = compress(torch, kt, kind), compress(torch, vt, kind)
    lens = [a + f for a, f in zip(q_start, fill)]
    need(max(lens) <= T, "check_flash: kv_len beyond the cache")
    qs = torch.tensor(q_start, dtype=torch.int32, device="cuda")
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    got = fa.flash_prefill(q, kt, vt, kv_len, qs, ks, vs, **mk)
    want = fa.prefill_plain(q, kt, vt, kv_len, qs, ks, vs, **mk)
    torch.cuda.synchronize()
    live = (qs[:, None] + torch.arange(S, device="cuda")[None, :]
            < kv_len[:, None])
    if window is None:
        live[:] = True
    err = (got.float() - want.float())[live].abs().max().item()
    tol = 2e-2        # bf16 probabilities in P V, plus one bf16 ulp
    what += mask_label(window, softcap, qscale)[1:] + (" " if window
                                                       or softcap else "")
    need(bool(torch.isfinite(got.float()).all())
         and within(torch, got[live], want[live], tol),
         f"flash_prefill {what}D={D} Hq={Hq} Hkv={Hkv}: max_abs_err {err} "
         f"beyond {tol} + 1 bf16 ulp")
    ms = cuda_ms(torch, lambda i: fa.flash_prefill(q, kt, vt, kv_len, qs, ks,
                                                   vs, **mk), 10)
    plain_ms = cuda_ms(torch, lambda i: fa.prefill_plain(
        q, kt, vt, kv_len, qs, ks, vs, **mk), 2, reps=3)
    mask = _attn_mask(torch, B, S, T, kv_len, qs, window)
    qh = q.transpose(1, 2)
    kd, vd = dequant(torch, kt, ks), dequant(torch, vt, vs)
    lib_ms = cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
        qh, kd, vd, attn_mask=mask, enable_gqa=Hq != Hkv), 10)
    del mask
    # SDPA's causal form computes the same function only where every
    # sequence starts at 0 and fills S (no padded keys, no window)
    causal_ms = cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
        qh, kd, vd, is_causal=True, enable_gqa=Hq != Hkv), 10) \
        if window is None and all(a == 0 and f == S for a, f in
                                  zip(q_start, fill)) else None
    # work this data needs: valid query rows, each against its visible
    # keys; each kv head reads the keys from the earliest window on
    w = window or 1 << 30
    pairs = sum(min(a + s + 1, w) for a, f in zip(q_start, fill)
                for s in range(f))
    flops = 4.0 * D * Hq * pairs
    keys = sum(n - max(0, a - w + 1) for a, n in zip(q_start, lens))
    nbytes = 2 * 2 * B * S * Hq * D + 2 * Hkv * kv_row_bytes(kt, D) * keys
    b, by = bound_ms(nbytes, flops)
    same = softcap is None
    row = dict(kernel="flash_prefill",
               shape=f"{what}B={B} Hq={Hq} Hkv={Hkv} S={S} D={D}",
               max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, library_causal_ms=causal_ms, bound_ms=b,
               bound_by=by, window=window, softcap=softcap,
               library_same_function=same)
    rows.append(row)
    causal = "" if causal_ms is None else \
        f" library_causal_ms={causal_ms:.4f} (SDPA is_causal)"
    say(f"  flash_prefill {row['shape']}: max_abs_err={err:.4g} (tol {tol}) "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b:.4f} ({by}) "
        f"library_ms={lib_ms:.4f}"
        f"{'' if same else ' (SDPA, window mask: not the same function)'}"
        f"{causal}")
    if record:
        results["flash_prefill"] = row


def check_cache_write(torch, rows, results, B=8, Hkv=32, S=512, T=1024,
                      D=128, record=True):
    from turboinfer_tpu_torch.kernels import cache_write as cw
    gen = torch.Generator(device="cuda").manual_seed(3)
    L = 4
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
    if record:
        results["cache_write_fresh"] = row


def check_encode_write(torch, rows, results, kind: str, layout: str,
                       record: bool, B: int = 8, S=None, Hkv: int = 32,
                       D: int = 128, Hq=None):
    """kv_encode_write against kv_encode_write_plain (encode_kv_scaled and
    an indexed assignment), byte for byte, into layer 2 of 4 of a cache:
    a decode step (S=1, positions 900 + 113 b) into [4, B, Hkv, 2048, D],
    a fresh prefill slab (S=1024 unless given) into the same cache, and a
    G=5 verify into 256-token pages of a [4, 33, Hkv, 256, D] pool.
    K/V are strided views of a fused qkv product; with Hq given, as the
    model hands them over: K heads of the RoPE output [N, Hq + Hkv, D],
    V of the product [N, (Hq + 2 Hkv) D]. layout "sweep": a slab of bf16
    values swept across [-600, 600], so every fp8 row crosses +-464
    (0x7F/0xFF codes). Each row also carries its ratio to the byte
    bound; the decode rows the wrapper's host time per call (1000 calls,
    no sync between them), the fp8 rows a yardstick: x.to(float8_e4m3fn)
    of K and V, one library pass each that reads the bf16 values and
    writes a byte each (not the same function: no NaN codes, no
    scatter). No single library call computes the encode: library_ms is
    None."""
    from turboinfer_tpu_torch.kernels import cache_write as cw
    gen = torch.Generator(device="cuda").manual_seed(9)
    L, T, P, PAGE = 4, 2048, 33, 256
    dt = {"int8": torch.int8, "fp8": torch.uint8}[kind]
    if layout == "paged":
        S, W = 5, PAGE
        shape = (L, P, Hkv, PAGE, D)
        slot = torch.randperm(P * PAGE, generator=gen, device="cuda")[:B * S]
        rows0 = (slot // PAGE) * (Hkv * PAGE) + slot % PAGE
    else:
        S, W = (1 if layout == "decode" else S or 1024), T
        shape = (L, B, Hkv, T, D)
        start = (torch.arange(B, device="cuda") * 113 + 900
                 if layout == "decode" else torch.zeros(B, device="cuda",
                                                        dtype=torch.long))
        pos = start.long()[:, None] + torch.arange(S, device="cuda")[None, :]
        rows0 = (torch.arange(B, device="cuda")[:, None] * (Hkv * T)
                 + pos).reshape(-1)
    N = B * S
    qkv = torch.randn((N, ((Hq or Hkv) + 2 * Hkv) * D), generator=gen,
                      device="cuda")
    if layout == "sweep":
        qkv = torch.linspace(-600, 600, qkv.numel(), device="cuda").reshape(
            qkv.shape)[:, torch.randperm(qkv.shape[1], generator=gen,
                                         device="cuda")]
    qkv = qkv.to(torch.bfloat16)
    v = qkv[:, -Hkv * D:].view(N, Hkv, D)
    if Hq is None:
        k = qkv[:, Hkv * D: 2 * Hkv * D].view(N, Hkv, D)
    else:
        rope = torch.randn((N, (Hq + Hkv) * D), generator=gen,
                           device="cuda").to(torch.bfloat16)
        k = rope[:, Hq * D:].view(N, Hkv, D)
    kc = torch.zeros(shape, dtype=dt, device="cuda")
    vc = torch.zeros_like(kc)
    ks = vs = None
    if kind == "int8":
        ks = torch.zeros(shape[:-1], device="cuda")
        vs = torch.zeros_like(ks)
    ref = [None if t is None else t.clone() for t in (kc, vc, ks, vs)]
    off = 2 * shape[1] * Hkv * W
    cw.kv_encode_write(k, v, kc, vc, ks, vs, rows0, off, W)
    cw.kv_encode_write_plain(k, v, *ref, rows0, off, W)
    torch.cuda.synchronize()
    same = torch.equal(kc, ref[0]) and torch.equal(vc, ref[1]) and (
        ks is None or (torch.equal(ks.view(torch.int32),
                                   ref[2].view(torch.int32))
                       and torch.equal(vs.view(torch.int32),
                                       ref[3].view(torch.int32))))
    what = (f"{kind} {layout} B={B} S={S} Hkv={Hkv} D={D}"
            + (f" (K from the RoPE output of Hq={Hq})" if Hq else ""))
    need(same, f"kv_encode_write {what} differs from the plain encode-write")
    if layout == "sweep":
        nan_codes = int(((kc == 0x7F) | (kc == 0xFF)).sum()) if kind == "fp8" \
            else 0
        need(kind != "fp8" or nan_codes > 0, "fp8 sweep wrote no 0x7F/0xFF")

    def kernel(i):
        cw.kv_encode_write(k, v, kc, vc, ks, vs, rows0,
                           (i % L) * shape[1] * Hkv * W, W)
    ms = cuda_ms(torch, kernel, 20)
    plain_ms = cuda_ms(torch, lambda i: cw.kv_encode_write_plain(
        k, v, kc, vc, ks, vs, rows0, (i % L) * shape[1] * Hkv * W, W), 5,
        reps=3, graph=False)
    nbytes = 2 * N * Hkv * (D * 2 + kv_row_bytes(kc, D)) + N * 8
    b, by = bound_ms(nbytes, 0.0)
    row = dict(kernel="kv_encode_write", shape=what, max_abs_err=0.0, tol=0.0,
               ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b,
               bound_by=by, bound_ratio=ms / b)
    extra = ""
    if layout == "decode":
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(1000):
            kernel(i)
        row["host_us"] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        extra += f" host_us={row['host_us']:.2f} a call"
    if kind == "fp8":
        f8 = torch.float8_e4m3fn
        row["yardstick_ms"] = cuda_ms(torch, lambda i: (k.to(f8), v.to(f8)),
                                      20)
        extra += (f" yardstick_ms={row['yardstick_ms']:.4f} (K and V "
                  ".to(float8_e4m3fn): not the same function)")
    rows.append(row)
    say(f"  kv_encode_write {what}: exact={same} kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={b:.4f} ({by}) "
        f"ratio={ms / b:.2f}{extra} library_ms=None (no one call encodes)")
    if record:
        results["kv_encode_write"] = row


def check_encode_writes(torch, rows, results):
    """Every kv_encode_write row of phase 2, int8 and fp8: the 7B's
    decode step, B=8 S=1024 prefill slab, G=5 paged verify and the
    +-600 sweep; phase 10 (a)'s own prefill (960-token prompts in the
    1024 bucket, T=2048, the model's K and V views); GPT-OSS-20B's
    prefills of phase 9 (e) (Hq=64, Hkv=8, D=64: B=1 S=1024 and B=8
    S=512). The int8 decode row is the kernels line's."""
    for kind in KV_KINDS:
        for layout in ("decode", "prefill", "paged", "sweep"):
            check_encode_write(torch, rows, results, kind, layout,
                               record=kind == "int8" and layout == "decode")
        check_encode_write(torch, rows, results, kind, "prefill", False,
                           Hq=32)
        for B, S in ((1, 1024), (8, 512)):
            check_encode_write(torch, rows, results, kind, "prefill", False,
                               B=B, S=S, Hkv=8, D=64, Hq=64)


def check_decode(torch, F, rows, results, B, Hq, Hkv, T, D, lens,
                 record: bool, window=None, sinks: bool = False, kind=None,
                 softcap=None, qscale=1.0, lib_expand: bool = False):
    """decode_attention against decode_plain on layer 0 of a stacked
    cache, optionally with a window and per-head sinks (from a seed), or
    compressed to kind "int8"/"fp8" (SDPA then reads K/V dequantized
    beforehand, the dequantization not timed), or with a softcap (the
    queries drawn qscale wider; SDPA is then not the same function).
    The library yardstick is SDPA with a float mask on the same keys
    plus one appended key column (K = 0, V = 0, mask value = the head's
    sink), which computes exactly the sink softmax; K/V extension and
    mask are built beforehand. lib_expand: SDPA reads K/V expanded to the
    Hq query heads beforehand (repeat_interleave, not timed) instead of
    its enable_gqa form."""
    from turboinfer_tpu_torch.kernels import decode_attention as da
    gen = torch.Generator(device="cuda").manual_seed(4)
    L = 4 if record else 1
    kc = torch.randn((L, B, Hkv, T, D), generator=gen,
                     device="cuda").to(torch.bfloat16)
    vc = torch.randn((L, B, Hkv, T, D), generator=gen,
                     device="cuda").to(torch.bfloat16)
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
    if qscale != 1.0:
        q = (q.float() * qscale).to(torch.bfloat16)
    snk = (2 * torch.randn((Hq,), generator=gen, device="cuda")).to(
        torch.bfloat16).float() if sinks else None       # f32, as prepared
    (kc, ks), (vc, vs) = compress(torch, kc, kind), compress(torch, vc, kind)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    mk = mask_kw(None, softcap)
    got = da.decode_attention(q, kc, vc, kv_len, 0, window, snk, ks, vs, **mk)
    want = da.decode_plain(q, kc, vc, kv_len, 0, window, snk, ks, vs, **mk)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = 1e-2        # f32 sums in another order, plus one bf16 ulp
    what = (f"D={D} Hq={Hq} Hkv={Hkv} window={window} "
            f"sinks={'yes' if sinks else 'no'}"
            f"{'' if kind is None else f' kv={kind}'}"
            f"{mask_label(None, softcap, qscale)}")
    need(within(torch, got, want, tol), f"decode_attention {what}: "
         f"max_abs_err {err} beyond {tol} + 1 bf16 ulp")
    ms = cuda_ms(torch, lambda i: da.decode_attention(
        q, kc, vc, kv_len, i % L, window, snk, ks, vs, **mk), 20)
    plain_ms = cuda_ms(torch, lambda i: da.decode_plain(
        q, kc, vc, kv_len, i % L, window, snk, ks, vs, **mk), 5, reps=3)
    kq, vq = kc, vc                  # the kernel's operands, for the bound
    if kind is not None:
        kc = dequant(torch, kc, ks)
        vc = dequant(torch, vc, vs)
    gqa = Hq != Hkv
    if lib_expand and gqa:
        kc = kc.repeat_interleave(Hq // Hkv, 2)
        vc = vc.repeat_interleave(Hq // Hkv, 2)
        gqa = False
    kvc = kv_len.clamp(1, T)
    lo = (kvc - window).clamp(min=0) if window else torch.zeros_like(kvc)
    t = torch.arange(T, device="cuda")[None, :]
    mask = (t < kvc[:, None]) & (t >= lo[:, None])            # [B, T]
    qh = q[:, :, None]
    if sinks:
        fmask = torch.zeros((B, Hq, 1, T + 1), dtype=torch.bfloat16,
                            device="cuda")
        fmask[..., :T].masked_fill_(~mask[:, None, None], float("-inf"))
        fmask[..., T] = snk[None, :, None]
        zero = torch.zeros((B, kc.shape[2], 1, D), dtype=torch.bfloat16,
                           device="cuda")
        kx = [torch.cat([kc[li], zero], 2) for li in range(L)]
        vx = [torch.cat([vc[li], zero], 2) for li in range(L)]

        def lib(i):
            return F.scaled_dot_product_attention(
                qh, kx[i % L], vx[i % L], attn_mask=fmask, enable_gqa=gqa)
    else:
        kx, vx = kc, vc

        def lib(i):
            return F.scaled_dot_product_attention(
                qh, kc[i % L], vc[i % L], attn_mask=mask[:, None, None],
                enable_gqa=gqa)
    lib_err = (lib(0)[:, :, 0].float() - want.float()).abs().max().item()
    lib_ms = cuda_ms(torch, lib, 20)
    del kx, vx
    fill = int((kvc - lo).sum())
    nbytes = 2 * Hkv * fill * kv_row_bytes(kq, D) + 2 * B * Hq * D * 2
    b, by = bound_ms(nbytes, 4.0 * Hq * fill * D)
    row = dict(kernel="decode_attention", shape=f"B={B} Hq={Hq} Hkv={Hkv} "
               f"T={T} D={D} window={window} sinks={'yes' if sinks else 'no'} "
               f"{'' if kind is None else f'kv={kind} '}"
               f"{mask_label(None, softcap, qscale)[1:]}"
               f"{' ' if softcap else ''}"
               f"kv_len={list(lens)}", max_abs_err=err, tol=tol,
               ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               library_max_abs_err=lib_err, bound_ms=b, bound_by=by,
               library_ratio=ms / lib_ms, window=window, softcap=softcap,
               library_same_function=softcap is None,
               library_kv_expanded=lib_expand and Hq != Hkv)
    rows.append(row)
    say(f"  decode_attention {row['shape']}: max_abs_err={err:.4g} "
        f"(tol {tol}) kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={b:.4f} ({by}) library_ms={lib_ms:.4f} (SDPA"
        f"{', sink column' if sinks else ''}"
        f"{', K/V expanded beforehand' if row['library_kv_expanded'] else ''}"
        f"{', no softcap: not the same function' if softcap else ''}; its "
        f"max_abs_err {lib_err:.4g}) kernel/library={ms / lib_ms:.2f}")
    if record:
        results["decode_attention"] = row


def paged_table(torch, gen, B, P, max_pages, need):
    """A shuffled, non-monotone block table drawn with replacement from
    [0, P) (so rows share pages), -1 past each row's need."""
    table = torch.randint(0, P, (B, max_pages), generator=gen,
                          dtype=torch.int32)
    for b, n in enumerate(need):
        table[b, n:] = -1
    return table.cuda()


def check_paged(torch, F, rows, results, B, Hq, Hkv, D, page, P, lens, G,
                record: bool, kind=None, T=1024, window=None, softcap=None,
                qscale=1.0):
    """paged_attention at G query tokens per row against paged_plain;
    rows whose query sees no key (kv_len < G: undefined, the caller
    discards them) are left out of the comparison. kind "int8"/"fp8":
    a compressed pool (int8 with its scale pages). window/softcap as in
    check_flash (queries drawn qscale wider; the bound counts the keys
    from the earliest query's window on)."""
    from turboinfer_tpu_torch.kernels import paged_attention as pa
    gen = torch.Generator().manual_seed(6 + G)
    L = 2
    max_pages = -(-T // page)
    # pools past the 7B's 1024 positions are drawn on the card
    dgen = gen if T <= 1024 else torch.Generator(device="cuda").manual_seed(
        6 + G)
    kp = torch.randn((L, P, Hkv, page, D), generator=dgen,
                     device=dgen.device).to(torch.bfloat16).cuda()
    vp = torch.randn((L, P, Hkv, page, D), generator=dgen,
                     device=dgen.device).to(torch.bfloat16).cuda()
    q = (qscale * torch.randn((B, G, Hq, D), generator=gen)).to(
        torch.bfloat16).cuda()
    (kp, ks), (vp, vs) = compress(torch, kp, kind), compress(torch, vp, kind)
    table = paged_table(torch, gen, B, P, max_pages,
                        [-(-max(n, 1) // page) for n in lens])
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    mk = mask_kw(window, softcap)
    got = pa.paged_attention(q, kp, vp, table, kv_len, 1, ks, vs, **mk)
    want = pa.paged_plain(q, kp, vp, table, kv_len, 1, G, ks, vs, **mk)
    torch.cuda.synchronize()
    kvc = kv_len.clamp(min=1)
    valid = ((kvc[:, None] - G + torch.arange(G, device="cuda")[None, :])
             >= 0)
    err = (got.float() - want.float())[valid].abs().max().item()
    tol = 1e-2        # f32 sums in another order, plus one bf16 ulp
    what = (f"G={G} D={D} Hq={Hq} Hkv={Hkv} page={page}"
            f"{'' if kind is None else f' kv={kind}'}"
            f"{mask_label(window, softcap, qscale)}")
    need(bool(torch.isfinite(got.float()).all())
         and within(torch, got[valid], want[valid], tol),
         f"paged_attention {what}: max_abs_err {err} beyond {tol} + 1 bf16 ulp")
    ms = cuda_ms(torch, lambda i: pa.paged_attention(q, kp, vp, table, kv_len,
                                                     i % L, ks, vs, **mk), 20)
    plain_ms = cuda_ms(torch, lambda i: pa.paged_plain(
        q, kp, vp, table, kv_len, i % L, G, ks, vs, **mk), 5, reps=3)
    # library yardstick: SDPA on K/V gathered (and dequantized)
    # beforehand, neither timed
    t = table.long().clamp(0, P - 1)
    kg = [dequant(torch, kp[li], None if ks is None else ks[li])[t].transpose(
        1, 2).reshape(B, Hkv, max_pages * page, D) for li in range(L)]
    vg = [dequant(torch, vp[li], None if vs is None else vs[li])[t].transpose(
        1, 2).reshape(B, Hkv, max_pages * page, D) for li in range(L)]
    qpos = kvc[:, None] - G + torch.arange(G, device="cuda")[None, :]
    kpos = torch.arange(max_pages * page, device="cuda")[None, None, :]
    mask = kpos <= qpos[:, :, None]
    if window is not None:
        mask &= kpos > qpos[:, :, None] - window
    mask = mask[:, None]
    qh = q.transpose(1, 2)
    lib_ms = cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
        qh, kg[i % L], vg[i % L], attn_mask=mask, enable_gqa=Hq != Hkv), 20)
    w = window or 1 << 30
    # keys from the earliest query's window on; each query's visible keys
    fill = sum(max(1, n) - max(0, max(n, 1) - G + 1 - w) for n in lens)
    nbytes = 2 * Hkv * fill * kv_row_bytes(kp, D) + 2 * B * G * Hq * D * 2
    pairs = sum(max(0, min(max(n, 1), max(n, 1) - G + g + 1, w))
                for n in lens for g in range(G))
    b, by = bound_ms(nbytes, 4.0 * Hq * pairs * D)
    row = dict(kernel="paged_attention", shape=f"{what} B={B} P={P} "
               f"kv_len={list(lens)}", max_abs_err=err, tol=tol, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b, bound_by=by,
               library_ratio=ms / lib_ms, window=window, softcap=softcap,
               library_same_function=softcap is None)
    rows.append(row)
    say(f"  paged_attention {row['shape']}: max_abs_err={err:.4g} (tol {tol}) "
        f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b:.4f} ({by}) "
        f"library_ms={lib_ms:.4f} (SDPA, gather excluded"
        f"{', no softcap: not the same function' if softcap else ''}) "
        f"kernel/library={ms / lib_ms:.2f} kernel/bound={ms / b:.2f}")
    if record:
        results["paged_attention"] = row
    del kp, vp, kg, vg


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
    paged_lens = [1, 1000, 257, 512, 700, 64, 999, 300]
    for G in (1, 5):        # decode, and a spec_k=4 verify
        check_paged(torch, F, rows, results, 8, 32, 32, 128, 256, 33,
                    paged_lens, G, record=G == 1)
    check_paged(torch, F, rows, results, 3, 8, 2, 64, 16, 40, [0, 77, 200],
                3, record=False)
    check_paged(torch, F, rows, results, 2, 4, 4, 32, 8, 40, [5, 130], 2,
                record=False)
    check_qmm_grouped(torch, rows, results)
    # Mixtral's GQA shape (Hq=32, Hkv=8, D=128) on the attention kernels
    check_flash(torch, F, rows, results, 1, 32, 8, 1024, 128, [1000],
                record=False)
    check_flash(torch, F, rows, results, 8, 32, 8, 512, 128,
                [512, 500, 384, 300, 257, 128, 64, 1], record=False)
    # every row full (kv_len = S, q_start 0), where SDPA's is_causal form
    # computes the same function: the 7B and Mixtral shapes
    check_flash(torch, F, rows, results, 8, 32, 32, 512, 128, [512] * 8,
                record=False)
    check_flash(torch, F, rows, results, 1, 32, 8, 1024, 128, [1024],
                record=False)
    check_decode(torch, F, rows, results, 1, 32, 8, 2048, 128, [1128],
                 record=False)
    check_decode(torch, F, rows, results, 8, 32, 8, 2048, 128,
                 [513, 1, 575, 560, 530, 600, 512, 575], record=False)
    check_paged(torch, F, rows, results, 8, 32, 8, 128, 256, 33, paged_lens,
                1, record=False)
    # the same over 8-bit pools, and a spec_k=4 verify there (G=5: 20
    # query rows a kv head) over every pool
    for kind in KV_KINDS:
        check_paged(torch, F, rows, results, 8, 32, 8, 128, 256, 33,
                    paged_lens, 1, record=False, kind=kind)
    for kind in (None, *KV_KINDS):
        check_paged(torch, F, rows, results, 8, 32, 8, 128, 256, 33,
                    paged_lens, 5, record=False, kind=kind)
    # GPT-OSS-20B's decode (Hq=64, Hkv=8, D=64, T=2048): its sliding
    # (window 128) and full layers with per-head sinks, phase 9's kv_len,
    # then the slice boundaries: kv_len 1, 255, 256, 257, a window start
    # on a 256-row boundary (384 - 128), window 1, a window past kv_len;
    # and the window without sinks (decode_pallas's window)
    gpt = (64, 8, 2048, 64)
    for window in (128, None):
        check_decode(torch, F, rows, results, 1, *gpt, [1128], False,
                     window, True)
        check_decode(torch, F, rows, results, 8, *gpt,
                     [1128, 1, 255, 256, 257, 384, 600, 2048], False, window,
                     True)
    for window, lens in ((1, [1, 256, 257, 2048]), (128, [384, 512, 129, 128]),
                         (3000, [1, 255, 256, 2048])):
        check_decode(torch, F, rows, results, 4, *gpt, lens, False, window,
                     True)
    check_decode(torch, F, rows, results, 8, *gpt,
                 [1128, 1, 255, 256, 257, 384, 600, 2048], False, 128, False)
    # a full layer at GPT-OSS's published context, 131072 rows: 1024
    # slices a kv head for the merge (the block's shared memory does not
    # grow with T)
    check_decode(torch, F, rows, results, 1, 64, 8, 131072, 64, [131072],
                 False, None, True)
    # the qmm at GPT-OSS's projection shapes (K=2880 is 45 groups; wo's
    # N=2880 leaves a 64-column tail in the 128-wide tile): decode at
    # M=1 and 8, phase 9's prefills at M=1024 (a) and 4096 (b)
    check_qmm(torch, rows, results, shapes=[
        ("gptoss wqkv", 2880, 5120), ("gptoss wo", 4096, 2880),
        ("gptoss lm_head", 2880, 201088)], Ms=(1, 8, 1024, 4096),
        record=False)
    # the cache write of phase 9's fresh prefills, (a) and (b)
    check_cache_write(torch, rows, results, 1, 8, 1024, 2048, 64, False)
    check_cache_write(torch, rows, results, 8, 8, 512, 2048, 64, False)
    # int8 and fp8 caches (phase 10): the encode-and-write kernel, byte
    # exact at its three addressings and across fp8's +-464; the
    # compressed reads of the decode kernel at the 7B and Mixtral shapes,
    # of the stacked prefill, and of the paged kernel at G=1 and G=5
    check_encode_writes(torch, rows, results)
    for kind in KV_KINDS:
        check_decode(torch, F, rows, results, 8, 32, 32, 1024, 128,
                     [1, 513, 960, 1024, 700, 64, 300, 1000], False,
                     kind=kind)
        check_decode(torch, F, rows, results, 1, 32, 8, 2048, 128, [1128],
                     False, kind=kind)
        check_flash(torch, F, rows, results, 8, 32, 32, 128, 128,
                    [128, 128, 100, 128, 77, 5, 128, 1], record=False,
                    q_start=[384, 0, 512, 256, 880, 128, 64, 700], T=1024,
                    kind=kind)
        # phase 10 (a)'s own shapes: the prefill of 960-token prompts
        # (bucket 1024) read back from a T=2048 cache, 16 query tiles per
        # head, and decode at fill 961..1088 (8 split-T slices); (b)'s
        # admissions over their small cache: a cold 700-token prompt
        # (bucket 1024) and a 190-token suffix behind 2 shared pages
        check_flash(torch, F, rows, results, 8, 32, 32, 1024, 128,
                    [960] * 8, record=False, q_start=[0] * 8, T=2048,
                    kind=kind)
        check_decode(torch, F, rows, results, 8, 32, 32, 2048, 128,
                     [961, 1088, 1000, 1024, 975, 1050, 1066, 993], False,
                     kind=kind)
        check_flash(torch, F, rows, results, 1, 32, 32, 1024, 128, [700],
                    record=False, q_start=[0], T=1024, kind=kind)
        check_flash(torch, F, rows, results, 1, 32, 32, 512, 128, [190],
                    record=False, q_start=[512], T=1024, kind=kind)
        for G in (1, 5):
            check_paged(torch, F, rows, results, 8, 32, 32, 128, 256, 33,
                        paged_lens, G, record=False, kind=kind)
    # int8 and zero-point weights (phase 11): the qmm at the 7B's decode,
    # verify, admission and prefill shapes, the head at decode; GPT-OSS's
    # K=2880 projections (45 groups) and wo's 64-column tail; int4 with
    # zero points; the grouped kernel over 64-plane int8 expert stacks
    for asym in (False, True):
        check_qmm(torch, rows, results, shapes=[("w_gateup", 4096, 22016)],
                  record=not asym, bits=8, asym=asym)
        check_qmm(torch, rows, results, shapes=[("lm_head", 4096, 32000)],
                  Ms=(8,), record=False, bits=8, asym=asym)
        check_qmm(torch, rows, results, shapes=[("gptoss wqkv", 2880, 5120)],
                  Ms=(1, 1024), record=False, bits=8, asym=asym)
        check_qmm(torch, rows, results, shapes=[("gptoss wo", 4096, 2880)],
                  Ms=(1,), record=False, bits=8, asym=asym)
        check_qmm_grouped(torch, rows, results, bits=8, asym=asym, n=64,
                          names=("we_gateup", "we_down"))
    # qmm_int8 at the other shapes phase 11 gives it: the 7B's wqkv, wo
    # and w_down (K=11008: 22 split-K slices, a 256-row tail) at (a)'s
    # decode and prefill and (b)'s admission, and with zero points at a
    # B=2 decode and prefill; Mixtral's attention and head at (c)'s
    # B=1 decode and 1000-token prefill, its expert planes through the
    # E-loop at that prefill and at a B=8 decode
    check_qmm(torch, rows, results, shapes=[
        ("wqkv", 4096, 12288), ("wo", 4096, 4096), ("w_down", 11008, 4096)],
        Ms=(8, 256, 4096), record=False, bits=8)
    check_qmm(torch, rows, results, shapes=[
        ("wqkv", 4096, 12288), ("wo", 4096, 4096), ("w_down", 11008, 4096)],
        Ms=(2, 128), record=False, bits=8, asym=True)
    check_qmm(torch, rows, results, shapes=[
        ("mixtral wqkv", 4096, 6144), ("mixtral wo", 4096, 4096),
        ("mixtral lm_head", 4096, 32000)], Ms=(1, 1000), record=False,
        bits=8)
    check_qmm(torch, rows, results, shapes=[
        ("we_gateup", 4096, 28672), ("we_down", 14336, 4096)],
        Ms=(8, 1000), record=False, bits=8)
    check_qmm(torch, rows, results, shapes=[("w_gateup", 4096, 22016)],
              Ms=(8, 4096), record=False, bits=4, asym=True)
    check_qmm_grouped(torch, rows, results, bits=4, asym=True, n=64,
                      names=("we_gateup", "we_down"))
    # the GEMV across its M range: the 7B's int4 and int8 projections at
    # M=1 (B=1 decode) and M=16 (B=16 decode, two token tiles)
    for bits in (4, 8):
        check_qmm(torch, rows, results, shapes=[
            ("wqkv", 4096, 12288), ("wo", 4096, 4096),
            ("w_gateup", 4096, 22016), ("w_down", 11008, 4096)],
            Ms=(1, 16), record=False, bits=bits)
    # the tensor-core qmm (M > 16) at the 7B int4 projections at a short
    # verify or admission (M = 17, one 64-token tile) and a 128-token
    # one (split-K), and at Mixtral's int4 expert planes through the
    # E-loop of phase 8 (b)'s prefill (M = 1000)
    check_qmm(torch, rows, results, shapes=[
        ("wqkv", 4096, 12288), ("wo", 4096, 4096), ("w_gateup", 4096, 22016),
        ("w_down", 11008, 4096)], Ms=(17, 128), record=False)
    check_qmm(torch, rows, results, shapes=[
        ("we_gateup", 4096, 28672), ("we_down", 14336, 4096)], Ms=(1000,),
        record=False)
    # W4A8 (phase 12): the row quantizer at the 7B's widths (K=4096 and
    # w_down's 11008) and the product at every 7B projection, g=256, at
    # (b)'s B=16 decode, (c)'s verify, an admission and (a)'s prefill
    check_a8_quantize(torch, rows, results, [(16, 4096), (40, 4096),
                                             (4096, 4096), (4096, 11008)])
    check_qmm_a8(torch, rows, results, [
        ("wqkv", 4096, 12288), ("wo", 4096, 4096), ("w_gateup", 4096, 22016),
        ("w_down", 11008, 4096)], Ms=(16, 40, 256, 4096))
    check_qmm_a8(torch, rows, results, [("lm_head", 4096, 32000)], Ms=(16,))
    # GPT-OSS on int8 and fp8 caches (phase 9 (e)): the decode kernel's
    # 8-bit reads with sinks, on the sliding (window 128) and full layers,
    # at (e)'s B=1 kv_len and B=8 across the slice boundaries
    for kind in KV_KINDS:
        for window in (128, None):
            check_decode(torch, F, rows, results, 1, *gpt, [1128], False,
                         window, True, kind=kind)
            check_decode(torch, F, rows, results, 8, *gpt,
                         [1128, 1, 255, 256, 257, 384, 600, 2048], False,
                         window, True, kind=kind)
    check_gemma2_attention(torch, F, rows, results)
    check_head_dim_256(torch, F, rows, results)
    check_head_dim_96(torch, F, rows, results)
    check_falcon_shapes(torch, F, rows, results)
    check_moe_shapes(torch, F, rows, results)
    report["kernel_rows"] = rows
    return results


# Gemma-2-27B's attention (phase 13): Hq=32, Hkv=16, D=128, cap 50, a
# 4096-key window on its local layers. Queries drawn GEMMA2_QSCALE wider
# put the scores (spread ~30) 2-3x past the cap in their tails; the rows
# at scale 1 stay below it.
GEMMA2_ATTN = (32, 16, 128)
GEMMA2_CAP, GEMMA2_WINDOW, GEMMA2_QSCALE = 50.0, 4096, 30.0


def check_gemma2_attention(torch, F, rows, results):
    """Phase 2's rows at Gemma-2-27B's attention shapes, each against its
    plain version at the existing tolerances, over bf16, int8 and fp8
    K/V: the flash prefill of a 5000-token prompt (B=1) with window 4096
    and with window 600 (the cap not biting), of B=8 512-token prompts
    (cap only), and a chunked read at q_start 4096 (window 4096, and a
    global layer); decode at B=8 T=8192 on a local and a global layer;
    paged decode (G=1) and verify (G=5) over 256-token pages, local and
    global. An 8-bit prefill reads the stacked cache (q_start 0), as the
    model's prefill over an int8 or fp8 cache does."""
    Hq, Hkv, D = GEMMA2_ATTN
    cap, win, qx = GEMMA2_CAP, GEMMA2_WINDOW, GEMMA2_QSCALE
    for kind in (None, *KV_KINDS):
        for window, scale in ((win, qx), (600, 1.0)):
            if kind is None:
                check_flash(torch, F, rows, results, 1, Hq, Hkv, 5000, D,
                            [5000], False, window=window, softcap=cap,
                            qscale=scale)
            else:
                check_flash(torch, F, rows, results, 1, Hq, Hkv, 5000, D,
                            [5000], False, q_start=[0], T=8192, kind=kind,
                            window=window, softcap=cap, qscale=scale)
        fill = [512, 500, 384, 300, 257, 128, 64, 1]
        if kind is None:
            check_flash(torch, F, rows, results, 8, Hq, Hkv, 512, D, fill,
                        False, softcap=cap, qscale=qx)
        else:
            check_flash(torch, F, rows, results, 8, Hq, Hkv, 512, D, fill,
                        False, q_start=[0] * 8, T=1024, kind=kind,
                        softcap=cap, qscale=qx)
        for window in (win, None):
            check_flash(torch, F, rows, results, 1, Hq, Hkv, 904, D, [904],
                        False, q_start=[4096], T=8192, kind=kind,
                        window=window, softcap=cap, qscale=qx)
        lens = [4000, 8192, 4097, 6000, 5000, 7777, 4500, 8000]
        for window, scale in ((win, qx), (None, 1.0)):
            check_decode(torch, F, rows, results, 8, Hq, Hkv, 8192, D, lens,
                         False, window, kind=kind, softcap=cap, qscale=scale)
        paged_lens = [600, 5000, 4097, 8192, 4200, 1000, 7000, 4500]
        for G in (1, 5):
            for window, scale in ((win, qx), (None, 1.0)):
                check_paged(torch, F, rows, results, 8, Hq, Hkv, D, 256,
                            8 * 32 + 1, paged_lens, G, False, kind=kind,
                            T=8192, window=window, softcap=cap, qscale=scale)


# Head dim 256 (phase 14): Gemma-3-12B's attention (Hq=16, Hkv=8, D=256,
# a 1024-key window on five layers of six, no softcap) and Gemma-2-9B's
# (the same heads, a 4096-key window on every other layer, cap 50: its
# queries drawn GEMMA2_QSCALE wider so the cap bites).
GEMMA3_ATTN = (16, 8, 256)
GEMMA3_WINDOW = 1024
# (window, softcap, query scale) of the three kinds of D=256 layer
D256_MASKS = ((GEMMA3_WINDOW, None, 1.0), (None, None, 1.0),
              (GEMMA2_WINDOW, GEMMA2_CAP, GEMMA2_QSCALE))


def check_head_dim_256(torch, F, rows, results):
    """Phase 2's rows at head dim 256, each against its plain version at
    the existing tolerances: the flash prefill of a 5000-token prompt
    (B=1) on a Gemma-3 local layer, a global layer and a Gemma-2-9B
    capped layer, the 8-bit prefill read back from the cache (q_start 0,
    as phase 14 (b)'s), and a chunked read of 904 tokens at q_start 4096
    over bf16, int8 and fp8 (local and global); decode at B=8 T=8192 on
    the three kinds of layer over bf16, int8 and fp8, and a lone head
    (Gemma-1-7B's 16:16) on the CUDA-core kernel; paged decode (G=1) and
    verify (G=5) over 256-token pages, local and global over every pool,
    capped over bf16; Gemma-3's products at a B=2 decode; the cache write
    of phase 14 (a)'s prefill (B=2, S=T=8192) and the encode-and-write of
    its decode step, of a 2048-token slab and of a G=5 verify into
    pages."""
    Hq, Hkv, D = GEMMA3_ATTN
    for window, cap, qs in D256_MASKS:
        check_flash(torch, F, rows, results, 1, Hq, Hkv, 5000, D, [5000],
                    False, window=window, softcap=cap, qscale=qs)
    for kind in KV_KINDS:
        check_flash(torch, F, rows, results, 1, Hq, Hkv, 5000, D, [5000],
                    False, q_start=[0], T=8192, kind=kind,
                    window=GEMMA3_WINDOW)
    for kind in (None, *KV_KINDS):
        for window in (GEMMA3_WINDOW, None):
            check_flash(torch, F, rows, results, 1, Hq, Hkv, 904, D, [904],
                        False, q_start=[4096], T=8192, kind=kind,
                        window=window)
    lens = [4000, 8192, 4097, 6000, 5000, 7777, 4500, 8000]
    for kind in (None, *KV_KINDS):
        for window, cap, qs in D256_MASKS:
            check_decode(torch, F, rows, results, 8, Hq, Hkv, 8192, D, lens,
                         False, window, kind=kind, softcap=cap, qscale=qs)
    check_decode(torch, F, rows, results, 8, 16, 16, 8192, D, lens, False)
    paged_lens = [600, 5000, 4097, 8192, 4200, 1000, 7000, 4500]
    for G in (1, 5):
        for kind in (None, *KV_KINDS):
            for window, cap, qs in D256_MASKS[:2 if kind else 3]:
                check_paged(torch, F, rows, results, 8, Hq, Hkv, D, 256,
                            8 * 32 + 1, paged_lens, G, False, kind=kind,
                            T=8192, window=window, softcap=cap, qscale=qs)
    check_qmm(torch, rows, results, shapes=[
        ("gemma3 wqkv", 3840, 8192), ("gemma3 wo", 4096, 3840),
        ("gemma3 w_gateup", 3840, 30720), ("gemma3 w_down", 15360, 3840),
        ("gemma3 lm_head", 3840, 262208)], Ms=(2,), record=False)
    check_cache_write(torch, rows, results, 2, Hkv, 8192, 8192, D, False)
    for kind in KV_KINDS:
        check_encode_write(torch, rows, results, kind, "decode", False, B=2,
                           Hkv=Hkv, D=D, Hq=Hq)
        check_encode_write(torch, rows, results, kind, "prefill", False, B=2,
                           S=2048, Hkv=Hkv, D=D, Hq=Hq)
        check_encode_write(torch, rows, results, kind, "paged", False,
                           Hkv=Hkv, D=D)


# Head dim 96 (phase 15): Phi-3-mini's attention (32:32 heads of 96, a
# 2047-key window on every layer; MHA, so its decode runs the lone-head
# CUDA-core kernels), at its 4096 positions. kv_lens and token counts
# include odd ones, so a lane of a padded row group that wrote or summed
# into a neighbouring row would show.
PHI3_ATTN = (32, 32, 96)
PHI3_WINDOW, PHI3_T = 2047, 4096


def check_head_dim_96(torch, F, rows, results):
    """Phase 2's rows at head dim 96, each against its plain version at
    the existing tolerances: the flash prefill of a 3500-token prompt
    (B=1) on a windowed and a global layer, the 8-bit prefill read back
    from the cache (q_start 0, as phase 15 (b)'s), and a chunk of 903
    tokens at q_start 2048 over bf16, int8 and fp8; decode at B=8 T=4096,
    kv_len 1..4096, on the lone-head kernel, windowed and global, over
    bf16, int8 and fp8, and on the tensor-core kernel (Hq=32 Hkv=8);
    paged decode (G=1) and verify (G=5) over 256-token pages and every
    pool; Phi-3's products at a B=2 decode; the cache write of phase 15
    (a)'s prefill (B=2, S=T=4096) and the encode-and-write of a decode
    step, a 2047-token slab and a G=5 verify of 7 rows into pages."""
    Hq, Hkv, D = PHI3_ATTN
    W, T = PHI3_WINDOW, PHI3_T
    for window in (W, None):
        check_flash(torch, F, rows, results, 1, Hq, Hkv, 3500, D, [3500],
                    False, window=window)
    for kind in KV_KINDS:
        check_flash(torch, F, rows, results, 1, Hq, Hkv, 3500, D, [3499],
                    False, q_start=[0], T=T, kind=kind, window=W)
    for kind in (None, *KV_KINDS):
        check_flash(torch, F, rows, results, 1, Hq, Hkv, 904, D, [903],
                    False, q_start=[2048], T=T, kind=kind, window=W)
    lens = [1, 4096, 2047, 2049, 3001, 3501, 777, 4095]
    for kind in (None, *KV_KINDS):
        for window in (W, None):
            check_decode(torch, F, rows, results, 8, Hq, Hkv, T, D, lens,
                         False, window, kind=kind)
    check_decode(torch, F, rows, results, 8, 32, 8, T, D, lens, False, W)
    paged_lens = [1, 3001, 2049, 4096, 2200, 601, 3500, 2047]
    for G in (1, 5):
        for kind in (None, *KV_KINDS):
            check_paged(torch, F, rows, results, 8, Hq, Hkv, D, 256,
                        8 * 16 + 1, paged_lens, G, False, kind=kind, T=T,
                        window=W)
    check_qmm(torch, rows, results, shapes=[
        ("phi3 wqkv", 3072, 9216), ("phi3 wo", 3072, 3072),
        ("phi3 w_gateup", 3072, 16384), ("phi3 w_down", 8192, 3072),
        ("phi3 lm_head", 3072, 32064)], Ms=(2,), record=False)
    check_cache_write(torch, rows, results, 2, Hkv, T, T, D, False)
    for kind in KV_KINDS:
        check_encode_write(torch, rows, results, kind, "decode", False, B=2,
                           Hkv=Hkv, D=D, Hq=Hq)
        check_encode_write(torch, rows, results, kind, "prefill", False, B=2,
                           S=2047, Hkv=Hkv, D=D, Hq=Hq)
        check_encode_write(torch, rows, results, kind, "paged", False, B=7,
                           Hkv=Hkv, D=D)


# Falcon-7B (phase 19): 71 query heads on one kv head of 64 (MQA), hidden
# 4544 (71 groups of 64: a prime group count for the qmm's K), FFN 18176,
# vocab 65024; and Falcon-40B's 128:8 grouping (16 a kv head).
FALCON_ATTN = (71, 1, 64)


def check_falcon_shapes(torch, F, rows, results):
    """Phase 2's rows at Falcon's shapes, each against its plain version
    at the existing tolerances: (8g) decode at the group of 71 (nine head
    tiles of 8), B=8 T=2048, kv_len 1..2048, bf16, int8 and fp8, and at
    Falcon-40B's 16 a kv head (Hq=128, Hkv=8), SDPA reading K/V expanded
    to the query heads beforehand; (5g) the flash prefill of phase 19
    (a)'s B=2 prompts (1536 and 1024 tokens; a block takes one head, 71
    being prime), (6g) the 8-bit prefill read back from the cache; (7g) the cache write of that
    prefill at Hkv=1, (7eg) the encode-and-write of a decode step and a
    1536-token slab; (1f) int4 qmm at K=4544 (w_qkv N=4672, wo, w_fc
    N=18176) and w_proj's K=18176, at M=2 (decode) and 1536 (a prompt),
    and the head (N=65024) at M=2."""
    Hq, Hkv, D = FALCON_ATTN
    T = 2048
    lens = [1, 2048, 1024, 1025, 1536, 129, 777, 2047]
    for kind in (None, *KV_KINDS):
        check_decode(torch, F, rows, results, 8, Hq, Hkv, T, D, lens, False,
                     kind=kind, lib_expand=True)
    check_decode(torch, F, rows, results, 8, 128, 8, T, D, lens, False,
                 lib_expand=True)
    check_flash(torch, F, rows, results, 2, Hq, Hkv, 1536, D, [1536, 1024],
                False)
    for kind in KV_KINDS:
        check_flash(torch, F, rows, results, 2, Hq, Hkv, 1536, D,
                    [1536, 1024], False, q_start=[0, 0], T=T, kind=kind)
    check_cache_write(torch, rows, results, 2, Hkv, 1536, T, D, False)
    for kind in KV_KINDS:
        check_encode_write(torch, rows, results, kind, "decode", False, B=8,
                           Hkv=Hkv, D=D, Hq=Hq)
        check_encode_write(torch, rows, results, kind, "prefill", False, B=2,
                           S=1536, Hkv=Hkv, D=D, Hq=Hq)
    shapes = [("falcon w_qkv", 4544, 4672), ("falcon wo", 4544, 4544),
              ("falcon w_fc", 4544, 18176), ("falcon w_proj", 18176, 4544)]
    check_qmm(torch, rows, results, shapes=shapes, Ms=(2, 1536),
              record=False)
    check_qmm(torch, rows, results, shapes=[("falcon lm_head", 4544, 65024)],
              Ms=(2,), record=False)


# phase 20's grouped products: (label, G routed experts, K, N, planes of
# the flat stack). DeepSeek-V2-Lite's stacks hold all 26 MoE layers x 64
# experts (1664 planes: the fused gate/up stack is 4.8 GB, so its last
# planes lie past 2^31 bytes); the variants' one layer of (d).
MOE_GROUPED = (("V2-Lite we_gateup", 6, 2048, 2 * 1408, 26 * 64),
               ("V2-Lite we_down", 6, 1408, 2048, 26 * 64),
               ("Qwen1.5-MoE we_gateup", 4, 2048, 2 * 1408, 60),
               ("Qwen1.5-MoE we_down", 4, 1408, 2048, 60),
               ("Qwen3-30B-A3B we_gateup", 8, 2048, 2 * 768, 128),
               ("Qwen3-30B-A3B we_down", 8, 768, 2048, 128),
               ("OLMoE we_gateup", 8, 2048, 2 * 1024, 64),
               ("OLMoE we_down", 8, 1024, 2048, 64))


def check_grouped_moe(torch, rows, label, G, K, N, n):
    """qmm_int4_grouped at a B=1 decode step's shape (G routed experts, M=1)
    on a flat int4 stack of n planes against qmatmul_grouped_plain: the
    last plane, repeated slots and slot 0 (2% of max|plain|), timed
    beside its byte bound, the plain version and torch.bmm on the G
    planes dequantized beforehand."""
    from turboinfer_tpu_torch.core.qtensor import QTensor, dequantize
    from turboinfer_tpu_torch.kernels import qmm
    gen = torch.Generator(device="cuda").manual_seed(20 + G)
    g = 64
    qt = rand_qtensor(torch, gen, (n,), K, N, 4, False, g)
    worst = (0.0, 0.0)
    cases = [list(range(n - G, n)), [n - 1] * G,
             [0] + [(37 * j) % n for j in range(1, G)]]
    x = torch.randn((G, 1, K), generator=gen, device="cuda").to(
        torch.bfloat16)
    for sl in cases:
        slots = torch.tensor(sl, dtype=torch.int32, device="cuda")
        got = qmm.qmm_int4_grouped(x, qt, slots)
        want = qmm.qmatmul_grouped_plain(x, qt, slots)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = 2e-2 * want.float().abs().max().item()
        need(err <= tol, f"qmm_int4_grouped {label} G={G} slots {sl}: "
                         f"max_abs_err {err} > {tol}")
        worst = max(worst, (err, tol))
    sets = [torch.tensor([(41 * i + 13 * j) % n for j in range(G)],
                         dtype=torch.int32, device="cuda") for i in range(20)]
    ms = cuda_ms(torch, lambda i: qmm.qmm_int4_grouped(x, qt, sets[i]), 20)
    plain_ms = cuda_ms(torch, lambda i: qmm.qmatmul_grouped_plain(
        x, qt, sets[i]), 4, reps=3)
    idx = sets[0].long()
    wd = dequantize(QTensor(data=qt.data[idx], scales=qt.scales[idx],
                            zero_points=None, bits=4, group_size=g,
                            shape=(K, N)), torch.bfloat16)
    lib_ms = cuda_ms(torch, lambda i: torch.bmm(x, wd), 20)
    nbytes = G * qmm_bytes(K, N, g, 4, False) + G * (K + N) * 2
    b, by = bound_ms(nbytes, 2.0 * G * K * N)
    stack_gb = qt.data.numel() / 1e9
    row = dict(kernel="qmm_int4_grouped", shape=f"{label} G={G} M=1 K={K} "
               f"N={N} (stack of {n}, {stack_gb:.2f} GB of codes)",
               max_abs_err=worst[0], tol=worst[1], ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=b, bound_by=by,
               library_ratio=ms / lib_ms)
    rows.append(row)
    say(f"  qmm_int4_grouped {row['shape']}: max_abs_err={worst[0]:.4g} "
        f"(tol {worst[1]:.3g}, last plane, repeats, slot 0) kernel_ms="
        f"{ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b:.4f} ({by}, "
        f"x{ms / b:.2f}) library_ms={lib_ms:.4f} (bmm, dequantized planes)")
    del qt, wd
    torch.cuda.empty_cache()


def check_moe_shapes(torch, F, rows, results):
    """Phase 2's rows at phase 20's shapes: int4 qmm at DeepSeek-V2-Lite's
    products (wq N=3072, wkv_a N=576, wo, the shared experts' ws_gate and
    ws_down, the dense layer's w_gate N=10944 and w_down K=10944, the
    head N=102400) at a B=1 decode (M=1), wkv_a and the expert planes
    (we_gateup N=2816, we_down K=1408) at a 4-row E-loop step (M=4) and
    a 1024-token prefill (M=1024); the grouped product at every model's
    B=1 decode shape (MOE_GROUPED); decode, flash and paged attention at
    Qwen3-30B-A3B's 32:4 heads of 128 (a group of 8)."""
    check_qmm(torch, rows, results, shapes=[
        ("ds wq", 2048, 3072), ("ds wkv_a", 2048, 576), ("ds wo", 2048, 2048),
        ("ds ws_gate", 2048, 2816), ("ds ws_down", 2816, 2048),
        ("ds w_gate", 2048, 10944), ("ds w_down", 10944, 2048),
        ("ds lm_head", 2048, 102400)], Ms=(1,), record=False)
    check_qmm(torch, rows, results, shapes=[
        ("ds wkv_a", 2048, 576), ("ds we_gateup", 2048, 2816),
        ("ds we_down", 1408, 2048)], Ms=(4, 1024), record=False)
    for spec in MOE_GROUPED:
        check_grouped_moe(torch, rows, *spec)
    lens = [1, 2048, 1024, 1025, 777, 129, 1500, 2047]
    check_decode(torch, F, rows, results, 8, 32, 4, 2048, 128, lens, False)
    check_flash(torch, F, rows, results, 1, 32, 4, 1024, 128, [1024], False)
    check_paged(torch, F, rows, results, 8, 32, 4, 128, 256, 65, lens[:4] +
                [1000, 64, 999, 300], 1, False, T=2048)


# -- phase 3 ---------------------------------------------------------------

def expected_launches(L: int, decode_forwards: int, prefills: int = 1,
                      compressed: bool = False, qmm: str = "qmm_int4"):
    """Launches of the llama path: qmm 4L+1 per forward (on the `qmm`
    kernel of the weights' width), flash L per prefill, decode attention
    L per decode forward; a model-dtype cache is written by
    cache_write_fresh (L per prefill, decode steps index), an int8 or fp8
    one by kv_encode_write (L per forward)."""
    per_fwd = 4 * L + 1
    return want_counts(**{qmm: per_fwd * (prefills + decode_forwards)},
                       flash_prefill=L * prefills,
                       cache_write_fresh=0 if compressed else L * prefills,
                       kv_encode_write=(L * (prefills + decode_forwards)
                                        if compressed else 0),
                       decode_attention=L * decode_forwards)


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


def trace_steps(torch, step, steps: int, label: str):
    """Device busy share of `steps` calls of step(), from a torch.profiler
    trace: the summed duration of the CUDA kernels over the wall time of
    the window (kernels of one stream do not overlap). The profiler
    slows the host, so the traced share is a lower bound of the
    untraced one. Also reports the host ops and the device kernels that
    cost the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_kernel = {}
    for e in kernels:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU),
                 key=lambda e: e.self_cpu_time_total, reverse=True)[:6]
    res = dict(steps=steps, wall_ms_per_step=wall_ms / steps,
               device_busy_ms_per_step=busy_ms / steps,
               kernels_per_step=len(kernels) / steps,
               busy_share=busy_ms / wall_ms if kernels else None,
               top_host_ops=[(e.key, e.count / steps,
                              e.self_cpu_time_total / 1e3 / steps)
                             for e in top],
               top_device_kernels=[(k, v / steps) for k, v in sorted(
                   by_kernel.items(), key=lambda kv: -kv[1])[:6]],
               device_ms_per_step_by_kernel={k: v / steps
                                             for k, v in by_kernel.items()})
    if not kernels:
        say(f"  {label} trace: the profiler recorded no device kernels "
            "(device busy share not measured)")
        return res
    say(f"  {label} trace ({steps} steps, profiler on): wall "
        f"{res['wall_ms_per_step']:.3f} ms/step, device busy "
        f"{res['device_busy_ms_per_step']:.3f} ms/step (share "
        f"{res['busy_share']:.3f}), {res['kernels_per_step']:.1f} "
        f"kernels/step")
    for key, n, ms in res["top_host_ops"]:
        say(f"    host {key}: {n:.1f} calls/step, {ms:.3f} ms/step self CPU")
    for key, ms in res["top_device_kernels"]:
        say(f"    device {key[:60]}: {ms:.3f} ms/step")
    return res


def trace_prefill(torch, eng, prompts, label: str, steps: int = 2):
    """trace_steps over generate_batch's prefill (a cache taken and given
    back each time), plus the flash prefill kernel's device ms and its
    share of the prefill's device time."""
    B = len(prompts)
    tokens, seq_lens, _ = eng._pad_batch(prompts)

    def prefill():
        cache = eng._take_cache(B)
        eng._run_prefill(tokens, seq_lens, cache)
        eng._put_cache(B, cache)
    res = trace_steps(torch, prefill, steps, label)
    busy = res["device_busy_ms_per_step"]
    flash = sum(v for k, v in res["device_ms_per_step_by_kernel"].items()
                if "flash_prefill" in k)
    res.update(flash_ms_per_step=flash,
               flash_share=flash / busy if busy else None)
    if busy:
        say(f"  {label}: flash prefill {flash:.3f} of {busy:.3f} device ms a "
            f"prefill (share {flash / busy:.3f})")
    return res


def trace_decode(torch, eng, prompts, steps: int = 8):
    """trace_steps over greedy decode steps of generate_batch's path."""
    B = len(prompts)
    tokens, seq_lens, _ = eng._pad_batch(prompts)
    cache = eng._take_cache(B)
    logits, cache = eng._run_prefill(tokens, seq_lens, cache)
    state = dict(tok=logits.argmax(-1).to(torch.int32), cache=cache)

    def step():
        lg, state["cache"] = eng._decode_step(state["tok"], state["cache"])
        state["tok"] = lg.argmax(-1).to(torch.int32)
    res = trace_steps(torch, step, steps, "decode")
    eng._put_cache(B, state["cache"])
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
                               prefill_trace=trace_prefill(torch, eng, prompts,
                                                           "prefill"),
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
    # both schedulers, so the D=32 paged kernel runs on a real path
    from turboinfer_tpu_torch.engine.scheduler import (
        ContinuousBatchingScheduler, PagedContinuousScheduler)
    icfg = InferenceConfig(max_seq_len=256, temperature=0.0, seed=0,
                           eos_token_id=-1)
    gen = torch.Generator().manual_seed(5)
    reqs = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
            for n in (5, 40, 17, 90, 33)]
    toks = {}
    for name, cls, kw in (("contiguous", ContinuousBatchingScheduler, {}),
                          ("paged", PagedContinuousScheduler,
                           dict(page_size=16))):
        sched = cls(params, cfg, icfg, batch_slots=2, device="cuda", **kw)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        rids = [sched.submit(r, 24) for r in reqs]
        res = sched.run()
        counts = kernels.launch_counts()
        need(all(res[i].finished and res[i].stop_reason == "length"
                 and len(res[i].tokens) == len(r) + 24
                 for i, r in zip(rids, reqs)),
             f"tiny {name} scheduler: requests did not finish as expected")
        path_kernel = "paged_attention" if name == "paged" else \
            "decode_attention"
        other = "decode_attention" if name == "paged" else "paged_attention"
        need(counts[path_kernel] > 0 and counts[other] == 0,
             f"tiny {name} scheduler: launch counts {counts}")
        toks[name] = [res[i].tokens for i in rids]
        say(f"  tiny {name} scheduler: 5 requests x 24 tokens, launches "
            f"{counts}")
        stats[f"{name}_scheduler_launches"] = counts
    agree = sum(a == b for a, b in zip(toks["contiguous"], toks["paged"]))
    say(f"  tiny schedulers: greedy trajectories equal in {agree}/5 requests "
        f"(contiguous decode kernel vs paged kernel, bf16)")
    stats["scheduler_greedy_agreement"] = agree
    report["tiny"] = stats


# -- phases 6 and 7 ---------------------------------------------------------

def first_layers(params, n: int):
    """The draft of phase 7: the first n layers of a stacked parameter
    tree, with its embedding, final norm and head."""
    import dataclasses
    from turboinfer_tpu_torch.core.qtensor import QTensor
    layers = {k: (dataclasses.replace(v, data=v.data[:n], scales=v.scales[:n])
                  if isinstance(v, QTensor) else v[:n])
              for k, v in params["layers"].items()}
    return {**params, "layers": layers}


def serving_model(torch, L: int, T: int):
    from turboinfer_tpu_torch.config import llama7b_config
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    cfg = llama7b_config(num_layers=L, max_seq_len=T)
    params = prepare_params(create_synthetic_quantized_model(
        cfg, bits=4, group_size=64, device="cuda", seed=0).params)
    return cfg, params


def pct(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def phase_serving(torch, report, kv: str = "model", model=None,
                  short: bool = False):
    """Phase 6 (kv "model"), or phase 10 (b) over an int8 or fp8 pool
    (kv_cache_dtype = kv) on the weights `model` = (cfg, params). short:
    half the new tokens per request (16..48), about half the decode
    steps; the admissions, and so the prefix hits, stay the same. Stores
    its results in report["paged_serving"] or report["paged_serving_" +
    kv] and returns the run's launch counts."""
    from turboinfer_tpu_torch import kernels
    from turboinfer_tpu_torch.config import InferenceConfig
    from turboinfer_tpu_torch.engine.scheduler import PagedContinuousScheduler
    L, T, B, PAGE = model[0].num_layers if model else 32, 1024, 8, 256
    say(f"{'phase 6' if kv == 'model' else '  (b)'}: paged serving, 7B "
        f"shape int4 g=64, L={L}, {B} slots, page {PAGE}, max_seq {T}, 24 "
        f"requests{' (half the new tokens)' if short else ''}, "
        f"kv_cache_dtype={kv}")
    torch.cuda.reset_peak_memory_stats()
    cfg, params = model or serving_model(torch, L, T)
    sched = PagedContinuousScheduler(
        params, cfg, InferenceConfig(max_seq_len=T, temperature=0.8, top_k=50,
                                     top_p=0.9, seed=0, eos_token_id=-1,
                                     kv_cache_dtype=kv),
        batch_slots=B, page_size=PAGE, device="cuda")
    del params
    gen = torch.Generator().manual_seed(6)

    def rand(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
    system = rand(2 * PAGE)                   # two full shared pages
    shared = [system + rand(n) for n in torch.linspace(
        32, 190, 12).long().tolist()]
    unique = [rand(n) for n in torch.linspace(64, 700, 12).long().tolist()]
    reqs = []                                 # interleaved, shared last
    for i in range(12):
        reqs += [unique[i], shared[i]]
    max_new = torch.linspace(16 if short else 32, 48 if short else 96,
                             24).long().tolist()
    # first logits row of each admission prefill, by request id
    first_logits = {}
    prefill = sched._paged_prefill

    def recording_prefill(req, m, *a):
        out = prefill(req, m, *a)
        first_logits[req.rid] = (m, out[2].float())
        return out
    sched._paged_prefill = recording_prefill
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [sched.submit(r, n, **({"temperature": 0.0} if i % 2 else {}))
            for i, (r, n) in enumerate(zip(reqs, max_new))]
    kernels.reset_launch_counts()
    prev = kernels.launch_counts()
    decode_ms, steps = [], 0
    per_fwd = 4 * L + 1
    while sched.pending:
        q0 = len(sched._queue)
        ts = time.perf_counter()
        sched.step()
        dt = (time.perf_counter() - ts) * 1e3
        adm = q0 - len(sched._queue)
        now = kernels.launch_counts()
        d = {k: now[k] - prev[k] for k in now}
        prev = now
        want = want_counts(
            qmm_int4=per_fwd * (adm + 1), flash_prefill=L * adm,
            kv_encode_write=L * (adm + 1) if kv != "model" else 0,
            paged_attention=L)
        need(d == want, f"step {steps} ({adm} admissions): launches {d} != "
                        f"{want}")
        if adm == 0:
            decode_ms.append(dt)
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    res = sched.run()
    need(len(res) == 24, f"{len(res)} of 24 requests completed")
    need(all(r.finished and r.stop_reason == "length" for r in res.values()),
         "a request ended with an unexpected stop reason")
    need(all(len(res[i].tokens) == len(r) + n
             for i, r, n in zip(rids, reqs, max_new)),
         "a request produced the wrong number of tokens")
    need(all(0 <= t < cfg.vocab_size for r in res.values() for t in r.tokens),
         "token out of range")
    need(sched.pool.hits > 0, "no prefix-cache hits")
    need(sched.pool.live_pages == 1
         and sched.pool.available == sched.pool.num_pages - 1,
         f"pages leaked: {sched.pool.live_pages} live, "
         f"{sched.pool.available} available of {sched.pool.num_pages}")
    new_tokens = sum(max_new)
    prefill_ms = [r.prefill_time_ms for r in res.values()]
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = dict(requests=24, steps=steps, wall_s=wall, requests_per_s=24 / wall,
               tokens_per_s=new_tokens / wall, new_tokens=new_tokens,
               prefill_ms_median=statistics.median(prefill_ms),
               prefill_ms_p90=pct(prefill_ms, 0.9),
               decode_ms_per_step_median=statistics.median(decode_ms),
               decode_steps_timed=len(decode_ms), peak_gib=peak,
               launches=counts, prefix_hits=sched.pool.hits,
               prefix_misses=sched.pool.misses)
    say(f"  24 requests in {wall:.3f} s over {steps} steps: "
        f"{out['requests_per_s']:.3f} req/s, {out['tokens_per_s']:.1f} tok/s "
        f"({new_tokens} new tokens); prefill_ms median "
        f"{out['prefill_ms_median']:.2f} p90 {out['prefill_ms_p90']:.2f}; "
        f"decode {out['decode_ms_per_step_median']:.3f} ms/step (median of "
        f"{len(decode_ms)} steps without admission); peak {peak:.2f} GiB")
    say(f"  launches {counts}, as expected at every step; prefix pool hits "
        f"{sched.pool.hits} misses {sched.pool.misses}; all pages but the "
        f"trash page free or evictable")
    # the first shared-prefix request (a cold admission), again: its
    # prefix pages are cached now, and its greedy tokens must not change
    j = 1
    rid = sched.submit(reqs[j], max_new[j], temperature=0.0)
    again = sched.run()[rid]
    need(again.tokens == res[rids[j]].tokens,
         "resubmitted shared-prefix request: greedy tokens differ")
    (m0, lg0), (m1, lg1) = first_logits[rids[j]], first_logits[rid]
    dlogit = (lg0 - lg1).abs().max().item()
    out.update(rerun_shared_pages=(m0, m1), rerun_first_logit_max_abs_diff=dlogit)
    say(f"  shared-prefix request again ({m0} then {m1} shared pages): same "
        f"{len(again.tokens) - len(reqs[j])} greedy tokens, first-token "
        f"max|dlogit|={dlogit:.4g}")
    c = sched.cache
    out["pool_bytes"] = sum(t.numel() * t.element_size() for t in (
        c.k_pages, c.v_pages, c.k_scale_pages, c.v_scale_pages)
        if t is not None)
    # where a serving step's time goes: 8 greedy requests in flight
    for r in unique[:B]:
        sched.submit(r, 64, temperature=0.0)
    sched.step()                           # admissions and the first step
    tr = out["decode_trace"] = trace_steps(torch, sched.step, 8,
                                           f"paged decode ({kv} pool)")
    tr["paged_ms_per_step"] = sum(
        v for k, v in tr["device_ms_per_step_by_kernel"].items()
        if "paged" in k)
    if tr["busy_share"] is not None:
        say(f"  paged attention {tr['paged_ms_per_step']:.3f} of "
            f"{tr['device_busy_ms_per_step']:.3f} device ms/step, "
            f"{tr['kernels_per_step']:.1f} kernels/step")
    sched.run()
    if kv == "model":
        report["paged_serving"] = out
    else:
        # the same requests in the same order: the same admissions, so
        # the prefix pool hits what phase 6's did
        ref = report.get("paged_serving", {}).get("prefix_hits")
        need(ref is None or out["prefix_hits"] == ref,
             f"{kv} pool: prefix hits {out['prefix_hits']} != phase 6's {ref}")
        say(f"  {kv} pool {out['pool_bytes'] / 2**30:.3f} GiB; prefix hits "
            f"{out['prefix_hits']} (phase 6: {ref})")
        report[f"paged_serving_{kv}"] = out
    # the recording wrapper closes over sched (a reference cycle that
    # would keep the weights and the pool alive until a gc pass)
    del sched._paged_prefill, sched, c
    torch.cuda.empty_cache()
    return counts


def phase_speculative(torch, report, kv: str = "model", model=None,
                      tag: str = "", chain: bool = True):
    """Phase 7 (kv "model"), or phase 10 (c) over int8 pages (and an int8
    draft cache) on the weights `model` = (cfg, params), or phase 12 (c)
    (tag "w4a8", env TURBOINFER_QMM_A8=1, int4 g=256 weights). chain:
    also hold the verify's logits against chained decode steps (not under
    W4A8, where the verify at M = B*G takes int8 activations and a
    decode step at M = B does not). Returns the run's measurements."""
    from turboinfer_tpu_torch import kernels
    from turboinfer_tpu_torch.config import InferenceConfig
    from turboinfer_tpu_torch.engine import paged_cache
    from turboinfer_tpu_torch.engine.scheduler import PagedContinuousScheduler
    from turboinfer_tpu_torch.models import llama
    # The draft is the first 2 layers: on these synthetic weights the
    # target's layers 5-32 flip no greedy token, so a 4-layer draft would
    # match it on every proposal, and the check below needs the verify to
    # reject some.
    L, T, B, PAGE, K, DL = (model[0].num_layers if model else 32, 1024, 8,
                            256, 4, 2)
    say(f"{'phase 7' if kv == 'model' and not tag else '  (c)'}: paged "
        f"speculative serving, 7B shape int4, L={L}, draft = first {DL} "
        f"layers, spec_k={K}, 8 greedy requests x 48 tokens, "
        f"kv_cache_dtype={kv}{' ' + tag if tag else ''}")
    cfg, params = model or serving_model(torch, L, T)
    dcfg = cfg.replace(num_layers=DL)
    sched = PagedContinuousScheduler(
        params, cfg, InferenceConfig(max_seq_len=T, temperature=0.0, seed=0,
                                     eos_token_id=-1, kv_cache_dtype=kv),
        batch_slots=B, page_size=PAGE, draft_params=first_layers(params, DL),
        draft_config=dcfg, spec_k=K, device="cuda")
    gen = torch.Generator().manual_seed(7)
    reqs = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
            for n in torch.linspace(40, 600, B).long().tolist()]
    rids = [sched.submit(r, 48) for r in reqs]
    sched.step()                       # admissions, then the first round
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    rounds, t0 = 0, time.perf_counter()
    while sched.pending:
        sched.step()
        rounds += 1
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    res = sched.run()
    need(all(len(res[i].tokens) == len(r) + 48 for i, r in zip(rids, reqs)),
         "speculative run: wrong number of tokens")
    acc, prop = sched.spec_accepted, sched.spec_proposed
    need(0 < acc < prop, f"acceptance {acc}/{prop} not strictly between 0 "
                         f"and the proposals")
    need(counts["paged_attention"] > 0 and counts["decode_attention"] > 0
         and (counts["kv_encode_write"] > 0) == (kv != "model"),
         f"speculative run: launches {counts}")
    out = dict(accepted=acc, proposed=prop, acceptance=acc / prop,
               rounds_timed=rounds, ms_per_round=wall * 1e3 / rounds,
               launches=counts)
    say(f"  acceptance {acc}/{prop} = {acc / prop:.3f}; "
        f"{wall * 1e3 / rounds:.3f} ms per round over {rounds} rounds; "
        f"launches {counts}")
    key = "paged_speculative" + ("" if kv == "model" else f"_{kv}") + (
        f"_{tag}" if tag else "")
    if not chain:
        report[key] = out
        del sched
        torch.cuda.empty_cache()
        return out
    # verify logits against 5 chained decode steps on the same pages; the
    # prefix K/V is random, encoded straight into the pages (an int8 pool
    # with its scale pages)
    g = torch.Generator(device="cuda").manual_seed(7)
    cache = paged_cache.init_paged_cache(cfg, B, num_pages=1 + B * 4,
                                         page_size=PAGE, max_seq=T,
                                         dtype=sched._kv_dtype, device="cuda")
    pools = [cache.k_pages, cache.v_pages]
    scales = [cache.k_scale_pages, cache.v_scale_pages]
    for i in range(2):
        x = torch.randn(pools[i].shape, generator=g, device="cuda").to(
            torch.bfloat16)
        code, sc = compress(torch, x, None if kv == "model" else kv)
        pools[i].copy_(code)
        if sc is not None:
            scales[i].copy_(sc)
    table = torch.randperm(B * 4, generator=gen).add(1).to(
        torch.int32).reshape(B, 4).cuda()
    lengths = torch.tensor([5, 11, 300, 3, 256, 60, 17, 511],
                           dtype=torch.int32)
    kp, vp = pools
    kp0, vp0 = kp.clone(), vp.clone()
    sc0 = {} if scales[0] is None else dict(
        k_scale_pages=scales[0].clone(), v_scale_pages=scales[1].clone())
    sc1 = {} if scales[0] is None else dict(k_scale_pages=scales[0],
                                            v_scale_pages=scales[1])
    chunk = torch.randint(1, cfg.vocab_size, (B, K + 1), generator=gen).cuda()
    lens = lengths.cuda()
    want = torch.stack([llama.forward_paged_decode(
        sched.params, cfg, chunk[:, g], kp, vp, table, lens + g, **sc1)[0]
        for g in range(K + 1)], dim=1)
    got = llama.forward_paged_verify(sched.params, cfg, chunk, kp0, vp0,
                                     table, lens, **sc0)[0]
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ref = want.abs().max().item()
    tol = 5e-2 * ref
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    need(bool(torch.isfinite(got).all()) and err <= tol,
         f"verify vs decode chain: max_abs_err {err} > {tol}")
    out.update(verify_max_abs_err=err, verify_tol=tol, max_abs_logit=ref,
               verify_greedy_agreement=agree)
    say(f"  verify vs 5 chained decode steps: logits max_abs_err={err:.4g} "
        f"(tol {tol:.3g}, max|logit|={ref:.3g}), greedy agreement "
        f"{agree:.3f}")
    report[key] = out
    del sched, kp, vp, kp0, vp0, pools, scales, sc0, sc1, cache
    torch.cuda.empty_cache()
    return out


# -- phase 8 ---------------------------------------------------------------

def moe_expected(L: int, E: int, U: int, prefills: int, decodes: int,
                 grouped: bool, bits: int = 4):
    """Launches of `prefills` prefill and `decodes` decode forwards of the
    MoE model with int`bits` weights: qmm 2L+1 per forward (wqkv, wo,
    head) plus U*E*L for the E-loop (every prefill; decode at B > 1), the
    grouped kernel U*L per decode at B=1 (U = 2 expert products with
    we_gateup fused, else 3)."""
    loop = U * E * L
    return want_counts(**{
        f"qmm_int{bits}": (2 * L + 1) * (prefills + decodes)
        + loop * prefills + (0 if grouped else loop * decodes),
        f"qmm_int{bits}_grouped": U * L * decodes if grouped else 0},
        flash_prefill=L * prefills, cache_write_fresh=L * prefills,
        decode_attention=L * decodes)


def path_logits(torch, eng, prompts):
    """Prefill and one greedy decode step of generate_batch's path: both
    logits finite and [B, V]."""
    B, V = len(prompts), eng.model_config.vocab_size
    tokens, seq_lens, _ = eng._pad_batch(prompts)
    cache = eng._take_cache(B)
    logits, cache = eng._run_prefill(tokens, seq_lens, cache)
    step, cache = eng._decode_step(logits.argmax(-1).to(torch.int32), cache)
    eng._put_cache(B, cache)
    torch.cuda.synchronize()
    need(tuple(logits.shape) == (B, V) and tuple(step.shape) == (B, V)
         and bool(torch.isfinite(logits).all())
         and bool(torch.isfinite(step).all()),
         f"B={B}: logits not finite or not [B, V]")
    say(f"  B={B} logits finite: prefill max|x|="
        f"{logits.abs().max().item():.3f}, decode step max|x|="
        f"{step.abs().max().item():.3f}")


def sync_free_step(torch, kernels, eng, prompt, want):
    """One B=1 decode step (the forward and the greedy pick) under
    torch.cuda.set_sync_debug_mode("error"): routing, the slots and the
    grouped launches must not make the host wait. Returns the wrappers'
    launches in that step, checked against `want`."""
    from turboinfer_tpu_torch.engine import sampling
    tokens, seq_lens, _ = eng._pad_batch([prompt])
    cache = eng._take_cache(1)
    logits, cache = eng._run_prefill(tokens, seq_lens, cache)
    tok = logits.argmax(-1).to(torch.int32)
    greedy = sampling.SamplingParams(temperature=0.0)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lg, cache = eng._decode_step(tok, cache)
        sampling.sample(eng._gen, lg, greedy)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = kernels.launch_counts()
    eng._put_cache(1, cache)
    need(counts == want, f"one B=1 decode step: launches {counts} != {want}")
    say(f"  one B=1 decode step under sync debug mode 'error': no host "
        f"sync; launches {counts}")
    return counts


def serve_paged(torch, kernels, params, cfg, step_want, label: str,
                n_req: int = 12, kv: str = "model"):
    """(c) of phases 8 and 9, (f) of phase 9 (kv "fp8"), (b) of phase 11:
    PagedContinuousScheduler, 8 slots, 256-token pages, max_seq 1024, a
    pool of kv_cache_dtype kv; n_req requests at once, half of them
    sharing a 512-token prefix, half greedy. step_want(adm): the launches
    of a step that admits adm requests, checked at every step."""
    from turboinfer_tpu_torch.config import InferenceConfig
    from turboinfer_tpu_torch.engine.scheduler import PagedContinuousScheduler
    T, B, PAGE = 1024, 8, 256
    sched = PagedContinuousScheduler(
        params, cfg, InferenceConfig(max_seq_len=T, temperature=0.8, top_k=50, top_p=0.9,
                        seed=0, eos_token_id=-1, kv_cache_dtype=kv),
        batch_slots=B, page_size=PAGE, device="cuda")
    gen = torch.Generator().manual_seed(8)

    def rand(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
    system = rand(2 * PAGE)
    h = n_req // 2
    shared = [system + rand(n) for n in torch.linspace(16, 188, h).long().tolist()]
    unique = [rand(n) for n in torch.linspace(64, 700, h).long().tolist()]
    reqs = [r for pair in zip(unique, shared) for r in pair]
    max_new = torch.linspace(32, 64, 2 * h).long().tolist()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [sched.submit(r, n, **({"temperature": 0.0} if i % 2 else {}))
            for i, (r, n) in enumerate(zip(reqs, max_new))]
    kernels.reset_launch_counts()
    prev = kernels.launch_counts()
    decode_ms, steps = [], 0
    while sched.pending:
        q0 = len(sched._queue)
        ts = time.perf_counter()
        sched.step()
        dt = (time.perf_counter() - ts) * 1e3
        adm = q0 - len(sched._queue)
        now = kernels.launch_counts()
        d = {k: now[k] - prev[k] for k in now}
        prev = now
        want = step_want(adm)
        need(d == want, f"paged {label} step {steps} ({adm} admissions): "
                        f"launches {d} != {want}")
        if adm == 0:
            decode_ms.append(dt)
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    res = sched.run()
    need(len(res) == 2 * h and all(
        res[i].finished and res[i].stop_reason in ("length", "eos", "max_seq")
        and len(res[i].tokens) == len(r) + n
        and all(0 <= t < cfg.vocab_size for t in res[i].tokens)
        for i, r, n in zip(rids, reqs, max_new)),
        f"paged {label}: a request did not end as expected")
    need(sched.pool.hits > 0, f"paged {label}: no prefix-cache hits")
    need(sched.pool.live_pages == 1
         and sched.pool.available == sched.pool.num_pages - 1,
         f"paged {label}: pages leaked: {sched.pool.live_pages} live, "
         f"{sched.pool.available} available of {sched.pool.num_pages}")
    new_tokens = sum(max_new)
    prefill_ms = [r.prefill_time_ms for r in res.values()]
    out = dict(requests=2 * h, steps=steps, wall_s=wall,
               requests_per_s=2 * h / wall, tokens_per_s=new_tokens / wall,
               new_tokens=new_tokens,
               prefill_ms_median=statistics.median(prefill_ms),
               prefill_ms_p90=pct(prefill_ms, 0.9),
               decode_ms_per_step_median=statistics.median(decode_ms),
               launches=counts, prefix_hits=sched.pool.hits,
               prefix_misses=sched.pool.misses)
    say(f"  paged: {2 * h} requests in {wall:.3f} s over {steps} steps: "
        f"{out['requests_per_s']:.3f} req/s, {out['tokens_per_s']:.1f} tok/s "
        f"({new_tokens} new tokens); prefill_ms median "
        f"{out['prefill_ms_median']:.2f} p90 {out['prefill_ms_p90']:.2f}; "
        f"decode {out['decode_ms_per_step_median']:.3f} ms/step (median of "
        f"{len(decode_ms)}); prefix hits {sched.pool.hits}; no page leaked; "
        f"launches {counts}, as expected at every step")
    del sched
    return out


def mixtral_paged(torch, kernels, params, cfg, U, report_out):
    """(c): paged serving; per step qmm 2L+1 plus the E-loop per forward,
    the paged kernel L, flash L per admission."""
    L, E = cfg.num_layers, cfg.num_experts
    per_fwd = 2 * L + 1 + U * E * L
    report_out["paged"] = serve_paged(
        torch, kernels, params, cfg, lambda adm: want_counts(
            qmm_int4=per_fwd * (adm + 1), flash_prefill=L * adm,
            paged_attention=L), "Mixtral")


# (d): the share of layer x token routings whose plain top-k may differ
# from the kernel path's while the plain forward takes the kernel path's
# experts
FLIP_SHARE = 0.10
# (d) of phase 11: a greedy token may differ from the plain one only in a
# tie row, where the plain logit of the kernel's token lies within
# TIE_ULPS bf16 ulps of max|logit| below the plain top (both sides'
# logits are bf16 values), and in at most MAX_TIE_ROWS rows of a model
TIE_ULPS = 1
MAX_TIE_ROWS = 1
VS_PLAIN_BATCHES = ((1, [61]), (2, [64, 37]))


class SharedRouting:
    """While active, mod.route of a CPU forward takes the experts that the
    preceding cuda forward chose (gates from the CPU's own router logits
    at those experts) and counts the tokens whose own top-k differs. With
    GPT-OSS's 4 of 32 experts (or Mixtral's 2 of 8 on weights quantized
    from bf16), a bf16 ulp in h can swap a routed expert: a discontinuity
    of the model, not an error of the kernels. mod is models.gptoss or
    models.moe: route(config, h, *rest), router_logits(h, *rest) and
    gates_at(config, logits, top_i); `name` is the routing function's
    name in mod."""

    def __init__(self, mod, name: str = "route"):
        self.mod, self.name, self.route = mod, name, getattr(mod, name)
        self.chosen, self.flips, self.tokens = [], 0, 0

    def __enter__(self):
        setattr(self.mod, self.name, self._route)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.route)

    def gates(self, config, h, want, *rest):
        """The CPU's own gates at the experts `want`."""
        return self.mod.gates_at(config, self.mod.router_logits(h, *rest),
                                 want)

    def _route(self, config, h, *rest):
        gates, top_i = self.route(config, h, *rest)
        if h.device.type == "cuda":
            self.chosen.append(top_i)
            return gates, top_i
        want = self.chosen.pop(0).to(h.device)
        same = want.sort(-1).values == top_i.sort(-1).values
        self.flips += int((~same).any(-1).sum())
        self.tokens += top_i.shape[0] * top_i.shape[1]
        return self.gates(config, h, want, *rest), want


def kernels_vs_plain(torch, mod, cfg, params, step_want, label: str,
                     seed: int, kv_dtype=None, all_agree: bool = False,
                     decided_agree: bool = False, batches=VS_PLAIN_BATCHES):
    """(d) of phases 8-11: the kernels against their plain versions on a
    model's path at L=2: prefill and first-decode logits at B=1 (61
    tokens) and B=2 (64 and 37) of batches, the plain side on the CPU,
    over a cache of kv_dtype (None: the model dtype). step_want(B):
    launches the cuda decode step must show (a subset of the counts).
    all_agree: every greedy token must agree too. decided_agree: every
    greedy token must agree but in at most MAX_TIE_ROWS tie rows (see
    TIE_ULPS), which are counted and reported."""
    from turboinfer_tpu_torch import kernels
    from turboinfer_tpu_torch.models.common import params_to
    L, T = cfg.num_layers, cfg.max_seq_len
    t0 = time.perf_counter()
    sides = [("cuda", params), ("cpu", params_to(params, "cpu"))]
    gen = torch.Generator().manual_seed(seed)
    out, ties = {}, 0
    for B, lens in batches:
        S = max(lens)
        tok = torch.zeros((B, S), dtype=torch.int32)
        for b, n in enumerate(lens):
            tok[b, :n] = torch.randint(1, cfg.vocab_size, (n,), generator=gen)
        seq = torch.tensor(lens, dtype=torch.int32)
        idx = seq - 1
        res = {}
        for dev, p in sides:
            cache = mod.init_cache(cfg, B, max_seq=T, dtype=kv_dtype,
                                   device=dev)
            lg, cache = mod.forward(p, cfg, tok.to(dev), cache,
                                    seq_lens=seq.to(dev),
                                    logit_idx=idx.to(dev), fresh_prefill=True)
            res[dev] = [lg[:, 0].float().cpu(), cache]
        nxt = res["cuda"][0].argmax(-1).to(torch.int32)[:, None]
        for dev, p in sides:
            if dev == "cuda":
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
            lg, _ = mod.forward(p, cfg, nxt.to(dev), res[dev][1])
            if dev == "cuda":
                step_counts = kernels.launch_counts()
            res[dev].append(lg[:, 0].float().cpu())
        want = step_want(B)
        need(all(step_counts[k] == v for k, v in want.items()),
             f"{label} L={L} B={B} decode: launches {step_counts}, want {want}")
        for i, name in ((0, "prefill"), (2, "decode_step")):
            out[f"B{B}_{name}"], ties = logits_agree(
                torch, res["cuda"][i], res["cpu"][i], f"{label} L={L} B={B} "
                f"{name}", ties, all_agree, decided_agree)
    out["seconds"] = time.perf_counter() - t0
    say(f"  (d) {label} L={L}: {out['seconds']:.1f} s, the CPU side included")
    return out


def logits_agree(torch, a, b_, what: str, ties: int, all_agree: bool,
                 decided_agree: bool, tag: str = "(d)"):
    """Kernel logits a against plain logits b_ [rows, V]: within 5% of
    max|logit|; all_agree: every greedy token equal; decided_agree:
    equal but in tie rows (see TIE_ULPS), at most MAX_TIE_ROWS counting
    the `ties` before. Returns (the measurements, the ties so far)."""
    err = (a - b_).abs().max().item()
    ref = b_.abs().max().item()
    tol = 5e-2 * ref
    need(bool(torch.isfinite(a).all()) and err <= tol,
         f"{what}: kernel vs plain max_abs_err {err} > {tol}")
    same = a.argmax(-1) == b_.argmax(-1)
    agree = same.float().mean().item()
    # the plain logit of the kernel's token, below the plain top
    gap = b_.max(-1).values - b_.gather(-1, a.argmax(-1, keepdim=True))[:, 0]
    tie_gap = TIE_ULPS * BF16_ULP * 2.0 ** math.floor(math.log2(ref))
    tie = ~same & (gap <= tie_gap)
    ties += int(tie.sum())
    need(not all_agree or agree == 1.0,
         f"{what}: greedy agreement {agree} < 1")
    need(not decided_agree or bool((same | tie).all()),
         f"{what}: greedy tokens differ beyond a tie of {tie_gap} "
         f"(plain-logit gaps {gap.tolist()})")
    need(not decided_agree or ties <= MAX_TIE_ROWS,
         f"{what}: {ties} tie rows > {MAX_TIE_ROWS}")
    say(f"  {tag} {what}: logits max_abs_err={err:.4g} (tol {tol:.3g}, "
        f"max|logit|={ref:.3g}) greedy agreement {agree:.3f}"
        + (f" ({int(tie.sum())} tie rows within {tie_gap}, plain-logit gaps "
           f"{[round(g, 4) for g in gap[tie].tolist()]})"
           if bool(tie.any()) else ""))
    return dict(max_abs_err=err, tol=tol, max_abs_logit=ref,
                greedy_agreement=agree, tie_rows=int(tie.sum()),
                tie_gaps=gap[tie].tolist(), tie_gap=tie_gap), ties


def mixtral_vs_plain(torch, report_out, kinds=("model",),
                     batches=VS_PLAIN_BATCHES):
    """(d) of phase 8 (kind "model") and of phase 10 ("int8", "fp8"
    caches, B=1 only): Mixtral's full width at one layer (the script's
    time limit: the CPU side's E-loop costs ~12-15 s a layer and
    forward); decode at B=1 through the grouped kernel, at B=2 through
    the E-loop. Results land in report_out["vs_plain"] (model)
    or report_out["mixtral_vs_plain_" + kind]."""
    from turboinfer_tpu_torch.config import mixtral_config
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    from turboinfer_tpu_torch.models import moe
    cfg = mixtral_config(num_layers=1, max_seq_len=256)
    L = cfg.num_layers
    params = prepare_params(create_synthetic_quantized_model(
        cfg, bits=4, group_size=64, device="cuda", seed=1).params)
    for kind in kinds:
        dt = {"int8": torch.int8, "fp8": torch.uint8}.get(kind)
        cw = {} if dt is None else {"decode_attention": L,
                                    "kv_encode_write": L,
                                    "cache_write_fresh": 0}
        key = "vs_plain" if dt is None else f"mixtral_vs_plain_{kind}"
        report_out[key] = kernels_vs_plain(
            torch, moe, cfg, params,
            lambda B: {"qmm_int4_grouped": 2 * L if B == 1 else 0, **cw},
            "Mixtral" if dt is None else f"Mixtral {kind}", 9, kv_dtype=dt,
            batches=batches)
    del params
    torch.cuda.empty_cache()


def phase_mixtral(torch, report):
    from turboinfer_tpu_torch import kernels
    from turboinfer_tpu_torch.config import InferenceConfig, mixtral_config
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    # every width; 2 of the 32 layers, so phases 1-20 fit the time limit
    cfg = mixtral_config(num_layers=2, max_seq_len=2048)
    L, E, T = cfg.num_layers, cfg.num_experts, cfg.max_seq_len
    say(f"phase 8: Mixtral-8x7B int4 g=64, L={L} (of 32), bf16, synthetic on "
        "the device")
    gc.collect()                    # nothing of the 7B phases may stay
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    params = prepare_params(create_synthetic_quantized_model(
        cfg, bits=4, group_size=64, device="cuda", seed=0).params)
    U = 2 if "we_gateup" in params["layers"] else 3
    eng = InferenceEngine(params, cfg, InferenceConfig(
        max_seq_len=T, temperature=0.0, seed=0, eos_token_id=-1,
        measure_ttft=True), device="cuda")
    torch.cuda.synchronize()
    say(f"  model built in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"({base_gib:.2f} before the build), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB while fusing; "
        f"{U} expert products per expert (we_gateup fused: {U == 2})")
    torch.cuda.reset_peak_memory_stats()
    out = dict(config=f"mixtral-8x7b int4 g=64 L={L} E={E} top-2", U=U)
    gen = torch.Generator().manual_seed(10)
    # (a) B=1: prompt 1000, 128 new tokens
    prompt = torch.randint(1, cfg.vocab_size, (1000,), generator=gen).tolist()
    path_logits(torch, eng, [prompt])
    res, counts, stats = run_counted(torch, kernels, eng, [prompt], 128,
                                     "(a) B=1 greedy")
    want = moe_expected(L, E, U, 1, 127, grouped=True)
    need(counts == want, f"(a) launch counts {counts} != {want}")
    need(len(res[0].tokens) == 1128, "(a) wrong number of tokens")
    stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    stats["step_launches"] = sync_free_step(
        torch, kernels, eng, prompt, moe_expected(L, E, U, 0, 1, True))
    stats["decode_trace"] = trace_decode(torch, eng, [prompt])
    say(f"  (a) launches as expected: {want}; peak {stats['peak_gib']:.2f} "
        f"GiB")
    out["b1"] = stats
    # (b) B=8: prompts 512, 64 new tokens
    prompts = torch.randint(1, cfg.vocab_size, (8, 512), generator=gen).tolist()
    path_logits(torch, eng, prompts)
    res, counts, stats = run_counted(torch, kernels, eng, prompts, 64,
                                     "(b) B=8 greedy")
    want = moe_expected(L, E, U, 1, 63, grouped=False)
    need(counts == want, f"(b) launch counts {counts} != {want}")
    need(all(len(r.tokens) == 512 + 64 for r in res),
         "(b) wrong number of tokens")
    stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    stats["decode_trace"] = trace_decode(torch, eng, prompts)
    say(f"  (b) launches as expected: {want}; peak {stats['peak_gib']:.2f} "
        f"GiB")
    out["b8"] = stats
    del eng
    torch.cuda.empty_cache()
    # (c) paged serving on the same weights
    mixtral_paged(torch, kernels, params, cfg, U, out)
    del params
    torch.cuda.empty_cache()
    # (d) kernels against plain versions on the path, L=1
    mixtral_vs_plain(torch, out)
    report["mixtral"] = out
    return out["b1"]["launches"]


# -- phase 9 ---------------------------------------------------------------

def gptoss_expected(L: int, prefills: int, decodes: int, fresh: int,
                    compressed: bool = False):
    """Launches of GPT-OSS forwards: qmm 2L+1 per forward (wqkv, wo, head;
    the experts and the router are bf16 torch matmuls, as the JAX package
    leaves them to XLA), the decode kernel L per decode forward, the
    cache-write kernel L per fresh prefill (the engine's; an admission
    prefill of the paged scheduler writes with indexing), or with an int8
    or fp8 cache (compressed) the encode-and-write kernel L per forward
    instead. Prefill attention is the plain streaming form (jnp in the
    JAX package) and paged decode the plain paged form (jnp there too):
    no flash, no paged kernel."""
    return want_counts(qmm_int4=(2 * L + 1) * (prefills + decodes),
                       cache_write_fresh=0 if compressed else L * fresh,
                       kv_encode_write=(L * (prefills + decodes)
                                        if compressed else 0),
                       decode_attention=L * decodes)


def cache_bytes(cache) -> int:
    """Bytes of a KVCache: K, V and an int8 cache's scale planes."""
    return sum(t.numel() * t.element_size() for t in
               (cache.k, cache.v, cache.k_scale, cache.v_scale)
               if t is not None)


def gptoss_compressed(torch, kernels, params, cfg, kind: str, gen):
    """(e) of phase 9: GPT-OSS-20B over an int8 or fp8 contiguous cache on
    the phase's weights: B=1 (prompt 1000, 64 new; one step sync-free,
    traced) and B=8 (prompts 512, 32 new, traced); launch counts with the
    encode-and-write kernel; the cache's bytes beside the model-dtype
    cache's."""
    from turboinfer_tpu_torch.config import InferenceConfig
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    L, T = cfg.num_layers, cfg.max_seq_len
    eng = InferenceEngine(params, cfg, InferenceConfig(
        max_seq_len=T, temperature=0.0, seed=0, eos_token_id=-1,
        measure_ttft=True, kv_cache_dtype=kind), device="cuda")
    out = {}
    for B, S, new in ((1, 1000, 64), (8, 512, 32)):
        prompts = torch.randint(1, cfg.vocab_size, (B, S),
                                generator=gen).tolist()
        path_logits(torch, eng, prompts)
        res, counts, stats = run_counted(torch, kernels, eng, prompts, new,
                                         f"(e) {kind} B={B} greedy")
        want = gptoss_expected(L, 1, new - 1, 0, compressed=True)
        need(counts == want, f"(e) {kind} B={B}: launch counts {counts} != "
                             f"{want}")
        need(all(len(r.tokens) == S + new for r in res),
             f"(e) {kind} B={B}: wrong number of tokens")
        cache = eng._take_cache(B)
        need(cache.k.dtype == {"int8": torch.int8, "fp8": torch.uint8}[kind],
             f"(e) {kind}: cache dtype {cache.k.dtype}")
        stats["cache_bytes"] = cache_bytes(cache)
        # the bf16 model-dtype cache of the same shape
        stats["model_cache_bytes"] = 2 * cache.k.numel() * 2
        eng._put_cache(B, cache)
        if B == 1:
            stats["step_launches"] = sync_free_step(
                torch, kernels, eng, prompts[0],
                gptoss_expected(L, 0, 1, 0, compressed=True))
        stats["decode_trace"] = trace_decode(torch, eng, prompts)
        say(f"  (e) {kind} B={B}: launches as expected {want}; cache "
            f"{stats['cache_bytes'] / 2**30:.3f} GiB (model dtype "
            f"{stats['model_cache_bytes'] / 2**30:.3f} GiB)")
        out[f"b{B}"] = stats
    del eng
    torch.cuda.empty_cache()
    return out


def phase_gptoss(torch, report):
    from turboinfer_tpu_torch import kernels
    from turboinfer_tpu_torch.config import (InferenceConfig,
                                             QuantizationConfig, QuantType,
                                             gptoss20b_config)
    from turboinfer_tpu_torch.core.qtensor import QTensor
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    from turboinfer_tpu_torch.models import gptoss
    from turboinfer_tpu_torch.quant.quantizer import quantize_params
    # every width; 2 of the 24 layers (a sliding and a full one, so both
    # kinds stay), so phases 1-19 fit the time limit
    cfg = gptoss20b_config(num_layers=2, max_seq_len=2048)
    L, E, T = cfg.num_layers, cfg.num_experts, cfg.max_seq_len
    say(f"phase 9: GPT-OSS-20B, L={L} (of 24), E={E} "
        f"top-{cfg.experts_per_token}, "
        f"bf16 experts, int4 g=64 attention and head, synthetic on the "
        f"device")
    gc.collect()                    # nothing of the Mixtral phase may stay
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    qcfg = QuantizationConfig(type=QuantType.INT4, group_size=64)
    eng = InferenceEngine(quantize_params(gptoss.init_params(
        cfg, seed=0, device="cuda"), qcfg), cfg, InferenceConfig(
        max_seq_len=T, temperature=0.0, seed=0, eos_token_id=-1,
        measure_ttft=True), device="cuda")
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated() / 2**30
    lw = eng.params["layers"]
    need(not isinstance(lw["we_gate"], QTensor)
         and isinstance(lw["wqkv"], QTensor) and "b_qkv" in lw
         and "we_gateup" not in lw,
         "GPT-OSS params: experts must stay fp and unfused, b_qkv fused")
    say(f"  model built in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"({base_gib:.2f} before the build), build peak {build_peak:.2f} "
        f"GiB; experts bf16 and unfused (gate and up stay two stacks)")
    need(build_peak < 60.0, f"build peak {build_peak:.2f} GiB >= 60 GiB")
    torch.cuda.reset_peak_memory_stats()
    out = dict(config=f"gpt-oss-20b L={L} of 24 E={E} "
               f"top-{cfg.experts_per_token} "
               f"bf16 experts, int4 g=64 attention/head", base_gib=base_gib,
               build_peak_gib=build_peak,
               weights_gib=torch.cuda.memory_allocated() / 2**30 - base_gib)
    gen = torch.Generator().manual_seed(11)
    # (a) B=1: prompt 1000, 128 new tokens; kv_len passes the window
    prompt = torch.randint(1, cfg.vocab_size, (1000,), generator=gen).tolist()
    path_logits(torch, eng, [prompt])
    res, counts, stats = run_counted(torch, kernels, eng, [prompt], 128,
                                     "(a) B=1 greedy")
    want = gptoss_expected(L, 1, 127, 1)
    need(counts == want, f"(a) launch counts {counts} != {want}")
    need(len(res[0].tokens) == 1128, "(a) wrong number of tokens")
    stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    stats["step_launches"] = sync_free_step(
        torch, kernels, eng, prompt, gptoss_expected(L, 0, 1, 0))
    stats["decode_trace"] = trace_decode(torch, eng, [prompt])
    say(f"  (a) launches as expected: {want}; peak {stats['peak_gib']:.2f} "
        f"GiB")
    out["b1"] = stats
    # (b) B=8: prompts 512, 64 new tokens; B*k = E: the dense expert mix
    prompts = torch.randint(1, cfg.vocab_size, (8, 512), generator=gen).tolist()
    path_logits(torch, eng, prompts)
    res, counts, stats = run_counted(torch, kernels, eng, prompts, 64,
                                     "(b) B=8 greedy")
    want = gptoss_expected(L, 1, 63, 1)
    need(counts == want, f"(b) launch counts {counts} != {want}")
    need(all(len(r.tokens) == 512 + 64 for r in res),
         "(b) wrong number of tokens")
    stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    stats["decode_trace"] = trace_decode(torch, eng, prompts)
    say(f"  (b) launches as expected: {want}; peak {stats['peak_gib']:.2f} "
        f"GiB")
    out["b8"] = stats
    # (c) paged serving on the same weights
    per_fwd = 2 * L + 1
    out["paged"] = serve_paged(
        torch, kernels, eng.params, cfg, lambda adm: want_counts(
            qmm_int4=per_fwd * (adm + 1)), "GPT-OSS")
    # (e) int8 and fp8 contiguous caches on the same weights
    for kind in KV_KINDS:
        out[f"kv_{kind}"] = gptoss_compressed(torch, kernels, eng.params, cfg,
                                              kind, gen)
    # (f) paged serving over an fp8 pool (each forward writes its K/V
    # through the encode-and-write kernel); an int8 pool is refused, as
    # the JAX package refuses it
    out["paged_fp8"] = serve_paged(
        torch, kernels, eng.params, cfg, lambda adm: want_counts(
            qmm_int4=per_fwd * (adm + 1), kv_encode_write=L * (adm + 1)),
        "GPT-OSS fp8", kv="fp8")
    from turboinfer_tpu_torch.engine.scheduler import PagedContinuousScheduler
    try:
        PagedContinuousScheduler(eng.params, cfg, InferenceConfig(
            max_seq_len=1024, kv_cache_dtype="int8"), batch_slots=8,
            page_size=256, device="cuda")
        refused = False
    except NotImplementedError as e:
        refused = True
        say(f"  (f) an int8 pool is refused at construction: {e}")
    need(refused, "GPT-OSS paged serving took an int8 pool")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # (d) kernels against plain versions on the path, L=2
    cfg2 = gptoss20b_config(num_layers=2, max_seq_len=256)
    params = prepare_params(quantize_params(
        gptoss.init_params(cfg2, seed=1, device="cuda"), qcfg))

    def step_want(B):
        return {"decode_attention": cfg2.num_layers,
                "qmm_int4": 2 * cfg2.num_layers + 1}
    with SharedRouting(gptoss) as shared:
        out["vs_plain"] = kernels_vs_plain(torch, gptoss, cfg2, params,
                                           step_want, "GPT-OSS", 12,
                                           batches=VS_PLAIN_BATCHES[:1])
    # bf16 rounding alone moves a few tokens to another expert (5 of the
    # 384 routings at this seed on an H100); a kernel error that
    # misroutes moves most of them
    bound = FLIP_SHARE * shared.tokens
    out["vs_plain"]["routing_flips"] = [shared.flips, shared.tokens]
    say(f"  (d) tokens whose plain top-4 differed from the kernel path's: "
        f"{shared.flips} of {shared.tokens} layer x token routings (bound "
        f"{bound:.1f})")
    need(shared.flips <= bound, f"GPT-OSS (d): {shared.flips} of "
         f"{shared.tokens} routings differ, beyond {bound:.1f}")
    # the same over int8 and fp8 caches, at B=1 only (the CPU side costs)
    for kind in KV_KINDS:
        dt = {"int8": torch.int8, "fp8": torch.uint8}[kind]
        vs_plain_routed(torch, gptoss, cfg2, params, lambda B: {
            "decode_attention": cfg2.num_layers,
            "kv_encode_write": cfg2.num_layers, "cache_write_fresh": 0,
            "qmm_int4": 2 * cfg2.num_layers + 1}, f"GPT-OSS {kind}", 12, out,
            kv_dtype=dt, batches=VS_PLAIN_BATCHES[:1])
    del params
    torch.cuda.empty_cache()
    report["gptoss"] = out
    return out["b1"]["launches"]


# -- phase 10 --------------------------------------------------------------

def paged_vs_plain(torch, cfg, params, kind, PAGE=64, T=256,
                   lens=(1, 70, 130, 250), decided_agree=False, mod=None):
    """(d): forward_paged_decode (G=1) and forward_paged_verify (G=5) over
    an int8 (with scale pages), fp8 or (kind None) model-dtype pool of
    random encoded K/V, rows at `lens`, kernels on the card against the
    plain versions on the CPU on a copy of the same pool: logits within
    5% of max|logit|, greedy agreement 1.0 (decided_agree: equal but in
    tie rows, see logits_agree). mod: the model module (default
    models/llama.py)."""
    from turboinfer_tpu_torch.engine import paged_cache
    from turboinfer_tpu_torch.models import llama
    mod = mod or llama
    from turboinfer_tpu_torch.models.common import params_to
    B, npg = len(lens), T // PAGE
    g = torch.Generator(device="cuda").manual_seed(13)
    gen = torch.Generator().manual_seed(13)
    dt = {"int8": torch.int8, "fp8": torch.uint8}.get(kind)
    cache = paged_cache.init_paged_cache(cfg, B, num_pages=1 + B * npg,
                                         page_size=PAGE, max_seq=T, dtype=dt,
                                         device="cuda")
    pools = [cache.k_pages, cache.v_pages]
    scales = [cache.k_scale_pages, cache.v_scale_pages]
    for i in range(2):
        code, sc = compress(torch, torch.randn(
            pools[i].shape, generator=g, device="cuda").to(torch.bfloat16),
            kind)
        pools[i].copy_(code)
        if sc is not None:
            scales[i].copy_(sc)
    table = torch.randperm(B * npg, generator=gen).add(1).to(
        torch.int32).reshape(B, npg)
    lens = torch.tensor(lens, dtype=torch.int32)
    cpu_params = params_to(params, "cpu")
    out, ties = {}, 0
    for G in (1, 5):
        toks = torch.randint(1, cfg.vocab_size, (B, G), generator=gen,
                             dtype=torch.int32)
        res = []
        for dev, p in (("cuda", params), ("cpu", cpu_params)):
            kp, vp = (t.to(dev).clone() for t in pools)
            sc = {} if scales[0] is None else dict(
                k_scale_pages=scales[0].to(dev).clone(),
                v_scale_pages=scales[1].to(dev).clone())
            lg = mod.forward_paged_verify(p, cfg, toks.to(dev), kp, vp,
                                          table.to(dev), lens.to(dev),
                                          **sc)[0]
            res.append(lg.float().cpu().reshape(B * G, -1))
        out[f"paged_G{G}"], ties = logits_agree(
            torch, *res, f"L={cfg.num_layers} paged {kind or 'model'} "
            f"G={G} kv_len={lens.tolist()}", ties, not decided_agree,
            decided_agree)
    return out


def phase_kvcache(torch, report):
    """Phase 10: int8 and fp8 KV caches on the 7B int4 model (L=8 of 32,
    full width: the depth cut so phase 17 fits the time limit; the
    kernels' shapes do not depend on it): (a) generate_batch at B=8,
    prompts of 960, 128 new tokens, max_seq 2048, with "model", "int8"
    and "fp8" caches; (b) paged
    serving as phase 6 over an int8, then an fp8 pool; (c) speculative
    serving as phase 7 over int8 pages; (d) at L=2, kernels against plain
    versions for int8 and fp8, contiguous and paged, and Mixtral's
    contiguous path over the same caches at B=1 and L=1."""
    from turboinfer_tpu_torch import kernels
    from turboinfer_tpu_torch.config import InferenceConfig, llama7b_config
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    from turboinfer_tpu_torch.models import llama
    L, B, S, NEW, T = 8, 8, 960, 128, 2048
    say(f"phase 10: int8 and fp8 KV caches, 7B shape int4 g=64, L={L} "
        "(of 32)")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = llama7b_config(num_layers=L, max_seq_len=T)
    params = prepare_params(create_synthetic_quantized_model(
        cfg, bits=4, group_size=64, device="cuda", seed=0).params)
    gen = torch.Generator().manual_seed(10)
    prompts = torch.randint(1, cfg.vocab_size, (B, S), generator=gen).tolist()
    out = {}
    for kv in ("model",) + KV_KINDS:
        say(f"  (a) generate_batch B={B}, prompts {S}, {NEW} new, max_seq "
            f"{T}, kv_cache_dtype={kv}")
        eng = InferenceEngine(params, cfg, InferenceConfig(
            max_seq_len=T, temperature=0.0, seed=0, eos_token_id=-1,
            measure_ttft=True, kv_cache_dtype=kv), device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        path_logits(torch, eng, prompts)
        res, counts, stats = run_counted(torch, kernels, eng, prompts, NEW,
                                         f"(a) {kv}")
        want = expected_launches(L, NEW - 1, compressed=kv != "model")
        need(counts == want, f"(a) {kv}: launch counts {counts} != {want}")
        need(all(len(r.tokens) == S + NEW for r in res),
             f"(a) {kv}: wrong number of tokens")
        cache = next(iter(eng._cache_pool.values()))
        need(cache.k.dtype == {"model": torch.bfloat16, "int8": torch.int8,
                               "fp8": torch.uint8}[kv],
             f"(a) {kv}: cache dtype {cache.k.dtype}")
        stats["cache_bytes"] = sum(t.numel() * t.element_size() for t in (
            cache.k, cache.v, cache.k_scale, cache.v_scale) if t is not None)
        stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        tr = trace_decode(torch, eng, prompts)
        by = tr.get("device_ms_per_step_by_kernel", {})
        tr["decode_attention_ms_per_step"] = sum(
            v for k, v in by.items() if "decode_split" in k
            or "decode_combine" in k)
        tr["kv_encode_write_ms_per_step"] = sum(
            v for k, v in by.items() if "kv_encode_write" in k)
        stats["decode_trace"] = tr
        # the prefill's device time and the encode-and-write share of it
        trp = trace_prefill(torch, eng, prompts, f"(a) {kv} prefill")
        trp["kv_encode_write_ms_per_step"] = sum(
            v for k, v in trp.get("device_ms_per_step_by_kernel", {}).items()
            if "kv_encode_write" in k)
        say(f"  (a) {kv} prefill: encode-write "
            f"{trp['kv_encode_write_ms_per_step']:.4f} of "
            f"{trp['device_busy_ms_per_step']:.3f} device ms a prefill")
        stats["prefill_trace"] = trp
        stats["greedy_tokens"] = [r.tokens[S:] for r in res]
        say(f"  (a) {kv}: cache {stats['cache_bytes'] / 2**30:.3f} GiB, peak "
            f"{stats['peak_gib']:.2f} GiB; trace: device "
            f"{tr['device_busy_ms_per_step']:.3f} ms/step, decode attention "
            f"{tr['decode_attention_ms_per_step']:.4f} ms/step, encode-write "
            f"{tr['kv_encode_write_ms_per_step']:.4f} ms/step; launches as "
            f"expected {want}")
        out[kv] = stats
        del eng, cache
        torch.cuda.empty_cache()
    agree = {kv: sum(a == b for a, b in zip(
        out[kv]["greedy_tokens"], out["model"]["greedy_tokens"])) for kv in
        KV_KINDS}
    say(f"  (a) greedy rows equal to the model-dtype cache's: {agree} of {B}")
    out["greedy_rows_equal_to_model_cache"] = agree
    # (b), (c) on the same weights at phase 6's max_seq
    serving = (cfg.replace(max_seq_len=1024), params)
    # the fp8 run is the short one: the script's time limit
    out["paged_launches"] = {kv: phase_serving(torch, report, kv, serving,
                                               short=kv == "fp8")
                             for kv in KV_KINDS}
    phase_speculative(torch, report, "int8", serving)
    del params, serving
    gc.collect()
    torch.cuda.empty_cache()
    # (d) L=2: kernels against plain versions, contiguous and paged
    cfg2 = llama7b_config(num_layers=2, max_seq_len=256)
    params2 = prepare_params(create_synthetic_quantized_model(
        cfg2, bits=4, group_size=64, device="cuda", seed=1).params)
    for kind in KV_KINDS:
        dt = {"int8": torch.int8, "fp8": torch.uint8}[kind]
        out[f"vs_plain_{kind}"] = kernels_vs_plain(
            torch, llama, cfg2, params2, lambda B: {
                "decode_attention": 2, "kv_encode_write": 2,
                "cache_write_fresh": 0}, f"7B {kind}", 14, kv_dtype=dt,
            all_agree=True, batches=VS_PLAIN_BATCHES[:1])
        out[f"vs_plain_{kind}"].update(paged_vs_plain(torch, cfg2, params2,
                                                      kind))
    del params2
    torch.cuda.empty_cache()
    # the MoE family over the same caches (llama's attention body, with
    # the B=1 grouped decode beside the compressed decode kernel)
    mixtral_vs_plain(torch, out, KV_KINDS, batches=VS_PLAIN_BATCHES[:1])
    report["kv_cache"] = out
    return out["int8"]["launches"]


# -- phase 11 --------------------------------------------------------------

def qtensor_bytes(params, expert_share: float = 1.0) -> int:
    """Bytes of the QTensors of a parameter tree (codes, scales, zero
    points; DeepSeek's "dense_layers" group too): what one decode step
    must read, with the expert stacks ("we_*") counted at expert_share
    (k of E experts at B=1)."""
    from turboinfer_tpu_torch.core.qtensor import QTensor
    total = 0
    for tree in (params["layers"], params.get("dense_layers", {}), params):
        for k, v in tree.items():
            if isinstance(v, QTensor):
                total += v.nbytes() * (expert_share if k.startswith("we_")
                                       else 1.0)
    return int(total)


def vs_plain_routed(torch, mod, cfg, params, step_want, label, seed, out,
                    **kw):
    """kernels_vs_plain under SharedRouting, into out["vs_plain " +
    label]; fails past FLIP_SHARE of layer x token routings whose plain
    top-k differs from the kernel path's."""
    with SharedRouting(mod) as shared:
        res = out[f"vs_plain {label}"] = kernels_vs_plain(
            torch, mod, cfg, params, step_want, label, seed, **kw)
    bound = FLIP_SHARE * shared.tokens
    res["routing_flips"] = [shared.flips, shared.tokens]
    say(f"  (d) {label}: {shared.flips} of {shared.tokens} layer x token "
        f"routings differed (bound {bound:.1f})")
    need(shared.flips <= bound, f"{label} (d): {shared.flips} of "
         f"{shared.tokens} routings differ, beyond {bound:.1f}")


def phase_int8_weights(torch, report):
    """Phase 11: int8 and zero-point weights through the qmm kernels. (a)
    the 7B at the default QuantizationConfig() (int8, symmetric, g=64),
    L=2 of 32 (a depth cut, so phases 19-20 fit the time limit;
    the kernels' shapes do not depend on it), through generate_batch as
    phase 3 (B=8, prompts 512, 128 new, greedy and sampled; every product
    on qmm_int8, traced); (b) the same weights through
    PagedContinuousScheduler, 8 requests, 4 sharing a 512-token prefix;
    (c) Mixtral-8x7B int8 g=64 (gate and up experts drawn fused: the
    split stacks and their fused copy would not fit side by side), L=2
    of 32 (the same cut), B=1 prompt 1000, 64 new, decode through
    qmm_int8_grouped, one step sync-free, peak < 70 GiB; (d) bf16
    weights drawn on the card and quantized there, kernels against plain
    versions: at L=1 the 7B int8, int8 with zero points and int4 with
    zero points, at L=1 Mixtral int4 with zero points (B=1: the E-loop
    prefill, the grouped decode; phase 8 (d) holds the B=2 E-loop
    decode), at L=2 GPT-OSS-20B with int8 attention and head (K=2880,
    wo's 64-column tail; B=1, phase 9 (d) holds B=2; both B=1-only so
    phase 20 fits the time limit), all within 5% of max|logit| and with
    every greedy token equal but in at most MAX_TIE_ROWS tie rows (see
    kernels_vs_plain)."""
    from turboinfer_tpu_torch import kernels
    from turboinfer_tpu_torch.config import (InferenceConfig,
                                             QuantizationConfig, QuantType,
                                             gptoss20b_config, llama7b_config,
                                             mixtral_config)
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    from turboinfer_tpu_torch.models import gptoss, llama, moe
    from turboinfer_tpu_torch.quant.quantizer import quantize_params
    qdef = QuantizationConfig()
    need(qdef.type == QuantType.INT8 and qdef.symmetric
         and qdef.group_size == 64, f"default QuantizationConfig {qdef}")
    L, B, S, NEW, T = 2, 8, 512, 128, 1024
    say(f"phase 11: int8 and zero-point weights; (a) 7B shape at the default "
        f"QuantizationConfig() (int{qdef.bits} g={qdef.group_size}, "
        f"symmetric), L={L}, B={B}, prompt {S}, {NEW} new tokens")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = llama7b_config(num_layers=L, max_seq_len=T)
    data = create_synthetic_quantized_model(cfg, bits=qdef.bits,
                                            group_size=qdef.group_size,
                                            device="cuda", seed=0)
    eng = InferenceEngine(data.params, cfg, InferenceConfig(
        max_seq_len=T, temperature=0.8, top_k=50, top_p=0.9, seed=0,
        eos_token_id=-1, measure_ttft=True), device="cuda")
    del data
    wbytes = qtensor_bytes(eng.params)
    floor_ms = wbytes / HBM_BYTES_PER_S * 1e3
    say(f"  weights {wbytes / 1e9:.3f} GB of int8 codes and scales: a "
        f"decode step's byte floor {floor_ms:.3f} ms")
    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(1, cfg.vocab_size, (B, S), generator=gen).tolist()
    path_logits(torch, eng, prompts)
    want = expected_launches(L, decode_forwards=NEW - 1, qmm="qmm_int8")
    a = dict(config=f"llama7b int8 g=64 symmetric L={L} B={B} S={S} "
             f"new={NEW} max_seq={T}", weight_bytes=wbytes,
             step_floor_ms=floor_ms, expected_launches=want)
    for label, kw in (("greedy", dict(temperature=0.0)), ("sampled", {})):
        res, got, stats = run_counted(torch, kernels, eng, prompts, NEW,
                                      f"(a) {label}", **kw)
        need(got == want, f"(a) {label}: launch counts {got} != {want}")
        need(all(len(r.tokens) == S + NEW for r in res)
             and all(0 <= t < cfg.vocab_size for r in res for t in r.tokens),
             f"(a) {label}: wrong tokens")
        a[label] = stats
    a["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    a["decode_trace"] = trace_decode(torch, eng, prompts)
    say(f"  (a) every product on qmm_int8 ({want['qmm_int8']} launches a "
        f"run, qmm_int4 0); peak {a['peak_gib']:.2f} GiB")
    out = {"a": a}
    # (b) paged serving on the same weights
    say("  (b) paged serving, 8 requests, 4 sharing a 512-token prefix")
    per_fwd = 4 * L + 1
    out["paged"] = serve_paged(
        torch, kernels, eng.params, cfg, lambda adm: want_counts(
            qmm_int8=per_fwd * (adm + 1), flash_prefill=L * adm,
            paged_attention=L), "7B int8", n_req=8)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # (c) Mixtral-8x7B int8 at B=1
    mcfg = mixtral_config(num_layers=2, max_seq_len=2048)
    ML, E = mcfg.num_layers, mcfg.num_experts
    say(f"  (c) Mixtral-8x7B int8 g=64, L={ML}, B=1, prompt 1000, 64 new")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = prepare_params(create_synthetic_quantized_model(
        mcfg, bits=8, group_size=64, device="cuda", seed=0,
        fused_experts=True).params)
    need("we_gateup" in params["layers"], "(c) experts not fused")
    eng = InferenceEngine(params, mcfg, InferenceConfig(
        max_seq_len=2048, temperature=0.0, seed=0, eos_token_id=-1,
        measure_ttft=True), device="cuda")
    del params
    torch.cuda.synchronize()
    wall_b = qtensor_bytes(eng.params)
    step_b = qtensor_bytes(eng.params, mcfg.experts_per_token / E)
    c = dict(weight_bytes=wall_b, step_bytes=step_b,
             step_floor_ms=step_b / HBM_BYTES_PER_S * 1e3,
             build_s=time.perf_counter() - t0)
    say(f"  (c) built in {c['build_s']:.1f} s: weights {wall_b / 1e9:.2f} GB, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; a B=1 "
        f"step reads {step_b / 1e9:.2f} GB: floor {c['step_floor_ms']:.3f} ms")
    prompt = torch.randint(1, mcfg.vocab_size, (1000,), generator=gen).tolist()
    path_logits(torch, eng, [prompt])
    res, got, stats = run_counted(torch, kernels, eng, [prompt], 64,
                                  "(c) B=1 greedy")
    want = moe_expected(ML, E, 2, 1, 63, grouped=True, bits=8)
    need(got == want, f"(c) launch counts {got} != {want}")
    need(len(res[0].tokens) == 1064, "(c) wrong number of tokens")
    c.update(stats)
    c["step_launches"] = sync_free_step(
        torch, kernels, eng, prompt, moe_expected(ML, E, 2, 0, 1, True,
                                                  bits=8))
    c["decode_trace"] = trace_decode(torch, eng, [prompt])
    c["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    need(c["peak_gib"] < 70.0, f"(c) peak {c['peak_gib']:.2f} GiB >= 70")
    say(f"  (c) launches as expected {want}; peak {c['peak_gib']:.2f} GiB")
    out["mixtral"] = c
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # (d) kernels against plain versions on weights quantized on the card
    # from bf16 drawn from a seed: GPT-OSS at L=2 (both kinds of layer),
    # the 7B and Mixtral at L=1 (depth cuts: their CPU sides cost ~5 s and
    # ~20 s a layer)
    cfg2 = llama7b_config(num_layers=1, max_seq_len=256)
    fp = llama.init_params(cfg2, seed=2, device="cuda", dtype=torch.bfloat16)
    for label, qtype, sym in (("int8", QuantType.INT8, True),
                              ("int8 zp", QuantType.INT8, False),
                              ("int4 zp", QuantType.INT4, False)):
        params = prepare_params(quantize_params(fp, QuantizationConfig(
            type=qtype, group_size=64, symmetric=sym)))
        lw = params["layers"]
        need((lw["wqkv"].zero_points is None) == sym, f"(d) {label}: zero "
             "points lost")
        kname = f"qmm_int{lw['wqkv'].bits}"
        out[f"vs_plain 7B {label}"] = kernels_vs_plain(
            torch, llama, cfg2, params, lambda B: {kname: 4 * 1 + 1},
            f"7B {label}", 15, decided_agree=True,
            batches=VS_PLAIN_BATCHES[:1])
        del params
    del fp
    mcfg2 = mixtral_config(num_layers=1, max_seq_len=256)
    params = prepare_params(quantize_params(
        moe.init_params(mcfg2, seed=3, device="cuda", dtype=torch.bfloat16),
        QuantizationConfig(type=QuantType.INT4, group_size=64,
                           symmetric=False)))
    need(params["layers"]["we_gateup"].zero_points is not None,
         "(d) Mixtral: expert zero points lost")
    vs_plain_routed(torch, moe, mcfg2, params, lambda B: {
        "qmm_int4_grouped": 2 * 1 if B == 1 else 0,
        "qmm_int4": 2 * 1 + 1 + (0 if B == 1 else 2 * E * 1)},
        "Mixtral int4 zp", 16, out, decided_agree=True, batches=((1, [61]),))
    del params
    torch.cuda.empty_cache()
    gcfg = gptoss20b_config(num_layers=2, max_seq_len=256)
    params = prepare_params(quantize_params(
        gptoss.init_params(gcfg, seed=1, device="cuda"),
        QuantizationConfig(type=QuantType.INT8, group_size=64)))
    vs_plain_routed(torch, gptoss, gcfg, params, lambda B: {
        "decode_attention": 2, "qmm_int8": 2 * 2 + 1}, "GPT-OSS int8", 12,
        out, decided_agree=True, batches=((1, [61]),))
    del params
    torch.cuda.empty_cache()
    report["int8_weights"] = out
    return dict(a["greedy"]["launches"], qmm_int8_grouped=c["launches"][
        "qmm_int8_grouped"])


# -- phase 12 --------------------------------------------------------------

def phase_w4a8(torch, report):
    """Phase 12: W4A8 (TURBOINFER_QMM_A8=1) on the 7B shape with int4
    symmetric g=256 weights, L=32 (at L=16 the 2-layer draft of (c)
    accepts every proposal on these weights). (a) generate_batch, B=8
    prompts of 512,
    64 new tokens, greedy: 4 W4A8 products a layer in the prefill (wqkv,
    wo, w_gateup, w_down at M=4096), none in decode at M=8 and none for
    the last-position head (M=8), as the JAX package decides; the prefill
    and decode traced. (d) the same run with the env unset: no W4A8
    launch; (a) and (d) interleaved a, d, a, d in this process after one
    untimed prefill each, so their prefill times compare. (b) B=16
    prompts of 128, 32 new: every product of the prefill, the head and
    each decode step (M=16) on qmm_int4_a8.
    (c) paged speculative rounds as phase 7 (spec_k=4): the verify at
    M=40 on qmm_int4_a8, the draft's decode at M=8 not. (e) at L=1,
    kernels against plain versions (the plain side runs W4A8 too):
    logits within 5% of max|logit|, greedy tokens equal under phase 11's
    tie rule."""
    import os
    from turboinfer_tpu_torch import kernels
    from turboinfer_tpu_torch.config import InferenceConfig, llama7b_config
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    from turboinfer_tpu_torch.models import llama
    L, T, G, B, S, NEW = 32, 1024, 256, 8, 512, 64
    say(f"phase 12: W4A8 (TURBOINFER_QMM_A8=1), 7B shape int4 g={G} "
        f"symmetric, L={L}")
    prev = os.environ.get("TURBOINFER_QMM_A8")

    def a8(on: bool):
        if on:
            os.environ["TURBOINFER_QMM_A8"] = "1"
        else:
            os.environ.pop("TURBOINFER_QMM_A8", None)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = llama7b_config(num_layers=L, max_seq_len=T)
    params = prepare_params(create_synthetic_quantized_model(
        cfg, bits=4, group_size=G, device="cuda", seed=0).params)
    eng = InferenceEngine(params, cfg, InferenceConfig(
        max_seq_len=T, temperature=0.0, seed=0, eos_token_id=-1,
        measure_ttft=True), device="cuda")
    wbytes = qtensor_bytes(eng.params)
    out = dict(config=f"llama7b int4 g={G} symmetric L={L}",
               weight_bytes=wbytes)
    say(f"  weights {wbytes / 1e9:.3f} GB of int4 codes and scales")
    gen = torch.Generator().manual_seed(12)
    prompts = torch.randint(1, cfg.vocab_size, (B, S), generator=gen).tolist()
    per_fwd = 4 * L + 1
    want_a = want_counts(qmm_int4_a8=4 * L, a8_quantize_rows=4 * L,
                         qmm_int4=1 + per_fwd * (NEW - 1), flash_prefill=L,
                         cache_write_fresh=L, decode_attention=L * (NEW - 1))
    want_d = expected_launches(L, decode_forwards=NEW - 1)
    try:
        # (a) and (d), interleaved, after one untimed prefill each: the
        # first W4A8 prefill of the process took 175 ms more than the next
        # on the H100, a one-time cost a median of two runs cannot absorb
        tokens, seq_lens, _ = eng._pad_batch(prompts)
        for on in (True, False):
            a8(on)
            cache = eng._take_cache(B)
            eng._run_prefill(tokens, seq_lens, cache)
            eng._put_cache(B, cache)
        torch.cuda.synchronize()
        runs, toks = {"a": [], "d": []}, {}
        for rep in range(2):
            for key, on, want in (("a", True, want_a), ("d", False, want_d)):
                a8(on)
                res, got, stats = run_counted(
                    torch, kernels, eng, prompts, NEW,
                    f"({key}) B={B} W4A8 {'on' if on else 'off'}, rep {rep}",
                    temperature=0.0)
                need(got == want, f"({key}) launch counts {got} != {want}")
                need(all(len(r.tokens) == S + NEW for r in res),
                     f"({key}) wrong number of tokens")
                runs[key].append(stats)
                toks[key] = [r.tokens[S:] for r in res]
        pa = statistics.median(r["prefill_ms"] for r in runs["a"])
        pd = statistics.median(r["prefill_ms"] for r in runs["d"])
        same = sum(x == y for ra, rd in zip(toks["a"], toks["d"])
                   for x, y in zip(ra, rd)) / (B * NEW)
        a8(True)
        trace_a = trace_prefill(torch, eng, prompts, "(a) W4A8 prefill")
        dec_a = trace_decode(torch, eng, prompts)
        a8(False)
        trace_d = trace_prefill(torch, eng, prompts,
                                "(d) bf16-activation prefill")
        out["a"] = dict(runs=runs["a"], expected_launches=want_a,
                        prefill_ms_median=pa, prefill_trace=trace_a,
                        decode_trace=dec_a)
        out["d"] = dict(runs=runs["d"], expected_launches=want_d,
                        prefill_ms_median=pd, prefill_trace=trace_d)
        out["prefill_ms_ratio_a_over_d"] = pa / pd
        out["greedy_token_share_equal_a_d"] = same
        say(f"  (a) vs (d): prefill {pa:.2f} ms with W4A8, {pd:.2f} ms "
            f"without (median of 2 interleaved runs; ratio {pa / pd:.3f});"
            f" device busy per prefill {trace_a['device_busy_ms_per_step']:.2f}"
            f" vs {trace_d['device_busy_ms_per_step']:.2f} ms; greedy tokens "
            f"equal in {same:.3f} of positions (W4A8 changes the numbers)")
        # (b) B=16: decode at M=16 and the head take W4A8 too
        a8(True)
        B2, S2, NEW2 = 16, 128, 32
        p2 = torch.randint(1, cfg.vocab_size, (B2, S2), generator=gen).tolist()
        want_b = want_counts(qmm_int4_a8=per_fwd * NEW2,
                             a8_quantize_rows=per_fwd * NEW2,
                             flash_prefill=L, cache_write_fresh=L,
                             decode_attention=L * (NEW2 - 1))
        res, got, stats = run_counted(torch, kernels, eng, p2, NEW2,
                                      f"(b) B={B2} W4A8", temperature=0.0)
        need(got == want_b, f"(b) launch counts {got} != {want_b}")
        need(all(len(r.tokens) == S2 + NEW2 for r in res),
             "(b) wrong number of tokens")
        stats["decode_trace"] = trace_decode(torch, eng, p2)
        out["b"] = dict(stats, expected_launches=want_b)
        say(f"  (b) every product on qmm_int4_a8: {want_b['qmm_int4_a8']}"
            " launches, qmm_int4 0")
        del eng
        torch.cuda.empty_cache()
        # (c) paged speculative rounds: the verify on qmm_int4_a8
        spec = phase_speculative(torch, report, model=(cfg, params),
                                 tag="w4a8", chain=False)
        c = spec["launches"]
        need(c["qmm_int4_a8"] > 0 and c["qmm_int4_a8"] % per_fwd == 0
             and c["a8_quantize_rows"] == c["qmm_int4_a8"]
             and c["qmm_int4"] > 0, f"(c) launches {c}: the verify must "
             "run on qmm_int4_a8, the draft's decode on qmm_int4")
        out["c"] = spec
        del params
        gc.collect()
        torch.cuda.empty_cache()
        # (e) L=1 (a depth cut), kernels against plain versions, W4A8 on
        # both sides
        cfg2 = llama7b_config(num_layers=1, max_seq_len=256)
        p2l = prepare_params(create_synthetic_quantized_model(
            cfg2, bits=4, group_size=G, device="cuda", seed=1).params)
        out["vs_plain"] = kernels_vs_plain(
            torch, llama, cfg2, p2l, lambda B: {"qmm_int4": 4 * 1 + 1,
                                                "qmm_int4_a8": 0},
            "7B W4A8", 17, decided_agree=True, batches=VS_PLAIN_BATCHES[:1])
        del p2l
    finally:
        if prev is None:
            os.environ.pop("TURBOINFER_QMM_A8", None)
        else:
            os.environ["TURBOINFER_QMM_A8"] = prev
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    report["w4a8"] = out
    return runs["a"][0]["launches"]


# -- phase 13 --------------------------------------------------------------

def decode_step_launches(torch, kernels, eng, prompts, want):
    """The launches of one decode step of generate_batch's path after a
    prefill of `prompts`, checked against `want`."""
    B = len(prompts)
    tokens, seq_lens, _ = eng._pad_batch(prompts)
    cache = eng._take_cache(B)
    logits, cache = eng._run_prefill(tokens, seq_lens, cache)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    _, cache = eng._decode_step(logits.argmax(-1).to(torch.int32), cache)
    counts = kernels.launch_counts()
    eng._put_cache(B, cache)
    need(counts == want, f"one B={B} decode step: launches {counts} != {want}")
    say(f"  one B={B} decode step: launches {counts}, as expected")
    return counts


def gemma_batch(torch, kernels, params, cfg, kv: str, runs, report_out,
                trace: bool = True):
    """(a), (b) and (e) of phase 13, (a) and (b) of phase 14:
    generate_batch on one engine of
    kv_cache_dtype kv (max_seq 8192, greedy) for each (label, prompts,
    new tokens) of runs: logits finite, launch counts, tokens, peak
    memory, the cache's bytes; the first run also one decode step
    counted alone and (trace) traced (a prefill, 8 decode steps)."""
    from turboinfer_tpu_torch.config import InferenceConfig
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    L, T = cfg.num_layers, cfg.max_seq_len
    eng = InferenceEngine(params, cfg, InferenceConfig(
        max_seq_len=T, temperature=0.0, seed=0, eos_token_id=-1,
        measure_ttft=True, kv_cache_dtype=kv), device="cuda")
    compressed = kv != "model"
    for i, (label, prompts, new) in enumerate(runs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        B = len(prompts)
        say(f"  {label} generate_batch B={B}, prompts "
            f"{sorted({len(p) for p in prompts})}, {new} new, max_seq {T}, "
            f"kv_cache_dtype={kv}")
        path_logits(torch, eng, prompts)
        res, counts, stats = run_counted(torch, kernels, eng, prompts, new,
                                         f"{label} {kv} greedy")
        want = expected_launches(L, new - 1, compressed=compressed)
        need(counts == want, f"{label} {kv}: launch counts {counts} != "
                             f"{want}")
        need(all(len(r.tokens) == len(p) + new for r, p in zip(res, prompts))
             and all(0 <= t < cfg.vocab_size for r in res for t in r.tokens),
             f"{label} {kv}: wrong tokens")
        stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        cache = eng._take_cache(B)
        stats["cache_bytes"] = cache_bytes(cache)
        eng._put_cache(B, cache)
        if i == 0:
            stats["step_launches"] = decode_step_launches(
                torch, kernels, eng, prompts, expected_launches(
                    L, 1, prefills=0, compressed=compressed))
        if i == 0 and trace:
            stats["prefill_trace"] = trace_prefill(
                torch, eng, prompts, f"{label} {kv} prefill", steps=1)
            stats["decode_trace"] = trace_decode(torch, eng, prompts)
        say(f"  {label} {kv}: launches as expected {want}; cache "
            f"{stats['cache_bytes'] / 2**30:.3f} GiB; peak "
            f"{stats['peak_gib']:.2f} GiB")
        report_out[f"{label} {kv}"] = stats
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return report_out[f"{runs[0][0]} {kv}"]["launches"]


def gemma_paged(torch, kernels, params, cfg, gen, report_out,
                prefix_len: int = 4200, unique=(600, 1700, 3000, 5000)):
    """(c) of phases 13-15: PagedContinuousScheduler (8 slots,
    256-token pages, max_seq the config's) with speculative rounds (the
    first 2 layers as the draft, spec_k=4, greedy): 8 requests, 4 of
    `unique` lengths and 4 of a prefix_len-token prefix (past the
    window) and their own suffix, 32 new tokens each. All 8 admit in the
    first step, in submission order, so the first sharing request pools
    the prefix's full pages (16 of a 4200-token prefix, 8 of 2200, 4 of
    1100) and each later one
    hits them all: 3 x that many hits. No page may leak; the verify runs
    windowed (and, on Gemma-2, softcapped) on the paged kernel."""
    from turboinfer_tpu_torch.config import InferenceConfig
    from turboinfer_tpu_torch.engine.scheduler import PagedContinuousScheduler
    L, T, PAGE, DL, K, NEW = cfg.num_layers, cfg.max_seq_len, 256, 2, 4, 32
    say(f"  (c) paged serving, 8 slots, page {PAGE}, max_seq {T}, 8 requests "
        f"(4 sharing a {prefix_len}-token prefix), speculative rounds: draft "
        f"= first {DL} layers, spec_k={K}, {NEW} new tokens each")
    sched = PagedContinuousScheduler(
        params, cfg, InferenceConfig(max_seq_len=T, temperature=0.0, seed=0,
                                     eos_token_id=-1),
        batch_slots=8, page_size=PAGE, draft_params=first_layers(params, DL),
        draft_config=cfg.replace(num_layers=DL), spec_k=K, device="cuda")

    def rand(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
    prefix = rand(prefix_len)
    unique = [rand(n) for n in unique]
    shared = [prefix + rand(n) for n in (50, 300, 500, 800)]
    reqs = [r for pair in zip(unique, shared) for r in pair]
    want_hits = 3 * (len(prefix) // PAGE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [sched.submit(r, NEW) for r in reqs]
    kernels.reset_launch_counts()
    steps = 0
    while sched.pending:
        sched.step()
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    res = sched.run()
    need(all(len(res[i].tokens) == len(r) + NEW
             and all(0 <= t < cfg.vocab_size for t in res[i].tokens)
             for i, r in zip(rids, reqs)), "(c) wrong tokens")
    acc, prop = sched.spec_accepted, sched.spec_proposed
    need(prop > 0, "(c) no speculative round ran")
    need(counts["paged_attention"] > 0 and counts["flash_prefill"] > 0
         and counts["decode_attention"] > 0,
         f"(c) launches {counts}: a kernel of the path did not run")
    need(sched.pool.hits == want_hits, f"(c) prefix hits {sched.pool.hits} "
         f"!= {want_hits} (misses {sched.pool.misses})")
    need(sched.pool.live_pages == 1
         and sched.pool.available == sched.pool.num_pages - 1,
         f"(c) pages leaked: {sched.pool.live_pages} live, "
         f"{sched.pool.available} available of {sched.pool.num_pages}")
    prefill_ms = [r.prefill_time_ms for r in res.values()]
    out = dict(requests=8, steps=steps, wall_s=wall,
               tokens_per_s=8 * NEW / wall,
               prefill_ms_median=statistics.median(prefill_ms),
               prefill_ms_max=max(prefill_ms), accepted=acc, proposed=prop,
               acceptance=acc / prop, launches=counts,
               prefix_hits=sched.pool.hits, prefix_misses=sched.pool.misses,
               pool_pages=sched.pool.num_pages)
    say(f"  (c) 8 requests in {wall:.3f} s over {steps} steps, "
        f"{out['tokens_per_s']:.1f} tok/s; prefill_ms median "
        f"{out['prefill_ms_median']:.1f} max {out['prefill_ms_max']:.1f}; "
        f"acceptance {acc}/{prop}; prefix hits {sched.pool.hits} (the plan: "
        f"{want_hits}), misses {sched.pool.misses}; no page leaked; launches "
        f"{counts}")
    report_out["paged"] = out
    del sched
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_gemma2(torch, report):
    """Phase 13: Gemma-2-27B (google/gemma-2-27b's config.json, as
    config.gemma2_27b_config transcribes it: 46 layers, hidden 4608,
    32:16 heads of 128, FFN 36864 GeGLU, vocab 256000, 8192 positions,
    a 4096-key window on every even layer, softcaps 50 / 30, attn_scale
    144**-0.5, (1 + w) and sandwich norms, tied embeddings), int4 g=64,
    bf16, synthetic weights from a seed, 2 of its 46 layers (a depth
    cut, so phases 14-20 fit the time limit; every kernel shape and
    both kinds of layer stay: layer 0 windowed, layer 1 global; the
    2-layer draft of (c) is then the whole target, and (c) checks that
    rounds ran): (a) generate_batch B=2, prompts of 4500
    and 5000 (past the window), 64 new tokens, max_seq 8192, launch
    counts of the run and of one decode step, a traced prefill and 8
    traced decode steps; (b) B=8, prompts
    512, 128 new; (e) (a) over int8 and fp8 caches; (c) paged serving
    with speculative verify (gemma_paged); (d) at L=2 (layer 0 windowed,
    layer 1 global), kernels against plain versions: a 4160-token
    prompt, then paged decode and verify over pools filled past the
    window, within 5% of max|logit| and under phase 11's tie rule."""
    from turboinfer_tpu_torch import kernels
    from turboinfer_tpu_torch.config import gemma2_27b_config
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    from turboinfer_tpu_torch.models import llama
    cfg = gemma2_27b_config(num_layers=2)
    L, T = cfg.num_layers, cfg.max_seq_len
    say(f"phase 13: Gemma-2-27B int4 g=64, L={L} (of 46), hidden "
        f"{cfg.hidden_size}, Hq={cfg.num_heads} Hkv={cfg.kv_heads} "
        f"D={cfg.head_dim_}, FFN {cfg.ffn_dim}, V={cfg.vocab_size}, window "
        f"{cfg.sliding_window} on even layers, softcaps "
        f"{cfg.attn_logit_softcap}/{cfg.final_logit_softcap}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = prepare_params(create_synthetic_quantized_model(
        cfg, bits=4, group_size=64, device="cuda", seed=0).params)
    torch.cuda.synchronize()
    out = dict(config="gemma-2-27b int4 g=64 L=2 of 46 bf16 max_seq 8192",
               build_s=time.perf_counter() - t0,
               build_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               allocated_gib=torch.cuda.memory_allocated() / 2**30,
               weight_bytes=qtensor_bytes(params))
    say(f"  model built in {out['build_s']:.1f} s: int4 weights "
        f"{out['weight_bytes'] / 1e9:.2f} GB, {out['allocated_gib']:.2f} GiB "
        f"allocated, build peak {out['build_peak_gib']:.2f} GiB")
    gen = torch.Generator().manual_seed(13)

    def rand(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
    long = [rand(4500), rand(5000)]
    launches = gemma_batch(torch, kernels, params, cfg, "model", [
        ("(a)", long, 64), ("(b)", [rand(512) for _ in range(8)], 128)], out)
    for kv in KV_KINDS:
        gemma_batch(torch, kernels, params, cfg, kv, [("(e)", long, 64)], out)
    gemma_paged(torch, kernels, params, cfg, gen, out)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # (d) L=2: layer 0 windowed, layer 1 global
    cfg2 = cfg.replace(num_layers=2)
    params2 = prepare_params(create_synthetic_quantized_model(
        cfg2, bits=4, group_size=64, device="cuda", seed=1).params)
    out["vs_plain"] = kernels_vs_plain(
        torch, llama, cfg2, params2, lambda B: {"decode_attention": 2},
        "Gemma-2-27B", 15, decided_agree=True, batches=((1, [4160]),))
    out["vs_plain"].update(paged_vs_plain(
        torch, cfg2, params2, None, PAGE=256, T=T, lens=(4150, 5000),
        decided_agree=True))
    del params2
    torch.cuda.empty_cache()
    report["gemma2"] = out
    return launches


# -- phase 14 --------------------------------------------------------------

def phase_gemma3(torch, report):
    """Phase 14: Gemma-3-12B (google/gemma-3-12b-pt's config.json, as
    config.gemma3_12b_config transcribes it: 48 layers, hidden 3840,
    16:8 heads of 256, FFN 15360 GeGLU, vocab 262208, per-head q/k
    norms, a 1024-key window on five layers of six with a local RoPE base
    of 1e4, linear RoPE scaling 8 on the global layers, attn_scale
    256**-0.5, no softcaps, tied embeddings), int4 g=64, bf16, synthetic
    weights from a seed, 6 of the 48 layers, positions cut to 8192 (the
    published 131072): (a) generate_batch B=2, prompts of 4500 and 5000
    (past the window, through the global layers), 64 new tokens (launch
    counts of the run and of one decode step, a traced prefill and 8
    traced decode steps, cache and peak memory); (b) (a) over int8 and
    fp8 caches (the 8-bit D=256 flash, decode and encode-and-write); (c)
    paged serving with speculative verify, 4 of 8 requests on a
    1100-token prefix (gemma_paged: 12 prefix hits); (d) at L=2 with the
    pattern set to 2 (layer 0 local, layer 1 global, as Gemma-3's layers
    5 and 6 are), kernels against plain versions: a 1100-token prompt's
    prefill and decode step, paged decode and verify over pools filled
    to 1150 and 5000, within 5% of max|logit| and under phase 11's tie
    rule."""
    from turboinfer_tpu_torch import kernels
    from turboinfer_tpu_torch.config import gemma3_12b_config
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    from turboinfer_tpu_torch.models import llama
    # every width; 6 of the 48 layers (its first global layer, 5, stays),
    # so phases 1-19 fit the time limit
    cfg = gemma3_12b_config(num_layers=6, max_seq_len=8192)
    L, T = cfg.num_layers, cfg.max_seq_len
    windows = [llama.layer_window(cfg, li) for li in range(L)]
    say(f"phase 14: Gemma-3-12B int4 g=64, L={L}, hidden "
        f"{cfg.hidden_size}, Hq={cfg.num_heads} Hkv={cfg.kv_heads} "
        f"D={cfg.head_dim_}, FFN {cfg.ffn_dim}, V={cfg.vocab_size}, window "
        f"{cfg.sliding_window} on {sum(w is not None for w in windows)} of "
        f"{L} layers, RoPE {cfg.rope_theta:g} "
        f"x{dict(cfg.rope_scaling)['factor']:g} global / "
        f"{cfg.rope_local_theta:g} local, max_seq {T}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = prepare_params(create_synthetic_quantized_model(
        cfg, bits=4, group_size=64, device="cuda", seed=0).params)
    torch.cuda.synchronize()
    out = dict(config="gemma-3-12b-pt int4 g=64 L=6 of 48 bf16 max_seq 8192",
               build_s=time.perf_counter() - t0,
               build_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               allocated_gib=torch.cuda.memory_allocated() / 2**30,
               weight_bytes=qtensor_bytes(params))
    say(f"  model built in {out['build_s']:.1f} s: int4 weights "
        f"{out['weight_bytes'] / 1e9:.2f} GB, {out['allocated_gib']:.2f} GiB "
        f"allocated, build peak {out['build_peak_gib']:.2f} GiB")
    gen = torch.Generator().manual_seed(14)

    def rand(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
    long = [rand(4500), rand(5000)]
    launches = gemma_batch(torch, kernels, params, cfg, "model",
                           [("(a)", long, 64)], out)
    for kv in KV_KINDS:
        gemma_batch(torch, kernels, params, cfg, kv, [("(b)", long, 64)], out)
    gemma_paged(torch, kernels, params, cfg, gen, out, prefix_len=1100)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # (d) L=2, pattern 2: layer 0 local, layer 1 global
    cfg2 = cfg.replace(num_layers=2, sliding_window_pattern=2)
    params2 = prepare_params(create_synthetic_quantized_model(
        cfg2, bits=4, group_size=64, device="cuda", seed=1).params)
    out["vs_plain"] = kernels_vs_plain(
        torch, llama, cfg2, params2, lambda B: {"decode_attention": 2},
        "Gemma-3-12B", 16, decided_agree=True, batches=((1, [1100]),))
    out["vs_plain"].update(paged_vs_plain(
        torch, cfg2, params2, None, PAGE=256, T=T, lens=(1150, 5000),
        decided_agree=True))
    del params2
    torch.cuda.empty_cache()
    report["gemma3"] = out
    return launches


# -- phase 15 --------------------------------------------------------------

def nocache_vs_cached(torch, kernels, params, cfg, prompts, new: int,
                      report_out):
    """(e) of phase 15: generate_batch with use_cache=False (every token
    recomputes the padded sequence through forward_no_cache) against the
    cached path on the same weights, greedy. Launches equal one prefill a
    token (flash and the cache write L each, qmm 4L+1, no decode
    attention); the tokens equal the cached path's but where a row's
    first difference is a tie: the recomputed logits there put the cached
    token within TIE_ULPS bf16 ulps of max|logit| below their top (the
    two paths reach that position through different kernels), in at most
    MAX_TIE_ROWS rows."""
    from turboinfer_tpu_torch.config import InferenceConfig
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    L, T = cfg.num_layers, cfg.max_seq_len
    icfg = dict(max_seq_len=T, temperature=0.0, seed=0, eos_token_id=-1)
    cached = InferenceEngine(params, cfg, InferenceConfig(**icfg),
                             device="cuda")
    want_tokens = [r.tokens for r in cached.generate_batch(prompts, new)]
    del cached
    eng = InferenceEngine(params, cfg, InferenceConfig(use_cache=False,
                                                       **icfg), device="cuda")
    say(f"  (e) generate_batch use_cache=False, B={len(prompts)}, prompts "
        f"{[len(p) for p in prompts]}, {new} new (every token recomputes "
        "the sequence)")
    res, counts, stats = run_counted(torch, kernels, eng, prompts, new,
                                     "(e) use_cache=False greedy")
    want = want_counts(qmm_int4=(4 * L + 1) * new, flash_prefill=L * new,
                       cache_write_fresh=L * new)
    need(counts == want, f"(e) launch counts {counts} != {want}")
    ties = []
    for b, (r, w) in enumerate(zip(res, want_tokens)):
        got = r.tokens
        need(len(got) == len(w) and r.stop_reason == "length",
             f"(e) row {b}: {len(got)} tokens, stop {r.stop_reason}")
        if got == w:
            continue
        i = next(j for j in range(len(w)) if got[j] != w[j])
        k = i - len(prompts[b])
        # that step's recompute again: the batch as it stood, padded
        tok, lens, _ = eng._pad_batch([x.tokens[:len(p) + k]
                                       for x, p in zip(res, prompts)])
        lg = eng._model.forward_no_cache(eng.params, cfg, tok,
                                         seq_lens=lens)[b, lens[b] - 1]
        lg = lg.float()
        ref = lg.abs().max().item()
        gap = (lg.max() - lg[w[i]]).item()
        tie_gap = TIE_ULPS * BF16_ULP * 2.0 ** math.floor(math.log2(ref))
        need(int(lg.argmax()) == got[i] and gap <= tie_gap,
             f"(e) row {b}: new token {k} differs from the cached path's "
             f"({got[i]} vs {w[i]}) beyond a tie: logit gap {gap} > "
             f"{tie_gap}")
        ties.append(dict(row=b, new_token=k, gap=gap, tie_gap=tie_gap))
    need(len(ties) <= MAX_TIE_ROWS, f"(e) {len(ties)} tie rows")
    stats.update(expected_launches=want, tie_rows=ties)
    say(f"  (e) launches as expected {want}; tokens equal the cached "
        f"path's{'' if not ties else f' but in tie rows {ties}'}")
    report_out["nocache"] = stats
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def phase_phi3(torch, report):
    """Phase 15: Phi-3-mini-4k (microsoft/Phi-3-mini-4k-instruct's
    config.json, as config.phi3_mini_4k_config transcribes it: 32 layers,
    hidden 3072, 32:32 heads of 96, FFN 8192 SiLU, vocab 32064, 4096
    positions, a 2047-key window on every layer, untied embeddings),
    int4 g=64, bf16, synthetic weights from a seed, 16 of the 32 layers
    (a depth cut so phase 19 fits the time limit, as phase 18; phase 17
    runs 8, phase 16 all 32) at published widths: (a) generate_batch B=2, prompts of 3000
    and 3500
    (past the window; bucket 4096), 64 new tokens (launch counts of the
    run and of one decode step, a traced prefill and 8 traced decode
    steps, cache and peak memory); (b) (a) over int8 and fp8 caches; (c)
    paged serving with speculative verify, 4 of 8 requests on a
    2200-token prefix (24 prefix hits, no page leaked); (e) generate_batch
    with use_cache=False (B=2, prompts 200 and 300, 8 new) against the
    cached path (nocache_vs_cached); (d) at L=1, kernels against plain
    versions: a 2100-token prompt's prefill and decode step (past the
    window), paged decode and verify over pools filled to 2100 and 3001,
    within 5% of max|logit| and under phase 11's tie rule."""
    from turboinfer_tpu_torch import kernels
    from turboinfer_tpu_torch.config import phi3_mini_4k_config
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    from turboinfer_tpu_torch.models import llama
    cfg = phi3_mini_4k_config(num_layers=16)
    L, T = cfg.num_layers, cfg.max_seq_len
    say(f"phase 15: Phi-3-mini-4k int4 g=64, L={L} (of 32), hidden "
        f"{cfg.hidden_size}, Hq={cfg.num_heads} Hkv={cfg.kv_heads} "
        f"D={cfg.head_dim_}, FFN {cfg.ffn_dim}, V={cfg.vocab_size}, window "
        f"{cfg.sliding_window} on every layer, max_seq {T}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = prepare_params(create_synthetic_quantized_model(
        cfg, bits=4, group_size=64, device="cuda", seed=0).params)
    torch.cuda.synchronize()
    out = dict(config="phi-3-mini-4k-instruct int4 g=64 L=16 of 32 bf16",
               build_s=time.perf_counter() - t0,
               build_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               allocated_gib=torch.cuda.memory_allocated() / 2**30,
               weight_bytes=qtensor_bytes(params))
    say(f"  model built in {out['build_s']:.1f} s: int4 weights "
        f"{out['weight_bytes'] / 1e9:.2f} GB, {out['allocated_gib']:.2f} GiB "
        f"allocated, build peak {out['build_peak_gib']:.2f} GiB")
    gen = torch.Generator().manual_seed(15)

    def rand(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
    long = [rand(3000), rand(3500)]
    launches = gemma_batch(torch, kernels, params, cfg, "model",
                           [("(a)", long, 64)], out)
    for kv in KV_KINDS:
        gemma_batch(torch, kernels, params, cfg, kv, [("(b)", long, 64)], out)
    gemma_paged(torch, kernels, params, cfg, gen, out, prefix_len=2200,
                unique=(600, 1700, 3001, 3900))
    nocache_vs_cached(torch, kernels, params, cfg, [rand(200), rand(300)], 8,
                      out)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # (d) L=1 (a depth cut): windowed, as every Phi-3 layer
    cfg2 = cfg.replace(num_layers=1)
    params2 = prepare_params(create_synthetic_quantized_model(
        cfg2, bits=4, group_size=64, device="cuda", seed=1).params)
    out["vs_plain"] = kernels_vs_plain(
        torch, llama, cfg2, params2, lambda B: {"decode_attention": 1},
        "Phi-3-mini", 16, decided_agree=True, batches=((1, [2100]),))
    out["vs_plain"].update(paged_vs_plain(
        torch, cfg2, params2, None, PAGE=256, T=T, lens=(2100, 3001),
        decided_agree=True))
    del params2
    torch.cuda.empty_cache()
    report["phi3"] = out
    return launches


# -- phase 16: weights in and out ------------------------------------------

# microsoft/Phi-3-mini-4k-instruct's published config.json, transcribed
# (the keys the loader reads; config_from_hf_dict maps it to
# config.phi3_mini_4k_config()).
PHI3_MINI_4K_CONFIG_JSON = {
    "_name_or_path": "microsoft/Phi-3-mini-4k-instruct",
    "architectures": ["Phi3ForCausalLM"], "model_type": "phi3",
    "vocab_size": 32064, "hidden_size": 3072, "num_hidden_layers": 32,
    "num_attention_heads": 32, "num_key_value_heads": 32,
    "intermediate_size": 8192, "hidden_act": "silu",
    "max_position_embeddings": 4096, "original_max_position_embeddings": 4096,
    "rope_theta": 10000.0, "rope_scaling": None, "rms_norm_eps": 1e-05,
    "sliding_window": 2047, "tie_word_embeddings": False,
    "attention_bias": False, "bos_token_id": 1, "eos_token_id": 32000,
    "pad_token_id": 32000, "torch_dtype": "bfloat16"}

# The tokenizer files of phases 16 (a) and 17, in the shape of
# microsoft/Phi-3-mini-4k-instruct's tokenizer.json and
# tokenizer_config.json: a Llama-2-style BPE (byte_fallback, fuse_unk,
# the normalizer Prepend "▁" + Replace " " -> "▁", no pre-tokenizer, the
# matching decoder), <unk> <s> </s> at 0-2, <0x00>..<0xFF> at 3-258, the
# rest of ids 0..31999 the corpus alphabet and merges learned here in
# pure Python from a fixed text (the card machine has no `tokenizers`
# and no network), Phi-3's added tokens at 32000-32010 (lstrip and
# rstrip off: the readers split added tokens verbatim) and Phi-3's chat
# template: system, user and assistant turns each closed by <|end|>, the
# generation prompt <|assistant|>\n.
PHI3_BASE_VOCAB = 32000
PHI3_ADDED = ["<|endoftext|>", "<|assistant|>", "<|placeholder1|>",
              "<|placeholder2|>", "<|placeholder3|>", "<|placeholder4|>",
              "<|system|>", "<|end|>", "<|placeholder5|>",
              "<|placeholder6|>", "<|user|>"]
PHI3_CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "{% if message['role'] == 'system' %}"
    "{{'<|system|>\n' + message['content'] + '<|end|>\n'}}"
    "{% elif message['role'] == 'user' %}"
    "{{'<|user|>\n' + message['content'] + '<|end|>\n'}}"
    "{% elif message['role'] == 'assistant' %}"
    "{{'<|assistant|>\n' + message['content'] + '<|end|>\n'}}"
    "{% endif %}{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|assistant|>\n' }}"
    "{% else %}{{ eos_token }}{% endif %}")
# the fixed text the merges are learned from, and the non-ASCII text
# phase 17 (a) round-trips (its CJK characters are outside the learned
# alphabet, so they go through byte_fallback)
PHI3_FIXED_TEXT = (
    "The quick brown fox jumps over the lazy dog. A language model reads "
    "text as tokens and writes text back one token at a time; a tokenizer "
    "turns each word into pieces it has learned from text like this one. "
    "Café owners in Zürich, naïve façades, smörgåsbord, jalapeño and crème "
    "brûlée: accents share the alphabet with plain letters. Numbers such "
    "as 3, 14, 159 and 2026 come digit by digit.")
PHI3_ROUND_TRIP = ("Grüße aus Zürich — naïve café, 你好世界, "
                   "smörgåsbord at 3.14 °C!")
_SYLLABLE_ONSETS = ["b", "c", "d", "f", "g", "h", "j", "k", "l", "m", "n",
                    "p", "r", "s", "t", "v", "w", "z", "ch", "sh", "th", "st",
                    "tr", "pl", "gr", "br", "qu", "ph", "é", "ü", "ñ", "ç"]
_SYLLABLE_VOWELS = ["a", "e", "i", "o", "u", "y", "ai", "ou", "ea", "io",
                    "ö", "å"]
_PHI3_TOKENIZER = None


def _bpe_corpus(seed: int = 17, n_words: int = 20000):
    """{"▁word": count}: the fixed text's words, then n_words pseudo-words
    of one to four syllables drawn from a seed, with Zipf-like counts."""
    import random
    rng = random.Random(seed)
    words = {}
    for w in PHI3_FIXED_TEXT.split():
        words["▁" + w] = words.get("▁" + w, 0) + 50
    for i in range(n_words):
        w = "".join(rng.choice(_SYLLABLE_ONSETS) + rng.choice(_SYLLABLE_VOWELS)
                    for _ in range(rng.choice((1, 2, 2, 3, 3, 3, 4))))
        if rng.random() < 0.3:
            w += rng.choice(_SYLLABLE_ONSETS)
        if rng.random() < 0.1:
            w = w.capitalize()
        words["▁" + w] = words.get("▁" + w, 0) + max(
            1, int(50000 / (1 + i) ** 0.8))
    return words


def learn_bpe(words, vocab, size: int):
    """Byte-pair merges learned from {word: count} until `vocab` (piece ->
    id, extended in place: first the corpus alphabet, then each merge's
    piece) holds `size` pieces. Pair counts are kept incrementally and a
    heap with stale entries skipped picks the most frequent pair, the
    lexicographically smallest among equals. Returns the merges."""
    import heapq
    from collections import defaultdict
    syms = [list(w) for w in words]
    freq = list(words.values())
    for s in syms:
        for ch in s:
            vocab.setdefault(ch, len(vocab))
    counts = defaultdict(int)
    where = defaultdict(set)
    for i, s in enumerate(syms):
        for q in zip(s, s[1:]):
            counts[q] += freq[i]
            where[q].add(i)
    heap = [(-c, q) for q, c in counts.items()]
    heapq.heapify(heap)
    merges = []
    while len(vocab) < size and heap:
        c, pair = heapq.heappop(heap)
        if c == 0 or -c != counts.get(pair, 0):
            continue                    # stale entry
        a, b = pair
        new = a + b
        merges.append(f"{a} {b}")
        vocab.setdefault(new, len(vocab))
        touched = set()
        for i in where.pop(pair):
            s, f = syms[i], freq[i]
            out, j, n = [], 0, len(s)
            while j < n:
                if j + 1 < n and s[j] == a and s[j + 1] == b:
                    out.append(new)
                    j += 2
                else:
                    out.append(s[j])
                    j += 1
            if len(out) == n:
                continue                # the word lost the pair earlier
            for q in zip(s, s[1:]):
                counts[q] -= f
                touched.add(q)
            for q in zip(out, out[1:]):
                counts[q] += f
                where[q].add(i)
                touched.add(q)
            syms[i] = out
        counts.pop(pair, None)
        for q in touched:
            if counts.get(q, 0) > 0:
                heapq.heappush(heap, (-counts[q], q))
    return merges


def phi3_tokenizer_files():
    """(tokenizer.json, tokenizer_config.json) dicts of the Phi-3-style
    tokenizer (see PHI3_ADDED above); learned once a process."""
    global _PHI3_TOKENIZER
    if _PHI3_TOKENIZER is not None:
        return _PHI3_TOKENIZER
    specials = ["<unk>", "<s>", "</s>"]
    vocab = {t: i for i, t in enumerate(specials)}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    merges = learn_bpe(_bpe_corpus(), vocab, PHI3_BASE_VOCAB)
    need(len(vocab) == PHI3_BASE_VOCAB, f"the corpus gave {len(vocab)} "
         f"pieces, not {PHI3_BASE_VOCAB}")

    def added(i, t):
        return {"id": i, "content": t, "single_word": False, "lstrip": False,
                "rstrip": False, "normalized": False, "special": True}
    tj = {"version": "1.0", "truncation": None, "padding": None,
          "added_tokens": [added(i, t) for i, t in enumerate(specials)]
          + [added(PHI3_BASE_VOCAB + i, t) for i, t in enumerate(PHI3_ADDED)],
          "normalizer": {"type": "Sequence", "normalizers": [
              {"type": "Prepend", "prepend": "▁"},
              {"type": "Replace", "pattern": {"String": " "},
               "content": "▁"}]},
          "pre_tokenizer": None,
          "post_processor": {
              "type": "TemplateProcessing",
              "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                         {"Sequence": {"id": "A", "type_id": 0}}],
              "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "<s>", "type_id": 1}},
                       {"Sequence": {"id": "B", "type_id": 1}}],
              "special_tokens": {"<s>": {"id": "<s>", "ids": [1],
                                         "tokens": ["<s>"]}}},
          "decoder": {"type": "Sequence", "decoders": [
              {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
              {"type": "ByteFallback"}, {"type": "Fuse"},
              {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
          "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                    "continuing_subword_prefix": None,
                    "end_of_word_suffix": None, "fuse_unk": True,
                    "byte_fallback": True, "ignore_merges": False,
                    "vocab": vocab, "merges": merges}}
    tc = {"add_bos_token": True, "add_eos_token": False, "bos_token": "<s>",
          "eos_token": "<|endoftext|>", "pad_token": "<|endoftext|>",
          "unk_token": "<unk>", "chat_template": PHI3_CHAT_TEMPLATE,
          "clean_up_tokenization_spaces": False, "legacy": False,
          "model_max_length": 4096, "padding_side": "left",
          "tokenizer_class": "LlamaTokenizer"}
    _PHI3_TOKENIZER = (tj, tc)
    return _PHI3_TOKENIZER


def write_phi3_tokenizer(d: str) -> None:
    """tokenizer.json and tokenizer_config.json of the Phi-3-style
    tokenizer into directory d."""
    import os
    tj, tc = phi3_tokenizer_files()
    for name, obj in (("tokenizer.json", tj), ("tokenizer_config.json", tc)):
        with open(os.path.join(d, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, ensure_ascii=False)


SHARD_BYTES = 5 * 10 ** 9        # HF's default max_shard_size, "5GB"
FILES_NEED_BYTES = 16 * 2 ** 30  # the largest set of files alive at once,
                                 # with room


def nbytes(t) -> int:
    return t.numel() * t.element_size()


def phi3_hf_tensors(params, cfg):
    """The bf16 params of a Phi-3 model under Phi-3's HF names and
    layout: [out, in] weights, q/k/v fused into qkv_proj, gate/up into
    gate_up_proj (device tensors; the writer moves them to the host)."""
    import torch
    lw = params["layers"]
    t = {"model.embed_tokens.weight": params["embed"]}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        t[f"{p}.input_layernorm.weight"] = lw["attn_norm"][i]
        t[f"{p}.self_attn.qkv_proj.weight"] = torch.cat(
            [lw["wq"][i].T, lw["wk"][i].T, lw["wv"][i].T])
        t[f"{p}.self_attn.o_proj.weight"] = lw["wo"][i].T
        t[f"{p}.post_attention_layernorm.weight"] = lw["ffn_norm"][i]
        t[f"{p}.mlp.gate_up_proj.weight"] = torch.cat(
            [lw["w_gate"][i].T, lw["w_up"][i].T])
        t[f"{p}.mlp.down_proj.weight"] = lw["w_down"][i].T
    t["model.norm.weight"] = params["final_norm"]
    t["lm_head.weight"] = params["lm_head"].T
    return t


def write_hf_checkpoint(d, tensors, config_json):
    """An HF checkpoint directory: model-0000N-of-0000M.safetensors
    shards of at most SHARD_BYTES in tensor order, their
    model.safetensors.index.json and config.json. Returns bytes written."""
    import os
    from turboinfer_tpu_torch.loader.safetensors import write_safetensors
    shards, cur, size = [], {}, 0
    for k, v in tensors.items():
        if cur and size + nbytes(v) > SHARD_BYTES:
            shards.append(cur)
            cur, size = {}, 0
        cur[k] = v
        size += nbytes(v)
    shards.append(cur)
    weight_map, total = {}, 0
    for n, shard in enumerate(shards):
        fname = f"model-{n + 1:05d}-of-{len(shards):05d}.safetensors"
        write_safetensors(os.path.join(d, fname), shard,
                          metadata={"format": "pt"})
        weight_map.update({k: fname for k in shard})
        total += os.path.getsize(os.path.join(d, fname))
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": sum(
            nbytes(v) for v in tensors.values())},
            "weight_map": weight_map}, f)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(config_json, f)
    return total, len(shards)


def same_tree(torch, a, b, what: str) -> int:
    """Two parameter trees equal bit for bit (QTensor codes, scales and
    zero points, QEmbed codes and scales, tensors); returns the leaves
    compared."""
    from turboinfer_tpu_torch.core.qtensor import QEmbed, QTensor
    n = 0
    need(set(a) == set(b), f"{what}: keys {sorted(a)} != {sorted(b)}")
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, dict):
            n += same_tree(torch, x, y, f"{what}/{k}")
            continue
        if isinstance(x, QTensor):
            need(isinstance(y, QTensor) and x.bits == y.bits
                 and x.group_size == y.group_size and x.shape == y.shape,
                 f"{what}/{k}: QTensor layouts differ")
            pairs = [(x.data, y.data), (x.scales, y.scales)]
            if x.zero_points is not None or y.zero_points is not None:
                pairs.append((x.zero_points, y.zero_points))
        elif isinstance(x, QEmbed):
            pairs = [(x.data, y.data), (x.scales, y.scales)]
        else:
            pairs = [(x, y)]
        for u, v in pairs:
            need(u is not None and v is not None and u.dtype == v.dtype
                 and torch.equal(u, v.to(u.device)),
                 f"{what}/{k}: not bit-identical")
            n += 1
    return n


def tokens_or_ties(torch, eng, cfg, prompts, got, want, label: str):
    """got == want row for row, but where a row's first difference is a
    tie: the engine's own logits at that position (a B=1 recompute of the
    want row's prefix through forward_no_cache) put the wanted token
    within TIE_ULPS bf16 ulps of max|logit| below the top, in at most
    MAX_TIE_ROWS rows (the two paths reach that position through
    different batch shapes and kernels). Returns the tie rows."""
    ties = []
    for b, (g, w) in enumerate(zip(got, want)):
        need(len(g) == len(w), f"{label} row {b}: {len(g)} tokens, want "
                               f"{len(w)}")
        if g == w:
            continue
        i = next(j for j in range(len(w)) if g[j] != w[j])
        tok = torch.tensor([w[:i]], dtype=torch.int32, device="cuda")
        lg = eng._model.forward_no_cache(eng.params, cfg, tok)[0, -1].float()
        ref = lg.abs().max().item()
        gap = abs(lg[g[i]].item() - lg[w[i]].item())
        tie_gap = TIE_ULPS * BF16_ULP * 2.0 ** math.floor(math.log2(ref))
        need(gap <= tie_gap, f"{label} row {b}: token {i - len(prompts[b])} "
             f"differs ({g[i]} vs {w[i]}) beyond a tie: logit gap {gap} > "
             f"{tie_gap}")
        ties.append(dict(row=b, new_token=i - len(prompts[b]), gap=gap,
                         tie_gap=tie_gap))
    need(len(ties) <= MAX_TIE_ROWS, f"{label}: {len(ties)} tie rows")
    return ties


def random_adapter(torch, gen, cfg, r: int, layers: int):
    """PEFT tensors of an adapter on all seven modules of `layers`
    layers: lora_A [r, in] and lora_B [out, r], N(0, 0.01^2), f32."""
    H, F, QD, KVD = cfg.hidden_size, cfg.ffn_dim, cfg.q_dim, cfg.kv_dim
    dims = {"self_attn.q_proj": (QD, H), "self_attn.k_proj": (KVD, H),
            "self_attn.v_proj": (KVD, H), "self_attn.o_proj": (H, QD),
            "mlp.gate_proj": (F, H), "mlp.up_proj": (F, H),
            "mlp.down_proj": (H, F)}
    t = {}
    for i in range(layers):
        for m, (o, n) in dims.items():
            pre = f"base_model.model.model.layers.{i}.{m}"
            t[f"{pre}.lora_A.weight"] = 0.01 * torch.randn(
                (r, n), generator=gen)
            t[f"{pre}.lora_B.weight"] = 0.01 * torch.randn(
                (o, r), generator=gen)
    return t


def loader_hf_tinq(torch, kernels, work, cfg, params, long, out):
    """(a) and (b) of phase 16; returns (a)'s quantized params and
    launches."""
    import os
    import shutil
    from turboinfer_tpu_torch.config import (InferenceConfig,
                                             QuantizationConfig, QuantType,
                                             phi3_mini_4k_config)
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    from turboinfer_tpu_torch.loader import load_engine, load_model_data
    from turboinfer_tpu_torch.quant.quantizer import (quantize_model_file,
                                                      quantize_params)
    from turboinfer_tpu_torch.tokenizer.hf import HFTokenizer
    L, T = cfg.num_layers, cfg.max_seq_len
    qc = QuantizationConfig(type=QuantType.INT4, group_size=64)
    hf = os.path.join(work, "phi3-hf")
    os.makedirs(hf)
    tensors = phi3_hf_tensors(params, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    size, n_shards = write_hf_checkpoint(hf, tensors,
                                         PHI3_MINI_4K_CONFIG_JSON)
    write_s = time.perf_counter() - t0
    del tensors
    write_phi3_tokenizer(hf)
    t0 = time.perf_counter()
    data = load_model_data(hf, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    need(data.config == phi3_mini_4k_config(),
         f"(a) config.json mapped to {data.config}, not "
         "phi3_mini_4k_config()")
    need(data.params["layers"]["wq"].is_cuda, "(a) loaded off the card")
    tok = data.tokenizer
    need(isinstance(tok, HFTokenizer) and tok.chat_template is not None
         and tok.chat_template.source == PHI3_CHAT_TEMPLATE,
         f"(a) the tokenizer.json sidecar was not attached: {tok!r}")
    n_raw = same_tree(torch, data.params, params, "(a) loaded bf16")
    t0 = time.perf_counter()
    qp = quantize_params(data.params, qc)
    torch.cuda.synchronize()
    quant_ms = (time.perf_counter() - t0) * 1e3
    del data
    gc.collect()
    qmem = quantize_params(params, qc)
    n_q = same_tree(torch, qp, qmem, "(a) quantized loaded vs in memory")
    a = dict(shards=n_shards, file_bytes=size, write_s=write_s,
             write_gb_per_s=size / write_s / 1e9, load_s=load_s,
             load_gb_per_s=size / load_s / 1e9, quantize_ms=quant_ms,
             leaves_bit_identical=n_raw + n_q)
    say(f"  (a) HF checkpoint: {n_shards} bf16 shards, {size / 1e9:.3f} GB "
        f"written in {write_s:.2f} s ({a['write_gb_per_s']:.2f} GB/s); "
        f"load_model_data onto the card {load_s:.2f} s "
        f"({a['load_gb_per_s']:.2f} GB/s, page cache warm); config.json -> "
        f"phi3_mini_4k_config(); quantize_params int4 g=64 on the card "
        f"{quant_ms:.1f} ms; {n_raw} bf16 and {n_q} quantized leaves bit "
        "for bit the in-memory ones")
    icfg = InferenceConfig(max_seq_len=T, temperature=0.0, seed=0,
                           eos_token_id=-1, measure_ttft=True)
    runs = {}
    for label, p in (("in memory", qmem), ("loaded", qp)):
        # the loaded engine as load_engine builds it: with the file's
        # tokenizer
        eng = InferenceEngine(p, cfg, icfg, device="cuda",
                              tokenizer=tok if label == "loaded" else None)
        res, counts, stats = run_counted(torch, kernels, eng, long, 64,
                                         f"(a) {label} B=2 greedy")
        want = expected_launches(L, 63)
        need(counts == want, f"(a) {label}: launches {counts} != {want}")
        runs[label] = ([r.tokens for r in res], stats)
        if label == "loaded":
            msgs = [{"role": "user", "content": "Grüezi! Who are you?"}]
            prompt = tok.apply_chat_template(msgs, tokenize=True)
            turn = eng.chat(msgs, 8)
            new = turn.tokens[len(prompt):]
            need(len(new) == 8 and turn.text == tok.decode(new),
                 "(a) engine.chat on the loaded model")
            a["chat"] = dict(prompt_tokens=len(prompt), new_tokens=8,
                             total_ms=turn.total_time_ms)
        del eng
    need(runs["loaded"][0] == runs["in memory"][0],
         "(a) the loaded model's tokens differ from the in-memory path's")
    a.update(generate=runs["loaded"][1], in_memory=runs["in memory"][1])
    say("  (a) tokens equal the in-memory path's (phase 15 (a)'s path on "
        "the same weights); the tokenizer.json sidecar attached as an "
        f"HFTokenizer (vocab {tok.vocab_size}) with Phi-3's chat template; "
        f"one engine.chat turn ({a['chat']['prompt_tokens']}-token prompt, 8 "
        f"new) in {a['chat']['total_ms']:.1f} ms")
    out["hf"] = a
    del qmem
    gc.collect()
    # (b) TINQ
    tq = os.path.join(work, "phi3.tinq")
    t0 = time.perf_counter()
    quantize_model_file(hf, tq, qc, device="cuda")
    file_s = time.perf_counter() - t0
    shutil.rmtree(hf)
    t0 = time.perf_counter()
    eng = load_engine(tq, icfg, device="cuda")
    torch.cuda.synchronize()
    tload_s = time.perf_counter() - t0
    tbytes = os.path.getsize(tq)
    from turboinfer_tpu_torch.loader import tinq
    raw, _, tqc, _ = tinq.load(tq, device="cuda")
    n_t = same_tree(torch, raw, qp, "(b) TINQ params")
    need(tqc == qc, f"(b) TINQ quantization config {tqc}")
    del raw
    res, counts, stats = run_counted(torch, kernels, eng, long, 64,
                                     "(b) TINQ B=2 greedy")
    need(counts == expected_launches(L, 63), f"(b) launches {counts}")
    need([r.tokens for r in res] == runs["loaded"][0],
         "(b) the TINQ model's tokens differ from (a)'s")
    out["tinq"] = dict(file_bytes=tbytes, quantize_model_file_s=file_s,
                       load_engine_s=tload_s,
                       load_gb_per_s=tbytes / tload_s / 1e9,
                       leaves_bit_identical=n_t, generate=stats)
    say(f"  (b) quantize_model_file (load, int4 g=64, save) {file_s:.2f} s; "
        f".tinq {tbytes / 1e9:.3f} GB; load_engine {tload_s:.2f} s "
        f"({out['tinq']['load_gb_per_s']:.2f} GB/s); QTensors bit for bit "
        "(a)'s; tokens equal (a)'s")
    del eng
    os.remove(tq)
    gc.collect()
    torch.cuda.empty_cache()
    return qp, runs["loaded"][1]["launches"]


def loader_gguf(torch, work, cfg, params, out):
    """(c) of phase 16: a 4-layer Phi-3 GGUF (llama.cpp names, F16), and
    the GGML dequantizers at w_gateup's size."""
    import os
    import numpy as np
    from turboinfer_tpu_torch import native
    from turboinfer_tpu_torch.loader import gguf, load_gguf
    from turboinfer_tpu_torch.models import llama
    Lg = 4
    cfg4 = cfg.replace(num_layers=Lg)
    lw = params["layers"]

    def f16(t):
        return t.to(torch.float16).cpu().numpy()
    t = {"token_embd.weight": f16(params["embed"]),
         "output_norm.weight": f16(params["final_norm"]),
         "output.weight": f16(params["lm_head"].T)}
    for i in range(Lg):
        t[f"blk.{i}.attn_norm.weight"] = f16(lw["attn_norm"][i])
        t[f"blk.{i}.attn_qkv.weight"] = f16(torch.cat(
            [lw["wq"][i].T, lw["wk"][i].T, lw["wv"][i].T]))
        t[f"blk.{i}.attn_output.weight"] = f16(lw["wo"][i].T)
        t[f"blk.{i}.ffn_norm.weight"] = f16(lw["ffn_norm"][i])
        t[f"blk.{i}.ffn_up.weight"] = f16(torch.cat(
            [lw["w_gate"][i].T, lw["w_up"][i].T]))
        t[f"blk.{i}.ffn_down.weight"] = f16(lw["w_down"][i].T)
    a = "phi3"
    md = {"general.architecture": a, "general.name": "phi3-mini-4k-4layers",
          f"{a}.embedding_length": cfg.hidden_size, f"{a}.block_count": Lg,
          f"{a}.attention.head_count": cfg.num_heads,
          f"{a}.attention.head_count_kv": cfg.kv_heads,
          f"{a}.feed_forward_length": cfg.ffn_dim,
          f"{a}.rope.freq_base": cfg.rope_theta,
          f"{a}.attention.layer_norm_rms_epsilon": cfg.rms_norm_eps,
          f"{a}.context_length": cfg.max_seq_len,
          f"{a}.attention.sliding_window": cfg.sliding_window,
          "tokenizer.ggml.model": "llama",
          "tokenizer.ggml.tokens": ["<unk>", "<s>", "</s>"] + [
              f"<tok{i}>" for i in range(cfg.vocab_size - 3)],
          "tokenizer.ggml.scores": [0.0] * cfg.vocab_size,
          "tokenizer.ggml.eos_token_id": 32000}
    path = os.path.join(work, "phi3-4layers-f16.gguf")
    t0 = time.perf_counter()
    gguf.write_gguf(path, md, t)
    write_s = time.perf_counter() - t0
    del t
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    data = load_gguf(path, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    c = data.config
    need((c.architecture, c.num_layers, c.hidden_size, c.num_heads,
          c.kv_heads, c.head_dim_, c.ffn_dim, c.vocab_size, c.sliding_window,
          c.max_seq_len, c.rope_mode, c.tie_embeddings) ==
         (cfg4.architecture, Lg, cfg4.hidden_size, cfg4.num_heads,
          cfg4.kv_heads, cfg4.head_dim_, cfg4.ffn_dim, cfg4.vocab_size,
          cfg4.sliding_window, cfg4.max_seq_len, cfg4.rope_mode, False)
         and abs(c.rms_norm_eps - cfg4.rms_norm_eps) < 1e-9,
         f"(c) GGUF metadata mapped to {c}")
    need(data.tokenizer is not None and data.tokenizer.eos_id == 32000,
         "(c) no tokenizer from the GGUF metadata")
    os.remove(path)
    say(f"  (c) GGUF F16, {Lg} of 32 layers, llama.cpp names (attn_qkv, "
        f"double-width ffn_up): {size / 1e9:.3f} GB written in {write_s:.2f} "
        f"s, load_gguf onto the card {load_s:.2f} s "
        f"({size / load_s / 1e9:.2f} GB/s, native index "
        f"{native.available()})")
    mem = {**params, "layers": {k: v[:Lg] for k, v in lw.items()}}
    gen = torch.Generator().manual_seed(16)
    tok = torch.randint(1, cfg.vocab_size, (1, 512), generator=gen,
                        dtype=torch.int32).cuda()
    lg = {}
    for label, p, c in (("gguf", data.params, data.config),
                        ("memory", mem, cfg4)):
        lg[label] = llama.forward_no_cache(p, c, tok)[0].float().cpu()
    del data
    what = f"(c) GGUF f32 logits vs the in-memory bf16 params L={Lg}"
    cmp = {"all 512 positions": logits_agree(
        torch, lg["gguf"], lg["memory"], what + ", all 512 positions", 0,
        False, False)[0], "last position": logits_agree(
        torch, lg["gguf"][-1:], lg["memory"][-1:], what + ", last position",
        0, False, True)[0]}
    res = dict(file_bytes=size, write_s=write_s, load_s=load_s,
               load_gb_per_s=size / load_s / 1e9, logits=cmp)
    # the dequantizers at w_gateup's size (16384 x 3072), random blocks
    # with finite fp16 scale fields
    need(native.available(), f"(c) the native library did not build: "
         f"{native.last_error()}")
    n = 2 * cfg.ffn_dim * cfg.hidden_size
    rng = np.random.default_rng(16)
    deq = {}
    for name, fields in (("Q4_0", (0,)), ("Q8_0", (0,)), ("Q4_K", (0, 2)),
                         ("Q6_K", (208,))):
        ty = {v: k for k, v in gguf.GGML_TYPE_NAMES.items()}[name]
        be, bb = gguf._BLOCK_LAYOUT[ty]
        blocks = rng.integers(0, 256, size=(n // be, bb), dtype=np.uint8)
        for o in fields:
            blocks[:, o:o + 2] = rng.normal(scale=0.02, size=n // be).astype(
                np.float16).view(np.uint8).reshape(-1, 2)
        raw = blocks.reshape(-1)
        t0 = time.perf_counter()
        got = native.ggml_dequant(raw, ty, n)
        nat_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = gguf.dequantize_ggml_numpy(raw, ty, n)
        np_s = time.perf_counter() - t0
        need(got is not None and np.array_equal(got, want),
             f"(c) native {name} dequant differs from numpy")
        deq[name] = dict(native_s=nat_s, numpy_s=np_s, elements=n,
                         native_gelem_per_s=n / nat_s / 1e9)
        say(f"  (c) dequant {name} {n} elements: native {nat_s * 1e3:.1f} ms "
            f"({n / nat_s / 1e9:.2f} Gelem/s), numpy {np_s * 1e3:.1f} ms, "
            "equal bit for bit")
    res["dequant"] = deq
    out["gguf"] = res


def loader_lora(torch, kernels, work, out):
    """(d) of phase 16: the 7B int4 under an r=16 PEFT adapter on all
    seven modules, through load_engine(.tinq, lora=...)."""
    import os
    from turboinfer_tpu_torch.config import InferenceConfig, llama7b_config
    from turboinfer_tpu_torch.engine.scheduler import PagedContinuousScheduler
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    from turboinfer_tpu_torch.loader import (load_engine, load_lora,
                                             strip_lora, tinq)
    from turboinfer_tpu_torch.loader.safetensors import write_safetensors
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    from turboinfer_tpu_torch.models import llama
    L, B, S, NEW, T, R = 8, 8, 512, 64, 1024, 16
    cfg = llama7b_config(num_layers=L, max_seq_len=T)
    base = os.path.join(work, "llama7b-int4.tinq")
    ad = os.path.join(work, "adapter")
    os.makedirs(ad)
    gen = torch.Generator().manual_seed(17)
    t0 = time.perf_counter()
    tinq.save(base, create_synthetic_quantized_model(
        cfg, bits=4, group_size=64, device="cuda", seed=0).params, cfg)
    write_safetensors(os.path.join(ad, "adapter_model.safetensors"),
                      random_adapter(torch, gen, cfg, R, L))
    with open(os.path.join(ad, "adapter_config.json"), "w") as f:
        json.dump({"peft_type": "LORA", "r": R, "lora_alpha": 32,
                   "use_rslora": False, "target_modules": [
                       "q_proj", "k_proj", "v_proj", "o_proj",
                       "gate_proj", "up_proj", "down_proj"]}, f)
    write_s = time.perf_counter() - t0
    icfg = InferenceConfig(max_seq_len=T, temperature=0.0, seed=0,
                           eos_token_id=-1, measure_ttft=True)
    t0 = time.perf_counter()
    eng = load_engine(base, icfg, lora=ad, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    os.remove(base)
    need(all(f"lora_{s}_{x}" in eng.params["layers"] for x in "ab" for s in (
        "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")),
        "(d) adapter slots missing")
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    plain = InferenceEngine(strip_lora(eng.params), cfg, icfg, device="cuda")
    say(f"  (d) 7B int4 g=64 L={L} as .tinq + r={R} adapter on all seven "
        f"modules written in {write_s:.2f} s; load_engine(lora=) "
        f"{load_s:.2f} s")
    prompts = torch.randint(1, cfg.vocab_size, (B, S),
                            generator=torch.Generator().manual_seed(0)
                            ).tolist()
    want = expected_launches(L, NEW - 1)
    runs = {"base": [], "lora": []}
    toks = {}
    for rep in range(2):
        for label, e in (("base", plain), ("lora", eng)):
            res, counts, stats = run_counted(
                torch, kernels, e, prompts, NEW,
                f"(d) {label} B={B} prompts {S} run {rep}")
            need(counts == want, f"(d) {label}: launches {counts} != {want}")
            runs[label].append(stats)
            toks[label] = [r.tokens for r in res]
    lora_step = statistics.median(r["decode_ms_per_step"]
                                  for r in runs["lora"])
    base_step = statistics.median(r["decode_ms_per_step"]
                                  for r in runs["base"])
    differ = sum(a != b for a, b in zip(toks["lora"], toks["base"]))
    say(f"  (d) decode ms/step interleaved: base {base_step:.3f}, with the "
        f"adapter {lora_step:.3f} (+{lora_step - base_step:.3f}); prefill "
        f"{statistics.median(r['prefill_ms'] for r in runs['base']):.2f} vs "
        f"{statistics.median(r['prefill_ms'] for r in runs['lora']):.2f} ms; "
        f"the adapter changed {differ} of {B} rows")
    res = dict(write_s=write_s, load_engine_s=load_s, runs=runs,
               decode_ms_per_step_base=base_step,
               decode_ms_per_step_lora=lora_step,
               rows_changed_by_adapter=differ)
    del plain
    # the same adapter through the paged scheduler
    sched = PagedContinuousScheduler(eng.params, cfg, icfg, batch_slots=B,
                                     page_size=256, device="cuda")
    kernels.reset_launch_counts()
    ids = [sched.submit(p, NEW) for p in prompts]
    done = sched.run()
    counts = kernels.launch_counts()
    need(counts["paged_attention"] > 0, f"(d) paged launches {counts}")
    res["paged_ties"] = tokens_or_ties(
        torch, eng, cfg, prompts, [done[i].tokens for i in ids],
        toks["lora"], "(d) paged + adapter")
    say(f"  (d) paged scheduler with the adapter: tokens equal "
        f"generate_batch's{'' if not res['paged_ties'] else ' but tie rows ' + str(res['paged_ties'])}; "
        f"launches {counts}")
    del sched, eng
    gc.collect()
    torch.cuda.empty_cache()
    # L=1 (a depth cut): kernels against plain with the adapter
    cfg2 = cfg.replace(num_layers=1)
    p2 = create_synthetic_quantized_model(cfg2, bits=4, group_size=64,
                                          device="cuda", seed=1).params
    ad2 = os.path.join(work, "adapter2")
    os.makedirs(ad2)
    write_safetensors(os.path.join(ad2, "adapter_model.safetensors"),
                      random_adapter(torch, gen, cfg2, R, cfg2.num_layers))
    with open(os.path.join(ad2, "adapter_config.json"), "w") as f:
        json.dump({"r": R, "lora_alpha": 32}, f)
    p2["layers"].update(load_lora(ad2, cfg2, device="cuda"))
    res["vs_plain"] = kernels_vs_plain(
        torch, llama, cfg2, prepare_params(p2),
        lambda B: {"decode_attention": 1}, "7B + LoRA", 17,
        decided_agree=True, batches=VS_PLAIN_BATCHES[:1])
    out["lora"] = res


def loader_calibrate(torch, cfg, params, qp, out):
    """(e) of phase 16: calibrated int4 g=64 of Phi-3-mini on 8 x 512
    tokens, and its activation-weighted reconstruction error beside
    (a)'s uncalibrated QTensors."""
    from turboinfer_tpu_torch.config import QuantizationConfig, QuantType
    from turboinfer_tpu_torch.core.qtensor import dequantize
    from turboinfer_tpu_torch.quant import calibrate
    qc = QuantizationConfig(type=QuantType.INT4, group_size=64,
                            calibration_samples=8, calibration_max_len=512)
    toks = calibrate.default_calibration_tokens(qc, cfg, seed=16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    moments = calibrate.collect_moments(params, cfg, toks)
    torch.cuda.synchronize()
    moments_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cal = calibrate.calibrated_quantize_params(params, qc, cfg,
                                               sample_tokens=toks)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    errs = {}
    for slot in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        num = {"uncalibrated": 0.0, "calibrated": 0.0}
        den = 0.0
        for li in range(cfg.num_layers):
            w = params["layers"][slot][li].float()
            m = moments[slot][li].float()
            m = torch.maximum(m, 0.01 * m.mean())[:, None]
            den += (m * w * w).sum().item()
            for label, q in (("uncalibrated", qp), ("calibrated", cal)):
                wq = dequantize(q["layers"][slot].layer(li))
                num[label] += (m * (w - wq) ** 2).sum().item()
        errs[slot] = {k: v / den for k, v in num.items()}
    tot = {k: sum(e[k] for e in errs.values()) for k in
           ("uncalibrated", "calibrated")}
    need(tot["calibrated"] < tot["uncalibrated"],
         f"(e) calibration did not lower the weighted error: {tot}")
    say(f"  (e) calibrated int4 g=64 on {len(toks)} x {len(toks[0])} tokens: "
        f"moments {moments_s:.2f} s, calibrated_quantize_params "
        f"{cal_s:.2f} s; activation-weighted relative error (sum over "
        f"slots) {tot['calibrated']:.5f} vs {tot['uncalibrated']:.5f} "
        "uncalibrated")
    for slot, e in errs.items():
        say(f"    {slot}: {e['calibrated']:.6f} vs {e['uncalibrated']:.6f}")
    out["calibrate"] = dict(moments_s=moments_s, seconds=cal_s,
                            tokens=[len(toks), len(toks[0])],
                            weighted_rel_err=errs, total=tot)


def phase_loader(torch, report):
    """Phase 16: weights in and out at full width. Phi-3-mini-4k's bf16
    weights drawn from a seed: (a) written as an HF checkpoint directory
    (bf16 shards of at most 5 GB under Phi-3's HF names, the index and
    the published config.json), loaded onto the card by load_model_data
    and quantized there to int4 g=64: bit for bit the in-memory
    quantization, then generate_batch B=2 (prompts 3000/3500, 64 new)
    with tokens equal to the in-memory path's; (b) quantize_model_file to
    .tinq and load_engine of it: the same QTensors and tokens; (c) a
    4-layer F16 GGUF under llama.cpp's names against the in-memory
    params (5% rule, ties), and the native GGML dequantizers against
    numpy at w_gateup's size; (d) the 7B int4 L=8 as .tinq under an
    r=16 PEFT adapter on all seven modules through load_engine(lora=):
    decode ms/step with and without it, interleaved; the paged
    scheduler's tokens against generate_batch's; L=2 kernels against
    plain with the adapter; (e) calibrated quantization of Phi-3-mini on
    8 x 512 tokens. The files live in _smoke_files/ beside this script
    (gitignored), which must have FILES_NEED_BYTES free, and are removed
    at the end."""
    import os
    import shutil
    from turboinfer_tpu_torch import kernels, native
    from turboinfer_tpu_torch.config import phi3_mini_4k_config
    from turboinfer_tpu_torch.models import llama
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "_smoke_files")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    free = shutil.disk_usage(work).free
    need(free >= FILES_NEED_BYTES, f"phase 16 needs {FILES_NEED_BYTES} bytes "
         f"free beside the script for its files, has {free}")
    need(native.available(), f"the native library did not build: "
                             f"{native.last_error()}")
    say(f"phase 16: weights in and out; files in {work} ({free / 2**30:.0f} "
        f"GiB free); native library {native.version()} built, OpenMP "
        f"{native.openmp()} (GGUF index and dequant on the native path)")
    out = dict(native=native.version(), native_openmp=native.openmp(),
               free_bytes=free)
    cfg = phi3_mini_4k_config()
    try:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = llama.init_params(cfg, seed=16, device="cuda")
        torch.cuda.synchronize()
        say(f"  Phi-3-mini-4k bf16 weights drawn on the card in "
            f"{time.perf_counter() - t0:.1f} s")
        gen = torch.Generator().manual_seed(15)
        long = [torch.randint(1, cfg.vocab_size, (n,), generator=gen
                              ).tolist() for n in (3000, 3500)]
        qp, launches = loader_hf_tinq(torch, kernels, work, cfg, params,
                                      long, out)
        loader_gguf(torch, work, cfg, params, out)
        loader_calibrate(torch, cfg, params, qp, out)
        del params, qp
        gc.collect()
        torch.cuda.empty_cache()
        loader_lora(torch, kernels, work, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    report["loader"] = out
    return launches


# -- phase 17: text in and out ---------------------------------------------

# a JSON Schema of three required properties whose grammar always ends
# within 128 tokens (at most ~60 bytes, however the vocab splits them)
TEXT_SCHEMA = {"type": "object",
               "properties": {"name": {"type": "string", "maxLength": 12},
                              "age": {"type": "integer", "minimum": 0,
                                      "maximum": 150},
                              "tag": {"type": "string",
                                      "enum": ["alpha", "beta", "gamma"]}},
               "required": ["name", "age", "tag"]}
TEXT_RF_SCHEMA = {"type": "json_schema", "json_schema": {"schema": TEXT_SCHEMA}}
TEXT_MESSAGES = [
    {"role": "system", "content": "You answer in one short sentence."},
    {"role": "user", "content": "Wie heißt die Hauptstadt der Schweiz?"},
    {"role": "assistant", "content": "Bern."},
    {"role": "user", "content": "And its population, roughly?"}]


def counted(torch, kernels, total, fn):
    """fn() with every launch count set to 0 just before and read just
    after; the counts are added into `total`. -> (fn's result, counts)."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return out, counts


def json_prefix_legal(tok, ids) -> bool:
    """Every prefix of the tokens' bytes is legal to the JSON object FSM."""
    from turboinfer_tpu_torch.structured import json_fsm, token_bytes_table
    table = token_bytes_table(tok)
    state = json_fsm.initial(True)
    for t in ids:
        state = (json_fsm.advance_bytes(state, table[t])
                 if 0 <= t < len(table) and table[t] else None)
        if state is None:
            return False
    return True


def conforms(doc) -> bool:
    """doc is TEXT_SCHEMA's object: its three keys in order, a name of at
    most 12 characters, an integer age in [0, 150], a tag of the enum."""
    return (isinstance(doc, dict) and list(doc) == ["name", "age", "tag"]
            and isinstance(doc["name"], str) and len(doc["name"]) <= 12
            and type(doc["age"]) is int and 0 <= doc["age"] <= 150
            and doc["tag"] in ("alpha", "beta", "gamma"))


def text_load(work):
    """(a) of phase 17: the Phi-3-style tokenizer files written and read
    back by from_hf_dir; an HFTokenizer with Phi-3's chat template whose
    encode/decode round-trips a non-ASCII text through byte_fallback."""
    from turboinfer_tpu_torch.tokenizer.hf import HFTokenizer, from_hf_dir
    t0 = time.perf_counter()
    write_phi3_tokenizer(work)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tok = from_hf_dir(work)
    read_s = time.perf_counter() - t0
    need(isinstance(tok, HFTokenizer), f"(a) from_hf_dir gave {tok!r}")
    need(tok.chat_template is not None and not tok.chat_template.is_default
         and tok.chat_template.source == PHI3_CHAT_TEMPLATE,
         "(a) the tokenizer carries no Phi-3 chat template")
    need((tok.vocab_size, tok.bos_id, tok.eos_id) == (32011, 1, 32000),
         f"(a) vocab {tok.vocab_size}, bos {tok.bos_id}, eos {tok.eos_id}")
    ids = tok.encode(PHI3_ROUND_TRIP)
    back = tok.decode(ids)
    need(back == PHI3_ROUND_TRIP, f"(a) round trip gave {back!r}")
    n_bytes = sum(tok.tokens[i].startswith("<0x") for i in ids)
    need(n_bytes > 0, "(a) the round trip took no byte_fallback token")
    say(f"  (a) tokenizer.json + tokenizer_config.json written in {write_s:.2f}"
        f" s (merges learned in pure Python), read in {read_s:.2f} s: "
        f"HFTokenizer, vocab {tok.vocab_size}, Phi-3 chat template; "
        f"{len(PHI3_ROUND_TRIP)} characters -> {len(ids)} tokens ({n_bytes} "
        "byte_fallback) -> the same text")
    return tok, dict(write_s=write_s, read_s=read_s, tokens=len(ids),
                     byte_tokens=n_bytes)


def text_chat_stream(torch, kernels, eng, tok, rand, total, L, out):
    """(b) and (c) of phase 17."""
    msgs = TEXT_MESSAGES
    ids = tok.apply_chat_template(msgs, tokenize=True)
    res, c_chat = counted(torch, kernels, total,
                          lambda: eng.chat(msgs, 32))
    new = res.tokens[len(ids):]
    need(len(new) == 32 and res.text == tok.decode(new),
         "(b) chat: .text is not decode of the new tokens")
    chunks, _ = counted(torch, kernels, total,
                        lambda: list(eng.chat_stream(msgs, 32, burst=8)))
    need([c.token for c in chunks] == new,
         "(b) chat_stream's tokens differ from chat's")
    streamed = "".join(c.text for c in chunks)
    # the stream withholds a trailing incomplete UTF-8 sequence, which
    # decode() shows as U+FFFD
    tail = res.text[len(streamed):]
    need(res.text.startswith(streamed) and set(tail) <= {"�"},
         f"(b) streamed text {streamed!r} != chat text {res.text!r}")
    need(c_chat == expected_launches(L, 31), f"(b) chat launches {c_chat}")
    out["chat"] = dict(prompt_tokens=len(ids), new_tokens=32,
                       total_ms=res.total_time_ms, text_chars=len(res.text))
    say(f"  (b) chat: {len(ids)}-token Phi-3 prompt (system, user, "
        f"assistant, user), 32 new greedy tokens in {res.total_time_ms:.1f} "
        "ms; .text == decode(new tokens); chat_stream's tokens equal, its "
        f"deltas concatenate to the same {len(streamed)} characters")
    # (c) streaming against generate_batch, interleaved
    p = rand(3000)
    runs = {"generate": [], "burst 1": [], "burst 8": []}
    want = None
    for rep in range(2):
        res, counts = counted(torch, kernels, total,
                              lambda: eng.generate(p, 64))
        need(counts == expected_launches(L, 63),
             f"(c) generate launches {counts}")
        want = res.tokens[len(p):]
        runs["generate"].append((res.total_time_ms - res.prefill_time_ms)
                                / 63)
        for burst in (1, 8):
            stamps, toks = [], []

            def stream():
                for ch in eng.generate_stream(p, 64, burst=burst):
                    stamps.append(time.perf_counter())
                    toks.append(ch.token)
            _, counts = counted(torch, kernels, total, stream)
            need(toks == want, f"(c) burst {burst}: stream tokens differ "
                               "from generate's")
            need(counts == expected_launches(L, 63),
                 f"(c) burst {burst} launches {counts}")
            runs[f"burst {burst}"].append((stamps[-1] - stamps[0]) * 1e3
                                          / 63)
    out["stream"] = {k: dict(ms_per_token=v) for k, v in runs.items()}
    say("  (c) prompt 3000, 64 new greedy: generate_stream tokens equal "
        "generate()'s at bursts 1 and 8; ms per token after the first "
        "(interleaved, 2 repeats): " + "; ".join(
            f"{k} {', '.join(f'{x:.3f}' for x in v)}"
            for k, v in runs.items())
        + " (generate: decode ms/step of generate_batch B=1)")


def text_structured(torch, kernels, eng, tok, total, L, out):
    """(d) of phase 17."""
    from turboinfer_tpu_torch.structured import TokenMaskCache
    from turboinfer_tpu_torch.structured.schema_fsm import SchemaFSM
    V = eng.model_config.vocab_size
    masks = {}
    for name, fsm in (("json_object", None),
                      ("schema", SchemaFSM(TEXT_SCHEMA))):
        t0 = time.perf_counter()
        mk = TokenMaskCache(tok, require_object=True, vocab_size=V, fsm=fsm)
        t1 = time.perf_counter()
        row = mk.bias_row(mk.initial(), -1)
        t2 = time.perf_counter()
        masks[name] = dict(trie_s=t1 - t0, first_mask_s=t2 - t1,
                           legal_first=int((row == 0).sum()))
    prompt = tok.apply_chat_template(
        [{"role": "user", "content": "Describe a person as JSON."}],
        tokenize=True)
    res = {}
    for name, rf, budget in (("json_object", "json_object", 64),
                             ("schema", TEXT_RF_SCHEMA, 128)):
        r, counts = counted(torch, kernels, total, lambda: (
            eng.generate_structured(prompt, budget, response_format=rf,
                                    temperature=0.0)))
        new = r.tokens[len(prompt):]
        need(json_prefix_legal(tok, new),
             f"(d) {name}: a prefix is illegal to the JSON FSM")
        need(counts == expected_launches(L, len(new) - 1),
             f"(d) {name}: launches {counts}")
        res[name] = dict(new_tokens=len(new), stop_reason=r.stop_reason,
                         prefill_ms=r.prefill_time_ms,
                         ms_per_token=(r.total_time_ms - r.prefill_time_ms)
                         / max(len(new), 1), text=r.text, **masks[name])
    sch = res["schema"]
    need(sch["stop_reason"] == "stop", f"(d) the schema grammar did not "
         f"finish within 128 tokens ({sch['new_tokens']})")
    doc = json.loads(sch["text"])
    need(conforms(doc), f"(d) schema output does not conform: {doc}")
    out["structured"] = res
    for name, r in res.items():
        say(f"  (d) {name}: {r['new_tokens']} tokens ({r['stop_reason']}), "
            f"every prefix legal; host loop {r['ms_per_token']:.2f} ms/token "
            f"after a {r['prefill_ms']:.1f} ms prefill; TokenMaskCache trie "
            f"{r['trie_s']:.3f} s, first mask {r['first_mask_s'] * 1e3:.2f} "
            f"ms ({r['legal_first']} legal tokens)"
            + (f"; {r['text']!r} parses and conforms" if name == "schema"
               else ""))


def text_beam_scoring(torch, kernels, eng, rand, total, L, out):
    """(e) and (f) of phase 17."""
    cfg = eng.model_config
    p = rand(1000)
    beams, counts = counted(torch, kernels, total, lambda: (
        eng.generate_beam_search(p, 32, beam_size=4, return_all_beams=True)))
    need(counts == expected_launches(L, 31), f"(e) beam launches {counts}")
    need(len(beams) == 4 and all(len(b.tokens) == 1032 for b in beams),
         "(e) wrong beams")
    pen = eng.config.length_penalty
    norm = [sum(b.logprobs) / len(b.logprobs) ** pen for b in beams]
    need(all(a >= b for a, b in zip(norm, norm[1:])),
         f"(e) normalized scores not sorted: {norm}")
    errs = []
    for b in beams:
        lp = eng.compute_logprobs(b.tokens)[len(p):]
        want = sum(lp)
        errs.append(abs(sum(b.logprobs) - want))
        need(errs[-1] <= 0.05 * abs(want), f"(e) a beam's summed logprobs "
             f"{sum(b.logprobs)} vs compute_logprobs {want}")
    greedy = eng.generate(p, 32)
    one = eng.generate_beam_search(p, 32, beam_size=1)
    ties = tokens_or_ties(torch, eng, cfg, [p], [one.tokens], [greedy.tokens],
                          "(e) beam 1 vs greedy")
    step_ms = (beams[0].total_time_ms - greedy.prefill_time_ms) / 31
    # the cache gather of one beam step at this run's widths
    cache = eng._take_cache(4)
    parent = torch.tensor([1, 0, 3, 3], device="cuda")
    n = len(p) + 31
    gather_ms = cuda_ms(torch, lambda i: eng._beam_gather(cache, parent, n),
                        10, graph=False)
    prefix = sum(a[:, :, :, :n].numel() * a.element_size()
                 for a, _ in eng._cache_planes(cache, cache))
    eng._put_cache(4, cache)
    gather_bytes = 4 * prefix   # read and write of the copy, then of the cache
    out["beam"] = dict(ms_per_step=step_ms, total_ms=beams[0].total_time_ms,
                       norm_scores=norm, logprob_sum_errs=errs,
                       gather_ms=gather_ms, gather_bytes=gather_bytes,
                       gather_bound_ms=gather_bytes / HBM_BYTES_PER_S * 1e3,
                       beam1_ties=ties, launches=counts)
    say(f"  (e) beam 4, 32 new on a 1000-token prompt: normalized scores "
        f"sorted {[round(x, 4) for x in norm]}; summed logprobs within "
        f"{max(errs):.4f} of compute_logprobs; beam 1 == greedy generate "
        f"({len(ties)} tie rows); {step_ms:.3f} ms per beam step; the cache "
        f"gather {gather_ms:.4f} device ms, {gather_bytes / 1e9:.3f} GB moved "
        f"(bound {out['beam']['gather_bound_ms']:.4f} ms)")
    # (f) scoring
    q = rand(3436)
    res = eng.generate_batch([q], 64, return_logprobs=True)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp, counts = counted(torch, kernels, total,
                         lambda: eng.compute_logprobs(res.tokens))
    ms = (time.perf_counter() - t0) * 1e3
    need(counts == expected_launches(L, 0), f"(f) launches {counts}")
    need(len(lp) == 3500 and lp[0] == 0.0, "(f) wrong logprobs")
    got = torch.tensor(lp[len(q):])
    want = torch.tensor(res.logprobs)
    err = (got - want).abs().max().item()
    tol = 0.05 * want.abs().max().item()
    need(err <= tol, f"(f) compute_logprobs vs generate_batch logprobs: "
                     f"{err} > {tol}")
    out["scoring"] = dict(tokens=3500, bucket=4096, ms=ms, max_abs_err=err,
                          tol=tol)
    say(f"  (f) compute_logprobs of 3500 tokens (bucket 4096): {ms:.2f} ms; "
        f"its last 64 within {err:.4f} (tol {tol:.3f}) of "
        "generate_batch(return_logprobs=True)'s")


def text_serving(torch, kernels, params, cfg, icfg, tok, gen, total, out):
    """(g) of phase 17."""
    from turboinfer_tpu_torch.engine.scheduler import PagedContinuousScheduler
    L = cfg.num_layers
    lens = (512, 600, 700, 800, 900, 1000, 550, 950)
    prompts = [torch.randint(1, 32000, (n,), generator=gen).tolist()
               for n in lens]
    kinds = ["json_object", "plain", "schema", "plain"] * 2
    budget = {"json_object": 48, "schema": 128, "plain": 96}

    def serve(rows, tokenizer):
        sched = PagedContinuousScheduler(params, cfg, icfg, batch_slots=8,
                                         page_size=256, decode_burst=4,
                                         tokenizer=tokenizer, device="cuda")
        rf = {"json_object": "json_object", "schema": TEXT_RF_SCHEMA}
        rids = [sched.submit(prompts[i], budget[kinds[i]],
                             **({"response_format": rf[kinds[i]]}
                                if kinds[i] in rf else {})) for i in rows]
        steps = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while sched.pending:
            _, counts = counted(torch, kernels, total, sched.step)
            steps.append((counts["paged_attention"], sched._has_structured()))
        wall = time.perf_counter() - t0
        res = sched.run()
        return sched, [res[r] for r in rids], steps, wall
    sched, res, steps, wall = serve(range(8), tok)
    for i, r in enumerate(res):
        new = r.tokens[len(prompts[i]):]
        if kinds[i] == "plain":
            need(len(new) == budget["plain"], f"(g) row {i}: {len(new)} tokens")
            continue
        need(json_prefix_legal(tok, new), f"(g) row {i} ({kinds[i]}): an "
             "illegal JSON prefix")
        if kinds[i] == "schema":
            need(r.stop_reason == "stop", f"(g) row {i}: the schema grammar "
                 f"did not finish ({r.stop_reason})")
            doc = json.loads(tok.decode(new))
            need(conforms(doc), f"(g) row {i}: {doc} does not conform")
    single = [n for n, live in steps if live]
    need(all(n == L for n in single), f"(g) a step with a constrained slot "
         f"live ran {set(single)} paged launches, not one step's {L}")
    need(any(n == 4 * L for n, live in steps if not live),
         "(g) no burst ran after the constrained slots finished")
    n_new = sum(len(r.tokens) - len(p) for r, p in zip(res, prompts))
    plain = [i for i in range(8) if kinds[i] == "plain"]
    _, alone, _, _ = serve(plain, None)
    ties = tokens_or_ties(torch, sched, cfg, [prompts[i] for i in plain],
                          [res[i].tokens for i in plain],
                          [r.tokens for r in alone],
                          "(g) plain rows beside constrained ones")
    need(sched.pool.live_pages == 1, f"(g) {sched.pool.live_pages} pages "
                                     "still live")
    out["serving"] = dict(requests=8, wall_s=wall, req_per_s=8 / wall,
                          tok_per_s=n_new / wall, new_tokens=n_new,
                          steps=len(steps), single_steps_constrained=len(
                              single),
                          burst_steps=sum(n == 4 * L for n, _ in steps),
                          plain_ties=ties,
                          schema_docs=[tok.decode(r.tokens[len(p):])
                                       for r, p, k in zip(res, prompts, kinds)
                                       if k == "schema"])
    say(f"  (g) PagedContinuousScheduler(tokenizer=...), decode_burst=4: 8 "
        f"requests of 500-1000 tokens (2 json_object, 2 schema, 4 plain) in "
        f"{wall:.3f} s, {8 / wall:.2f} req/s, {n_new / wall:.1f} tok/s; "
        f"{len(single)} steps with a constrained slot live, each one decode "
        f"step ({L} paged launches), then "
        f"{out['serving']['burst_steps']} bursts of 4; schema outputs parse "
        f"and conform {out['serving']['schema_docs']}; the plain rows' tokens "
        f"equal a run of them alone ({len(ties)} tie rows)")


def text_vs_plain(torch, cfg, tok, gen, out):
    """(h) of phase 17: at L=1 (Phi-3 has one kind of layer), beam search
    and generate_structured through the kernels against the plain
    versions (the engine on the CPU): tokens equal or tied."""
    from turboinfer_tpu_torch.config import InferenceConfig
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    from turboinfer_tpu_torch.models.common import params_to
    t0 = time.perf_counter()
    cfg2 = cfg.replace(num_layers=1)
    params2 = prepare_params(create_synthetic_quantized_model(
        cfg2, bits=4, group_size=64, device="cuda", seed=1).params)
    icfg = InferenceConfig(max_seq_len=256, temperature=0.0, seed=0,
                           eos_token_id=-1)
    kern = InferenceEngine(params2, cfg2, icfg, tokenizer=tok, device="cuda")
    plain = InferenceEngine(params_to(params2, "cpu"), cfg2, icfg,
                            tokenizer=tok, device="cpu")
    p = torch.randint(1, 32000, (64,), generator=gen).tolist()
    bk, bp = (e.generate_beam_search(p, 6, beam_size=4, return_all_beams=True)
              for e in (kern, plain))
    res = dict(beam_equal=bk[0].tokens == bp[0].tokens)
    if not res["beam_equal"]:
        # a tie: on the plain side the kernels' best beam scores within
        # 5% of the plain best beam
        a = sum(plain.compute_logprobs(bk[0].tokens)[len(p):])
        b = sum(bp[0].logprobs)
        res.update(plain_score_of_kernel_beam=a, plain_best=b)
        need(abs(a - b) <= 0.05 * abs(b), f"(h) beams differ beyond a tie: "
             f"{a} vs {b}")
    sk, sp = (e.generate_structured(p, 12, response_format="json_object",
                                    temperature=0.0) for e in (kern, plain))
    res["structured_ties"] = tokens_or_ties(
        torch, kern, cfg2, [p], [sk.tokens], [sp.tokens],
        "(h) generate_structured kernels vs plain")
    res["seconds"] = time.perf_counter() - t0
    out["vs_plain"] = res
    say(f"  (h) L=1 kernels vs plain (CPU): beam 4 x 6 new top beams "
        f"{'equal' if res['beam_equal'] else 'tied'}; generate_structured "
        f"json_object 12 tokens equal ({len(res['structured_ties'])} tie "
        f"rows); {res['seconds']:.1f} s, the CPU side included")


def phase_text(torch, report):
    """Phase 17: text in and out at Phi-3-mini-4k's full width (int4
    g=64, 8 of the 32 layers, bf16 cache, max_seq 4096, synthetic weights from
    a seed) with the Phi-3-style tokenizer files this script writes: (a)
    from_hf_dir reads them (an HFTokenizer with Phi-3's chat template; a
    non-ASCII round trip); (b) engine.chat on a system/user/assistant/user
    conversation, 32 greedy tokens, .text == decode, chat_stream's deltas
    the same text; (c) generate_stream on a 3000-token prompt, 64 new, at
    bursts 1 and 8: tokens equal generate()'s, ms per token beside
    generate_batch's decode ms/step, interleaved over 2 repeats; (d)
    generate_structured with json_object (every prefix legal) and a JSON
    Schema (finishes within 128 tokens, parses, conforms), host-loop ms
    per token and the first mask's build time; (e) beam search, beam 4,
    32 new on a 1000-token prompt: scores sorted, each beam's summed
    logprobs within 5% of compute_logprobs, a width-1 beam equal to
    greedy generate under the tie rule, ms per beam step and the cache
    gather's device ms and bytes; (f) compute_logprobs of 3500 tokens
    against generate_batch(return_logprobs=True); (g)
    PagedContinuousScheduler(tokenizer=...) with 8 requests (2
    json_object, 2 schema, 4 plain), decode_burst=4: outputs legal and
    conforming, single steps while a constrained slot lives, the plain
    rows equal to a run of them alone, req/s and tok/s; (h) at L=1, beam
    search and generate_structured through the kernels against the
    plain versions. Returns the launches of (b)-(g)."""
    import os
    import shutil
    import jinja2
    from turboinfer_tpu_torch import kernels
    from turboinfer_tpu_torch.config import (InferenceConfig,
                                             phi3_mini_4k_config)
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    # every width; 8 of the 32 layers, so phases 1-20 fit the time limit
    cfg = phi3_mini_4k_config(num_layers=8)
    L, T = cfg.num_layers, cfg.max_seq_len
    say(f"phase 17: text in and out, Phi-3-mini-4k int4 g=64, L={L}, max_seq "
        f"{T}, bf16 cache; jinja2 {jinja2.__version__}")
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "_smoke_files", "text")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = {}
    try:
        tok, out["load"] = text_load(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    params = prepare_params(create_synthetic_quantized_model(
        cfg, bits=4, group_size=64, device="cuda", seed=0).params)
    icfg = InferenceConfig(max_seq_len=T, temperature=0.0, seed=0,
                           eos_token_id=-1, measure_ttft=True)
    eng = InferenceEngine(params, cfg, icfg, tokenizer=tok, device="cuda")
    gen = torch.Generator().manual_seed(17)

    def rand(n):
        return torch.randint(1, 32000, (n,), generator=gen).tolist()
    total = {}
    text_chat_stream(torch, kernels, eng, tok, rand, total, L, out)
    text_structured(torch, kernels, eng, tok, total, L, out)
    text_beam_scoring(torch, kernels, eng, rand, total, L, out)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    text_serving(torch, kernels, params, cfg, icfg, tok, gen, total, out)
    need(all(total[k] > 0 for k in ("qmm_int4", "flash_prefill",
                                    "cache_write_fresh", "decode_attention",
                                    "paged_attention")),
         f"(b)-(g) launches {total}: a kernel of the text paths did not run")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    text_vs_plain(torch, cfg, tok, gen, out)
    out["launches"] = total
    report["text"] = out
    return total


# -- phase 18: the server and the command line -------------------------------

SERVE_LIVE = (500, 500, 500, 500)   # (b): the live decodes' prompt lengths
SERVE_LONG = 3500                   # (b): the prompt admitted while they run
SERVE_CHUNK = 512


def http_json(port, method, path, obj=None, timeout=300):
    """(status, parsed JSON body or text) of one request to 127.0.0.1."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, None if obj is None else json.dumps(obj),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        body = r.read().decode()
        try:
            return r.status, json.loads(body)
        except ValueError:
            return r.status, body
    finally:
        conn.close()


def http_stream(port, path, obj, timeout=300):
    """POST with stream=True, read to the end of the chunked body ->
    (status, [parsed SSE events], seconds to the first event, seconds to
    the end)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t0 = time.perf_counter()
    first = None
    try:
        conn.request("POST", path, json.dumps(dict(obj, stream=True)),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        events, buf = [], b""
        while r.status == 200:
            chunk = r.read1(65536)
            if not chunk:
                break
            buf += chunk
            while b"\n\n" in buf:
                ev, buf = buf.split(b"\n\n", 1)
                if ev.startswith(b"data: "):
                    first = first or time.perf_counter() - t0
                    events.append(ev[6:].decode())
        done = time.perf_counter() - t0
        need(r.status == 200 and events and events[-1] == "[DONE]",
             f"(a) stream {path}: status {r.status}, events {events[-2:]}")
        return r.status, [json.loads(e) for e in events[:-1]], first, done
    finally:
        conn.close()


def counters_zero(torch) -> bool:
    from turboinfer_tpu_torch.kernels import _build
    torch.cuda.synchronize()
    return all(int(b.count_nonzero()) == 0 for b in _build._counters.values())


def serve_http(torch, kernels, params, cfg, tok, gen, total, out):
    """(a) of phase 18."""
    import threading
    from turboinfer_tpu_torch.config import InferenceConfig
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    from turboinfer_tpu_torch.engine.scheduler import PagedContinuousScheduler
    from turboinfer_tpu_torch.models.common import param_bytes
    from turboinfer_tpu_torch.serve import ServingEngine, make_server
    from turboinfer_tpu_torch.structured import json_fsm
    from turboinfer_tpu_torch.tokenizer.stream import IncrementalDecoder
    L = cfg.num_layers
    icfg = InferenceConfig(max_seq_len=cfg.max_seq_len, temperature=0.0,
                           seed=0, eos_token_id=-1)
    lens = (512, 600, 700, 800, 900, 1000, 550, 950)
    prompts = [torch.randint(1, 32000, (n,), generator=gen).tolist()
               for n in lens]
    NEW = 64

    def scheduler():
        return PagedContinuousScheduler(params, cfg, icfg, batch_slots=8,
                                        page_size=256, decode_burst=4,
                                        tokenizer=tok, device="cuda")
    # the same requests through the scheduler alone (no HTTP, no threads)
    ref = scheduler()
    rids = [ref.submit(p, NEW) for p in prompts]
    res = ref.run()
    want = [res[r].tokens for r in rids]
    del ref, res
    gc.collect()
    torch.cuda.empty_cache()
    sched = scheduler()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    beam = InferenceEngine(sched.params, cfg, icfg, tokenizer=tok,
                           device="cuda", params_are_prepared=True)
    torch.cuda.synchronize()
    beam_bytes = torch.cuda.memory_allocated() - mem0
    wbytes = param_bytes(sched.params)
    need(beam_bytes < 0.01 * wbytes, f"(a) the beam engine allocated "
         f"{beam_bytes} bytes beside {wbytes} bytes of weights")
    eng = ServingEngine(sched, tokenizer=tok, model_name="phi3-mini-4k",
                        beam_engine=beam)
    seen = {}                      # prompt -> the serving thread's token ids
    real_pump = eng._pump

    def pump(rid, req):
        seen[tuple(req.prompt)] = list(req.out_tokens)
        real_pump(rid, req)
    eng._pump = pump
    srv = make_server(eng, "127.0.0.1", 0)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        results = [None] * len(prompts)

        def one(i):
            results[i] = http_stream(port, "/v1/completions", {
                "prompt": prompts[i], "max_tokens": NEW, "temperature": 0})
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        got, texts, ttft = [], [], []
        for i, r in enumerate(results):
            need(r is not None, f"(a) request {i} did not finish")
            _, events, first, _ = r
            finish = events[-1]["choices"][0]["finish_reason"]
            need(finish == "length", f"(a) request {i} finished {finish!r}")
            texts.append("".join(e["choices"][0]["text"] for e in events))
            ttft.append(first * 1e3)
            got.append(prompts[i] + seen[tuple(prompts[i])])
            dec = IncrementalDecoder(tok)
            need(texts[i] == "".join(dec.push(t) for t in got[i][len(
                prompts[i]):]), f"(a) request {i}: streamed text is not "
                "the decode of its tokens")
        ties = tokens_or_ties(torch, sched, cfg, prompts, got, want,
                              "(a) HTTP completions vs the scheduler alone")
        n_new = NEW * len(prompts)
        # a chat turn streamed and not, JSON mode, n=2, beam search
        chat = {"messages": TEXT_MESSAGES, "max_tokens": 32,
                "temperature": 0}
        st, events, chat_first, _ = http_stream(
            port, "/v1/chat/completions", chat)
        streamed = "".join(e["choices"][0]["delta"].get("content", "")
                           for e in events)
        st, body = http_json(port, "POST", "/v1/chat/completions", chat)
        need(st == 200 and body["choices"][0]["message"]["content"]
             == streamed, f"(a) chat: streamed {streamed!r} vs {body!r}")
        st, js = http_json(port, "POST", "/v1/chat/completions", {
            "messages": [{"role": "user",
                          "content": "Describe a person as JSON."}],
            "max_tokens": 64, "temperature": 0,
            "response_format": {"type": "json_object"}})
        need(st == 200, f"(a) json_object: {st} {js}")
        jtext = js["choices"][0]["message"]["content"]
        need(js["choices"][0]["finish_reason"] == "stop"
             and isinstance(json.loads(jtext), dict)
             and json_fsm.advance_bytes(json_fsm.initial(True),
                                        jtext.encode()) is not None,
             f"(a) json_object output {jtext!r} does not parse")
        st, nb = http_json(port, "POST", "/v1/completions", {
            "prompt": prompts[0][:300], "max_tokens": 16, "temperature": 0.8,
            "n": 2})
        need(st == 200 and len(nb["choices"]) == 2
             and nb["usage"]["completion_tokens"] == 32,
             f"(a) n=2: {st} {nb}")
        st, bb = http_json(port, "POST", "/v1/completions", {
            "prompt": prompts[1][:300], "max_tokens": 16,
            "use_beam_search": True, "best_of": 4, "n": 2})
        need(st == 200 and len(bb["choices"]) == 2, f"(a) beam: {st} {bb}")
        st, health = http_json(port, "GET", "/health")
        need(st == 200 and health["status"] == "ok", f"(a) /health {health}")
        st, metrics = http_json(port, "GET", "/metrics")
        need(st == 200 and "turboinfer_requests_total" in metrics,
             f"(a) /metrics {metrics!r}")
        finishes = [c["finish_reason"] for b in (body, js, nb, bb)
                    for c in b["choices"]]
        need(all(f in ("stop", "length") for f in finishes),
             f"(a) finish reasons {finishes}")
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        need(counters_zero(torch), "(a) arrival counters left non-zero")
    finally:
        srv.shutdown()
        eng.shutdown()
    out["http"] = dict(
        requests=len(prompts), wall_s=wall, req_per_s=len(prompts) / wall,
        tok_per_s=n_new / wall, ttft_ms=ttft, ttft_p50_ms=pct(ttft, 0.5),
        ttft_p90_ms=pct(ttft, 0.9), ties=ties, chat_text=streamed,
        chat_ttft_ms=chat_first * 1e3, json_object=jtext,
        beam_engine_bytes=beam_bytes, weight_bytes=wbytes,
        requests_total=health["requests"], launches=counts)
    say(f"  (a) HTTP server (PagedContinuousScheduler, 8 slots, 256-token "
        f"pages, decode_burst=4): 8 concurrent streamed completions of "
        f"500-1000 tokens, {NEW} new: {wall:.3f} s, {len(prompts) / wall:.2f} "
        f"req/s, {n_new / wall:.1f} tok/s, client TTFT p50 "
        f"{pct(ttft, 0.5):.1f} ms p90 {pct(ttft, 0.9):.1f} ms; tokens equal to "
        f"the scheduler alone ({len(ties)} tie rows); chat streamed == not "
        f"streamed ({len(streamed)} chars, TTFT {chat_first * 1e3:.1f} ms); "
        f"json_object {jtext!r} parses; n=2 and a 4-beam search answered; "
        f"/health, /metrics; the beam engine added {beam_bytes} bytes beside "
        f"{wbytes / 1e9:.3f} GB of weights; arrival counters zero; launches "
        f"{counts}")


def serve_chunked(torch, kernels, params, cfg, gen, total, out):
    """(b) of phase 18: a 3500-token prompt arrives while 4 requests
    decode, admitted in chunks of 512 and at full width, each at exact
    prompt widths (prefill_bucket=False: 7 chunks) and at the default
    power-of-two buckets (the long prompt in a 4096 slab: 8 chunks, the
    last one all padding)."""
    from turboinfer_tpu_torch.engine.engine import _bucket
    live = [torch.randint(1, 32000, (n,), generator=gen).tolist()
            for n in SERVE_LIVE]
    long = torch.randint(1, 32000, (SERVE_LONG,), generator=gen).tolist()
    # the runs allocate one small cache of the long prompt's width (exact
    # or bucketed): take those blocks from the CUDA allocator once here, so
    # no run's timed steps pay the allocation (otherwise the first run's
    # first chunk does)
    from turboinfer_tpu_torch.models import llama
    widths = {bk: _bucket(SERVE_LONG, bk, cap=cfg.max_seq_len)
              for bk in (False, True)}
    warm = [llama.init_cache(cfg, 1, max_seq=w, device="cuda")
            for w in widths.values()]
    del warm
    runs, ties = {}, {}
    for bucket in (False, True):
        for chunk in (SERVE_CHUNK, 0):
            runs[chunk, bucket] = chunked_run(
                torch, kernels, params, cfg, live, long, chunk, bucket,
                widths[bucket], total)
        ties[bucket] = tokens_or_ties(
            torch, runs[0, bucket].pop("sched"), cfg, live + [long],
            runs[SERVE_CHUNK, bucket]["tokens"], runs[0, bucket]["tokens"],
            f"(b) chunked vs full-width admission, prefill_bucket={bucket}")
        runs[SERVE_CHUNK, bucket].pop("sched")
        gc.collect()

    def summary(bucket):
        full, ch = runs[0, bucket], runs[SERVE_CHUNK, bucket]
        return dict(
            chunk=SERVE_CHUNK, prefill_bucket=bucket, width=widths[bucket],
            chunks=ch["chunks"],
            unchunked_stall_ms=next(st["ms"] for st in full["steps"]
                                    if st["admitted"]),
            longest_chunked_step_ms=max(st["ms"] for st in ch["steps"]
                                        if st["chunk"]),
            decode_step_median_ms=statistics.median(
                st["ms"] for st in full["steps"] if not st["admitted"]),
            ttft_long_chunked_ms=ch["ttft_ms"],
            ttft_long_unchunked_ms=full["ttft_ms"], ties=ties[bucket],
            step_ms_chunked=[st["ms"] for st in ch["steps"]],
            step_ms_unchunked=[st["ms"] for st in full["steps"]],
            launches_chunked=ch["launches"], launches_unchunked=full["launches"])
    out["chunked"] = summary(False)
    out["chunked_bucketed"] = summary(True)
    for bucket in (False, True):
        o = out["chunked_bucketed" if bucket else "chunked"]
        say(f"  (b) prefill_bucket={bucket}: 4 live decodes (prompts "
            f"{SERVE_LIVE[0]}), then a {SERVE_LONG}-token prompt in a "
            f"{o['width']}-wide slab: chunked ({SERVE_CHUNK}) in "
            f"{o['chunks']} chunks, every live row one token a step "
            f"meanwhile, longest chunked step "
            f"{o['longest_chunked_step_ms']:.2f} ms; full-width admission "
            f"stalls one step {o['unchunked_stall_ms']:.2f} ms (decode step "
            f"median {o['decode_step_median_ms']:.2f} ms); the long prompt's "
            f"TTFT {o['ttft_long_chunked_ms']:.1f} ms chunked, "
            f"{o['ttft_long_unchunked_ms']:.1f} ms not; tokens equal "
            f"({len(o['ties'])} tie rows); step ms chunked "
            f"{[round(x, 1) for x in o['step_ms_chunked']]}, not "
            f"{[round(x, 1) for x in o['step_ms_unchunked']]}")


def chunked_run(torch, kernels, params, cfg, live, long, chunk, bucket,
                width, total):
    """One run of (b): the live requests decode 3 steps, then the long
    prompt arrives; every step is timed until all are done."""
    from turboinfer_tpu_torch.config import InferenceConfig
    from turboinfer_tpu_torch.engine.scheduler import \
        ContinuousBatchingScheduler
    icfg = InferenceConfig(max_seq_len=cfg.max_seq_len, temperature=0.0,
                           seed=0, eos_token_id=-1, prefill_bucket=bucket,
                           prefill_chunk=chunk)
    s = ContinuousBatchingScheduler(params, cfg, icfg, batch_slots=5,
                                    device="cuda")
    chunks = [0]
    real = s._adm_advance

    def adv():
        chunks[0] += 1
        real()
    s._adm_advance = adv
    rl = [s.submit(p, 40) for p in live]
    for _ in range(3):
        s.step()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t_sub = time.perf_counter()
    rlong = s.submit(long, 8)
    steps, ttft = [], None
    while s.pending:
        before = [len(s.get_request(r).out_tokens) for r in rl]
        c0 = chunks[0]
        t0 = time.perf_counter()
        s.step()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        after = [len(s.get_request(r).out_tokens) for r in rl]
        adv_ = [a - b for a, b in zip(after, before)]
        first = ttft is None and s.get_request(rlong).out_tokens
        if first:
            ttft = (t1 - t_sub) * 1e3
        steps.append(dict(ms=(t1 - t0) * 1e3, chunk=chunks[0] > c0,
                          admitted=bool(first), live_advance=adv_))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    res = s.run()
    if chunk:
        need(chunks[0] == -(-width // chunk), f"(b) prefill_bucket={bucket}: "
             f"the long prompt admitted in {chunks[0]} chunks, not "
             f"{-(-width // chunk)}")
        mid = [st for st in steps if st["chunk"]]
        need(all(a == 1 for st in mid for a in st["live_advance"]),
             f"(b) prefill_bucket={bucket}: a live row stalled while the "
             f"chunks ran: {[st['live_advance'] for st in mid]}")
    gc.collect()
    return dict(steps=steps, chunks=chunks[0], ttft_ms=ttft,
                tokens=[res[r].tokens for r in rl + [rlong]], sched=s,
                launches=counts)


def serve_speculative(torch, kernels, params, cfg, gen, total, out):
    """(c) of phase 18: speculative_generate with a 2-layer draft of the
    same weights against generate_batch."""
    from turboinfer_tpu_torch.config import InferenceConfig
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    from turboinfer_tpu_torch.engine.speculative import speculative_generate
    icfg = InferenceConfig(max_seq_len=cfg.max_seq_len, temperature=0.0,
                           seed=0, eos_token_id=-1)
    prompts = [torch.randint(1, 32000, (n,), generator=gen).tolist()
               for n in (1000, 1500)]
    eng = InferenceEngine(params, cfg, icfg, device="cuda",
                          params_are_prepared=True)
    want = [r.tokens for r in eng.generate_batch(prompts, 32)]
    res, counts = counted(torch, kernels, total, lambda: speculative_generate(
        params, cfg, first_layers(params, 2), cfg.replace(num_layers=2),
        prompts, 32, k=4, config=icfg))
    ties = tokens_or_ties(torch, eng, cfg, prompts, res.tokens, want,
                          "(c) speculative_generate vs generate_batch")
    ms_round = (res.total_time_ms - res.prefill_ms) / max(res.rounds, 1)
    out["speculative"] = dict(
        acceptance=res.acceptance_rate, tokens_per_round=res.tokens_per_round,
        rounds=res.rounds, total_ms=res.total_time_ms,
        prefill_ms=res.prefill_ms, ms_per_round=ms_round, ties=ties,
        launches=counts)
    say(f"  (c) speculative_generate B=2 (prompts 1000, 1500), 32 new, k=4, "
        f"draft = the first 2 of {cfg.num_layers} layers: acceptance "
        f"{res.acceptance_rate:.3f}, {res.tokens_per_round:.2f} tokens a "
        f"round, {res.rounds} rounds, {ms_round:.2f} ms a round after a "
        f"{res.prefill_ms:.1f} ms prefill of both models; tokens equal to "
        f"generate_batch's ({len(ties)} tie rows)")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_cli_start(torch, work, out):
    """(d) of phase 18, first half: Phi-3-mini at 2 of 32 layers written
    as an HF directory (bf16 shards, config.json, tokenizer files), then
    `python -m turboinfer_tpu_torch generate` and `serve --paged` started
    as subprocesses. Returns what serve_cli_finish needs."""
    import os
    from turboinfer_tpu_torch.config import phi3_mini_4k_config
    from turboinfer_tpu_torch.models import llama
    cfg2 = phi3_mini_4k_config(num_layers=2)
    hf = os.path.join(work, "phi3-l2")
    os.makedirs(hf)
    params = llama.init_params(cfg2, seed=18, device="cuda")
    size, _ = write_hf_checkpoint(hf, phi3_hf_tensors(params, cfg2),
                                  dict(PHI3_MINI_4K_CONFIG_JSON,
                                       num_hidden_layers=2))
    del params
    write_phi3_tokenizer(hf)
    root = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    logs = {n: open(os.path.join(work, f"{n}.log"), "w+")
            for n in ("generate", "serve")}
    cmd = [sys.executable, "-m", "turboinfer_tpu_torch"]
    procs = {
        "generate": subprocess.Popen(
            cmd + ["generate", hf, SERVE_CLI_TEXT, "--greedy",
                   "--max-tokens", "16", "--quiet"], cwd=root,
            stdout=logs["generate"], stderr=subprocess.STDOUT),
        "serve": subprocess.Popen(
            cmd + ["serve", hf, "--paged", "--host", "127.0.0.1", "--port",
                   str(port), "--quiet"], cwd=root,
            stdout=logs["serve"], stderr=subprocess.STDOUT)}
    out["cli"] = dict(hf_bytes=size, port=port)
    t0 = time.perf_counter()
    health = {}

    def poll():
        """The seconds from the server's start to its first /health 200
        (None after 120 s or once the process exited)."""
        while time.perf_counter() - t0 < 120 and procs["serve"].poll() is None:
            try:
                if http_json(port, "GET", "/health", timeout=5)[0] == 200:
                    health["s"] = time.perf_counter() - t0
                    return
            except OSError:
                pass
            time.sleep(0.5)
    import threading
    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    return dict(hf=hf, port=port, procs=procs, logs=logs, health=health,
                poller=poller)


SERVE_CLI_TEXT = "The port answers from the command line, too."


def serve_cli_finish(torch, work, st, out):
    """(d) of phase 18, second half: the generate subprocess printed the
    in-process engine's text; the server answers /health within 120 s and
    one chat completion, then exits 0 on SIGINT; inspect, quantize to
    .tinq and eval of that file run in process through cli.main."""
    import contextlib
    import io
    import os
    import signal
    from turboinfer_tpu_torch import cli
    from turboinfer_tpu_torch.loader import load_engine
    procs, logs, hf, port = st["procs"], st["logs"], st["hf"], st["port"]
    try:
        g = procs["generate"]
        g.wait(timeout=300)
        logs["generate"].seek(0)
        printed = logs["generate"].read()
        need(g.returncode == 0, f"(d) generate exited {g.returncode}: "
                                f"{printed[-2000:]}")
        eng = load_engine(hf, device="cuda")
        ids = eng.encode(SERVE_CLI_TEXT)
        text = eng.decode(eng.generate(ids, 16, temperature=0.0, top_k=50,
                                       top_p=0.9).tokens)
        need(printed.rstrip("\n") == text, f"(d) generate printed "
             f"{printed!r}, the engine gives {text!r}")
        del eng
        s = procs["serve"]
        st["poller"].join(timeout=130)
        t_health = st["health"].get("s")
        need(t_health is not None, f"(d) serve did not answer /health in "
             f"120 s (exit code {s.poll()})")
        code, body = http_json(port, "POST", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "Hello there!"}],
            "max_tokens": 8, "temperature": 0})
        need(code == 200 and body["choices"][0]["finish_reason"] in (
            "stop", "length") and isinstance(
            body["choices"][0]["message"]["content"], str),
            f"(d) serve chat: {code} {body}")
        s.send_signal(signal.SIGINT)
        s.wait(timeout=60)
        logs["serve"].seek(0)
        need(s.returncode == 0, f"(d) serve exited {s.returncode} on SIGINT:"
                                f" {logs['serve'].read()[-2000:]}")
        tinq = os.path.join(work, "phi3-l2.tinq")
        txt = os.path.join(work, "eval.txt")
        with open(txt, "w", encoding="utf-8") as f:
            f.write(PHI3_ROUND_TRIP * 8)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rq = cli.main(["quantize", hf, tinq, "--type", "int4",
                           "--group-size", "64"])
            ri = cli.main(["inspect", tinq])
            mark = len(buf.getvalue())
            re_ = cli.main(["eval", tinq, txt, "--quiet", "--window", "256"])
        printed = buf.getvalue()
        ev = json.loads(printed[mark:].strip().splitlines()[-1])
        need((rq, ri, re_) == (0, 0, 0) and '"int4"' in printed
             and math.isfinite(ev["perplexity"]) and ev["perplexity"] > 0,
             f"(d) quantize/inspect/eval gave {(rq, ri, re_)}: "
             f"{printed[-1500:]}")
        out["cli"].update(generate_text=text, serve_health_s=t_health,
                          serve_chat=body["choices"][0]["message"]["content"],
                          tinq_bytes=os.path.getsize(tinq), eval=ev)
        say(f"  (d) Phi-3-mini L=2 as an HF directory "
            f"({out['cli']['hf_bytes'] / 1e9:.3f} GB): `python -m "
            f"turboinfer_tpu_torch generate` printed the engine's text; "
            f"`serve --paged` answered /health {t_health:.1f} s after its "
            f"start, then a chat completion, and exited 0 on SIGINT; "
            f"quantize -> .tinq ({out['cli']['tinq_bytes'] / 1e6:.1f} MB), "
            f"inspect, eval perplexity {ev['perplexity']:.2f} over "
            f"{ev['tokens']} tokens")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs.values():
            f.close()


def serve_vs_plain(torch, cfg, gen, out):
    """(e) of phase 18: at L=2, chunked admission (a 50-key window: the
    shorter row's padded queries in the last chunk see no key) and
    speculative_generate through the kernels against the plain versions
    on the CPU."""
    import types
    from turboinfer_tpu_torch.config import InferenceConfig
    from turboinfer_tpu_torch.engine.scheduler import \
        ContinuousBatchingScheduler
    from turboinfer_tpu_torch.engine.speculative import speculative_generate
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    from turboinfer_tpu_torch.models import llama
    from turboinfer_tpu_torch.models.common import params_to
    t0 = time.perf_counter()
    cfg2 = cfg.replace(num_layers=2)
    params2 = prepare_params(create_synthetic_quantized_model(
        cfg2, bits=4, group_size=64, device="cuda", seed=1).params)
    cpu = params_to(params2, "cpu")
    cfgw = cfg2.replace(sliding_window=50)
    icfg = InferenceConfig(max_seq_len=1024, temperature=0.0, seed=0,
                           eos_token_id=-1, prefill_chunk=128)
    ps = [torch.randint(1, 32000, (n,), generator=gen).tolist()
          for n in (40, 300, 450)]
    got, logits, ties = {}, {}, 0
    for dev, p in (("cuda", params2), ("cpu", cpu)):
        s = ContinuousBatchingScheduler(p, cfgw, icfg, batch_slots=3,
                                        device=dev)
        seen = []
        real = s._sample_first

        def grab(last, knobs, real=real, seen=seen):
            seen.append(last.float().cpu())
            return real(last, knobs)
        s._sample_first = grab
        r0 = s.submit(ps[0], 4)
        s.step()
        rids = [s.submit(q, 2) for q in ps[1:]]
        s.step()
        need(s._adm is not None and len(s._adm["group"]) == 2,
             "(e) the two prompts did not admit as one chunked group")
        res = s.run()
        got[dev] = [res[r].tokens for r in [r0] + rids]
        logits[dev] = seen[-1]
        for name, t in (("k", s.cache.k), ("v", s.cache.v)):
            need(bool(torch.isfinite(t.float()).all()), f"(e) the {dev} "
                 f"slot cache's {name} holds NaN or inf")
        del s
    agree, ties = logits_agree(
        torch, logits["cuda"], logits["cpu"], "L=2 chunked admission first "
        "tokens (window 50, a padded query with no key)", ties, False, True,
        tag="(e)")
    view = types.SimpleNamespace(_model=llama, params=params2)
    tt = tokens_or_ties(torch, view, cfgw, ps, got["cuda"], got["cpu"],
                        "(e) chunked admission kernels vs plain")
    sps = [torch.randint(1, 32000, (n,), generator=gen).tolist()
           for n in (64, 96)]
    sk = speculative_generate(params2, cfg2, first_layers(params2, 1),
                              cfg2.replace(num_layers=1), sps, 4, k=2,
                              config=icfg)
    sp = speculative_generate(cpu, cfg2, first_layers(cpu, 1),
                              cfg2.replace(num_layers=1), sps, 4, k=2,
                              config=icfg, device="cpu")
    st = tokens_or_ties(torch, types.SimpleNamespace(_model=llama,
                                                     params=params2),
                        cfg2, sps, sk.tokens, sp.tokens,
                        "(e) speculative_generate kernels vs plain")
    out["vs_plain"] = dict(chunked=agree, chunked_ties=tt, spec_ties=st,
                           spec_acceptance=[sk.acceptance_rate,
                                            sp.acceptance_rate],
                           seconds=time.perf_counter() - t0)
    say(f"  (e) L=2 vs plain (CPU): chunked admission in chunks of 128 "
        f"under a 50-key window, tokens equal ({len(tt)} tie rows), both "
        f"slot caches finite; speculative_generate B=2 tokens equal "
        f"(prompts 64, 96, 4 new, k=2; {len(st)} tie rows), acceptance "
        f"{sk.acceptance_rate:.3f} / "
        f"{sp.acceptance_rate:.3f}; {out['vs_plain']['seconds']:.1f} s")


def phase_serve(torch, report):
    """Phase 18: the server and the command line at Phi-3-mini-4k's full
    width (int4 g=64, 16 of the 32 layers, max_seq 4096, synthetic weights from
    a seed, the Phi-3-style tokenizer of phase 17): (a) the HTTP server in
    process over the paged scheduler (8 slots, 256-token pages,
    decode_burst=4) with a beam engine on the scheduler's own weights: 8
    concurrent streamed completions of 500-1000 tokens (64 new) whose
    tokens equal the scheduler alone, a chat turn streamed and not,
    json_object, n=2, a 4-beam search, /health and /metrics; req/s,
    tok/s, client TTFT; (b) chunked admission (512) of a 3500-token
    prompt while 4 requests decode, against full-width admission: step
    ms, stall, TTFT; (c) speculative_generate with a 2-layer draft
    against generate_batch; (d) the command line on Phi-3-mini at 2
    layers written as an HF directory: generate and serve --paged as
    subprocesses, quantize/inspect/eval through cli.main; (e) at L=2,
    chunked admission and speculative_generate against the plain
    versions on the CPU. Returns the launches of (a)-(c)."""
    import os
    import shutil
    from turboinfer_tpu_torch import kernels
    from turboinfer_tpu_torch.config import phi3_mini_4k_config
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    # every width; 16 of the 32 layers (as phase 15), so phases 1-20 fit
    # the time limit
    cfg = phi3_mini_4k_config(num_layers=16)
    L, T = cfg.num_layers, cfg.max_seq_len
    say(f"phase 18: the server and the command line, Phi-3-mini-4k int4 "
        f"g=64, L={L}, max_seq {T}")
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "_smoke_files", "serve")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out, total = {}, {}
    try:
        tok, _ = text_load(work)
        gc.collect()
        torch.cuda.empty_cache()
        params = prepare_params(create_synthetic_quantized_model(
            cfg, bits=4, group_size=64, device="cuda", seed=0).params)
        gen = torch.Generator().manual_seed(18)
        serve_http(torch, kernels, params, cfg, tok, gen, total, out)
        serve_chunked(torch, kernels, params, cfg, gen, total, out)
        serve_speculative(torch, kernels, params, cfg, gen, total, out)
        need(all(total.get(k, 0) > 0 for k in (
            "qmm_int4", "flash_prefill", "cache_write_fresh",
            "decode_attention", "paged_attention")),
            f"(a)-(c) launches {total}: a kernel of the serving paths did "
            "not run")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        # the subprocesses start up while (e)'s CPU side runs
        st = serve_cli_start(torch, work, out)
        try:
            serve_vs_plain(torch, cfg, gen, out)
        finally:
            serve_cli_finish(torch, work, st, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["launches"] = total
    report["serve"] = out
    return total


# -- phase 19: the GPT-2 and NeoX families ---------------------------------

def falcon_scheduler(torch, kernels, params, cfg, gen, report_out):
    """(b) of phase 19: ContinuousBatchingScheduler (the contiguous one,
    8 slots, max_seq the config's) answering 8 greedy requests of
    300-1500 tokens, 32 new each: every request finishes by length,
    every decode step on the decode kernel (group 71), no paged launch;
    the paged scheduler refuses the model at construction (no paged
    forward, as in the JAX package)."""
    from turboinfer_tpu_torch.config import InferenceConfig
    from turboinfer_tpu_torch.engine.scheduler import (
        ContinuousBatchingScheduler, PagedContinuousScheduler)
    T, NEW = cfg.max_seq_len, 32
    icfg = InferenceConfig(max_seq_len=T, temperature=0.0, seed=0,
                           eos_token_id=-1)
    try:
        PagedContinuousScheduler(params, cfg, icfg, batch_slots=2,
                                 page_size=256, device="cuda")
        refused = None
    except NotImplementedError as e:
        refused = str(e)
    need(refused is not None and "forward_paged_decode" in refused,
         "(b) the paged scheduler took a model without a paged forward")
    sched = ContinuousBatchingScheduler(params, cfg, icfg, batch_slots=8,
                                        device="cuda")
    lens = (300, 1500, 700, 1100, 450, 1300, 900, 600)
    reqs = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
            for n in lens]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [sched.submit(r, NEW) for r in reqs]
    res = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    need(all(res[i].finished and res[i].stop_reason == "length"
             and len(res[i].tokens) == len(r) + NEW
             and all(0 <= t < cfg.vocab_size for t in res[i].tokens)
             for i, r in zip(rids, reqs)), "(b) wrong tokens or stop")
    need(counts["decode_attention"] > 0 and counts["flash_prefill"] > 0
         and counts["paged_attention"] == 0
         and counts["decode_attention"] % cfg.num_layers == 0,
         f"(b) launches {counts}")
    out = dict(requests=len(reqs), new_tokens=len(reqs) * NEW, wall_s=wall,
               req_per_s=len(reqs) / wall, tok_per_s=len(reqs) * NEW / wall,
               launches=counts, paged_refused=refused)
    say(f"  (b) contiguous scheduler: 8 requests ({min(lens)}-{max(lens)} "
        f"tokens, {NEW} new) in {wall:.3f} s, {out['req_per_s']:.2f} req/s, "
        f"{out['tok_per_s']:.1f} tok/s; launches {counts}; the paged "
        f"scheduler refuses it ({refused})")
    report_out["scheduler"] = out
    del sched
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def neox_vs_plain(torch, report_out):
    """(d) of phase 19: the kernels against the plain versions at L=1 (a
    depth cut: these bodies have one kind of layer) for four published
    configurations at full width, int4 g=64 from a seed: Falcon-7B (MQA
    71:1, D=64), GPT-2-XL (25 heads of 64; its 50257-wide head fp),
    Pythia-6.9B (rotary_pct 0.25, parallel residual) and BLOOM-7b1 (ALiBi:
    no attention kernel, as in the JAX package), each at B=1: prefill and
    decode-step logits within 5% of max|logit| and phase 11's tie rule,
    the decode step's launches as the body's structure."""
    from turboinfer_tpu_torch.config import (bloom_7b1_config,
                                             falcon7b_config, gpt2_xl_config,
                                             pythia_6_9b_config)
    from turboinfer_tpu_torch.core.qtensor import QTensor
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    from turboinfer_tpu_torch.models import registry
    for label, fn in (("Falcon-7B", falcon7b_config),
                      ("GPT-2-XL", gpt2_xl_config),
                      ("Pythia-6.9B", pythia_6_9b_config),
                      ("BLOOM-7b1", bloom_7b1_config)):
        cfg = fn(num_layers=1)
        attn = 0 if cfg.alibi else 1
        params = prepare_params(create_synthetic_quantized_model(
            cfg, bits=4, group_size=64, device="cuda", seed=1).params)
        # GPT-2's 50257-wide head stays fp (qmm takes N % 8 == 0 only)
        qmm = 4 + isinstance(params["lm_head"], QTensor)
        report_out[f"vs_plain {label}"] = kernels_vs_plain(
            torch, registry.get_model(cfg.architecture), cfg, params,
            lambda B: {"decode_attention": attn, "flash_prefill": 0,
                       "qmm_int4": qmm},
            label, 19, decided_agree=True, batches=((1, [61]),))
        del params
        gc.collect()
        torch.cuda.empty_cache()


def phi2_refused(torch, kernels, report_out):
    """(e) of phase 19: a Phi-2-width model (microsoft/phi-2: 32 heads of
    80, partial rotary 0.4) at L=1 raises on the card, the error naming
    head dim 80 (no kernel instance takes it), and no attention kernel
    launches."""
    from turboinfer_tpu_torch.config import InferenceConfig, phi2_config
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    from turboinfer_tpu_torch.utils.errors import KernelError
    cfg = phi2_config(num_layers=1)
    params = create_synthetic_quantized_model(cfg, bits=4, group_size=64,
                                              device="cuda", seed=2).params
    eng = InferenceEngine(params, cfg, InferenceConfig(
        max_seq_len=cfg.max_seq_len, temperature=0.0, eos_token_id=-1),
        device="cuda")
    kernels.reset_launch_counts()
    try:
        eng.generate_batch([[1, 2, 3, 4, 5]], 4)
        err = None
    except KernelError as e:
        err = str(e)
    counts = kernels.launch_counts()
    need(err is not None and "head dim 80" in err,
         f"(e) Phi-2 (D=80) on the card: {err!r}")
    need(counts["flash_prefill"] == 0 and counts["decode_attention"] == 0,
         f"(e) an attention kernel ran at D=80: {counts}")
    say(f"  (e) Phi-2 width (D=80) refused on the card: {err}")
    report_out["phi2_refused"] = err
    del eng, params
    torch.cuda.empty_cache()


def phase_falcon(torch, report):
    """Phase 19: Falcon-7B (tiiuae/falcon-7b's config.json, as
    config.falcon7b_config transcribes it: 32 layers, hidden 4544, 71
    query heads on one kv head of 64, FFN 18176 GELU, vocab 65024, 2048
    positions, the parallel block, tied embeddings) through
    models/neox.py, int4 g=64, bf16, synthetic weights from a seed, all 32
    layers at published widths: (a) generate_batch B=2, prompts of 1024
    and 1536, 128 new tokens over a model-dtype cache (launch counts of
    the run and of one decode step: every decode step on the group-71
    decode kernel; a traced prefill and 8 traced decode steps; cache bytes
    a token; peak memory); (b) the contiguous scheduler answering 8
    requests, the paged one refusing the model (falcon_scheduler); (c)
    (a) over int8 and fp8 caches, 32 new; (d) at L=1, the kernels against
    the plain versions for Falcon-7B, GPT-2-XL, Pythia-6.9B and BLOOM-7b1
    (neox_vs_plain); (e) a Phi-2-width model refused on the card
    (phi2_refused)."""
    from turboinfer_tpu_torch import kernels
    from turboinfer_tpu_torch.config import falcon7b_config
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    cfg = falcon7b_config()
    L, T = cfg.num_layers, cfg.max_seq_len
    say(f"phase 19: Falcon-7B int4 g=64, L={L}, hidden {cfg.hidden_size}, "
        f"Hq={cfg.num_heads} Hkv={cfg.kv_heads} D={cfg.head_dim_}, FFN "
        f"{cfg.ffn_dim}, V={cfg.vocab_size}, parallel block, max_seq {T}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = prepare_params(create_synthetic_quantized_model(
        cfg, bits=4, group_size=64, device="cuda", seed=0).params)
    torch.cuda.synchronize()
    out = dict(config="falcon-7b int4 g=64 L=32 bf16 max_seq 2048",
               build_s=time.perf_counter() - t0,
               build_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               allocated_gib=torch.cuda.memory_allocated() / 2**30,
               weight_bytes=qtensor_bytes(params))
    say(f"  model built in {out['build_s']:.1f} s: int4 weights "
        f"{out['weight_bytes'] / 1e9:.2f} GB, {out['allocated_gib']:.2f} GiB "
        f"allocated, build peak {out['build_peak_gib']:.2f} GiB")
    gen = torch.Generator().manual_seed(19)

    def rand(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
    prompts = [rand(1024), rand(1536)]
    launches = gemma_batch(torch, kernels, params, cfg, "model",
                           [("(a)", prompts, 128)], out)
    a = out["(a) model"]
    a["cache_bytes_per_token"] = a["cache_bytes"] / (2 * T)
    need(a["cache_bytes_per_token"] == 2 * L * cfg.kv_heads
         * cfg.head_dim_ * 2, f"(a) cache bytes a token "
         f"{a['cache_bytes_per_token']}")
    say(f"  (a) cache {a['cache_bytes_per_token']:.0f} bytes a token (MQA: "
        f"2 x {L} layers x 1 kv head x {cfg.head_dim_} x bf16)")
    falcon_scheduler(torch, kernels, params, cfg, gen, out)
    for kv in KV_KINDS:
        gemma_batch(torch, kernels, params, cfg, kv, [("(c)", prompts, 32)],
                    out, trace=False)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    neox_vs_plain(torch, out)
    phi2_refused(torch, kernels, out)
    report["falcon"] = out
    return launches


# -- phase 20 --------------------------------------------------------------

def deepseek_expected(cfg, U: int, prefills: int, decodes: int,
                      grouped: bool):
    """Launches of DeepSeek's forwards with int4 weights: per forward the
    attention products of every layer (wq, or wq_a and wq_b; wkv_a; wo),
    the dense group's w_gate, w_up and w_down, the MoE layers' shared
    experts (ws_gate, ws_up, ws_down) and the head, on qmm_int4; the
    routed experts U*E a MoE layer on qmm_int4 (the E-loop: every prefill,
    and decode at B > 1) or U a MoE layer on qmm_int4_grouped (B=1
    decode); no attention or cache kernel: MLA and the latent writes are
    torch, as the JAX package runs them in jnp."""
    kd = cfg.first_k_dense_replace
    Lm, E = cfg.num_layers - kd, cfg.num_experts
    attn = (2 if cfg.q_lora_rank else 1) + 2
    shared = 3 if cfg.shared_expert_size else 0
    per_fwd = kd * (attn + 3) + Lm * (attn + shared) + 1
    loop = U * E * Lm
    return want_counts(
        qmm_int4=per_fwd * (prefills + decodes) + loop * prefills
        + (0 if grouped else loop * decodes),
        qmm_int4_grouped=U * Lm * decodes if grouped else 0)


class SharedDeepSeekRouting(SharedRouting):
    """SharedRouting for models/deepseek.py's _route(config, h, router,
    bias): the router bias only selects, so the gates come from the
    router logits alone."""

    def __init__(self):
        from turboinfer_tpu_torch.models import deepseek
        super().__init__(deepseek, "_route")

    def gates(self, config, h, want, router, bias):
        from turboinfer_tpu_torch.models import moe
        return self.mod.gates_at(config, moe.router_logits(h, router), want)


def deepseek_schedulers(torch, kernels, params, cfg, gen, U, report_out):
    """(b) and (c) of phase 20: the contiguous scheduler (4 slots) and the
    paged one over int8 latent pools (4 slots, 256-token pages), each
    answering 4 greedy requests of 300-900 tokens, 4 new; in (c) two of
    them share a 512-token prefix, so the second hits the first's 2
    full pages. Every step runs 4 rows, so the experts take the E-loop;
    no attention, cache or paged kernel launches (MLA is torch); no page
    leaks."""
    from turboinfer_tpu_torch.config import InferenceConfig
    from turboinfer_tpu_torch.engine.scheduler import (
        ContinuousBatchingScheduler, PagedContinuousScheduler)
    T, NEW, PAGE = cfg.max_seq_len, 4, 256

    def rand(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
    system = rand(2 * PAGE)
    runs = (("(b) contiguous", "model", [rand(300), rand(700), rand(500),
                                          rand(900)]),
            ("(c) paged int8", "int8", [system + rand(40), system + rand(200),
                                        rand(600), rand(350)]))
    for label, kv, reqs in runs:
        icfg = InferenceConfig(max_seq_len=T, temperature=0.0, seed=0,
                               eos_token_id=-1, kv_cache_dtype=kv)
        paged = label.startswith("(c)")
        sched = (PagedContinuousScheduler(params, cfg, icfg, batch_slots=4,
                                          page_size=PAGE, device="cuda")
                 if paged else ContinuousBatchingScheduler(
                     params, cfg, icfg, batch_slots=4, device="cuda"))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rids = [sched.submit(r, NEW) for r in reqs]
        res = sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        need(all(res[i].finished and res[i].stop_reason == "length"
                 and len(res[i].tokens) == len(r) + NEW
                 and all(0 <= t < cfg.vocab_size for t in res[i].tokens)
                 for i, r in zip(rids, reqs)), f"{label}: wrong tokens")
        need(counts["qmm_int4"] > 0 and counts["qmm_int4_grouped"] == 0
             and all(v == 0 for k, v in counts.items()
                     if k not in ("qmm_int4", "qmm_int4_grouped")),
             f"{label}: launches {counts}")
        out = dict(requests=len(reqs), new_tokens=len(reqs) * NEW,
                   wall_s=wall, req_per_s=len(reqs) / wall,
                   tok_per_s=len(reqs) * NEW / wall, launches=counts,
                   expert_loop_per_layer=U * cfg.num_experts)
        extra = ""
        if paged:
            c = sched.cache
            need(c.k_pages.dtype == torch.int8
                 and tuple(c.k_pages.shape[2:]) == (1, PAGE, cfg.kv_lora_rank)
                 and tuple(c.v_pages.shape[2:]) == (1, PAGE,
                                                    cfg.qk_rope_head_dim)
                 and c.k_scale_pages is not None,
                 f"(c) latent pools {c.k_pages.shape} {c.v_pages.shape}")
            need(sched.pool.hits == 2, f"(c) prefix hits {sched.pool.hits}, "
                 "want 2 (the shared prefix's 2 full pages)")
            need(sched.pool.live_pages == 1
                 and sched.pool.available == sched.pool.num_pages - 1,
                 f"(c) pages leaked: {sched.pool.live_pages} live")
            out.update(prefix_hits=sched.pool.hits,
                       prefix_misses=sched.pool.misses)
            extra = (f"; int8 latent pools k {tuple(c.k_pages.shape)} v "
                     f"{tuple(c.v_pages.shape)}; prefix hits "
                     f"{sched.pool.hits}; no page leaked")
        say(f"  {label} scheduler: {len(reqs)} requests "
            f"({min(map(len, reqs))}-{max(map(len, reqs))} tokens, {NEW} "
            f"new) in {wall:.3f} s, {out['req_per_s']:.2f} req/s, "
            f"{out['tok_per_s']:.1f} tok/s; launches {counts}{extra}")
        report_out[label] = out
        del sched
        gc.collect()
        torch.cuda.empty_cache()


def moe_variants_vs_plain(torch, report_out):
    """(d) of phase 20 for the MoE variants at L=1 (a depth cut: one kind
    of layer) and published widths, int4 g=64 from a seed, max_seq 256:
    Qwen1.5-MoE-A2.7B (q/k/v biases, 60 experts top-4 with raw gates, the
    shared expert and its gate), Qwen3-30B-A3B (32:4 heads, per-head q/k
    norms, 128 experts top-8) and OLMoE-1B-7B (q/k norms over the whole
    projection, [Hq*D] weights as the checkpoint ships them; 64 experts
    top-8): the contiguous prefill and decode step at B=1 (the grouped
    kernel) and a paged decode (G=1, the grouped kernel) and verify (G=5,
    the E-loop) over a 256-token pool, kernels on the card against the
    plain versions on the CPU, the CPU taking the card's experts
    (SharedRouting): within 5% of max|logit| and phase 11's tie rule."""
    from turboinfer_tpu_torch.config import (olmoe_1b_7b_config,
                                             qwen1_5_moe_a2_7b_config,
                                             qwen3_30b_a3b_config)
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    from turboinfer_tpu_torch.models import moe
    for label, fn in (("Qwen1.5-MoE-A2.7B", qwen1_5_moe_a2_7b_config),
                      ("Qwen3-30B-A3B", qwen3_30b_a3b_config),
                      ("OLMoE-1B-7B", olmoe_1b_7b_config)):
        cfg = fn(num_layers=1, max_seq_len=256)
        L = cfg.num_layers
        params = create_synthetic_quantized_model(
            cfg, bits=4, group_size=64, device="cuda", seed=3).params
        lw = params["layers"]
        g = torch.Generator(device="cuda").manual_seed(4)
        if cfg.qk_norm:
            whole = cfg.architecture == "olmoe"
            for k, h in (("q_norm", cfg.num_heads), ("k_norm", cfg.kv_heads)):
                n = h * cfg.head_dim_ if whole else cfg.head_dim_
                lw[k] = (1.0 + 0.2 * torch.randn((L, n), generator=g,
                                                 device="cuda")).to(
                    torch.bfloat16)
        params = prepare_params(params)
        with SharedRouting(moe) as shared:
            res = report_out[f"vs_plain {label}"] = kernels_vs_plain(
                torch, moe, cfg, params,
                lambda B: {"qmm_int4_grouped": 2 * L, "decode_attention": L},
                label, 20, decided_agree=True, batches=((1, [61]),))
            res.update(paged_vs_plain(torch, cfg, params, None, PAGE=64,
                                      T=256, lens=(200,), decided_agree=True,
                                      mod=moe))
        bound = FLIP_SHARE * shared.tokens
        res["routing_flips"] = [shared.flips, shared.tokens]
        say(f"  (d) {label}: {shared.flips} of {shared.tokens} layer x token "
            f"routings differed (bound {bound:.1f})")
        need(shared.flips <= bound, f"{label} (d): {shared.flips} of "
             f"{shared.tokens} routings differ, beyond {bound:.1f}")
        del params, lw
        gc.collect()
        torch.cuda.empty_cache()


def phase_deepseek(torch, report):
    """Phase 20: DeepSeek-V2-Lite (config.deepseek_v2_lite_config: 27
    layers, hidden 2048, 16 heads, MLA with kv_lora_rank 512 and
    nope/rope/v head dims 128/64/128, 64 experts top-6 of width 1408 plus
    two shared experts, the first layer dense, vocab 102400) through
    models/deepseek.py at full width and depth, int4 g=64, bf16,
    synthetic weights from a seed (gate and up drawn fused), max_seq
    2048 (softmax chunks of 512 keys): (a) generate_batch B=1, a
    1024-token prompt, 64 new tokens (launch counts of the run and of
    one decode step taken under sync debug mode "error": the routed
    experts on the grouped kernel, G=6; a traced decode; prefill ms,
    ms/step wall and device, kernels a step; cache bytes a token, 31104
    exactly), then a prefill and a decode step over an int8 latent cache
    (15768 bytes a token); (b) the contiguous scheduler and (c) the paged one over int8
    latent pools with a shared prefix (deepseek_schedulers); (d) at L=2
    (the dense layer and one MoE layer), the kernels against the plain
    versions (B=1 prefill and decode step) under shared routing, then
    the MoE variants at L=1 (moe_variants_vs_plain)."""
    from turboinfer_tpu_torch import kernels
    from turboinfer_tpu_torch.config import (InferenceConfig,
                                             deepseek_v2_lite_config)
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    from turboinfer_tpu_torch.kernels.dispatch import prepare_params
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    from turboinfer_tpu_torch.models import deepseek
    T = 2048
    cfg = deepseek_v2_lite_config(max_seq_len=T)
    L, E = cfg.num_layers, cfg.num_experts
    say(f"phase 20: DeepSeek-V2-Lite int4 g=64, L={L} (1 dense + {L - 1} "
        f"MoE), hidden {cfg.hidden_size}, {cfg.num_heads} heads, MLA "
        f"kv_lora_rank {cfg.kv_lora_rank} (softmax chunks of "
        f"{deepseek.chunk_size(T)}), {E} experts top-"
        f"{cfg.experts_per_token} + {cfg.shared_expert_size} shared, "
        f"V={cfg.vocab_size}, max_seq {T}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = prepare_params(create_synthetic_quantized_model(
        cfg, bits=4, group_size=64, device="cuda", seed=0,
        fused_experts=True).params)
    torch.cuda.synchronize()
    U = 2 if "we_gateup" in params["layers"] else 3
    out = dict(config=f"deepseek-v2-lite int4 g=64 L={L} E={E} top-6 bf16 "
               f"max_seq {T}", U=U, build_s=time.perf_counter() - t0,
               build_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               allocated_gib=torch.cuda.memory_allocated() / 2**30,
               weight_bytes=qtensor_bytes(params))
    say(f"  model built in {out['build_s']:.1f} s: int4 weights "
        f"{out['weight_bytes'] / 1e9:.2f} GB, {out['allocated_gib']:.2f} GiB "
        f"allocated, build peak {out['build_peak_gib']:.2f} GiB; {U} expert "
        f"products an expert")
    gen = torch.Generator().manual_seed(20)
    prompt = torch.randint(1, cfg.vocab_size, (1024,), generator=gen).tolist()
    for kv in ("model", "int8"):
        eng = InferenceEngine(params, cfg, InferenceConfig(
            max_seq_len=T, temperature=0.0, seed=0, eos_token_id=-1,
            measure_ttft=True, kv_cache_dtype=kv), device="cuda")
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        path_logits(torch, eng, [prompt])
        stats = dict(path_launches=kernels.launch_counts())
        want = deepseek_expected(cfg, U, 1, 1, True)
        need(stats["path_launches"] == want, f"(a) {kv}: a prefill and a "
             f"decode step launched {stats['path_launches']}, want {want}")
        if kv == "model":
            res, counts, run = run_counted(torch, kernels, eng, [prompt], 64,
                                           "(a) B=1 greedy")
            want = deepseek_expected(cfg, U, 1, 63, True)
            need(counts == want, f"(a): launch counts {counts} != {want}")
            need(len(res[0].tokens) == 1024 + 64, "(a): wrong tokens")
            stats.update(run)
        stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        cache = eng._take_cache(1)
        stats["cache_bytes_per_token"] = cache_bytes(cache) / T
        eng._put_cache(1, cache)
        per_tok = (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * L * (
            2 if kv == "model" else 1) + (8 * L if kv == "int8" else 0)
        need(stats["cache_bytes_per_token"] == per_tok == {
            "model": 31104, "int8": 15768}[kv],
             f"(a) {kv}: cache bytes a token {stats['cache_bytes_per_token']}")
        if kv == "model":
            stats["step_launches"] = sync_free_step(
                torch, kernels, eng, prompt,
                deepseek_expected(cfg, U, 0, 1, True))
            stats["decode_trace"] = trace_decode(torch, eng, [prompt])
        say(f"  (a) {kv} cache: launches as expected; "
            f"{stats['cache_bytes_per_token']:.0f} bytes a token; peak "
            f"{stats['peak_gib']:.2f} GiB")
        out[f"(a) {kv}"] = stats
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    deepseek_schedulers(torch, kernels, params, cfg, gen, U, out)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg2 = deepseek_v2_lite_config(num_layers=2, max_seq_len=256)
    p2 = prepare_params(create_synthetic_quantized_model(
        cfg2, bits=4, group_size=64, device="cuda", seed=1,
        fused_experts=True).params)
    with SharedDeepSeekRouting() as shared:
        res = out["vs_plain DeepSeek-V2-Lite"] = kernels_vs_plain(
            torch, deepseek, cfg2, p2, lambda B: deepseek_expected(
                cfg2, U, 0, 1, B == 1), "DeepSeek-V2-Lite", 20,
            decided_agree=True, batches=((1, [61]),))
    res["routing_flips"] = [shared.flips, shared.tokens]
    need(shared.flips <= FLIP_SHARE * shared.tokens,
         f"DeepSeek (d): {shared.flips} of {shared.tokens} routings differ")
    say(f"  (d) DeepSeek-V2-Lite: {shared.flips} of {shared.tokens} layer x "
        "token routings differed")
    del p2
    gc.collect()
    torch.cuda.empty_cache()
    moe_variants_vs_plain(torch, out)
    report["deepseek"] = out
    return out["(a) model"]["launches"]


# -- phase 21 --------------------------------------------------------------

TP_7B = dict(L=32, B=4, S=512, NEW=32, T=1024)
TP_SMALL_L = 4
TP_TIMEOUT_S = 900


def tp_prompts(torch, vocab, B, S, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(1, vocab, (B, S), generator=gen).tolist()


def tp_requests(torch, vocab):
    """(c)'s 8 requests: 4 on a shared 256-token prefix, 4 alone."""
    gen = torch.Generator().manual_seed(23)
    prefix = torch.randint(1, vocab, (256,), generator=gen).tolist()
    reqs = []
    for i in range(8):
        n = 64 + 24 * i
        tail = torch.randint(1, vocab, (n,), generator=gen).tolist()
        reqs.append((prefix + tail if i % 2 == 0 else tail, 12))
    return reqs


def tp_engine_7b(torch, L, mesh=None, T=1024):
    from turboinfer_tpu_torch.config import InferenceConfig, llama7b_config
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    cfg = llama7b_config(num_layers=L, max_seq_len=T)
    params = create_synthetic_quantized_model(
        cfg, bits=4, group_size=64, device="cuda", seed=0).params
    eng = InferenceEngine(params, cfg, InferenceConfig(
        max_seq_len=T, temperature=0.0, seed=0, eos_token_id=-1,
        measure_ttft=True), device="cuda", mesh=mesh)
    del params
    torch.cuda.empty_cache()
    return eng, cfg


def tp_mixtral(torch, mesh=None):
    from turboinfer_tpu_torch.config import InferenceConfig, mixtral_config
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    cfg = mixtral_config(num_layers=2, max_seq_len=1024)
    params = create_synthetic_quantized_model(
        cfg, bits=4, group_size=64, device="cuda", seed=0).params
    eng = InferenceEngine(params, cfg, InferenceConfig(
        max_seq_len=1024, temperature=0.0, seed=0, eos_token_id=-1,
        measure_ttft=True), device="cuda", mesh=mesh)
    del params
    torch.cuda.empty_cache()
    return eng, cfg


def tp_paged(torch, L, mesh=None):
    from turboinfer_tpu_torch.config import InferenceConfig, llama7b_config
    from turboinfer_tpu_torch.engine.scheduler import PagedContinuousScheduler
    from turboinfer_tpu_torch.loader.synthetic import \
        create_synthetic_quantized_model
    cfg = llama7b_config(num_layers=L, max_seq_len=1024)
    params = create_synthetic_quantized_model(
        cfg, bits=4, group_size=64, device="cuda", seed=0).params
    s = PagedContinuousScheduler(params, cfg, InferenceConfig(
        max_seq_len=1024, temperature=0.0, seed=0, eos_token_id=-1,
        kv_cache_dtype="int8"), batch_slots=4, page_size=64, device="cuda",
        mesh=mesh)
    rids = [s.submit(p, n, temperature=0.0) for p, n in tp_requests(
        torch, cfg.vocab_size)]
    t0 = time.perf_counter()
    out = s.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return ([out[r].tokens for r in rids], s.pool.live_pages,
            s.pool.hits, secs)


def collective_host_ms(prof, steps):
    """Host ms a step in the c10d collectives of a profiler trace (their
    own CPU time, the gloo host copies of CUDA tensors included)."""
    per = {}
    for e in prof.key_averages():
        if e.key.startswith("c10d::") or "gloo" in e.key:
            per[e.key] = e.cpu_time_total / 1e3 / steps
    return per


def tp_rank_main(rank, world, store, out_path):
    """One of the two ranks of phase 21 (spawned; both on cuda:0, gloo)."""
    import pickle
    import traceback
    import torch
    out = {}
    try:
        from turboinfer_tpu_torch import kernels
        from turboinfer_tpu_torch.kernels import _build
        from turboinfer_tpu_torch.parallel import comm, mesh as pmesh
        _build.library()                     # built by phase 1: loads it
        pmesh.initialize_distributed("gloo", "file://" + store, world, rank,
                                     timeout_s=TP_TIMEOUT_S)
        tp = pmesh.make_mesh((1, 2), device="cuda:0")
        # (a) 7B int4 L=32, TP=2
        p = TP_7B
        eng, cfg = tp_engine_7b(torch, p["L"], tp, p["T"])
        prompts = tp_prompts(torch, cfg.vocab_size, p["B"], p["S"], 21)
        tokens, seq_lens, _ = eng._pad_batch(prompts)
        lg, cache = eng._run_prefill(tokens, seq_lens,
                                     eng._take_cache(p["B"]))
        out["a_logits"] = lg.float().cpu()  # the trace decodes from here
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        c0 = comm.calls
        res = eng.generate_batch(prompts, p["NEW"], temperature=0.0)
        out["a_launches"] = kernels.launch_counts()
        out["a_collectives"] = comm.calls - c0
        out["a_tokens"] = [r.tokens for r in res]
        steps = -(-p["NEW"] // 32) * 32 - 1
        out["a_prefill_ms"] = res[0].prefill_time_ms
        out["a_ms_per_step"] = ((res[0].total_time_ms
                                 - res[0].prefill_time_ms) / steps)
        from torch.profiler import ProfilerActivity, profile
        B = p["B"]
        state = dict(tok=lg.argmax(-1).to(torch.int32), cache=cache)
        torch.cuda.synchronize()
        n = 4
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                g, state["cache"] = eng._decode_step(state["tok"],
                                                     state["cache"])
                state["tok"] = g.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
        from torch.autograd import DeviceType
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        out["a_trace"] = dict(
            wall_ms_per_step=wall,
            device_ms_per_step=sum(e.time_range.elapsed_us()
                                   for e in dev) / 1e3 / n,
            kernels_per_step=len(dev) / n,
            collective_host_ms_per_step=collective_host_ms(prof, n))
        eng._put_cache(B, state["cache"])
        del eng, state, cache
        torch.cuda.empty_cache()
        # (b) data parallel on a (2, 1) mesh, L=4
        dp = pmesh.make_mesh((2, 1), device="cuda:0")
        eng, cfg = tp_engine_7b(torch, TP_SMALL_L, dp)
        rows = tp_prompts(torch, cfg.vocab_size, 4, 256, 22)
        kernels.reset_launch_counts()
        out["b_tokens"] = [r.tokens for r in eng.generate_batch(
            rows, 16, temperature=0.0)]
        out["b_launches"] = kernels.launch_counts()
        del eng
        torch.cuda.empty_cache()
        # (c) the paged scheduler, TP=2, int8 pool, L=4
        kernels.reset_launch_counts()
        (out["c_tokens"], out["c_live_pages"], out["c_hits"],
         out["c_s"]) = tp_paged(torch, TP_SMALL_L, tp)
        out["c_launches"] = kernels.launch_counts()
        torch.cuda.empty_cache()
        # (d) Mixtral-8x7B under EP=2 at 2 of 32 layers
        eng, cfg = tp_mixtral(torch, tp)
        one = tp_prompts(torch, cfg.vocab_size, 1, 256, 24)
        four = tp_prompts(torch, cfg.vocab_size, 4, 128, 25)
        for key, ps, new in (("d1", one, 16), ("d4", four, 8)):
            kernels.reset_launch_counts()
            res = eng.generate_batch(ps, new, temperature=0.0)
            out[key + "_launches"] = kernels.launch_counts()
            out[key + "_tokens"] = [r.tokens for r in res]
            out[key + "_ms_per_step"] = (res[0].total_time_ms
                                         - res[0].prefill_time_ms) / 31
        del eng
        torch.cuda.empty_cache()
        out["counters_zero"] = counters_zero(torch)
        import torch.distributed as dist
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:                       # noqa: BLE001
        out["error"] = traceback.format_exc()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def tp_ties(torch, eng, cfg, prompts, got, want, label, kv_dtype=None):
    """tokens_or_ties's rule for a TP=2 run against the one-rank run:
    where a row first differs, the one-rank logits at the wanted prefix
    (read back through a kv_dtype cache when given) put both tokens
    within TIE_ULPS bf16 ulps of max|logit|; at most MAX_TIE_ROWS rows."""
    ties = []
    for b, (g, w) in enumerate(zip(got, want)):
        need(len(g) == len(w), f"{label} row {b}: {len(g)} tokens, want "
                               f"{len(w)}")
        if g == w:
            continue
        i = next(j for j in range(len(w)) if g[j] != w[j])
        x = torch.tensor([w[:i]], dtype=torch.int32, device="cuda")
        if kv_dtype is None:
            lg = eng._model.forward_no_cache(eng.params, cfg, x)[0, -1]
        else:
            cache = eng._model.init_cache(cfg, 1, max_seq=i, dtype=kv_dtype,
                                          device="cuda")
            lg = eng._model.forward(eng.params, cfg, x, cache)[0][0, -1]
        lg = lg.float()
        ref = lg.abs().max().item()
        gap = abs(lg[g[i]].item() - lg[w[i]].item())
        tie_gap = TIE_ULPS * BF16_ULP * 2.0 ** math.floor(math.log2(ref))
        need(gap <= tie_gap, f"{label} row {b}: token {i - len(prompts[b])} "
             f"differs ({g[i]} vs {w[i]}) beyond a tie: one-rank logit gap "
             f"{gap} > {tie_gap}")
        ties.append(dict(row=b, new_token=i - len(prompts[b]), gap=gap,
                         tie_gap=tie_gap))
    need(len(ties) <= MAX_TIE_ROWS, f"{label}: {len(ties)} tie rows")
    say(f"  {label}: tokens equal to the one-rank run"
        + (f" but {len(ties)} tie row(s) {ties}" if ties else ""))
    return ties


def tp_spawn(torch, work):
    """Both ranks of phase 21 on cuda:0 (one spawn); their results."""
    import pickle
    import torch.multiprocessing as tmp
    ctx = tmp.get_context("spawn")
    paths = [f"{work}/rank{r}.pkl" for r in range(2)]
    procs = [ctx.Process(target=tp_rank_main,
                         args=(r, 2, f"{work}/store", paths[r]))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(TP_TIMEOUT_S)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    secs = time.perf_counter() - t0
    outs = []
    for path in paths:
        try:
            with open(path, "rb") as f:
                outs.append(pickle.load(f))
        except OSError:
            outs.append({"error": "no results"})
    errs = [o["error"] for o in outs if "error" in o]
    need(not hung and not errs and all(p.exitcode == 0 for p in procs),
         f"phase 21 ranks: exit codes {[p.exitcode for p in procs]}, "
         f"{'hung ' if hung else ''}{errs}")
    return outs, secs


def tp_local_kernels(torch, out):
    """(f): the rank-local shapes of (a)'s TP=2 (M=4 products on a half of
    each projection, decode attention over 16 of the 32 heads), each
    against its plain version, timed by CUDA-graph replay as phase 2
    times its rows, beside its bound and library call."""
    import torch.nn.functional as F
    rows = []
    check_qmm(torch, rows, {}, shapes=[
        ("wqkv t2", 4096, 6144), ("wo t2", 2048, 4096),
        ("w_gateup t2", 4096, 11008), ("w_down t2", 5504, 4096),
        ("lm_head t2", 4096, 16000)], Ms=(4,), record=False)
    check_decode(torch, F, rows, {}, 4, 16, 16, 1024, 128,
                 [513, 530, 600, 1024], record=False)
    out["local_kernels"] = rows


def phase_tp(torch, report):
    """Phase 21: tensor, data and expert parallelism, two ranks on one
    card over gloo (both on cuda:0), held against the one-rank runs of
    the same seeds on the same card."""
    import os
    import shutil
    import tempfile
    import torch.distributed as dist
    from turboinfer_tpu_torch import kernels
    from turboinfer_tpu_torch.parallel import comm, mesh as pmesh
    say("phase 21: TP=2 / DP / EP on two ranks sharing cuda:0 (gloo)")
    out = {}
    p = TP_7B
    gc.collect()
    torch.cuda.empty_cache()
    # the one-rank references, same seeds, on this card
    eng7, cfg7 = tp_engine_7b(torch, p["L"], None, p["T"])
    prompts = tp_prompts(torch, cfg7.vocab_size, p["B"], p["S"], 21)
    tokens, seq_lens, _ = eng7._pad_batch(prompts)
    cache = eng7._take_cache(p["B"])
    ref_logits, cache = eng7._run_prefill(tokens, seq_lens, cache)
    eng7._put_cache(p["B"], cache)
    ref_logits = ref_logits.float().cpu()
    res, counts, stats = run_counted(torch, kernels, eng7, prompts,
                                     p["NEW"], "(a) one rank, 7B L=32 B=4",
                                     temperature=0.0)
    want_a = [r.tokens for r in res]
    out["a_one_rank"] = stats
    eng4, cfg4 = tp_engine_7b(torch, TP_SMALL_L)
    rows = tp_prompts(torch, cfg4.vocab_size, 4, 256, 22)
    want_b = [r.tokens for r in eng4.generate_batch(rows, 16,
                                                     temperature=0.0)]
    want_c, live1, hits1, secs1 = tp_paged(torch, TP_SMALL_L)
    engm, cfgm = tp_mixtral(torch)
    one = tp_prompts(torch, cfgm.vocab_size, 1, 256, 24)
    four = tp_prompts(torch, cfgm.vocab_size, 4, 128, 25)
    want_d1 = [r.tokens for r in engm.generate_batch(one, 16,
                                                      temperature=0.0)]
    want_d4 = [r.tokens for r in engm.generate_batch(four, 8,
                                                      temperature=0.0)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="tp_", dir=os.path.dirname(
        os.path.abspath(__file__)))
    try:
        outs, spawn_s = tp_spawn(torch, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    r0, r1 = outs
    say(f"  the two ranks ran (a)-(d) in {spawn_s:.1f} s (spawn, build and "
        "the one-card gloo collectives included)")
    for key in ("a_tokens", "b_tokens", "c_tokens", "d1_tokens",
                "d4_tokens"):
        need(r0[key] == r1[key], f"{key}: the two ranks' tokens differ")
    # (a)
    gap = (r0["a_logits"] - ref_logits).abs().max().item()
    ref = ref_logits.abs().max().item()
    want = expected_launches(p["L"], decode_forwards=p["NEW"] - 1)
    for r, o in enumerate(outs):
        need(o["a_launches"] == want, f"(a) rank {r} launches "
             f"{o['a_launches']} != {want}")
    say(f"  (a) TP=2 7B L=32 B=4: prefill logits vs one rank max_abs_err "
        f"{gap:.4g} (max|logit| {ref:.4g}, {gap / ref:.3g} of it); launches "
        f"per rank as TP=1: {want}; {r0['a_collectives']} collectives a "
        f"rank in the run")
    need(gap <= 5e-2 * ref, f"(a) TP=2 logits {gap} off the one-rank run")
    out["a_ties"] = tp_ties(torch, eng7, cfg7, prompts, r0["a_tokens"],
                            want_a, "(a) TP=2 vs one rank")
    tr = r0["a_trace"]
    say(f"  (a) rank 0: prefill {r0['a_prefill_ms']:.1f} ms, "
        f"{r0['a_ms_per_step']:.3f} ms/step (one rank: "
        f"{stats['prefill_ms']:.1f} ms, {stats['decode_ms_per_step']:.3f}); "
        f"traced decode {tr['wall_ms_per_step']:.3f} ms/step wall on "
        f"{tr['device_ms_per_step']:.3f} device ms, "
        f"{tr['kernels_per_step']:.1f} kernels; collectives' host ms/step "
        f"{tr['collective_host_ms_per_step']}")
    out["a"] = dict(logit_gap=gap, max_abs_logit=ref, launches=want,
                    rank0=dict((k, r0[k]) for k in (
                        "a_prefill_ms", "a_ms_per_step", "a_trace",
                        "a_collectives")),
                    rank1=dict((k, r1[k]) for k in (
                        "a_prefill_ms", "a_ms_per_step", "a_trace")))
    # (b), (c), (d)
    out["b_ties"] = tp_ties(torch, eng4, cfg4, rows, r0["b_tokens"], want_b,
                            "(b) DP (2, 1) L=4 vs one rank")
    need(r0["c_live_pages"] == 1 == live1, f"(c) pages held after the run: "
         f"{r0['c_live_pages']} (one rank {live1})")
    reqs = tp_requests(torch, cfg4.vocab_size)
    out["c_ties"] = tp_ties(torch, eng4, cfg4, [q for q, _ in reqs],
                            r0["c_tokens"], want_c,
                            "(c) paged TP=2 int8 pool L=4 vs one rank",
                            kv_dtype=torch.int8)
    say(f"  (c) prefix hits {r0['c_hits']} (one rank {hits1}), no page "
        f"leaked; {r0['c_s']:.2f} s (one rank {secs1:.2f})")
    out["d1_ties"] = tp_ties(torch, engm, cfgm, one, r0["d1_tokens"],
                             want_d1, "(d) EP=2 Mixtral L=2 B=1 vs one rank")
    out["d4_ties"] = tp_ties(torch, engm, cfgm, four, r0["d4_tokens"],
                             want_d4, "(d) EP=2 Mixtral L=2 B=4 vs one rank")
    want_d1l = moe_expected(2, 4, 2, 1, 31, grouped=True)
    need(r0["d1_launches"] == want_d1l, f"(d) B=1 rank launches "
         f"{r0['d1_launches']} != {want_d1l}")
    need(r0["counters_zero"] and r1["counters_zero"],
         "arrival counters not back at zero on a rank")
    say(f"  (d) per rank: B=1 {r0['d1_launches']} (the grouped kernel over "
        f"the rank's local slots), B=4 {r0['d4_launches']} (the E-loop over "
        f"4 local experts)")
    out.update(b_launches=r0["b_launches"], c_launches=r0["c_launches"],
               d1_launches=r0["d1_launches"], d4_launches=r0["d4_launches"],
               spawn_s=spawn_s)
    del eng4, engm
    torch.cuda.empty_cache()
    # (e) an NCCL group of world size 1 drives the 7B at L=2
    store = tempfile.mkdtemp(prefix="nccl_", dir=os.path.dirname(
        os.path.abspath(__file__)))
    try:
        pmesh.initialize_distributed("nccl", f"file://{store}/s", 1, 0,
                                     timeout_s=120)
        m = pmesh.make_mesh((1, 1), device="cuda:0")
        e2, c2 = tp_engine_7b(torch, 2, m)
        e2n, _ = tp_engine_7b(torch, 2, None)
        ps = tp_prompts(torch, c2.vocab_size, 4, 128, 26)
        c0 = comm.calls
        kernels.reset_launch_counts()
        got = [r.tokens for r in e2.generate_batch(ps, 8, temperature=0.0)]
        cm = kernels.launch_counts()
        kernels.reset_launch_counts()
        ref_t = [r.tokens for r in e2n.generate_batch(ps, 8,
                                                      temperature=0.0)]
        need(got == ref_t and cm == kernels.launch_counts()
             and comm.calls == c0, "(e) a (1, 1) NCCL mesh changed the "
             "tokens, the launches or issued a collective")
        x = torch.arange(8, dtype=torch.float32, device="cuda:0")
        dist.all_reduce(x)
        parts = [torch.empty_like(x)]
        dist.all_gather(parts, x)
        dist.barrier()
        torch.cuda.synchronize()
        need(torch.equal(parts[0], torch.arange(8., device="cuda:0")),
             "(e) NCCL all_reduce/all_gather of one rank changed data")
        say(f"  (e) NCCL world of 1 ({dist.get_backend()}): the L=2 engine "
            "on a (1, 1) mesh gives the mesh-less tokens and launches with "
            "no collective; all_reduce, all_gather and barrier ran")
        out["e"] = dict(backend=dist.get_backend(), launches=cm)
        del e2, e2n
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    # (f) the rank-local kernel shapes
    tp_local_kernels(torch, out)
    del eng7
    torch.cuda.empty_cache()
    report["tp"] = out
    return r0["a_launches"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,"
                            "19,20,21")
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
        ptxas = _build.BUILD_INFO.get("ptxas", {})
        for name, rep in ptxas.items():
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", rep)]
            spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                                 rep) if int(b)]
            say(f"  ptxas {name}: {len(regs)} kernels, <= {max(regs or [0])} "
                f"registers; {len(spills)} spill (max {max(spills or [0])} "
                f"bytes stored)")
        for line in qmm_tc_ptxas(ptxas.get("qmm_tc.cu", "")):
            say(f"  ptxas qmm_tc.cu {line}")
        for line in flash_ptxas(ptxas):
            say(f"  ptxas {line}")
        for line in qmm_a8_ptxas(ptxas.get("qmm_a8.cu", "")):
            say(f"  ptxas qmm_a8.cu {line}")
        for line in merge_kernels_ptxas(ptxas):
            say(f"  ptxas {line}")
        for line in encode_write_ptxas(ptxas.get("cache_write.cu", "")):
            say(f"  ptxas cache_write.cu {line}")
        report["env"] = dict(card=smi, torch=torch.__version__,
                             cuda=torch.version.cuda, build_s=build_s,
                             ptxas=ptxas)
        phase_s = report["phase_s"] = {}

        def run(n, fn, default=None):
            """Phase n (fn(torch, report)) if selected, timed."""
            if n not in phases:
                return default
            t = time.perf_counter()
            out = fn(torch, report)
            phase_s[n] = time.perf_counter() - t
            say(f"  phase {n} took {phase_s[n]:.1f} s")
            return out
        results = run(2, phase_kernels, {})
        main_launches = run(3, phase_main, {})
        run(4, phase_path_vs_plain)
        run(5, phase_tiny)
        paged_launches = run(6, phase_serving, {})
        run(7, phase_speculative)
        moe_launches = run(8, phase_mixtral, {})
        gptoss_launches = run(9, phase_gptoss, {})
        kv_launches = run(10, phase_kvcache, {})
        w8_launches = run(11, phase_int8_weights, {})
        a8_launches = run(12, phase_w4a8, {})
        gemma2_launches = run(13, phase_gemma2, {})
        gemma3_launches = run(14, phase_gemma3, {})
        phi3_launches = run(15, phase_phi3, {})
        files_launches = run(16, phase_loader, {})
        text_launches = run(17, phase_text, {})
        serve_launches = run(18, phase_serve, {})
        falcon_launches = run(19, phase_falcon, {})
        deepseek_launches = run(20, phase_deepseek, {})
        tp_launches = run(21, phase_tp, {})
    except (SmokeError, RuntimeError, ValueError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(dict(report, error=str(e)), f, indent=1)
        return 1

    # launches: each kernel's count from the run of its path, the paged
    # kernel from phase 6's serving run, the grouped qmm from phase 8(a)'s
    # Mixtral B=1 run, the encode-and-write kernel from phase 10(a)'s int8
    # run, qmm_int8 from phase 11(a)'s greedy run and qmm_int8_grouped
    # from 11(c)'s Mixtral int8 B=1 run, the others from phase 3's;
    # launches_gptoss from phase 9(a)'s GPT-OSS B=1 run,
    # launches_int8_cache from phase 10(a)'s int8 run,
    # launches_int8_weights from phase 11 (a) and (c); the W4A8 kernels
    # from phase 12 (a)'s first greedy run with the env set, and
    # launches_w4a8 from that run for every kernel; launches_gemma2 from
    # phase 13 (a)'s run (windowed and softcapped flash and decode),
    # launches_gemma3 from phase 14 (a)'s (head dim 256), launches_phi3
    # from phase 15 (a)'s (head dim 96), launches_files from phase 16
    # (a)'s run of the Phi-3 model loaded from its HF files,
    # launches_text from phase 17 (b)-(g) (chat, streaming, structured,
    # beam search, scoring and constrained serving), launches_serve from
    # phase 18 (a)-(c) (the HTTP server, chunked admission and
    # speculative_generate), launches_falcon from phase 19 (a) (Falcon-7B
    # through the NeoX body: every decode on the group-71 decode kernel),
    # launches_deepseek from phase 20 (a) (DeepSeek-V2-Lite B=1, every
    # decode step's routed experts on the grouped kernel at G=6),
    # launches_tp from phase 21 (a) (rank 0 of the 7B's TP=2 run: the
    # same kernels as one rank, at the rank's shapes)
    kern = []
    for name in kernels.wrappers():
        r = results.get(name, {})
        path = {"paged_attention": paged_launches,
                "qmm_int4_grouped": moe_launches,
                "kv_encode_write": kv_launches,
                "qmm_int8": w8_launches,
                "qmm_int8_grouped": w8_launches,
                "a8_quantize_rows": a8_launches,
                "qmm_int4_a8": a8_launches}.get(name, main_launches)
        kern.append({"name": name, "route": "cuda", "source": SOURCES[name],
                     "replaces": ROOT_REPLACES[name],
                     "launches": path.get(name, 0),
                     "launches_paged_serving": paged_launches.get(name, 0),
                     "launches_gptoss": gptoss_launches.get(name, 0),
                     "launches_int8_cache": kv_launches.get(name, 0),
                     "launches_int8_weights": w8_launches.get(name, 0),
                     "launches_w4a8": a8_launches.get(name, 0),
                     "launches_gemma2": gemma2_launches.get(name, 0),
                     "launches_gemma3": gemma3_launches.get(name, 0),
                     "launches_phi3": phi3_launches.get(name, 0),
                     "launches_files": files_launches.get(name, 0),
                     "launches_text": text_launches.get(name, 0),
                     "launches_serve": serve_launches.get(name, 0),
                     "launches_falcon": falcon_launches.get(name, 0),
                     "launches_deepseek": deepseek_launches.get(name, 0),
                     "launches_tp": tp_launches.get(name, 0),
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
