"""Command line: python -m turboinfer_tpu_torch <command> (counterpart of
turboinfer_tpu/cli.py).

Commands:
  generate   load a model file and generate text
  chat       interactive chat REPL (chat template + streaming)
  serve      OpenAI-compatible HTTP server (continuous batching + SSE)
  quantize   model file -> INT8/INT4 TINQ checkpoint
  inspect    print a model file's metadata/tensor inventory
  eval       perplexity of a model over a text file
  bench      the port's benchmark (not written yet: exits 2)

Every command that runs a model runs it on the GPU; `--device cpu` asks
for the plain PyTorch versions on the CPU instead. `serve --tp N` runs
as N processes, one a GPU:

  torchrun --nproc-per-node N -m turboinfer_tpu_torch serve MODEL --tp N

(NCCL, rank r on cuda:LOCAL_RANK; with --device cpu, gloo). Rank 0
answers HTTP; the other ranks replay its plans (serve/engine.follow).
Pipeline and context parallelism (--pp-stages, --context-parallel above
1) are not ported yet and exit 2.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

_MESH = ("pipeline and context parallelism are not ported yet (ROADMAP "
         "§1 item 13, the next slice): {flag} must be 1")


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the hand-written kernels) or cpu "
                        "(their plain PyTorch versions)")


def _refuse_mesh(args, flags=("pp_stages", "context_parallel")) -> bool:
    """Print why and return True if a flag of a mode not ported yet asks
    for > 1 device."""
    for flag in flags:
        if getattr(args, flag, 1) > 1:
            name = "--" + flag.replace("_", "-")
            print(_MESH.format(flag=name), file=sys.stderr)
            return True
    return False


def cmd_generate(args):
    import turboinfer_tpu_torch as ti
    if _refuse_mesh(args):
        return 2
    ti.initialize(enable_logging=not args.quiet)
    engine_kw = {"lora": args.lora} if args.lora else {}
    eng = ti.load_model(args.model, device=args.device, **engine_kw)
    # the command prints TTFT, so pay the one prefill->decode sync
    eng.config = dataclasses.replace(eng.config, measure_ttft=True)
    tokens = eng.encode(args.prompt)
    res = eng.generate(tokens, args.max_tokens,
                       temperature=0.0 if args.greedy else args.temperature,
                       top_k=args.top_k, top_p=args.top_p)
    print(eng.decode(res.tokens))
    if not args.quiet:
        print(f"[{len(res.tokens) - len(tokens)} tokens, "
              f"{res.tokens_per_second:.1f} tok/s, "
              f"TTFT {res.prefill_time_ms:.0f} ms]", file=sys.stderr)
    return 0


def cmd_chat(args):
    """Interactive multi-turn REPL through the checkpoint's chat
    template; the assistant's reply streams token by token."""
    import turboinfer_tpu_torch as ti
    ti.initialize(enable_logging=not args.quiet)
    eng = ti.load_model(args.model, device=args.device)
    messages = []
    if args.system:
        messages.append({"role": "system", "content": args.system})
    tpl = getattr(eng.tokenizer, "chat_template", None)
    if not args.quiet:
        kind = ("checkpoint template" if tpl is not None
                and not tpl.is_default else "ChatML fallback")
        print(f"[chat: {kind}; empty line or Ctrl-D to exit]",
              file=sys.stderr)
    while True:
        try:
            user = input("> ").strip()
        except EOFError:
            break
        if not user:
            break
        messages.append({"role": "user", "content": user})
        parts = []
        for c in eng.chat_stream(messages, args.max_tokens,
                                 temperature=args.temperature):
            if c.text:
                print(c.text, end="", flush=True)
                parts.append(c.text)
        print()
        messages.append({"role": "assistant", "content": "".join(parts)})
    return 0


def _serve_mesh(args):
    """(mesh, None) for `serve --tp N` under torchrun (the default group
    joined: NCCL on the GPUs, gloo with --device cpu), (None, None) at
    --tp 1, (None, 2) when the processes are not there."""
    if args.tp <= 1:
        return None, None
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != args.tp:
        print(f"serve --tp {args.tp} runs as {args.tp} processes: torchrun "
              f"--nproc-per-node {args.tp} -m turboinfer_tpu_torch serve "
              f"MODEL --tp {args.tp} (WORLD_SIZE is {world})",
              file=sys.stderr)
        return None, 2
    from turboinfer_tpu_torch.parallel import mesh as pmesh
    rank = int(os.environ["RANK"])
    cpu = args.device == "cpu"
    device = ("cpu" if cpu else f"cuda:{os.environ.get('LOCAL_RANK', rank)}"
              if args.device == "cuda" else args.device)
    pmesh.initialize_distributed("gloo" if cpu else "nccl", args.dist_init,
                                 world, rank)
    return pmesh.make_mesh((1, args.tp), device=device), None


def cmd_serve(args):
    """OpenAI-compatible HTTP server over continuous batching; rank 0 of
    `--tp N` serves, the other ranks follow its plans."""
    import turboinfer_tpu_torch as ti
    if _refuse_mesh(args):
        return 2
    mesh, rc = _serve_mesh(args)
    if rc is not None:
        return rc
    try:
        return _serve(args, ti, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def _serve(args, ti, mesh):
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    from turboinfer_tpu_torch.engine.scheduler import (
        ContinuousBatchingScheduler, PagedContinuousScheduler)
    from turboinfer_tpu_torch.loader import loader as loader_mod
    from turboinfer_tpu_torch.serve import ServingEngine, serve_forever
    from turboinfer_tpu_torch.serve.engine import follow
    ti.initialize(enable_logging=not args.quiet and
                  (mesh is None or mesh.rank == 0))
    # a rank reads the file to the host and keeps its own slice
    host = "cpu" if mesh is not None else args.device
    data = loader_mod.load_model_data(args.model, device=host)
    if args.lora:
        # a LoRA fine-tune: the adapter rides the scheduler's params
        # through the runtime low-rank path (quantized bases included)
        from turboinfer_tpu_torch.loader import lora as lora_mod
        data.params = lora_mod.apply_lora(data.params, lora_mod.load_lora(
            args.lora, data.config, device=host))
    cfg = ti.InferenceConfig(max_seq_len=args.max_seq_len
                             or data.config.max_seq_len,
                             kv_cache_dtype=args.kv_cache_dtype)
    if data.tokenizer is not None and hasattr(data.tokenizer, "eos_id"):
        cfg = dataclasses.replace(cfg, eos_token_id=data.tokenizer.eos_id)
    cls = PagedContinuousScheduler if args.paged \
        else ContinuousBatchingScheduler
    kw = dict(batch_slots=args.slots, max_queue=args.max_queue,
              decode_burst=args.burst, device=args.device, mesh=mesh)
    if args.paged:
        kw["page_size"] = args.page_size
    if args.draft_model:
        draft = loader_mod.load_model_data(args.draft_model, device=host)
        kw.update(draft_params=draft.params, draft_config=draft.config,
                  spec_k=args.spec_k)
    sched = cls(data.params, data.config, cfg, tokenizer=data.tokenizer,
                **kw)
    # n-best beam search on the batch path (`use_beam_search`): an engine
    # SHARING the scheduler's prepared weights (no second copy); its jobs
    # run on the serving serving thread
    beam_eng = InferenceEngine(sched.params, data.config, cfg,
                               tokenizer=data.tokenizer, device=args.device,
                               params_are_prepared=True, mesh=mesh)
    if mesh is not None and mesh.rank != 0:
        follow(sched, mesh, beam_eng)
        return 0
    eng = ServingEngine(sched, tokenizer=data.tokenizer,
                        model_name=args.served_name
                        or os.path.basename(os.path.normpath(args.model)),
                        beam_engine=beam_eng, mesh=mesh)
    tp = f", tp {mesh.tp}" if mesh is not None else ""
    print(f"serving {eng.model_name} on http://{args.host}:{args.port}/v1 "
          f"({args.slots} slots{', paged' if args.paged else ''}, "
          f"{args.device}{tp})", file=sys.stderr, flush=True)
    serve_forever(eng, args.host, args.port, verbose=not args.quiet)
    return 0


def cmd_quantize(args):
    from turboinfer_tpu_torch.config import QuantizationConfig, QuantType
    from turboinfer_tpu_torch.quant.quantizer import quantize_model_file
    cfg = QuantizationConfig(type=QuantType(args.type),
                             scale_method=args.scale_method,
                             group_size=args.group_size,
                             symmetric=not args.asymmetric,
                             calibration_samples=args.calibration_samples,
                             calibration_max_len=args.calibration_max_len)
    quantize_model_file(args.input, args.output, cfg,
                        calibrate=args.calibrate, device=args.device)
    print(f"wrote {args.output}")
    return 0


def cmd_inspect(args):
    from turboinfer_tpu_torch.loader import gguf, loader, safetensors, tinq
    fmt = loader.detect_format(args.model)
    print(f"format: {fmt}")
    if fmt == "gguf":
        with gguf.read_gguf(args.model) as gf:
            print(f"tensors: {len(gf.tensors)}")
            for k, v in sorted(gf.metadata.items()):
                if isinstance(v, list) and len(v) > 8:
                    v = f"[{len(v)} items]"
                print(f"  {k} = {v}")
            if args.tensors:
                for name, info in gf.tensors.items():
                    tname = gguf.GGML_TYPE_NAMES.get(info.ggml_type, "?")
                    print(f"  {name}: {info.shape} {tname}")
    elif fmt == "safetensors":
        with safetensors.read_safetensors(args.model) as sf:
            print(f"tensors: {len(sf.entries)}")
            for name, ent in sf.entries.items():
                print(f"  {name}: {ent['shape']} {ent['dtype']}")
    elif fmt == "tinq":
        params, config, qcfg, meta = tinq.load(args.model, device=args.device)
        from turboinfer_tpu_torch.loader.mapping import config_to_dict
        print(json.dumps({"config": config_to_dict(config),
                          "quantization": None if qcfg is None else
                          qcfg.type.value, "metadata": meta}, indent=2))
    else:
        print("cannot inspect this format")
        return 1
    return 0


def cmd_eval(args):
    """Perplexity of a model over a text file (or stdin).

    The text is tokenized once and scored in windows of --window tokens
    advancing by --stride (stride < window gives each scored token more
    context); only each window's tokens not scored before count, so
    every token is counted once."""
    import math
    import time

    import turboinfer_tpu_torch as ti
    ti.initialize(enable_logging=not args.quiet)
    eng = ti.load_model(args.model, device=args.device)
    if args.text_file == "-":
        text = sys.stdin.read()
    else:
        with open(args.text_file, encoding="utf-8") as f:
            text = f.read()
    tokens = eng.encode(text)
    if len(tokens) < 2:
        print("need at least 2 tokens to score", file=sys.stderr)
        return 1
    # prompts must stay strictly under max_seq_len
    window = min(args.window or eng.config.max_seq_len - 1,
                 eng.config.max_seq_len - 1)
    stride = args.stride or window
    if not 0 < stride <= window:
        print("--stride must be in (0, window]", file=sys.stderr)
        return 1
    total_lp, count = 0.0, 0
    t0 = time.perf_counter()
    start = 0
    while start < len(tokens) - 1:
        end = min(start + window, len(tokens))
        lps = eng.compute_logprobs(tokens[start:end])
        # position 0 of a window is a context-free 0.0 placeholder, so at
        # least it is skipped; later windows skip their overlap
        first = 1 if start == 0 else max(1, window - stride)
        total_lp += sum(lps[first:])
        count += len(lps) - first
        if end == len(tokens):
            break
        start = end - (window - stride)
    dt = time.perf_counter() - t0
    ppl = math.exp(-total_lp / max(count, 1))
    print(json.dumps({
        "tokens": len(tokens), "scored": count,
        "avg_logprob": total_lp / max(count, 1),
        "perplexity": ppl, "seconds": round(dt, 3),
        "tokens_per_second": round(len(tokens) / dt, 1),
    }))
    return 0


def cmd_bench(args):
    print("the port has no benchmark yet (ROADMAP §1 items 6-7); "
          "chip_smoke.py drives and times every path on the GPU",
          file=sys.stderr)
    return 2


def main(argv=None):
    ap = argparse.ArgumentParser(prog="turboinfer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="generate text from a model file")
    g.add_argument("model")
    g.add_argument("prompt")
    g.add_argument("--max-tokens", type=int, default=50)
    g.add_argument("--temperature", type=float, default=0.8)
    g.add_argument("--top-k", type=int, default=50)
    g.add_argument("--top-p", type=float, default=0.9)
    g.add_argument("--greedy", action="store_true")
    g.add_argument("--lora", default=None, metavar="ADAPTER",
                   help="PEFT LoRA adapter dir/file applied at runtime "
                        "(works on quantized bases)")
    g.add_argument("--context-parallel", type=int, default=1, metavar="N",
                   help="not ported yet (the next slice): values above 1 "
                        "exit 2")
    g.add_argument("--quiet", action="store_true")
    _add_device(g)
    g.set_defaults(fn=cmd_generate)

    c = sub.add_parser("chat", help="interactive chat (checkpoint's "
                                    "chat template, streamed replies)")
    c.add_argument("model")
    c.add_argument("--system", default=None, help="system prompt")
    c.add_argument("--max-tokens", type=int, default=256)
    c.add_argument("--temperature", type=float, default=0.7)
    c.add_argument("--quiet", action="store_true")
    _add_device(c)
    c.set_defaults(fn=cmd_chat)

    s = sub.add_parser("serve", help="OpenAI-compatible HTTP server "
                                     "(continuous batching + streaming)")
    s.add_argument("model")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--slots", type=int, default=8)
    s.add_argument("--burst", type=int, default=4)
    s.add_argument("--paged", action="store_true",
                   help="paged KV cache + prefix caching")
    s.add_argument("--page-size", type=int, default=64)
    s.add_argument("--max-seq-len", type=int, default=None)
    s.add_argument("--kv-cache-dtype", dest="kv_cache_dtype",
                   choices=["model", "bf16", "fp8", "int8"],
                   default="model",
                   help="KV-cache storage dtype; int8/fp8 halve the "
                        "cache's memory (2x slots or context)")
    s.add_argument("--max-queue", type=int, default=256,
                   help="waiting-request cap before 429s")
    s.add_argument("--pp-stages", type=int, default=1,
                   help="not ported yet (the next slice): values above 1 "
                        "exit 2")
    s.add_argument("--tp", type=int, default=1,
                   help="tensor/expert parallel degree: run under torchrun "
                        "--nproc-per-node N (one GPU a rank)")
    s.add_argument("--dist-init", default="env://", dest="dist_init",
                   help="torch.distributed init_method of --tp ranks "
                        "(default env://, as torchrun sets it)")
    s.add_argument("--context-parallel", type=int, default=1,
                   metavar="N", dest="context_parallel",
                   help="not ported yet (the next slice): values above 1 "
                        "exit 2")
    s.add_argument("--draft-model", default=None,
                   help="speculative decoding: small draft model file; "
                        "each scheduler step proposes --spec-k tokens "
                        "and verifies them in one target pass")
    s.add_argument("--spec-k", type=int, default=4,
                   help="draft tokens proposed per speculative round")
    s.add_argument("--lora", default=None, metavar="ADAPTER",
                   help="serve a LoRA fine-tune: PEFT adapter dir/file "
                        "applied through the scheduler's params")
    s.add_argument("--served-name", default=None)
    s.add_argument("--quiet", action="store_true")
    _add_device(s)
    s.set_defaults(fn=cmd_serve)

    q = sub.add_parser("quantize", help="quantize a model to TINQ")
    q.add_argument("input")
    q.add_argument("output")
    q.add_argument("--type", choices=["int8", "int4"], default="int4")
    q.add_argument("--group-size", type=int, default=64)
    q.add_argument("--asymmetric", action="store_true")
    q.add_argument("--scale-method", choices=["absmax", "mse"],
                   default="absmax",
                   help="mse: per-group clipping-threshold search "
                        "(lower quantization error)")
    q.add_argument("--calibrate", action="store_true",
                   help="activation-calibrated scales: run the fp "
                        "model over calibration sequences and weight "
                        "the scale search by per-channel activation "
                        "moments (llama family)")
    q.add_argument("--calibration-samples", type=int, default=128)
    q.add_argument("--calibration-max-len", type=int, default=512)
    _add_device(q)
    q.set_defaults(fn=cmd_quantize)

    i = sub.add_parser("inspect", help="print model file metadata")
    i.add_argument("model")
    i.add_argument("--tensors", action="store_true")
    _add_device(i)
    i.set_defaults(fn=cmd_inspect)

    e = sub.add_parser("eval", help="perplexity over a text file")
    e.add_argument("model")
    e.add_argument("text_file", help="UTF-8 text file, or - for stdin")
    e.add_argument("--window", type=int, default=None,
                   help="scoring window in tokens (default: model max)")
    e.add_argument("--stride", type=int, default=None,
                   help="window advance; < window adds context overlap")
    e.add_argument("--quiet", action="store_true")
    _add_device(e)
    e.set_defaults(fn=cmd_eval)

    b = sub.add_parser("bench", help="the port's benchmark (not written "
                                     "yet: exits 2)")
    b.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
