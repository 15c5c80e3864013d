"""One rank of the port's multi-rank CPU tests (tests/test_torch_tp.py).

The test spawns `world` of these with torch.multiprocessing: each joins
a gloo group through a file:// store, builds the (data, tp) mesh, runs
the job's cases through the port's entry points on the CPU and writes
its results (numpy arrays, token lists) to out_<rank>.pkl. It imports
the port only: the test computes the JAX package's side itself.

A case: {"name", "cfg": ModelConfig kwargs, "params": a numpy tree in
bridge.params_from_numpy's format, "icfg": InferenceConfig kwargs,
"ops": [(op, args...)], optionally "dtype": "bfloat16" (default f32)}; in
place of "params", "draw": (seed, bits) has each rank draw the weights
(the port's init_params from the seed on the CPU, quantized g=64);
the ops are listed in run_op. The job's "device" is every rank's
("cpu", "cuda:0" for ranks that share one card, "cuda:{rank}" for a card
a rank) and its "backend" the group's ("gloo" unless "nccl" is asked
for). make_mesh makes a rank's card its current device.
"""

import os
import pickle
import sys
import time
import traceback

import numpy as np
import torch


def _config(case):
    from turboinfer_tpu_torch.config import ModelConfig
    return ModelConfig(dtype=getattr(torch, case.get("dtype", "float32")),
                       **case["cfg"])


def _params(case, cfg):
    from turboinfer_tpu_torch import bridge
    if "draw" not in case:
        return bridge.params_from_numpy(case["params"], device="cpu")
    from turboinfer_tpu_torch.config import QuantizationConfig, QuantType
    from turboinfer_tpu_torch.models import registry
    from turboinfer_tpu_torch.quant.quantizer import quantize_params
    seed, bits = case["draw"]
    p = registry.get_model(cfg.architecture).init_params(cfg, seed=seed,
                                                         device="cpu")
    return quantize_params(p, QuantizationConfig(
        type=QuantType.INT4 if bits == 4 else QuantType.INT8, group_size=64))


def _engine(case, mesh, params=None, **kw):
    from turboinfer_tpu_torch import bridge
    from turboinfer_tpu_torch.config import InferenceConfig
    from turboinfer_tpu_torch.engine.engine import InferenceEngine
    cfg = _config(case)
    if params is None:
        params = _params(case, cfg)
    return InferenceEngine(params, cfg, InferenceConfig(**case["icfg"]),
                           mesh=mesh, device="cpu", **kw)


def _scheduler(case, mesh, paged, draft, kw):
    from turboinfer_tpu_torch import bridge
    from turboinfer_tpu_torch.config import InferenceConfig, ModelConfig
    from turboinfer_tpu_torch.engine.scheduler import (
        ContinuousBatchingScheduler, PagedContinuousScheduler)
    cfg = _config(case)
    params = bridge.params_from_numpy(case["params"], device="cpu")
    extra = {}
    if draft is not None:
        extra = dict(draft_params=bridge.params_from_numpy(draft["params"],
                                                           device="cpu"),
                     draft_config=ModelConfig(dtype=torch.float32,
                                              **draft["cfg"]),
                     spec_k=2)
    cls = PagedContinuousScheduler if paged else ContinuousBatchingScheduler
    return cls(params, cfg, InferenceConfig(**case["icfg"]), mesh=mesh,
               device="cpu", **kw, **extra)


def run_op(case, op, mesh, state):
    """The result of one op: tokens, logits or a check's outcome."""
    from turboinfer_tpu_torch.parallel import comm
    kind = op[0]
    if kind in ("batch", "sample", "logits", "beam", "logprobs", "stream",
                "launches"):
        if "engine" not in state:
            state["engine"] = _engine(case, mesh)
        eng = state["engine"]
    if kind == "batch":                      # greedy generate_batch
        _, prompts, n = op
        return [r.tokens for r in eng.generate_batch(prompts, n,
                                                      temperature=0.0)]
    if kind == "launches":                   # greedy, with kernel counts
        from turboinfer_tpu_torch import kernels
        _, prompts, n = op
        kernels.reset_launch_counts()
        toks = [r.tokens for r in eng.generate_batch(prompts, n,
                                                      temperature=0.0)]
        return toks, kernels.launch_counts()
    if kind == "sample":                     # sampled: ranks must agree
        _, prompts, n = op
        return [r.tokens for r in eng.generate_batch(
            prompts, n, temperature=0.9, top_k=40, top_p=0.95)]
    if kind == "sample_vs_one":              # sampled, mesh and one rank
        _, prompts, n, icfg = op
        c = dict(case, icfg={**case["icfg"], **icfg})
        params = _params(case, _config(case))
        return [[r.tokens for r in _engine(c, m, params=params).generate_batch(
            prompts, n, temperature=0.9, top_k=40, top_p=0.95)]
            for m in (mesh, None)]
    if kind == "logits":                     # cacheless forward logits
        toks = torch.from_numpy(np.asarray(op[1], np.int32))
        return eng._model.forward_no_cache(
            eng.params, eng.model_config, toks.to(eng.device)).float().cpu(
            ).numpy()
    if kind == "beam":
        _, prompt, n, beams = op
        return [r.tokens for r in eng.generate_beam_search(
            prompt, n, beam_size=beams, return_all_beams=True)]
    if kind == "logprobs":
        return eng.compute_logprobs(op[1])
    if kind == "stream":
        _, prompt, n = op
        return [c.token for c in eng.generate_stream(prompt, n,
                                                     temperature=0.0)]
    if kind == "sched":                      # (sched, paged, reqs, kw, draft)
        _, paged, reqs, kw, draft = op
        s = _scheduler(case, mesh, paged, draft, kw)
        rids = [s.submit(p, n, temperature=0.0) for p, n in reqs]
        out = s.run()
        res = [out[r].tokens for r in rids]
        if paged:      # every page back but the trash page (no leak)
            res.append(("live_pages", s.pool.live_pages))
        return res
    if kind == "ckpt":                       # save on rank 0, restore sliced
        from turboinfer_tpu_torch import bridge
        from turboinfer_tpu_torch.kernels.dispatch import prepare_params
        from turboinfer_tpu_torch.loader import ckpt
        from turboinfer_tpu_torch.parallel import shardings
        import torch.distributed as dist
        _, path, prompts, n = op
        cfg = _config(case)
        full = bridge.params_from_numpy(case["params"], device="cpu")
        if mesh.rank == 0:
            ckpt.save_checkpoint(path, full, cfg)
        dist.barrier()
        local, cfg2, _ = ckpt.load_checkpoint(path, mesh=mesh)
        want = shardings.rank_params(full, cfg, mesh)
        same = _same_tree(local, want)
        eng = _engine(case, mesh, params=prepare_params(local),
                      params_are_prepared=True)
        return same, cfg2 == cfg, [r.tokens for r in eng.generate_batch(
            prompts, n, temperature=0.0)]
    if kind == "calls":                      # collectives issued so far
        return comm.calls
    raise ValueError(f"unknown op {kind!r}")


def _same_tree(a, b) -> bool:
    """Trees of tensors, QTensors and QEmbeds equal bit for bit."""
    from turboinfer_tpu_torch.core.qtensor import QEmbed, QTensor
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, QTensor):
        return (a.shape == b.shape and _same_tree(a.data, b.data)
                and _same_tree(a.scales, b.scales)
                and (a.zero_points is None) == (b.zero_points is None)
                and (a.zero_points is None
                     or _same_tree(a.zero_points, b.zero_points)))
    if isinstance(a, QEmbed):
        return _same_tree(a.data, b.data) and _same_tree(a.scales, b.scales)
    return a.dtype == b.dtype and torch.equal(a, b)


def main(rank, world, store, job_path, out_dir):
    torch.set_num_threads(1)
    out = {}
    try:
        from turboinfer_tpu_torch.parallel import mesh as pmesh
        with open(job_path, "rb") as f:
            job = pickle.load(f)
        if job.get("serve"):
            out["__serve__"] = serve(job["serve"], rank, world, store)
            return
        import torch.distributed as dist
        pmesh.initialize_distributed(job["backend"], "file://" + store,
                                     world, rank,
                                     timeout_s=job.get("timeout_s", 120))
        device = job["device"].format(rank=rank)
        mesh = pmesh.make_mesh(tuple(job["mesh"]), device=device)
        out["__seconds__"] = {}
        for case in job["cases"]:
            state, t0 = {}, time.perf_counter()
            out[case["name"]] = [run_op(case, op, mesh, state)
                                 for op in case["ops"]]
            out["__seconds__"][case["name"]] = time.perf_counter() - t0
        out["__coords__"] = mesh.coords
        dist.destroy_process_group()
    except BaseException:
        out["__error__"] = traceback.format_exc()
        raise
    finally:
        with open(os.path.join(out_dir, f"out_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)


def serve(job, rank, world, store):
    """`serve --tp N` through the CLI, as torchrun would start it
    (WORLD_SIZE, RANK, LOCAL_RANK), with --device job["device"] ("cpu":
    gloo; "cuda": NCCL, a card a rank): rank 0's server answers one
    /v1/completions request over HTTP (on a port the OS picks) and shuts
    down, which releases the followers. -> (exit code, rank 0's answer)."""
    import json
    import threading
    import urllib.request
    from turboinfer_tpu_torch import cli
    from turboinfer_tpu_torch import serve as serve_mod
    from turboinfer_tpu_torch.serve import http_server
    answer = {}

    def one_request(eng, host, port, verbose=False):
        srv = http_server.make_server(eng, "127.0.0.1", 0, False)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}/v1/completions"
        req = urllib.request.Request(
            url, data=json.dumps(job["request"]).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            answer.update(json.loads(r.read()))
        srv.shutdown()
        eng.shutdown()

    serve_mod.serve_forever = one_request
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    rc = cli.main(["serve", job["model"], "--tp", str(world), "--device",
                   job.get("device", "cpu"), "--slots", "2", "--quiet",
                   "--dist-init", "file://" + store])
    return rc, answer


def spawn(tmpdir, world, mesh=None, cases=(), serve=None, device="cpu",
          timeout_s=300, backend="gloo"):
    """Run main on `world` gloo ranks (torch.multiprocessing, a file://
    store in tmpdir) and return every rank's results. A rank that fails
    or outlives timeout_s fails the call: the group's own timeout ends
    its peers' waits."""
    import torch.multiprocessing as tmp
    job = {"mesh": mesh, "serve": serve, "timeout_s": 120, "cases": cases,
           "device": device, "backend": backend}
    os.makedirs(tmpdir, exist_ok=True)
    job_path = os.path.join(tmpdir, "job.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    store = os.path.join(tmpdir, "store")
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=main,
                         args=(r, world, store, job_path, tmpdir))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout_s)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    outs = []
    for r in range(world):
        path = os.path.join(tmpdir, f"out_{r}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                outs.append(pickle.load(f))
        else:
            outs.append({"__error__": "no output"})
    errors = [o["__error__"] for o in outs if "__error__" in o]
    assert not alive and not errors and all(
        p.exitcode == 0 for p in procs), (
        [p.exitcode for p in procs], errors)
    return outs


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
