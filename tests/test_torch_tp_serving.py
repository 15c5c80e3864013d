"""The port's schedulers and `serve --tp 2` on 2 gloo ranks on the CPU
(helpers in tests/test_torch_tp.py), against the JAX package's
schedulers on a (1, 2) mesh, f32, token for token:
  - the contiguous scheduler with decode_burst=2 and the paged one over
    an int8 pool of 8-token pages, each with a 1-layer draft (spec_k=2),
    four requests, three sharing a prefix; no page left held;
  - `serve --tp 2 --device cpu` through the CLI as torchrun would start
    it: rank 0 answers one /v1/completions request over HTTP while rank
    1 replays its plans, with the answer of `serve` on one process.
"""

import json
import os
import threading
import urllib.request

import pytest
import torch

from turboinfer_tpu.config import InferenceConfig as JInferenceConfig
from turboinfer_tpu.config import QuantizationConfig as JQuantCfg
from turboinfer_tpu.config import QuantType as JQuantType
from turboinfer_tpu.engine.scheduler import (
    ContinuousBatchingScheduler as JSched, PagedContinuousScheduler as JPaged)
from turboinfer_tpu.quant.quantizer import quantize_params as jquantize

from test_torch_tp import (LLAMA, cfg_kwargs, case, jax_mesh, llama_case,
                           make_weights, same_on_ranks, spawn)
from test_torch_moe import jax_to_numpy

torch.set_num_threads(2)

DRAFT = dict(LLAMA, num_layers=1, name="tiny-draft")
REQS = [([1, 5, 7, 9], 9), ([1, 5, 7, 9, 11, 13], 7), ([2, 4, 6], 10),
        ([1, 5, 7, 9, 11, 12, 14, 15], 6)]
ICFG = dict(max_seq_len=128, eos_token_id=-1)
SCHEDULERS = {
    "contiguous": (False, ICFG, {"batch_slots": 2, "decode_burst": 2}),
    "paged": (True, dict(ICFG, kv_cache_dtype="int8"),
              {"batch_slots": 2, "page_size": 8}),
}


def _draft():
    return make_weights(DRAFT, seed=8)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    dcfg, dp = _draft()
    draft = {"cfg": cfg_kwargs(dcfg), "params": jax_to_numpy(dp)}
    cfg, jp = llama_case("int4", quant=True)
    cases = {name: case(name, cfg, jp, [("sched", paged, REQS, kw, draft)],
                        icfg)
             for name, (paged, icfg, kw) in SCHEDULERS.items()}
    return cases, spawn(str(tmp_path_factory.mktemp("sched")), 2, (1, 2),
                        cases.values())


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_tp2_schedulers_match_jax_mesh(ranks, name):
    cases, outs = ranks
    c = cases[name]
    paged, icfg, kw = SCHEDULERS[name]
    res = same_on_ranks(outs, name)[0]
    dcfg, dp = _draft()
    cls = JPaged if paged else JSched
    s = cls(c["_jp"], c["_jcfg"], JInferenceConfig(**icfg),
            mesh=jax_mesh((1, 2)), draft_params=dp, draft_config=dcfg,
            spec_k=2, **kw)
    rids = [s.submit(p, n, temperature=0.0) for p, n in REQS]
    out = s.run()
    want = [out[r].tokens for r in rids]
    if paged:
        assert res[-1] == ("live_pages", 1)     # the trash page only
        res = res[:-1]
    assert res == want


def _tinq(tmpdir):
    from turboinfer_tpu.loader import tinq
    cfg, jp = llama_case("serve")
    path = os.path.join(tmpdir, "tiny_f32.tinq")
    tinq.save(path, jquantize(jp, JQuantCfg(type=JQuantType.INT8,
                                            group_size=32)), cfg, None)
    return path


REQUEST = {"prompt": [1, 5, 7, 9, 11], "max_tokens": 8, "temperature": 0.0,
           "logprobs": 1}


def test_cli_serve_tp2_answers_as_tp1(tmp_path, monkeypatch):
    from turboinfer_tpu_torch import cli
    model = _tinq(str(tmp_path))
    outs = spawn(str(tmp_path / "ranks"), 2, serve={
        "model": model, "request": REQUEST})
    (rc0, ans), (rc1, _) = outs[0]["__serve__"], outs[1]["__serve__"]
    assert rc0 == rc1 == 0
    want = {}

    def one_request(eng, host, port, verbose=False):
        from turboinfer_tpu_torch.serve import http_server
        srv = http_server.make_server(eng, "127.0.0.1", 0, False)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/v1/completions",
            data=json.dumps(REQUEST).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            want.update(json.loads(r.read()))
        srv.shutdown()
        eng.shutdown()

    monkeypatch.setattr("turboinfer_tpu_torch.serve.serve_forever",
                        one_request)
    assert cli.main(["serve", model, "--device", "cpu", "--slots", "2",
                     "--quiet"]) == 0
    # the file has no tokenizer: the completion's tokens come back as
    # logprobs entries
    got, exp = ans["choices"][0]["logprobs"], want["choices"][0]["logprobs"]
    assert got["tokens"] == exp["tokens"]
    assert len(exp["tokens"]) == REQUEST["max_tokens"]
    assert got["token_logprobs"] == pytest.approx(exp["token_logprobs"],
                                                  abs=1e-4)
    assert ans["usage"] == want["usage"]
