"""The port's package facade, utils and command line against
turboinfer_tpu's (tests/test_facade.py's cases, on the CPU).

Both packages read the same files, written by the JAX package's writers
from one seed: the facade's cached tokenize, `generate --greedy` and
`chat` print the same text, `eval` perplexities agree within 1e-4
relative, and `serve` builds the schedulers it should (serve_forever
stubbed). The mesh flags and `bench` exit 2.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import turboinfer_tpu as jti
import turboinfer_tpu_torch as ti
from turboinfer_tpu import cli as jcli
from turboinfer_tpu.loader import gguf as jgguf
from turboinfer_tpu.models import llama as jllama
from turboinfer_tpu_torch import cli

torch.set_num_threads(2)

_F = {}


def tiny_gguf(tmp_path_factory):
    """An F32 GGUF of the tiny model (no tokenizer in it: both loaders
    attach their built-in byte tokenizer), written once a module."""
    if "gguf" not in _F:
        cfg = jti.tiny_config(dtype=jnp.float32)
        p = jllama.init_params(jax.random.PRNGKey(0), cfg)
        names = dict(attn_norm="attn_norm", ffn_norm="ffn_norm",
                     wq="attn_q", wk="attn_k", wv="attn_v", wo="attn_output",
                     w_gate="ffn_gate", w_up="ffn_up", w_down="ffn_down")
        t = {"token_embd.weight": np.asarray(p["embed"], np.float32),
             "output_norm.weight": np.asarray(p["final_norm"], np.float32),
             "output.weight": np.asarray(p["lm_head"], np.float32).T}
        for i in range(cfg.num_layers):
            for slot, name in names.items():
                a = np.asarray(p["layers"][slot][i], np.float32)
                t[f"blk.{i}.{name}.weight"] = a if "norm" in slot else a.T
        md = {"general.architecture": "llama", "general.name": "tiny-export",
              "llama.embedding_length": cfg.hidden_size,
              "llama.block_count": cfg.num_layers,
              "llama.attention.head_count": cfg.num_heads,
              "llama.attention.head_count_kv": cfg.kv_heads,
              "llama.feed_forward_length": cfg.ffn_dim,
              "llama.rope.freq_base": cfg.rope_theta,
              "llama.attention.layer_norm_rms_epsilon": cfg.rms_norm_eps,
              "llama.context_length": cfg.max_seq_len}
        d = tmp_path_factory.mktemp("gguf")
        path = str(d / "tiny.gguf")
        jgguf.write_gguf(path, md, t)
        _F["gguf"] = path
    return _F["gguf"]


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    return tiny_gguf(tmp_path_factory)


@pytest.fixture(scope="module")
def f32_tinq(tmp_path_factory):
    """The tiny model as an int8 g=32 TINQ file whose config keeps f32
    activations (a GGUF loads in bf16): the file for comparisons at
    f32's precision."""
    from turboinfer_tpu.config import QuantizationConfig, QuantType
    from turboinfer_tpu.loader import tinq
    from turboinfer_tpu.quant.quantizer import quantize_params
    cfg = jti.tiny_config(dtype=jnp.float32)
    p = jllama.init_params(jax.random.PRNGKey(0), cfg)
    path = str(tmp_path_factory.mktemp("tinq") / "tiny_f32.tinq")
    tinq.save(path, quantize_params(p, QuantizationConfig(
        type=QuantType.INT8, group_size=32)), cfg, None)
    return path


def _out(capsys):
    return capsys.readouterr().out


# -- facade ---------------------------------------------------------------

def test_init_shutdown_cycles():
    for _ in range(3):
        assert ti.initialize(enable_logging=False)
        assert ti.is_initialized()
        ti.shutdown()
        assert not ti.is_initialized()


def test_build_info_and_version():
    info = ti.build_info()
    assert "torch" in info and "CUDA" in info and "devices" in info
    assert ti.version_string() == ti.__version__ == jti.__version__
    from turboinfer_tpu_torch import version
    assert (version.MAJOR, version.MINOR, version.PATCH) == (0, 1, 0)


def test_facade_names_equal_the_jax_package():
    assert ti.__all__ == jti.__all__
    assert all(hasattr(ti, n) for n in ti.__all__)


def test_facade_tokenize_cached_equals_jax(gguf_path):
    ids1 = ti.tokenize("hello world", gguf_path, device="cpu")
    eng = ti._engine_cache[(gguf_path, "cpu")]
    ids2 = ti.tokenize("hello world", gguf_path, device="cpu")
    assert ti._engine_cache[(gguf_path, "cpu")] is eng       # cached
    assert ids1 == ids2 == jti.tokenize("hello world", gguf_path)
    assert ti.detokenize(ids1, gguf_path, device="cpu") == "hello world"
    got = ti.generate_text(gguf_path, "hi", max_tokens=5, temperature=0.0,
                           device="cpu")
    assert got == jti.generate_text(gguf_path, "hi", max_tokens=5,
                                    temperature=0.0)
    ti.shutdown()
    jti.shutdown()
    assert not ti._engine_cache


def test_load_model_passes_the_device(gguf_path, monkeypatch):
    from turboinfer_tpu_torch.utils.errors import DeviceError
    eng = ti.load_model(gguf_path, device="cpu")
    assert eng.device.type == "cpu"
    assert eng.params["embed"].device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        ti.load_model(gguf_path)


# -- logging, profiler, errors, metrics --------------------------------------

def test_logging_levels_and_file(tmp_path):
    from turboinfer_tpu_torch.utils import logging as tlog
    logfile = str(tmp_path / "t.log")
    tlog.set_level("DEBUG")
    tlog.set_log_file(logfile)
    tlog.log_debug("debug %d", 1)
    tlog.log_info("info msg")
    tlog.log_error("error msg")
    tlog.set_log_file(None)
    content = open(logfile).read()
    assert "debug 1" in content and "info msg" in content
    assert "[ERROR]" in content
    tlog.set_level("INFO")


def test_profiler_reports(tmp_path):
    from turboinfer_tpu_torch.utils.profiler import (MemoryProfiler, Profiler,
                                                     Timer)
    p = Profiler.instance()
    assert p is Profiler.instance()
    p.set_enabled(True)
    p.reset()
    with p.scope("op_a"):
        sum(range(1000))
    p.start("op_b")
    p.stop("op_b")
    p.record("op_c", 2.5)
    report = p.report()
    assert "op_a" in report and "op_b" in report
    assert p.stats()["op_c"].avg_ms == 2.5
    jpath, cpath, tpath = (str(tmp_path / f"p.{e}")
                           for e in ("json", "csv", "txt"))
    p.save(jpath, fmt="json")
    p.save(cpath, fmt="csv")
    p.save(tpath, fmt="text")
    assert any("op_a" in k for k in json.loads(open(jpath).read()))
    assert "op_a" in open(cpath).read() and "op_b" in open(tpath).read()
    with pytest.raises(ValueError):
        p.save(tpath, fmt="xml")
    p.set_enabled(False)
    p.record("op_d", 1.0)
    assert "op_d" not in p.stats()
    assert Timer().elapsed_ms() >= 0.0
    MemoryProfiler.reset()
    MemoryProfiler.record_alloc("kv", 100)
    MemoryProfiler.record_alloc("kv", 50)
    MemoryProfiler.record_free("kv", 120)
    assert (MemoryProfiler.current("kv"), MemoryProfiler.peak("kv")) == (30,
                                                                          150)
    MemoryProfiler.reset()


def test_profiler_trace_and_device_memory_on_the_cpu(tmp_path):
    from turboinfer_tpu_torch.utils import profiler
    with profiler.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None and (tmp_path / "tr" / "trace.json").exists()
    if not torch.cuda.is_available():
        assert profiler.device_memory_stats() == {}


def test_error_taxonomy(tmp_path, gguf_path):
    from turboinfer_tpu_torch.config import QuantType
    from turboinfer_tpu_torch.core.qtensor import quantize
    from turboinfer_tpu_torch.loader import loader
    from turboinfer_tpu_torch.models import registry
    from turboinfer_tpu_torch.utils.errors import (ConfigError,
                                                   ModelFormatError,
                                                   QuantizationError,
                                                   TokenError,
                                                   TurboInferError)
    bad = str(tmp_path / "bad.gguf")
    with open(bad, "wb") as f:
        f.write(b"X" * 32)
    with pytest.raises(ModelFormatError):
        loader.load_model_data(bad, device="cpu")
    onnx = str(tmp_path / "x.onnx")
    with open(onnx, "wb") as f:
        f.write(b"\x08\x01" + b"\x00" * 32)
    with pytest.raises(ModelFormatError, match="not supported"):
        loader.load_model_data(onnx, device="cpu")
    eng = ti.load_model(gguf_path, device="cpu")
    with pytest.raises(TokenError):
        eng.generate([], 4)
    with pytest.raises(TurboInferError):
        eng.generate([10 ** 6], 4)
    with pytest.raises(ValueError):          # the taxonomy stays ValueError
        eng.generate([], 4)
    with pytest.raises(QuantizationError):
        quantize(torch.ones((3, 4, 5)), QuantType.INT8)
    with pytest.raises(ConfigError):
        registry.get_model("nope")


def test_metrics_report(gguf_path):
    eng = ti.load_model(gguf_path, device="cpu")
    eng.generate([1, 2, 3], 6, temperature=0.0)
    rep = eng.performance_stats()
    assert "tok/s" in rep or "tokens" in rep.lower()
    assert eng.memory_usage() > 0
    eng.reset_state()


# -- command line ------------------------------------------------------------

def test_cli_generate_greedy_prints_jax_text(gguf_path, capsys):
    args = ["generate", gguf_path, "hello", "--max-tokens", "8", "--greedy",
            "--quiet"]
    assert jcli.main(args) == 0
    want = _out(capsys)
    assert cli.main(args + ["--device", "cpu"]) == 0
    assert _out(capsys) == want and want.strip()


def test_cli_chat_prints_jax_text(gguf_path, capsys, monkeypatch):
    def feed(lines):
        it = iter(lines)

        def fake_input(prompt=""):
            try:
                return next(it)
            except StopIteration:
                raise EOFError from None
        monkeypatch.setattr("builtins.input", fake_input)
    args = ["chat", gguf_path, "--max-tokens", "6", "--temperature", "0",
            "--quiet", "--system", "be brief"]
    feed(["hi there", "and again", ""])
    assert jcli.main(args) == 0
    want = _out(capsys)
    feed(["hi there", "and again", ""])
    assert cli.main(args + ["--device", "cpu"]) == 0
    assert _out(capsys) == want and want.count("\n") == 2


def test_cli_quantize_inspect_generate(tmp_path, gguf_path, capsys):
    dst = str(tmp_path / "m.tinq")
    assert cli.main(["quantize", gguf_path, dst, "--type", "int8",
                     "--group-size", "32", "--device", "cpu"]) == 0
    assert "wrote" in _out(capsys)
    assert cli.main(["inspect", dst, "--device", "cpu"]) == 0
    out = _out(capsys)
    assert "format: tinq" in out and "int8" in out
    assert cli.main(["inspect", gguf_path, "--tensors"]) == 0
    out = _out(capsys)
    assert "format: gguf" in out and "blk.0.attn_q.weight" in out
    assert cli.main(["generate", dst, "hello", "--max-tokens", "5",
                     "--greedy", "--quiet", "--device", "cpu"]) == 0
    # the same .tinq through the JAX CLI prints the same text
    out = _out(capsys)
    assert jcli.main(["generate", dst, "hello", "--max-tokens", "5",
                      "--greedy", "--quiet"]) == 0
    assert _out(capsys) == out


def test_cli_eval_perplexity_matches_jax(tmp_path, f32_tinq, capsys):
    txt = tmp_path / "sample.txt"
    txt.write_text("the quick brown fox jumps over the lazy dog " * 6)
    for extra in ([], ["--window", "16", "--stride", "8"]):
        args = ["eval", f32_tinq, str(txt), "--quiet"] + extra
        assert cli.main(args + ["--device", "cpu"]) == 0
        got = json.loads(_out(capsys).strip())
        assert jcli.main(args) == 0
        want = json.loads(_out(capsys).strip())
        assert got["scored"] == got["tokens"] - 1 == want["scored"]
        assert got["perplexity"] > 0 and got["avg_logprob"] <= 0
        assert abs(got["perplexity"] - want["perplexity"]) <= \
            1e-4 * want["perplexity"]
    assert cli.main(["eval", f32_tinq, str(txt), "--quiet", "--window",
                     "8", "--stride", "9", "--device", "cpu"]) == 1


def test_cli_serve_builds_the_schedulers(gguf_path, monkeypatch, capsys):
    """serve wires the scheduler it is asked for, with a beam engine on
    the scheduler's own weights (construction only: serve_forever is
    stubbed)."""
    from turboinfer_tpu_torch.engine.scheduler import (
        ContinuousBatchingScheduler, PagedContinuousScheduler)
    captured = {}

    def fake_serve_forever(eng, host, port, verbose=False):
        captured.update(sched=eng.sched, beam=eng.beam_engine, eng=eng,
                        host=host, port=port)
        eng.shutdown()

    monkeypatch.setattr("turboinfer_tpu_torch.serve.serve_forever",
                        fake_serve_forever)
    base = ["serve", gguf_path, "--slots", "2", "--quiet", "--device", "cpu"]
    assert cli.main(base + ["--port", "8123", "--burst", "2"]) == 0
    s = captured["sched"]
    assert type(s) is ContinuousBatchingScheduler and s.B == 2
    assert s.device.type == "cpu" and s.decode_burst == 2
    assert captured["port"] == 8123
    assert captured["eng"].model_name == "tiny.gguf"
    assert captured["beam"].params is s.params
    assert "serving tiny.gguf" in capsys.readouterr().err

    assert cli.main(base + ["--paged", "--page-size", "16",
                            "--kv-cache-dtype", "int8", "--max-queue", "3",
                            "--served-name", "tiny"]) == 0
    s = captured["sched"]
    assert isinstance(s, PagedContinuousScheduler) and s.page == 16
    assert s.cache.k_pages.dtype == torch.int8 and s.max_queue == 3
    assert captured["eng"].model_name == "tiny"
    assert captured["beam"].params is s.params

    for paged in ([], ["--paged"]):
        assert cli.main(base + paged + ["--draft-model", gguf_path,
                                        "--spec-k", "2"]) == 0
        s = captured["sched"]
        assert s._dmodel is not None and s.spec_k == 2
        assert isinstance(s, PagedContinuousScheduler) == bool(paged)
        assert captured["beam"].params is s.params


@pytest.mark.parametrize("argv,says", [
    (["serve", "M", "--tp", "2"], "torchrun --nproc-per-node 2"),
    (["serve", "M", "--pp-stages", "2"], "ROADMAP §1 item 13"),
    (["serve", "M", "--context-parallel", "2"], "ROADMAP §1 item 13"),
    (["generate", "M", "hi", "--context-parallel", "2"],
     "ROADMAP §1 item 13")],
    ids=["tp", "pp", "cp", "generate-cp"])
def test_cli_mesh_flags_exit_2_naming_the_roadmap(argv, says, capsys):
    """--pp-stages and --context-parallel wait for the next slice;
    --tp N outside torchrun's N processes says how to launch it."""
    assert cli.main(argv) == 2
    assert says in capsys.readouterr().err


def test_cli_bench_exits_2(capsys):
    assert cli.main(["bench"]) == 2
    assert "items 6-7" in capsys.readouterr().err


def test_python_dash_m_runs_the_cli(gguf_path):
    r = subprocess.run([sys.executable, "-m", "turboinfer_tpu_torch",
                        "generate", gguf_path, "hello", "--max-tokens", "4",
                        "--greedy", "--quiet", "--device", "cpu"],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip()
