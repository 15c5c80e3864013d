"""Boundaries of the port: no JAX inside it, and the device rule.

Entry points default to device="cuda"; without a GPU and without an
explicit device="cpu" they raise instead of drifting onto the CPU.
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from turboinfer_tpu_torch.config import tiny_config
from turboinfer_tpu_torch.engine.engine import InferenceEngine
from turboinfer_tpu_torch.engine.paged_cache import init_paged_cache
from turboinfer_tpu_torch.engine.scheduler import (ContinuousBatchingScheduler,
                                                   PagedContinuousScheduler)
from turboinfer_tpu_torch.loader.synthetic import \
    create_synthetic_quantized_model
from turboinfer_tpu_torch.models import llama
from turboinfer_tpu_torch.utils.errors import DeviceError

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "turboinfer_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_serving_slice_is_under_the_import_rule():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("engine/scheduler.py", "engine/paged_cache.py",
                "engine/speculative.py", "kernels/paged_attention.py"):
        assert f"turboinfer_tpu_torch/{mod}" in names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_in_the_port(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "turboinfer_tpu")]
    assert not bad, f"{path.name} imports {bad}"


def test_the_loader_slice_is_under_the_import_rule():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("native.py", "loader/loader.py", "loader/safetensors.py",
                "loader/gguf.py", "loader/mapping.py", "loader/tinq.py",
                "loader/lora.py", "loader/ckpt.py", "tokenizer/bpe.py",
                "quant/calibrate.py"):
        assert f"turboinfer_tpu_torch/{mod}" in names


def test_the_text_slice_is_under_the_import_rule():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("tokenizer/hf.py", "tokenizer/chat.py", "tokenizer/stream.py",
                "structured/__init__.py", "structured/json_fsm.py",
                "structured/regex_nfa.py", "structured/schema_fsm.py",
                "structured/filter.py"):
        assert f"turboinfer_tpu_torch/{mod}" in names


def test_the_server_slice_is_under_the_import_rule():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("serve/__init__.py", "serve/engine.py", "serve/http_server.py",
                "cli.py", "__main__.py", "utils/profiler.py", "__init__.py",
                "version.py"):
        assert f"turboinfer_tpu_torch/{mod}" in names


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda(monkeypatch):
    _no_cuda(monkeypatch)
    cfg = tiny_config(dtype=torch.float32)
    for call in (lambda: llama.init_params(cfg),
                 lambda: llama.init_cache(cfg, 1),
                 lambda: create_synthetic_quantized_model(cfg),
                 lambda: InferenceEngine(
                     llama.init_params(cfg, device="cpu"), cfg)):
        with pytest.raises(DeviceError):
            call()


def test_loader_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """The loaders place weights on the card unless asked for the CPU."""
    from turboinfer_tpu_torch.loader import (load_engine, load_model_data,
                                             save_checkpoint, load_checkpoint,
                                             tinq)
    cfg = tiny_config(dtype=torch.float32, num_layers=1)
    params = llama.init_params(cfg, device="cpu")
    tinq.save(str(tmp_path / "m.tinq"), params, cfg)
    save_checkpoint(str(tmp_path / "ck"), params, cfg)
    _no_cuda(monkeypatch)
    for call in (lambda: load_model_data(str(tmp_path / "m.tinq")),
                 lambda: load_engine(str(tmp_path / "m.tinq")),
                 lambda: load_checkpoint(str(tmp_path / "ck"))):
        with pytest.raises(DeviceError):
            call()
    eng = load_engine(str(tmp_path / "m.tinq"), device="cpu")
    assert len(eng.generate([1, 2, 3], 3, temperature=0.0).tokens) == 6


@pytest.mark.parametrize("sched", [ContinuousBatchingScheduler,
                                   PagedContinuousScheduler])
def test_schedulers_default_to_cuda(monkeypatch, sched):
    _no_cuda(monkeypatch)
    cfg = tiny_config(dtype=torch.float32, num_layers=1)
    params = llama.init_params(cfg, device="cpu")
    with pytest.raises(DeviceError):
        sched(params, cfg, batch_slots=2)
    with pytest.raises(DeviceError):
        init_paged_cache(cfg, 2, num_pages=4)
    s = sched(params, cfg, batch_slots=2, device="cpu")
    rid = s.submit([1, 2, 3], 3)
    assert len(s.run()[rid].tokens) == 6


def test_explicit_cpu_runs(monkeypatch):
    _no_cuda(monkeypatch)
    cfg = tiny_config(dtype=torch.float32, num_layers=1)
    data = create_synthetic_quantized_model(cfg.replace(dtype=torch.bfloat16),
                                            device="cpu")
    assert data.params["layers"]["wq"].data.dtype == torch.uint8
    eng = InferenceEngine(llama.init_params(cfg, device="cpu"), cfg,
                          device="cpu")
    assert len(eng.generate([1, 2, 3], 3, temperature=0.0).tokens) == 6


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a GPU,
    and alone in a directory without the package."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        r = subprocess.run([sys.executable, str(script)], cwd=cwd,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_server_slice_entry_points_default_to_cuda(monkeypatch):
    """speculative_generate runs on the card unless asked for the CPU."""
    from turboinfer_tpu_torch.engine.speculative import speculative_generate
    _no_cuda(monkeypatch)
    cfg = tiny_config(dtype=torch.float32, num_layers=1)
    params = llama.init_params(cfg, device="cpu")
    with pytest.raises(DeviceError):
        speculative_generate(params, cfg, params, cfg, [[1, 2, 3]], 4, k=2)
    res = speculative_generate(params, cfg, params, cfg, [[1, 2, 3]], 4, k=2,
                               device="cpu")
    assert len(res.tokens[0]) == 7
