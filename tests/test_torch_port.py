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
from turboinfer_tpu_torch.loader.synthetic import \
    create_synthetic_quantized_model
from turboinfer_tpu_torch.models import llama
from turboinfer_tpu_torch.utils.errors import DeviceError

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "turboinfer_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_in_the_port(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "turboinfer_tpu")]
    assert not bad, f"{path.name} imports {bad}"


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
