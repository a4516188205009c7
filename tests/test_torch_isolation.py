"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import no jax
and nothing of the reference package, and the entry points never fall back
to the CPU on their own."""

import importlib
import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"

FORBIDDEN = [
    re.compile(r"^\s*import\s+jax\b", re.M),
    re.compile(r"^\s*from\s+jax\b", re.M),
    re.compile(r"^\s*import\s+repro(\.|\s|$|,)", re.M),
    re.compile(r"^\s*from\s+repro(\.|\s)", re.M),
    re.compile(r"importlib\.import_module\(\s*['\"](jax|repro)(\.|['\"])"),
]


def _port_modules():
    import repro_torch

    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_every_port_module_imports_without_jax_or_reference():
    names = _port_modules()
    assert {"repro_torch.net.pipeline", "repro_torch.kernels.bitonic",
            "repro_torch.core.mergesort", "repro_torch.data.traces",
            "repro_torch.models.lm", "repro_torch.models.moe", "repro_torch.serve.engine",
            "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.decode_attention",
            "repro_torch.net.device_epoch", "repro_torch.net.timing",
            "repro_torch.net.control", "repro_torch.obs.metrics",
            "repro_torch.obs.telemetry", "repro_torch.obs.trace",
            "repro_torch.data.scenarios"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    subprocess.run(
        [sys.executable, "-c", code], check=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"])
def test_source_has_no_jax_or_reference_import(path):
    text = (ROOT / path).read_text()
    for pat in FORBIDDEN:
        assert not pat.search(text), f"{path}: {pat.pattern}"


def test_scan_patterns_let_repro_torch_through():
    ok = "from repro_torch.net import wire\nimport repro_torch\n"
    bad = ["import jax\n", "from jax import numpy\n", "import repro\n",
           "from repro.net import wire\n", "import repro.core\n"]
    assert not any(p.search(ok) for p in FORBIDDEN)
    for src in bad:
        assert any(p.search(src) for p in FORBIDDEN), src


def test_entry_points_refuse_a_missing_card(monkeypatch):
    """With no card, the default ``device="cuda"`` raises; it never carries
    on quietly on the CPU."""
    from repro_torch.core import partition, runs
    from repro_torch.net import egress, pipeline, server, wire

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vals = torch.arange(100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runs.RunArena()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        partition.set_ranges(100, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.run_pipeline(vals)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.plain_stream_sort(vals)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.StreamingServer(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        egress.ServerPool(4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wire.empty_batch()
    res = pipeline.run_pipeline(vals, device="cpu", verify=True)
    assert res.output.device.type == "cpu"


def test_serve_entry_points_refuse_a_missing_card(monkeypatch):
    """``build(cfg)``, ``LM`` and ``Engine`` default to the card too."""
    from repro_torch import configs, models
    from repro_torch.launch import serve
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import Engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke_config("mistral-nemo-12b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.build(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(cfg)
    model = models.build(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "mistral-nemo-12b", "--smoke"])
    eng = Engine(model, device="cpu")
    assert eng.cache["k"].device.type == "cpu"


def test_chip_smoke_fails_without_a_card_or_without_the_port(tmp_path):
    env = {"PYTHONPATH": "", "PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, str(SMOKE)], capture_output=True, text=True,
                       timeout=300, env=env, cwd=ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, alone)
    r = subprocess.run([sys.executable, str(alone)], capture_output=True, text=True,
                       timeout=300, env=env, cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_port_modules_are_importable_in_process():
    for name in _port_modules():
        importlib.import_module(name)
