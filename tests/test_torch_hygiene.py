"""Boundaries of the PyTorch port: it imports no JAX and nothing of the
JAX package, its entry points refuse to fall back to the CPU quietly, and
chip_smoke.py refuses to report without a card or without the port."""
import ast
import pathlib
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


def test_port_has_sources_for_both_kernels():
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    assert {"decode_attention.cu", "flash_attention.cu",
            "mq_decode_attention.cu", "paged_decode_attention.cu",
            "mq_paged_decode_attention.cu", "wkv_scan.cu", "ssm_scan.cu"} \
        <= {p.name for p in csrc.glob("*.cu")}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.device import resolve_device
    from repro_torch.models import model as M
    from repro_torch.core.engine import InterleavedEngine, UniformPlan
    from repro_torch.serving import EngineBackend, LimeServer

    cfg = get_smoke_config("gemma3-1b")
    params = M.init_params(cfg, device="cpu")        # explicit CPU works
    assert params["embedding"].device.type == "cpu"
    for call in (lambda: resolve_device(),
                 lambda: resolve_device("cuda"),
                 lambda: M.init_params(cfg),
                 lambda: M.init_cache(cfg, 1, 8),
                 lambda: LimeServer(cfg, params),
                 lambda: EngineBackend(cfg, params),
                 lambda: M.init_params_by_layer(cfg),
                 lambda: InterleavedEngine(cfg, UniformPlan(1, 2, 0, 1)),
                 lambda: params_from_numpy({"w": np.zeros(2, np.float32)})):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_launcher_raises_without_a_card(no_cuda):
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "gemma3-1b", "--smoke"])


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: chip_smoke.py would run for real")
    r = _run_smoke(ROOT)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_chip_smoke_refuses_without_the_port(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout
