"""Import and device guards of the PyTorch port.

The port imports neither ``jax`` nor anything of the JAX package ``repro``
(only the tests import both), and its entry points run on CUDA unless the
caller asks for the CPU: with no card they raise rather than fall back.
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core import run_async, run_sync
from repro_torch.core.version_store import build_ring
from repro_torch.models import init_lenet, lenet_loss, params_from_jax
from repro_torch.sim.scenarios import get_scenario
from repro_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_no_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_import_pulls_in_neither_jax_nor_repro():
    code = ("import sys, repro_torch.core, repro_torch.sim.engine, "
            "repro_torch.sim.legacy, repro_torch.models; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code],
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


def _setup():
    clients, _ = get_scenario("paper-fig1").make_dataset(
        4, samples_per_client=16, seed=0)
    fl = FLConfig(num_clients=4, buffer_size=2, local_steps=1, batch_size=4)
    return init_lenet(torch.Generator().manual_seed(0)), clients, fl


def test_entry_points_default_to_cuda_and_raise(no_cuda):
    params, clients, fl = _setup()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_async(lenet_loss, params, clients, fl, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_sync(lenet_loss, params, clients, fl, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax({"w": [1.0]})
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_unported_engines_name_their_slice():
    params, clients, fl = _setup()
    for engine in ("legacy", "population"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            run_async(lenet_loss, params, clients, fl, 1, engine=engine,
                      device="cpu")
    with pytest.raises(NotImplementedError, match="Slice E"):
        build_ring(params, fl, mesh=object())
