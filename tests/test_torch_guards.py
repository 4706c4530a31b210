"""Import and device guards of the PyTorch port.

The port imports neither ``jax`` nor anything of the JAX package ``repro``
(only the tests import both), and its entry points run on CUDA unless the
caller asks for the CPU: with no card they raise rather than fall back.
"""
import ast
import importlib
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_arch, smoke_variant
from repro_torch.configs.base import FLConfig
from repro_torch.core import (
    AsyncServer,
    ServingController,
    make_cohort_step,
    make_dist_step,
    run_async,
    run_sync,
)
from repro_torch.core.version_store import build_ring
from repro_torch.launch import population_scale, serve, serve_fl
from repro_torch.models import (
    Model,
    init_lenet,
    lenet_loss,
    lm_params_from_jax,
    params_from_jax,
)
from repro_torch.sim.population import (
    CounterBehavior,
    collect_windows,
    init_population,
    run_population,
)
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
    code = ("import sys, repro_torch.core, repro_torch.core.buffer, "
            "repro_torch.core.server, repro_torch.sim.engine, "
            "repro_torch.sim.legacy, repro_torch.sim.metrics, "
            "repro_torch.obs, repro_torch.launch.quickstart, "
            "repro_torch.models, "
            "repro_torch.models.model, repro_torch.launch.serve, "
            "repro_torch.kernels.flash_attn.ops, "
            "repro_torch.kernels.ssm_scan.ops, repro_torch.core.cohort, "
            "repro_torch.core.serving, repro_torch.sim.arrivals, "
            "repro_torch.transport, repro_torch.transport.wire, "
            "repro_torch.transport.server, repro_torch.transport.client, "
            "repro_torch.launch.cli, repro_torch.launch.serve_fl, "
            "repro_torch.launch.client_fl, repro_torch.launch.replay_probe, "
            "repro_torch.utils.threefry, repro_torch.sim.population, "
            "repro_torch.launch.population_scale; "
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
        run_async(lenet_loss, params, clients, fl, 1, engine="legacy")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AsyncServer(params, fl, None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_sync(lenet_loss, params, clients, fl, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax({"w": [1.0]})
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_slice_c_entry_points_default_to_cuda_and_raise(no_cuda):
    params, _, fl = _setup()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingController(lenet_loss, params, fl)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_cohort_step(lenet_loss, fl)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_dist_step(lenet_loss, fl)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_fl.main(["--clients", "4", "--samples-per-client", "16",
                       "--rounds", "1"])
    assert ServingController(lenet_loss, params, fl,
                             device="cpu").device == torch.device("cpu")


def test_unported_engines_name_their_slice():
    params, clients, fl = _setup()
    with pytest.raises(NotImplementedError, match="Slice E"):
        run_population(lenet_loss, params, clients, fl, 1, mesh=object(),
                       device="cpu")
    with pytest.raises(NotImplementedError, match="Slice E"):
        collect_windows(get_scenario("paper-fig1"), 4, fl, 1, mesh=object(),
                        device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        run_async(lenet_loss, params, clients, fl, 1, engine="nope",
                  device="cpu")
    with pytest.raises(NotImplementedError, match="Slice E"):
        build_ring(params, fl, mesh=object())


def test_population_entry_points_default_to_cuda_and_raise(no_cuda):
    params, clients, fl = _setup()
    sc = get_scenario("paper-fig1")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_async(lenet_loss, params, clients, fl, 1, engine="population")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_population(lenet_loss, params, clients, fl, 1, scenario=sc)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        collect_windows(sc, 4, fl, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_population(sc, 4, fl)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CounterBehavior(sc, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        population_scale.main(["--sizes", "100", "--windows", "1"])
    res = run_async(lenet_loss, params, clients, fl, 1, engine="population",
                    scenario=sc, device="cpu")
    assert res.server_rounds == 1


def test_lm_entry_points_default_to_cuda_and_raise(no_cuda):
    cfg = smoke_variant(get_arch("hymba-1.5b").model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "hymba-1.5b", "--smoke", "--gen", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_params_from_jax({"w": [1.0]})
    assert Model(cfg, device="cpu").device == torch.device("cpu")


KERNEL_MODULES = sorted(p.parent.name for p in (
    ROOT / "src" / "repro_torch" / "kernels").glob("*/kernel.py"))


def _extern_c_functions(source: str) -> dict:
    """name -> argument count of each function defined in the ``extern "C"``
    blocks of a CUDA source (plain C signatures: no function pointers)."""
    funcs = {}
    for block in re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"', source,
                            re.S):
        block = re.sub(r"//[^\n]*", "", block)
        for name, args in re.findall(
                r"^[A-Za-z_][\w\s\*]*?\b(\w+)\s*\(([^)]*)\)\s*\{", block,
                re.M):
            args = args.strip()
            funcs[name] = 0 if args in ("", "void") else args.count(",") + 1
    return funcs


@pytest.mark.parametrize("module", KERNEL_MODULES)
def test_ctypes_tables_match_the_c_sources(module):
    """Every entry of a kernel library's ctypes table names a function of the
    ``extern "C"`` block of its ``csrc/*.cu``, with as many arguments: a
    mismatch would otherwise show only as a crash on the card."""
    lib = importlib.import_module(
        f"repro_torch.kernels.{module}.kernel").LIBRARY
    defined = _extern_c_functions(lib.source.read_text())
    assert lib.error_fn in lib.signatures
    for name, (_, argtypes) in lib.signatures.items():
        assert name in defined, f"{name} is not in {lib.source.name}'s extern C block"
        assert len(argtypes) == defined[name], (
            f"{name}: {len(argtypes)} ctypes arguments, {defined[name]} in "
            f"{lib.source.name}")


def test_extern_c_parser_counts_arguments():
    src = ('extern "C" {\n\nconst char* a_err(int code) {\n  return 0;\n}\n\n'
           "// a comment (x, y)\nint a_launch(const float* x, float* y,\n"
           "             int64_t n, void* stream) {\n  return 0;\n}\n\n"
           'int64_t a_none(void) { return 1; }\n\n}  // extern "C"\n')
    assert _extern_c_functions(src) == {"a_err": 1, "a_launch": 4,
                                        "a_none": 0}
