"""Import and device guards of the PyTorch port.

The port imports neither ``jax`` nor anything of the JAX package ``repro``
(only the tests import both), and its entry points run on CUDA unless the
caller asks for the CPU: with no card they raise rather than fall back.
"""
import ast
import dataclasses
import importlib
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

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
from repro_torch.kernels.cuda_build import CudaLibrary
from repro_torch.launch import population_scale, serve, serve_fl, shard_scale, train
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
            "repro_torch.models.model, repro_torch.models.moe, "
            "repro_torch.launch.serve, repro_torch.configs.arctic_480b, "
            "repro_torch.configs.deepseek_moe_16b, "
            "repro_torch.configs.gemma_7b, repro_torch.configs.pixtral_12b, "
            "repro_torch.configs.qwen15_110b, "
            "repro_torch.configs.stablelm_12b, "
            "repro_torch.configs.whisper_tiny, "
            "repro_torch.kernels.flash_attn.ops, "
            "repro_torch.kernels.ssm_scan.ops, repro_torch.core.cohort, "
            "repro_torch.core.serving, repro_torch.sim.arrivals, "
            "repro_torch.transport, repro_torch.transport.wire, "
            "repro_torch.transport.server, repro_torch.transport.client, "
            "repro_torch.launch.cli, repro_torch.launch.serve_fl, "
            "repro_torch.launch.client_fl, repro_torch.launch.replay_probe, "
            "repro_torch.utils.threefry, repro_torch.sim.population, "
            "repro_torch.launch.population_scale, repro_torch.sharding, "
            "repro_torch.sharding.specs, repro_torch.sharding.collectives, "
            "repro_torch.launch.mesh, "
            "repro_torch.launch.multihost, repro_torch.launch.shard_scale, "
            "repro_torch.checkpoint, repro_torch.core.secure_agg, "
            "repro_torch.utils.remat, repro_torch.utils.fold, "
            "repro_torch.optim, repro_torch.optim.schedules, "
            "repro_torch.launch.program, repro_torch.launch.train, "
            "repro_torch.kernels.flash_attn.kernel, "
            "repro_torch.kernels.ssm_scan.kernel, "
            "repro_torch.kernels.flash_attn.ref, repro_torch.core.client, "
            "repro_torch.core.round_body, repro_torch.core.server_pass, "
            "repro_torch.models.blocks, repro_torch.utils.tree, "
            "repro_torch.launch.round_memory, repro_torch.launch.dryrun, "
            "repro_torch.launch.train_lm_federated, repro_torch.utils, "
            "repro_torch.utils.pytree, repro_torch.launch.k6_compare; "
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


def test_program_builders_and_lm_example_default_to_cuda_and_raise(no_cuda):
    from repro_torch.launch import train_lm_federated
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.program import build_program

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_program("hymba-1.5b", "decode_32k", make_production_mesh())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_lm_federated.run(rounds=1, log=lambda msg: None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_lm_federated.main(["--rounds", "1"])


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
    with pytest.raises(ValueError, match="unknown engine"):
        run_async(lenet_loss, params, clients, fl, 1, engine="nope",
                  device="cpu")
    # Slice E2 is ported: a delta ring on a mesh and the population engine
    # on a mesh build and run (test_slice_e2_paths_raise_on_a_mesh runs them
    # in worlds of ranks); a mismatched mesh and device still raise
    with pytest.raises(ValueError, match="mesh of 'cuda' ranks"):
        collect_windows(get_scenario("paper-fig1"), 4, fl, 1,
                        mesh=SimpleNamespace(device_type="cuda"),
                        device="cpu")


def rank_e2_paths(shapes):
    """A rank of a world that runs the Slice E2 paths on each mesh shape."""
    from repro_torch.launch import multihost

    params, clients, fl = _setup()
    delta = dataclasses.replace(fl, ring_codec="delta")
    out = {}
    for shape in shapes:
        mesh = multihost.make_round_mesh(*shape, device="cpu")
        ring = run_async(lenet_loss, params, clients, delta, 1, mesh=mesh,
                         device="cpu")
        pop = run_async(lenet_loss, params, clients, fl, 1,
                        engine="population",
                        scenario=get_scenario("paper-fig1"), mesh=mesh,
                        device="cpu")
        spec, state = build_ring(params, delta, mesh=mesh)
        out[tuple(shape)] = (ring.server_rounds, pop.server_rounds,
                             tuple(state.base.shape), spec.n_padded)
    return out


@pytest.fixture(scope="module")
def e2_worlds(tmp_path_factory):
    from repro_torch.launch import multihost

    here = Path(__file__).resolve()
    out = {}
    for world, shapes in ((2, [(1, 2), (2, 1)]), (4, [(2, 2)])):
        work = tmp_path_factory.mktemp(f"e2_world{world}")
        ranks = multihost.spawn_world(f"{here}:rank_e2_paths", world,
                                      {"shapes": shapes}, timeout=240.0,
                                      workdir=str(work))
        assert all(r == ranks[0] for r in ranks[1:])
        out.update(ranks[0])
    return out


@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (2, 1)])
def test_slice_e2_paths_raise_on_a_mesh(e2_worlds, shape):
    """The delta ring and the population engine on a mesh raised until
    Slice E2; they now run there: one round each through ``run_async``, and
    a model-sharded delta ring holds a rank's slice of the base."""
    ring_rounds, pop_rounds, base_shape, n_padded = e2_worlds[shape]
    assert (ring_rounds, pop_rounds) == (1, 1)
    assert base_shape == (n_padded // shape[1],)


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
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        shard_scale.main([])
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
        train.main(["--arch", "hymba-1.5b", "--smoke", "--rounds", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.TrainLoop(cfg, FLConfig(), cohort=2, batch=1, seq=8, rounds=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_params_from_jax({"w": [1.0]})
    assert Model(cfg, device="cpu").device == torch.device("cpu")


def test_moe_layer_reads_nothing_on_the_host_under_vmap():
    """The MoE layer under ``vmap(grad)`` over 2 slots at a capacity that
    drops tokens: a host read of a batched tensor (``F.one_hot`` reads its
    input's maximum, ``.item()``, ``bincount``) would raise here. Its
    source calls none of them."""
    from torch.func import grad, vmap

    from repro_torch.models import moe
    from repro_torch.models.layers import Init
    from repro_torch.utils.tree import tree_map

    cfg = smoke_variant(get_arch("deepseek-moe-16b").model).replace(
        moe_capacity_factor=1.25)
    p = moe.init_moe(Init(torch.Generator().manual_seed(0),
                          torch.device("cpu")), cfg)
    slots = tree_map(lambda v: v[None].expand((2,) + v.shape).clone(), p)
    x = torch.randn(2, 2, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))

    def loss(params, xs):
        y, aux = moe.moe_ffn(cfg, params, xs)
        return y.square().sum() + aux

    g = vmap(grad(loss))(slots, x)
    assert g["router"].shape == slots["router"].shape
    tree = ast.parse((ROOT / "src" / "repro_torch" / "models" /
                      "moe.py").read_text())
    called = {node.func.attr for node in ast.walk(tree)
              if isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)}
    assert not called & {"one_hot", "item", "tolist", "bincount", "nonzero",
                         "index_add_"}


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
    """Every entry of a kernel library's ctypes table (each ``CudaLibrary``
    of the module: the kernel's, and its backward's where it has one) names
    a function of the ``extern "C"`` block of its ``csrc/*.cu``, with as many
    arguments: a mismatch would otherwise show only as a crash on the
    card."""
    mod = importlib.import_module(f"repro_torch.kernels.{module}.kernel")
    libraries = [v for v in vars(mod).values() if isinstance(v, CudaLibrary)]
    assert mod.LIBRARY in libraries
    for lib in libraries:
        defined = _extern_c_functions(lib.source.read_text())
        assert lib.error_fn in lib.signatures
        for name, (_, argtypes) in lib.signatures.items():
            assert name in defined, \
                f"{name} is not in {lib.source.name}'s extern C block"
            assert len(argtypes) == defined[name], (
                f"{name}: {len(argtypes)} ctypes arguments, {defined[name]} "
                f"in {lib.source.name}")


def test_extern_c_parser_counts_arguments():
    src = ('extern "C" {\n\nconst char* a_err(int code) {\n  return 0;\n}\n\n'
           "// a comment (x, y)\nint a_launch(const float* x, float* y,\n"
           "             int64_t n, void* stream) {\n  return 0;\n}\n\n"
           'int64_t a_none(void) { return 1; }\n\n}  // extern "C"\n')
    assert _extern_c_functions(src) == {"a_err": 1, "a_launch": 4,
                                        "a_none": 0}
