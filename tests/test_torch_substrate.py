"""The distributed round substrate (Slice E1) against the JAX package.

The ``rank_*`` functions run inside gloo worlds that
``launch/multihost.spawn_world`` starts: one process per rank, one CPU
thread each, a file store in ``tmp_path``, one spawn per world size. They
load this file by path and run port code only (JAX is imported inside the
tests). The tests feed them numpy inputs, hold every rank's results equal to
rank 0's bit for bit, and hold them to the JAX package's single-device run
at JAX's own sharding tolerances (``tests/test_round_body.py``'s ``TOL``:
the sharded pass changes only the order of the eq. 3 sum). In-process tests
pin the partition specs, the sharded padding and the ring bytes against
JAX's, and a 1 x 1 mesh against no mesh.
"""
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import FLConfig as TFL
from repro_torch.data.synthetic import ClientDataset as TClientDataset
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import multihost
from repro_torch.sharding import specs as t_specs

HERE = Path(__file__).resolve()
TOL = {"new_x": 1e-5, "sq_dists": 1e-3, "weights": 1e-5, "global": 1e-5,
       "client_params": 1e-5, "metrics": 1e-5, "history_wnorm": 1e-5}
QUAD_FL = dict(num_clients=6, buffer_size=2, local_steps=2, local_lr=0.05,
               batch_size=8, max_staleness=4)
ROUNDS = 6
COHORT_MASKS = [[1, 1, 1, 0], [0, 1, 1, 1], [1, 1, 1, 1]]
SPEC_FNS = ("flat_param_pspec", "flat_stacked_pspec", "ring_pspec",
            "ring_codes_pspec", "ring_scales_pspec", "kclient_pspec",
            "client_state_pspec", "info_pspec")
WORLD_TIMEOUT = 240.0
DELTA_DENSITIES = (0.05, 0.75)  # m = 13 and 192 of 256; 128 columns a rank
# collect_windows cases on (2, 1): (preset, n, K, windows, seed)
WINDOW_CASES = {
    "bernoulli": ("dropout-bernoulli", 8, 4, 10, 3),  # _shard_worker's
    "reentry_paper": ("paper-fig1", 4, 3, 12, 5),  # exact windows
    "reentry_bernoulli": ("dropout-bernoulli", 4, 3, 12, 5),
    "k_above_n": ("paper-fig1", 4, 5, 6, 1),  # every window exact
    "n_odd": ("dropout-bernoulli", 7, 3, 10, 2),  # 7 % 2: replicated
    "fast": ("paper-fig1", 600, 16, 6, 0),  # every window fast
    "fast_drops": ("dropout-bernoulli", 600, 16, 6, 0),
}


# ---------------------------------------------------------------------------
# shared inputs (numpy, made from seeds) and port-side helpers
# ---------------------------------------------------------------------------


def _quad_clients(cls, n=6, size=64, d=4, seed=0):
    """tests/_shard_worker.py's quadratic clients, for either package."""
    rng = np.random.default_rng(seed)
    w_true = np.arange(1.0, d + 1.0)
    out = []
    for i in range(n):
        x = rng.normal(size=(size, d)).astype(np.float32)
        y = (x @ w_true + 0.05 * rng.normal(size=size)).astype(np.float32)
        out.append(cls(x=x, y=y, seed=seed + 10 + i))
    return out


def _t_quad(params, batch):
    x, y = batch
    return torch.mean((x @ params["w"] - y) ** 2), {}


def _t_fresh(params, batch):
    return _t_quad(params, batch)[0]


def _t_wnorm(p):
    return {"wnorm": float(torch.sum(p["w"] ** 2))}


def _stack_noisy(tree, k, rng, scale):
    return {key: (_stack_noisy(v, k, rng, scale) if isinstance(v, dict) else
                  (v[None].astype(np.float32) + scale * rng.standard_normal(
                      (k,) + v.shape).astype(np.float32)))
            for key, v in tree.items()}


def _pass_inputs(params, k, seed):
    rng = np.random.default_rng(seed)
    return {"params": params,
            "bases": _stack_noisy(params, k, rng, 0.1),
            "deltas": _stack_noisy(params, k, rng, 0.01),
            "losses": np.linspace(0.5, 2.0, k).astype(np.float32),
            "sizes": np.linspace(10.0, 50.0, k).astype(np.float32),
            "taus": np.arange(k, dtype=np.float32)}


def _quad_batch(rng, *lead, n=8, d=4):
    x = rng.normal(size=lead + (n, d)).astype(np.float32)
    y = (x @ np.arange(1.0, d + 1.0) + 0.01 * rng.normal(
        size=lead + (n,))).astype(np.float32)
    return x, y


def _server_pass_inputs(k=4, seed=2):
    """Stacked trees for make_server_pass, one entry without a probe."""
    rng = np.random.default_rng(seed)
    params = {"w": np.array([1.0, -1.0, 0.5, 2.0], np.float32)}
    out = _pass_inputs(params, k, seed)
    out.update(probes=_quad_batch(rng, k),
               probe_mask=np.array([1, 1, 0, 1], np.float32)[:k])
    return out


def _cohort_rounds(c=4, m=2, seed=0):
    rng = np.random.default_rng(seed)
    return [{"local": _quad_batch(rng, c, m), "probe": _quad_batch(rng, c),
             "arrival": np.asarray(mask, np.float32),
             "data_sizes": np.linspace(10.0, 40.0, c).astype(np.float32)}
            for mask in COHORT_MASKS]


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _engine(mesh, fl_kw=None, **kw):
    from repro_torch.sim.engine import run_vectorized

    fl = TFL(**{**QUAD_FL, **(fl_kw or {})})
    return run_vectorized(_t_quad, {"w": np.zeros(4, np.float32)},
                          _quad_clients(TClientDataset), fl, kw.pop(
                              "total_rounds", ROUNDS), eval_fn=_t_wnorm,
                          eval_every=2, seed=0, mesh=mesh, device="cpu", **kw)


def _record(res):
    return {"round_log": res.round_log, "history": res.history,
            "num_launches": res.num_launches, "num_events": res.num_events,
            "final_w": res.final_params["w"].numpy().copy()}


def _sharded_pass(inputs, mesh, mode, block_n=0):
    """apply_server_round on this rank's slices; the whole new x back."""
    from repro_torch.core.server_pass import (
        apply_server_round,
        flatten_stacked,
        flatten_tree,
        local_columns,
        make_flat_spec,
    )

    params = _tensors(inputs["params"])
    spec = make_flat_spec(params, block_n, mesh)
    new_x, info = apply_server_round(
        local_columns(spec, flatten_tree(spec, params)),
        local_columns(spec, flatten_stacked(spec, _tensors(inputs["bases"]))),
        local_columns(spec, flatten_stacked(spec, _tensors(inputs["deltas"]))),
        *(torch.from_numpy(inputs[f]) for f in ("losses", "sizes", "taus")),
        TFL(weighting="paper"), mode=mode, mesh=mesh)
    new_x = multihost.all_gather_cat(new_x, mesh.get_group("model"))
    return {"new_x": new_x[:spec.n].numpy(), "n_padded": spec.n_padded,
            **{k: v.numpy() for k, v in info.items()}}


def _topk_cases():
    """Signed vectors (numpy, seeded) whose |x| top-k ``top_k_across`` takes
    over a group, with ``k``: ties, zero padding, k above a rank's slice, k
    equal to the length, and a batch of rows."""
    rng = np.random.default_rng(11)
    f = np.float32
    return {
        "distinct": (rng.standard_normal(16).astype(f), 5),
        "duplicates": (rng.integers(-2, 3, 16).astype(f), 7),
        "zero_padding": (np.concatenate([rng.standard_normal(5),
                                         np.zeros(11)]).astype(f), 10),
        "k_above_local": (rng.integers(0, 4, 16).astype(f), 12),
        "k_is_n": (rng.integers(-2, 2, 16).astype(f), 16),
        "rows": (rng.integers(-2, 3, (3, 16)).astype(f), 6),
    }


TOPK_CASES = tuple(_topk_cases())


def _topk_run(cases, mesh, axis):
    """``top_k_across`` of |x| with x as the payload, each rank holding its
    slice of the last axis."""
    from repro_torch.sharding.collectives import top_k_across

    group = mesh.get_group(axis)
    size = dist.get_world_size(group)
    j = mesh.get_local_rank(axis)
    out = {}
    for name, (x, k) in cases.items():
        per = x.shape[-1] // size
        xs = torch.from_numpy(x[..., j * per:(j + 1) * per].copy())
        cols = torch.arange(j * per, (j + 1) * per, dtype=torch.int32)
        v, i, (p,) = top_k_across(xs.abs(), cols, k, group, payload=(xs,))
        out[name] = (v.numpy(), i.numpy(), p.numpy())
    return out


def _delta_fl(density=0.05, refresh=3, **kw):
    return {"ring_codec": "delta", "ring_delta_density": density,
            "ring_base_refresh": refresh, **kw}


def _windows_run(mesh, preset, n, k, t, seed):
    """collect_windows on ``mesh`` with its exact-window count."""
    from repro_torch.obs import MetricsRegistry
    from repro_torch.sim import get_scenario
    from repro_torch.sim.population import collect_windows

    reg = MetricsRegistry()
    multihost.reset_collective_stats()
    w = collect_windows(get_scenario(preset), n, TFL(**{
        **QUAD_FL, "num_clients": n, "buffer_size": k}), t, seed=seed,
        mesh=mesh, device="cpu", registry=reg)
    w.pop("state")
    snap = reg.snapshot()
    return {**w, "exact": snap.get("engine_exact_windows_total", 0.0),
            "collectives": dict(multihost.COLLECTIVE_STATS, seconds=None)}


def _population(mesh, rounds=8, **kw):
    """run_population on the six quadratic clients (tests/_shard_worker.py's
    population setup)."""
    from repro_torch.sim import get_scenario
    from repro_torch.sim.population import run_population

    return run_population(
        _t_quad, {"w": np.zeros(4, np.float32)},
        _quad_clients(TClientDataset), TFL(**QUAD_FL), rounds,
        eval_fn=_t_wnorm, eval_every=2,
        scenario=get_scenario("dropout-bernoulli"), seed=0, mesh=mesh,
        device="cpu", **kw)


def _population_record(mesh):
    """A run, and the same run resumed from its round-4 snapshot."""
    full = _population(mesh, capture_state=True)
    half = _population(mesh, rounds=4, capture_state=True)
    resumed = _population(mesh, init_state=half.final_state,
                          capture_state=True)
    out = {"full": _record(full), "resumed": _record(resumed)}
    for name, res in (("full", full), ("resumed", resumed)):
        st = res.final_state
        out[name]["state"] = [np.asarray(a) for a in (
            st.t_next, st.k_next, st.batch_k, st.base_version)]
        out[name]["num_launches"] = None
    return out


# ---------------------------------------------------------------------------
# rank programs
# ---------------------------------------------------------------------------


def rank_world4(work, lenet, lenet_pass, small_pass, cohort_rounds,
                quad_pass, topk):
    """A world of 4: the (2, 2) and (1, 4) meshes."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.core.cohort import init_cohort_state, make_cohort_step
    from repro_torch.core.server_pass import make_server_pass
    from repro_torch.obs import JsonlSink, MetricsRegistry, export_snapshot
    from repro_torch.sim.engine import (
        engine_state_from_tree,
        engine_state_to_tree,
        init_version_ring,
    )

    work = Path(work)
    rank = dist.get_rank()
    m22 = multihost.make_round_mesh(2, 2, device="cpu")
    m14 = multihost.make_round_mesh(1, 4, device="cpu")
    out = {"rank": rank, "coords": (m22.get_local_rank("data"),
                                    m22.get_local_rank("model"))}
    for name, mesh in (("m14", m14), ("m22", m22)):
        for mode in ("reference", "batched"):
            out[f"pass_{name}_{mode}"] = _sharded_pass(lenet_pass, mesh, mode)
    out["pass_small"] = _sharded_pass(small_pass, m14, "batched")
    pass_fn = make_server_pass(TFL(weighting="paper"), _t_fresh,
                               mode="batched", device="cpu", mesh=m22)
    new_params, info = pass_fn(
        _tensors(quad_pass["params"]), _tensors(quad_pass["deltas"]),
        _tensors(quad_pass["bases"]), tuple(map(torch.from_numpy,
                                                quad_pass["probes"])),
        *(torch.from_numpy(quad_pass[f])
          for f in ("probe_mask", "sizes", "taus")))
    out["server_pass_fn"] = {"w": new_params["w"].numpy(),
                             **{k: v.numpy() for k, v in info.items()}}
    # host <-> rank transfers: a sharded put gathers back to the value
    value = np.arange(24, dtype=np.float32).reshape(3, 8)
    local = multihost.put_with_sharding(value, m22, t_specs.ring_pspec())
    out["put_local"] = local.numpy()
    out["put_fetched"] = multihost.fetch_replicated(
        {"a": multihost.LocalShard(local, m22, t_specs.ring_pspec()),
         "b": multihost.put_replicated({"c": value}, m22)["c"]})
    out["host_mesh"] = tuple(t_mesh.make_host_mesh(2, device="cpu").mesh.shape)

    for policy in ("paper", "fedbuff"):
        out[f"engine_{policy}"] = _record(_engine(m22, {"weighting": policy}))
    out["engine_replicated_ring"] = _record(_engine(m22, shard_ring=False))
    out["engine_single"] = _record(_engine(None))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["engine_k3"] = _record(_engine(m22, {"buffer_size": 3}))
    out["k3_warned"] = any(issubclass(w.category, RuntimeWarning)
                           and "do not divide the data axis" in str(w.message)
                           for w in caught)
    out["engine_k3_single"] = _record(_engine(None, {"buffer_size": 3}))

    step = make_cohort_step(_t_quad, TFL(buffer_size=4, local_steps=2,
                                         local_lr=0.1, weighting="paper"),
                            mesh=m22, device="cpu")
    state = init_cohort_state({"w": torch.tensor([1.0, -1.0, 0.5, 2.0])}, 4)
    out["cohort"] = []
    for batch in cohort_rounds:
        state, mets = step(state, batch)
        out["cohort"].append({
            "global": state.global_params["w"].numpy().copy(),
            "client_params": state.client_params["w"].numpy().copy(),
            "client_version": state.client_version.numpy().copy(),
            "metrics": {k: float(v) for k, v in mets.items()}})

    # checkpoint of a sharded run: saved by rank 0, resumed by every rank
    full = _engine(m22, capture_state=True)
    half = _engine(m22, total_rounds=3, capture_state=True)
    tree = engine_state_to_tree(half.final_state)
    save_checkpoint(str(work / "engine.npz"), tree, step=3)
    multihost.barrier()
    loaded, step_no = load_checkpoint(str(work / "engine.npz"), like=tree)
    out["resume_step"] = step_no
    out["engine_full"] = _record(full)
    for shard_ring in (True, False):
        res = _engine(m22, init_state=engine_state_from_tree(loaded),
                      shard_ring=shard_ring, capture_state=True)
        out[f"engine_resumed_{shard_ring}"] = _record(res)
    # a LocalShard leaf is gathered on save: the whole ring lands on disk
    spec, ring = init_version_ring(_tensors(lenet), TFL(), mesh=m22)
    out["ring_local_shape"] = tuple(ring.shape)
    save_checkpoint(str(work / "ring.npz"), {"ring": multihost.LocalShard(
        ring, m22, t_specs.ring_pspec())})

    # Slice E2: the delta ring on (2, 2), its checkpoint; top_k_across over
    # 4 ranks; the population engine on (4, 1) and (2, 2)
    out["engine_delta"] = _record(_engine(m22, _delta_fl()))
    out["engine_delta_replicated"] = _record(_engine(m22, _delta_fl(),
                                                     shard_ring=False))
    full = _engine(m22, _delta_fl(), capture_state=True)
    half = _engine(m22, _delta_fl(), total_rounds=3, capture_state=True)
    tree = engine_state_to_tree(half.final_state)
    save_checkpoint(str(work / "engine_delta.npz"), tree, step=3)
    multihost.barrier()
    loaded, _ = load_checkpoint(str(work / "engine_delta.npz"), like=tree)
    out["engine_delta_full"] = _record(full)
    for shard_ring in (True, False):
        res = _engine(m22, _delta_fl(), shard_ring=shard_ring,
                      init_state=engine_state_from_tree(loaded),
                      capture_state=True)
        out[f"engine_delta_resumed_{shard_ring}"] = _record(res)
    out["topk"] = _topk_run(topk, m14, "model")
    m41 = multihost.make_round_mesh(4, 1, device="cpu")
    out["win_m41"] = _windows_run(m41, "dropout-bernoulli", 8, 4, 10, 3)
    out["pop_m41"] = _record(_population(m41))
    out["pop_m22"] = _population_record(m22)

    sink = JsonlSink(str(work / f"sink_rank{rank}.jsonl"))
    sink.emit({"event": "hello", "rank": rank})
    sink.close()
    out["snapshot_exported"] = export_snapshot(MetricsRegistry()) is not None
    return out


def rank_world2(lenet, topk):
    """A world of 2: the (1, 2) mesh (int8 and delta rings, ring bytes) and
    the (2, 1) mesh (the population engine)."""
    from repro_torch.core.version_store import (
        ring_device_bytes,
        ring_provenance,
        state_tensors,
    )
    from repro_torch.sim.engine import init_version_ring

    m12 = multihost.make_round_mesh(1, 2, device="cpu")
    m21 = multihost.make_round_mesh(2, 1, device="cpu")
    out = {}
    for codec in ("f32", "int8"):
        for shard_ring in (True, False):
            out[f"engine_{codec}_{shard_ring}"] = _record(_engine(
                m12, {"ring_codec": codec}, shard_ring=shard_ring))
    # Slice E2: the delta ring at two densities (m below and above a
    # rank's 128 columns), sharded and replicated, and on (2, 1)
    for density in DELTA_DENSITIES:
        for shard_ring in (True, False):
            out[f"engine_delta_{density}_{shard_ring}"] = _record(_engine(
                m12, _delta_fl(density), shard_ring=shard_ring))
    out["engine_delta_m21"] = _record(_engine(m21, _delta_fl()))
    out["topk"] = _topk_run(topk, m12, "model")
    for name, args in WINDOW_CASES.items():
        out[f"win_{name}"] = _windows_run(m21, *args)
    out["win_m12"] = _windows_run(m12, *WINDOW_CASES["bernoulli"])
    out["pop_m21"] = _population_record(m21)
    for codec in ("f32", "int8", "delta"):
        fl = TFL(ring_codec=codec)
        spec, ring = init_version_ring(_tensors(lenet), fl, mesh=m12)
        out[f"ring_bytes_{codec}"] = (
            sum(t.numel() * t.element_size() for t in state_tensors(ring)),
            ring_device_bytes(fl, spec, 2), ring_device_bytes(fl, spec),
            ring_provenance())
    return out


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def _assert_identical(a, b, where="result"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_identical(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_identical(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), where
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _assert_runs_close(got, ref, fields=("weights", "sq_dists")):
    """A port run against a reference run (round log, history, params)."""
    assert got["num_events"] == ref.num_events
    assert [(r["version"], r["clients"], r["tau"]) for r in got["round_log"]] \
        == [(r["version"], r["clients"], r["tau"]) for r in ref.round_log]
    for a, b in zip(got["round_log"], ref.round_log):
        for f in fields:
            assert _max_err(a[f], b[f]) <= TOL[f], (a["version"], f)
    assert [h["round"] for h in got["history"]] == \
        [h["round"] for h in ref.history]
    assert max(abs(a["wnorm"] - b["wnorm"]) for a, b in
               zip(got["history"], ref.history)) <= TOL["history_wnorm"]


def _jax():
    import jax
    import jax.numpy as jnp

    return jax, jnp


def _jax_engine(fl_kw=None, total_rounds=ROUNDS):
    jax, jnp = _jax()
    from repro.configs.base import FLConfig as JFL
    from repro.data.synthetic import ClientDataset as JClientDataset
    from repro.sim.engine import run_vectorized

    def loss(params, batch):
        x, y = batch
        return jnp.mean((x @ params["w"] - y) ** 2), {}

    return run_vectorized(
        loss, {"w": jnp.zeros(4)}, _quad_clients(JClientDataset),
        JFL(**{**QUAD_FL, **(fl_kw or {})}), total_rounds=total_rounds,
        eval_fn=lambda p: {"wnorm": float(jnp.sum(p["w"] ** 2))},
        eval_every=2, seed=0, capture_state=True)


def _jax_pass(inputs):
    jax, jnp = _jax()
    from repro.configs.base import FLConfig as JFL
    from repro.core import server_pass as jsp

    params = jax.tree.map(jnp.asarray, inputs["params"])
    spec = jsp.make_flat_spec(params, 0)
    new_x, info = jsp.apply_server_round(
        jsp.flatten_tree(spec, params),
        jsp.flatten_stacked(spec, jax.tree.map(jnp.asarray, inputs["bases"])),
        jsp.flatten_stacked(spec, jax.tree.map(jnp.asarray, inputs["deltas"])),
        *(jnp.asarray(inputs[f]) for f in ("losses", "sizes", "taus")),
        JFL(weighting="paper"), mode="reference", block_n=spec.block_n)
    return {"new_x": np.asarray(new_x[:spec.n]),
            **{k: np.asarray(v) for k, v in info.items()}}


@pytest.fixture(scope="module")
def lenet_np():
    jax, _ = _jax()
    from repro.models.lenet import init_lenet

    return jax.tree.map(np.asarray, init_lenet(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def world4(lenet_np, tmp_path_factory):
    work = tmp_path_factory.mktemp("world4")
    small = {"w": np.linspace(-1.0, 1.0, 100).astype(np.float32)}
    kwargs = {"work": str(work), "lenet": lenet_np,
              "lenet_pass": _pass_inputs(lenet_np, 8, 0),
              "small_pass": _pass_inputs(small, 4, 1),
              "cohort_rounds": _cohort_rounds(),
              "quad_pass": _server_pass_inputs(), "topk": _topk_cases()}
    ranks = multihost.spawn_world(f"{HERE}:rank_world4", 4, kwargs,
                                  timeout=WORLD_TIMEOUT,
                                  workdir=str(work / "spawn"))
    return SimpleNamespace(ranks=ranks, **{**kwargs, "work": work})


@pytest.fixture(scope="module")
def world2(lenet_np, tmp_path_factory):
    work = tmp_path_factory.mktemp("world2")
    return multihost.spawn_world(f"{HERE}:rank_world2", 2,
                                 {"lenet": lenet_np, "topk": _topk_cases()},
                                 timeout=WORLD_TIMEOUT, workdir=str(work))


# ---------------------------------------------------------------------------
# in-process pins: specs, padding, bytes, the 1 x 1 mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", SPEC_FNS)
def test_partition_specs_match_jax(name):
    from repro.sharding import specs as j_specs

    got, want = getattr(t_specs, name)(), getattr(j_specs, name)()
    assert isinstance(got, t_specs.PartitionSpec)
    assert tuple(got) == tuple(want)
    assert (t_specs.MODEL_AXIS, t_specs.DATA_AXIS) == (j_specs.MODEL_AXIS,
                                                       j_specs.DATA_AXIS)


class _JaxStubMesh:
    """What JAX's make_flat_spec reads of a mesh."""

    def __init__(self, data, model):
        self.axis_names = ("data", "model")
        self.devices = np.empty((data, model))


def _port_stub_mesh(data, model):
    """What the port's make_flat_spec reads of a DeviceMesh."""
    return SimpleNamespace(mesh_dim_names=("data", "model"),
                           mesh=torch.empty((data, model)),
                           device_type="cpu")


@pytest.mark.parametrize("model", [2, 4, 8])
@pytest.mark.parametrize("tree", ["lenet", "small", "tiny"])
def test_sharded_padding_matches_jax(lenet_np, tree, model):
    jax, jnp = _jax()
    from repro.core import server_pass as jsp
    from repro_torch.core import server_pass as tsp

    np_tree = {"lenet": lenet_np,
               "small": {"a": np.arange(7.0, dtype=np.float32),
                         "b": np.ones((3, 5), np.float32)},
               "tiny": {"w": np.zeros(100, np.float32)}}[tree]
    js = jsp.make_flat_spec(jax.tree.map(jnp.asarray, np_tree),
                            mesh=_JaxStubMesh(2, model))
    ts = tsp.make_flat_spec(_tensors(np_tree), mesh=_port_stub_mesh(2, model))
    assert isinstance(ts, tsp.ShardedFlatSpec)
    assert (ts.n, ts.n_padded, ts.block_n, ts.model_shards) == \
        (js.n, js.n_padded, js.block_n, js.model_shards)
    assert ts.n_padded % (ts.block_n * model) == 0
    flat = tsp.make_flat_spec(_tensors(np_tree), mesh=_port_stub_mesh(8, 1))
    assert isinstance(flat, tsp.FlatSpec)


@pytest.mark.parametrize("model", [1, 2, 4, 8])
@pytest.mark.parametrize("codec", ["f32", "int8", "delta"])
def test_ring_device_bytes_match_jax(lenet_np, codec, model):
    jax, jnp = _jax()
    from repro.configs.base import FLConfig as JFL
    from repro.core import server_pass as jsp
    from repro.core import version_store as jvs
    from repro_torch.core import server_pass as tsp
    from repro_torch.core import version_store as tvs

    js = jsp.make_flat_spec(jax.tree.map(jnp.asarray, lenet_np),
                            mesh=_JaxStubMesh(1, model))
    ts = tsp.make_flat_spec(_tensors(lenet_np), mesh=_port_stub_mesh(1, model))
    got = tvs.ring_device_bytes(TFL(ring_codec=codec), ts, model)
    assert got == jvs.ring_device_bytes(JFL(ring_codec=codec), js, model)


def test_one_by_one_mesh_is_the_single_device_program(tmp_path):
    multihost.initialize(f"file://{tmp_path / 'store'}", 1, 0)
    try:
        assert t_mesh.make_round_mesh(1, 1, device="cpu") is None
        mesh = multihost.make_round_mesh(1, 1, device="cpu")
        assert multihost.is_coordinator()
        assert not multihost.mesh_spans_processes(mesh)
        assert t_mesh.batch_axes_for(mesh) == ("data",)
        _assert_identical(_record(_engine(mesh, capture_state=True)),
                          _record(_engine(None, capture_state=True)))
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="torch.distributed world"):
        t_mesh.make_round_mesh(2, 1, device="cpu")


# ---------------------------------------------------------------------------
# the world of 4: (2, 2) and (1, 4)
# ---------------------------------------------------------------------------


def test_ranks_agree_bit_for_bit(world4, world2):
    for ranks in (world4.ranks, world2):
        ref = {k: v for k, v in ranks[0].items()
               if k not in ("rank", "coords", "snapshot_exported",
                            "put_local")}
        for r in ranks[1:]:
            _assert_identical({k: r[k] for k in ref}, ref)
    assert [r["coords"] for r in world4.ranks] == [(0, 0), (0, 1), (1, 0),
                                                    (1, 1)]


@pytest.mark.parametrize("case", ["pass_m14_reference", "pass_m14_batched",
                                  "pass_m22_reference", "pass_m22_batched",
                                  "pass_small"])
def test_sharded_server_pass_matches_jax(world4, case):
    inputs = world4.small_pass if case == "pass_small" else world4.lenet_pass
    got, want = world4.ranks[0][case], _jax_pass(inputs)
    for field in ("new_x", "sq_dists", "weights"):
        assert _max_err(got[field], want[field]) <= TOL[field], field
    assert got["n_padded"] % (4 if "m14" in case or case == "pass_small"
                              else 2) == 0


@pytest.mark.parametrize("policy", ["paper", "fedbuff"])
def test_sharded_engine_matches_jax(world4, policy):
    _assert_runs_close(world4.ranks[0][f"engine_{policy}"],
                       _jax_engine({"weighting": policy}))


def test_sharded_ring_equals_replicated_ring(world4, world2):
    _assert_identical(world4.ranks[0]["engine_replicated_ring"],
                      world4.ranks[0]["engine_paper"])
    for codec in ("f32", "int8"):
        _assert_identical(world2[0][f"engine_{codec}_False"],
                          world2[0][f"engine_{codec}_True"])


def test_launches_do_not_grow_with_the_world(world4):
    r = world4.ranks[0]
    assert r["engine_paper"]["num_launches"] == \
        r["engine_single"]["num_launches"] == _jax_engine().num_launches


def test_non_dividing_k_warns_and_falls_back(world4):
    r = world4.ranks[0]
    assert r["k3_warned"]
    single = r["engine_k3_single"]
    got = r["engine_k3"]
    assert [row["clients"] for row in got["round_log"]] == \
        [row["clients"] for row in single["round_log"]]
    for a, b in zip(got["round_log"], single["round_log"]):
        assert _max_err(a["weights"], b["weights"]) <= TOL["weights"]
    assert _max_err(got["final_w"], single["final_w"]) <= TOL["global"]


def test_sharded_cohort_matches_jax(world4):
    jax, jnp = _jax()
    from repro.configs.base import FLConfig as JFL
    from repro.core.cohort import init_cohort_state, make_cohort_step

    def loss(params, batch):
        x, y = batch
        return jnp.mean((x @ params["w"] - y) ** 2), {}

    step = jax.jit(make_cohort_step(loss, JFL(
        buffer_size=4, local_steps=2, local_lr=0.1, weighting="paper",
        server_pass_mode="reference")))
    state = init_cohort_state({"w": jnp.array([1.0, -1.0, 0.5, 2.0])}, 4)
    for batch, got in zip(world4.cohort_rounds, world4.ranks[0]["cohort"]):
        state, mets = step(state, jax.tree.map(jnp.asarray, batch))
        assert _max_err(got["global"], state.global_params["w"]) <= \
            TOL["global"]
        assert _max_err(got["client_params"], state.client_params["w"]) <= \
            TOL["client_params"]
        assert np.array_equal(got["client_version"],
                              np.asarray(state.client_version))
        for k, v in got["metrics"].items():
            assert abs(v - float(mets[k])) <= TOL["metrics"], k


def test_sharded_checkpoint_resumes_bit_identically(world4):
    r = world4.ranks[0]
    assert r["resume_step"] == 3
    full = dict(r["engine_full"], num_launches=None)
    for shard_ring in (True, False):  # a sharded ring, and whole rows
        _assert_identical(dict(r[f"engine_resumed_{shard_ring}"],
                               num_launches=None), full)


def test_sharded_checkpoint_loads_into_jax(world4, lenet_np):
    jax, jnp = _jax()
    from repro.checkpoint.ckpt import load_checkpoint
    from repro.configs.base import FLConfig as JFL
    from repro.sim.engine import engine_state_from_tree

    # the engine state: the whole ring of the sharded spec's layout
    flat, step = load_checkpoint(str(world4.work / "engine.npz"))
    assert step == 3
    ring = flat["['ring']"]
    assert ring.shape == (QUAD_FL["max_staleness"] + 1, 256)
    tree, _ = load_checkpoint(str(world4.work / "engine.npz"),
                              like=_jax_like(flat))
    state = engine_state_from_tree(tree)
    assert state.version == 3 and state.ring.shape == ring.shape
    # a LocalShard leaf gathered on save, the shards joined in rank order
    saved, _ = load_checkpoint(str(world4.work / "ring.npz"))
    whole = saved["['ring']"]
    assert world4.ranks[0]["ring_local_shape"] == (33, whole.shape[1] // 2)
    from repro.core import server_pass as jsp
    params = jax.tree.map(jnp.asarray, lenet_np)
    spec = jsp.make_flat_spec(params, 0, mesh=_JaxStubMesh(2, 2))
    row = np.asarray(jsp.flatten_tree(spec, params))
    assert whole.shape == (JFL().max_staleness + 1, spec.n_padded)
    assert all(np.array_equal(r, row) for r in whole)


def _jax_like(flat):
    """A template tree of the saved keys' shapes (JAX's keystr paths)."""
    like = {}
    for key, arr in flat.items():
        node = like
        parts = [p.strip("'") for p in key[1:-1].split("][")]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.zeros(arr.shape, arr.dtype)
    return like


def test_sharded_make_server_pass_matches_jax(world4):
    jax, jnp = _jax()
    from repro.configs.base import FLConfig as JFL
    from repro.core.server_pass import make_server_pass

    def fresh(params, batch):
        x, y = batch
        return jnp.mean((x @ params["w"] - y) ** 2)

    q = world4.quad_pass
    pass_fn = make_server_pass(JFL(weighting="paper"), fresh,
                               mode="reference")
    new_params, info = pass_fn(*(jax.tree.map(jnp.asarray, q[f]) for f in (
        "params", "deltas", "bases", "probes", "probe_mask", "sizes",
        "taus")))
    got = world4.ranks[0]["server_pass_fn"]
    assert _max_err(got["w"], new_params["w"]) <= TOL["global"]
    for field in ("sq_dists", "weights", "fresh_loss"):
        assert _max_err(got[field], info[field]) <= TOL["weights"], field


def test_put_and_fetch_round_trip(world4):
    value = np.arange(24, dtype=np.float32).reshape(3, 8)
    for r in world4.ranks:  # rank (i, j) holds columns [4j, 4j + 4)
        j = r["coords"][1]
        assert np.array_equal(r["put_local"], value[:, 4 * j:4 * j + 4])
        assert np.array_equal(r["put_fetched"]["a"], value)
        assert np.array_equal(r["put_fetched"]["b"], value)
        assert r["host_mesh"] == (2, 2)


def test_only_rank_zero_writes_a_sink(world4):
    files = sorted(p.name for p in world4.work.glob("sink_rank*.jsonl"))
    assert files == ["sink_rank0.jsonl"]
    assert [r["snapshot_exported"] for r in world4.ranks] == [True, False,
                                                              False, False]


# ---------------------------------------------------------------------------
# the world of 2: (1, 2)
# ---------------------------------------------------------------------------


def test_sharded_int8_ring_matches_jax(world2):
    _assert_runs_close(world2[0]["engine_int8_True"],
                       _jax_engine({"ring_codec": "int8"}))


@pytest.mark.parametrize("codec", ["f32", "int8"])
def test_ring_bytes_per_rank(world2, codec):
    got, quoted, whole, provenance = world2[0][f"ring_bytes_{codec}"]
    assert got == quoted
    assert 2 * got == whole
    assert provenance == {"ring_codec": codec, "ring_bytes_per_device": got}


@pytest.mark.parametrize("codec", ["delta"])
def test_delta_ring_bytes_per_rank(world2, lenet_np, codec):
    """A model-sharded delta ring holds the rank's base slice and the whole
    sparse rows: ``per_shard_np * 4 + depth * m * 8 + 4`` bytes, as
    ``ring_provenance`` quotes; not the replicated ring's."""
    got, quoted, whole, provenance = world2[0][f"ring_bytes_{codec}"]
    spec_np = 65_536  # LeNet on the (1, 2) layout
    m = round(0.05 * spec_np)
    assert got == quoted == spec_np // 2 * 4 + 33 * m * 8 + 4
    assert whole - got == spec_np // 2 * 4
    assert provenance == {"ring_codec": codec, "ring_bytes_per_device": got}


# ---------------------------------------------------------------------------
# Slice E2: top_k_across, the delta ring and the population engine on a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", TOPK_CASES)
def test_top_k_across_matches_lax_top_k(request, world, case):
    """Values and indices equal ``jax.lax.top_k``'s (ties to the lower
    index), and the payload rides beside each winner."""
    jax, jnp = _jax()
    ranks = (request.getfixturevalue("world2") if world == 2
             else request.getfixturevalue("world4").ranks)
    x, k = _topk_cases()[case]
    want_v, want_i = jax.lax.top_k(jnp.abs(jnp.asarray(x)), k)
    for r in ranks:
        v, i, p = r["topk"][case]
        np.testing.assert_array_equal(i, np.asarray(want_i))
        assert v.tobytes() == np.asarray(want_v).tobytes()
        np.testing.assert_array_equal(p, np.take_along_axis(x, i, -1))


def _jax_delta(fl_kw):
    return _jax_engine({**fl_kw, "server_pass_block_n": 256})


@pytest.mark.parametrize("density", DELTA_DENSITIES)
def test_sharded_delta_ring_matches_jax_at_1x2(world2, density):
    """(1, 2) pads the quadratic model to n_padded 256; JAX's single-device
    run gets the same 256 from server_pass_block_n = 256, so both keep
    m = round(density * 256) entries a row. Base refreshes at writes 3, 6."""
    _assert_runs_close(world2[0][f"engine_delta_{density}_True"],
                       _jax_delta(_delta_fl(density)))


@pytest.mark.parametrize("density", DELTA_DENSITIES)
def test_sharded_delta_ring_is_the_single_device_ring(world2, world4,
                                                      density):
    """Every step of the sharded delta ring (the top-m across ranks, eq. 3
    on the joined x - base, the refresh) is the single device's bit for bit,
    so at the same n_padded (256) the (1, 2) and (2, 2) runs equal the
    port's single-device run exactly."""
    single = _record(_engine(None, _delta_fl(density,
                                             server_pass_block_n=256)))
    _assert_identical(world2[0][f"engine_delta_{density}_True"], single)
    if density == DELTA_DENSITIES[0]:
        _assert_identical(world4.ranks[0]["engine_delta"], single)


def test_sharded_delta_ring_matches_jax_at_2x2(world4):
    _assert_runs_close(world4.ranks[0]["engine_delta"],
                       _jax_delta(_delta_fl()))


def test_delta_ring_on_a_data_only_mesh_matches_jax(world2):
    """(2, 1): whole rows on every rank, n_padded 128 as on one device."""
    _assert_runs_close(world2[0]["engine_delta_m21"],
                       _jax_engine(_delta_fl()))


@pytest.mark.parametrize("density", DELTA_DENSITIES)
def test_sharded_delta_ring_equals_replicated_ring(world2, world4, density):
    _assert_identical(world2[0][f"engine_delta_{density}_False"],
                      world2[0][f"engine_delta_{density}_True"])
    if density == DELTA_DENSITIES[0]:
        _assert_identical(world4.ranks[0]["engine_delta_replicated"],
                          world4.ranks[0]["engine_delta"])


def test_sharded_delta_checkpoint_resumes_bit_identically(world4):
    r = world4.ranks[0]
    full = dict(r["engine_delta_full"], num_launches=None)
    for shard_ring in (True, False):
        _assert_identical(dict(r[f"engine_delta_resumed_{shard_ring}"],
                               num_launches=None), full)


def test_sharded_delta_checkpoint_loads_into_jax(world4):
    from repro.checkpoint.ckpt import load_checkpoint
    from repro.sim.engine import engine_state_from_tree

    flat, step = load_checkpoint(str(world4.work / "engine_delta.npz"))
    assert step == 3
    tree, _ = load_checkpoint(str(world4.work / "engine_delta.npz"),
                              like=_jax_like(flat))
    state = engine_state_from_tree(tree)
    ring = state.ring
    assert state.version == 3 and str(ring["codec"]) == "delta"
    # the base gathered to the whole (2, 2) layout; the sparse rows as held
    assert ring["base"].shape == (256,)
    assert ring["idx"].shape == ring["val"].shape == (
        QUAD_FL["max_staleness"] + 1, 13)
    assert int(ring["writes"]) == 3


def _port_windows(preset, n, k, t, seed):
    from repro_torch.sim import get_scenario
    from repro_torch.sim.population import collect_windows

    return collect_windows(get_scenario(preset), n, TFL(**{
        **QUAD_FL, "num_clients": n, "buffer_size": k}), t, seed=seed,
        device="cpu")


def _jax_windows(preset, n, k, t, seed):
    from repro.configs.base import FLConfig as JFL
    from repro.sim import population as jpop
    from repro.sim.scenarios import get_scenario as j_scenario

    return jpop.collect_windows(j_scenario(preset), n, JFL(**{
        **QUAD_FL, "num_clients": n, "buffer_size": k}), t, seed=seed)


def _assert_windows_equal(got, want, exact_t=True):
    for f in ("clients", "tau", "slots"):
        np.testing.assert_array_equal(got[f], np.asarray(want[f]), f)
    if exact_t:
        np.testing.assert_array_equal(got["t"], np.asarray(want["t"]))
    else:
        np.testing.assert_allclose(got["t"], np.asarray(want["t"]),
                                   rtol=1e-5, atol=1e-5)
    assert got["num_events"] == want["num_events"]


@pytest.mark.parametrize("case", list(WINDOW_CASES) + ["m12", "m41"])
def test_sharded_windows_match_jax_exactly(world2, world4, case):
    """collect_windows on (2, 1) (and (1, 2), (4, 1)) == the port's single
    device bit for bit == JAX's single device (cids, tau, slots, events
    exact; times to JAX's own tolerance, in practice equal)."""
    args = WINDOW_CASES["bernoulli" if case in ("m12", "m41") else case]
    got = (world4.ranks[0] if case == "m41" else world2[0])[f"win_{case}"]
    _assert_windows_equal(got, _port_windows(*args))
    _assert_windows_equal(got, _jax_windows(*args), exact_t=False)


def test_exact_windows_are_taken_and_agreed(world2, world4):
    """Re-entry and K > N windows run the exact walk on every rank alike;
    every read that steers a collective is the same on every rank."""
    for case in ("reentry_paper", "reentry_bernoulli", "k_above_n"):
        r = world2[0][f"win_{case}"]
        assert r["exact"] > 0, case
    assert world2[0]["win_k_above_n"]["exact"] == WINDOW_CASES[
        "k_above_n"][3]
    assert world2[0]["win_fast"]["exact"] == 0
    for ranks in (world2, world4.ranks):
        for key in [k for k in ranks[0] if k.startswith("win_")]:
            assert all(r[key]["agreed"] == ranks[0][key]["agreed"]
                       for r in ranks[1:]), key
            assert ranks[0][key]["agreed"]["reads"] >= 1


@pytest.mark.parametrize("case", ["fast", "fast_drops"])
def test_fast_windows_gather_no_client_state(world2, case):
    """A fast window moves one candidate list a rank (K candidates of 12
    words: key, cid, t, k, drops, base version, batch counter, speed, comm,
    phase), plus one drop-count sum when the scenario drops; never the
    (N,) state, and no exact window ran."""
    preset, n, k, t, _ = WINDOW_CASES[case]
    r = world2[0][f"win_{case}"]
    drops = case == "fast_drops"
    per_window = 2 * k * 12 * 4 + (2 * 4 if drops else 0)
    assert r["exact"] == 0
    assert r["collectives"]["calls"] == t * (2 if drops else 1)
    assert r["collectives"]["bytes"] == t * per_window
    assert per_window < n * 4  # less than one (N,) f32 field


def _jax_population(rounds=8):
    jax, jnp = _jax()
    from repro.configs.base import FLConfig as JFL
    from repro.data.synthetic import ClientDataset as JClientDataset
    from repro.sim.population import run_population
    from repro.sim.scenarios import get_scenario as j_scenario

    def loss(params, batch):
        x, y = batch
        return jnp.mean((x @ params["w"] - y) ** 2), {}

    return run_population(
        loss, {"w": jnp.zeros(4)}, _quad_clients(JClientDataset),
        JFL(**QUAD_FL), total_rounds=rounds,
        eval_fn=lambda p: {"wnorm": float(jnp.sum(p["w"] ** 2))},
        eval_every=2, scenario=j_scenario("dropout-bernoulli"), seed=0)


@pytest.mark.parametrize("case", ["pop_m21", "pop_m22", "pop_m41"])
def test_sharded_population_matches_jax(world2, world4, case):
    """run_population on (2, 1) and (2, 2) (the (N,) state split over data)
    and (4, 1) (6 clients do not divide 4: replicated) against JAX's single
    device: windows exact, weights and history at TOL."""
    r = (world2[0] if case == "pop_m21" else world4.ranks[0])[case]
    got = r["full"] if case != "pop_m41" else r
    _assert_runs_close(got, _jax_population())


@pytest.mark.parametrize("case", ["pop_m21", "pop_m22"])
def test_sharded_population_resumes_bit_identically(world2, world4, case):
    r = (world2[0] if case == "pop_m21" else world4.ranks[0])[case]
    _assert_identical(r["resumed"], r["full"])
