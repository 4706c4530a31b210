"""The language-model sharding rules of the port against the JAX package's.

``sharding/specs.py``'s five LM rules (``param_pspecs``,
``cohort_state_pspecs``, ``dist_state_pspecs``, ``batch_pspecs``,
``cache_pspecs``) run on the port's meta trees at full size and JAX's on
``jax.eval_shape`` trees with a duck-typed mesh (as
``tests/test_sharding_specs.py`` does), for every arch of the registry on
the two production meshes and a (3, 5) mesh that divides nothing; the specs
must be equal leaf by leaf, ``fsdp`` on and off. Then, in (1, 2) and
(2, 2) gloo worlds, ``put_with_sharding`` of smoke LM trees under
``param_pspecs(fsdp=True)`` (the embedding's entry names two axes,
``("model", "data")``) must give each rank JAX's slice and reassemble bit
for bit through ``gather_shards``.
"""
import functools
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as j_get_arch
from repro.configs.base import FLConfig as JFL
from repro.core.cohort import init_cohort_state as j_init_cohort
from repro.core.cohort import init_dist_state as j_init_dist
from repro.launch.program import _model_batch_sds as j_batch_sds
from repro.models.model import build_model as j_build
from repro.sharding import specs as j_specs
from repro_torch.configs import get_arch, list_archs, smoke_variant
from repro_torch.configs.base import FLConfig
from repro_torch.core.cohort import init_cohort_state, init_dist_state
from repro_torch.launch import multihost
from repro_torch.launch.mesh import ShapeMesh
from repro_torch.launch.program import _model_batch_sds
from repro_torch.models.model import build_model
from repro_torch.sharding import specs as t_specs
from repro_torch.utils.tree import tree_paths

HERE = Path(__file__).resolve()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "3x5": ((3, 5), ("data", "model"))}
CACHE_B, CACHE_LEN = 128, 32_768  # decode_32k's batch and context
WORLD_TIMEOUT = 240.0
WORLD_ARCHS = ("hymba-1.5b", "deepseek-moe-16b", "qwen1.5-110b")


class _FakeMesh:
    """Duck-typed JAX mesh carrying only axis names and sizes."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.devices = np.empty(shape)


def _key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def _jax_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {tuple(_key(k) for k in p): tuple(s) for p, s in flat}


def _port_specs(tree, prefix=()):
    if isinstance(tree, t_specs.PartitionSpec):
        return {prefix: tuple(tree)}
    if hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    else:
        items = sorted(tree.items())
    out = {}
    for k, v in items:
        out.update(_port_specs(v, prefix + (k,)))
    return out


@functools.lru_cache(maxsize=None)
def _jax_trees(arch):
    model = j_build(j_get_arch(arch).model)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return model, params, jax.eval_shape(
        lambda: model.init_cache(CACHE_B, CACHE_LEN))


@functools.lru_cache(maxsize=None)
def _port_trees(arch):
    model = build_model(get_arch(arch).model, "meta")
    return model, model.init(None), model.init_cache(CACHE_B, CACHE_LEN)


def _baxes(names):
    return tuple(a for a in names if a in ("pod", "data"))


def _rules(side, arch, shape, names):
    """The five rules' spec trees on one side, as flat dicts."""
    fl = JFL() if side == "jax" else FLConfig()
    baxes = _baxes(names)
    cohort = int(np.prod([dict(zip(names, shape))[a] for a in baxes]))
    if side == "jax":
        S, mesh, flat = j_specs, _FakeMesh(shape, names), _jax_specs
        model, params, cache = _jax_trees(arch)
        state = jax.eval_shape(lambda p: j_init_cohort(p, cohort), params)
        dist = jax.eval_shape(lambda p: j_init_dist(p, fl), params)
        batch = j_batch_sds(model.cfg, (cohort, 2, 1), 4096)
    else:
        S, mesh, flat = t_specs, ShapeMesh(shape, names), _port_specs
        model, params, cache = _port_trees(arch)
        state = init_cohort_state(params, cohort)
        dist = init_dist_state(params, fl)
        batch = _model_batch_sds(model.cfg, (cohort, 2, 1), 4096)
    out = {}
    for fsdp in (False, True):
        out[f"param fsdp={fsdp}"] = flat(S.param_pspecs(params, mesh, fsdp))
        out[f"cohort fsdp={fsdp}"] = flat(S.cohort_state_pspecs(
            state, mesh, fsdp, client_axes=baxes))
    out["dist"] = flat(S.dist_state_pspecs(dist, mesh))
    out["batch"] = flat(S.batch_pspecs(batch, batch_axes=baxes))
    out["cache"] = flat(S.cache_pspecs(cache, mesh, batch_axes=baxes))
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_lm_rules_equal_jax_leaf_by_leaf(arch, mesh_name):
    shape, names = MESHES[mesh_name]
    got = _rules("torch", arch, shape, names)
    want = _rules("jax", arch, shape, names)
    assert got.keys() == want.keys()
    for rule in want:
        assert got[rule].keys() == want[rule].keys(), rule
        bad = {p: (got[rule][p], s) for p, s in want[rule].items()
               if got[rule][p] != s}
        assert not bad, f"{rule}: {bad}"
    if mesh_name == "16x16":  # the rules shard something on the real mesh
        assert any(e is not None for s in got["param fsdp=True"].values()
                   for e in s)


def _shapes_flat(tree, prefix=()):
    if hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = sorted(tree.items())
    else:
        return {prefix: tuple(getattr(tree, "shape", ()))}
    out = {}
    for k, v in items:
        out.update(_shapes_flat(v, prefix + (k,)))
    return out


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", list_archs())
def test_lm_rules_divide_on_the_production_meshes(arch, mesh_name):
    shape, names = MESHES[mesh_name]
    mesh = ShapeMesh(shape, names)
    baxes = _baxes(names)
    cohort = int(np.prod([t_specs.mesh_axis_size(mesh, a) for a in baxes]))
    model, params, cache = _port_trees(arch)
    trees = [
        (params, t_specs.param_pspecs(params, mesh, False)),
        (params, t_specs.param_pspecs(params, mesh, True)),
        (init_dist_state(params, FLConfig()),
         t_specs.dist_state_pspecs(init_dist_state(params, FLConfig()), mesh)),
        (cache, t_specs.cache_pspecs(cache, mesh, batch_axes=baxes))]
    state = init_cohort_state(params, cohort)
    trees.append((state, t_specs.cohort_state_pspecs(state, mesh,
                                                     client_axes=baxes)))
    n = 0
    for tree, spec in trees:
        shapes, specs = _shapes_flat(tree), _port_specs(spec)
        for path, sp in specs.items():
            for dim, entry in zip(shapes[path], sp):
                n += entry is not None
                assert dim % t_specs.mesh_axis_size(mesh, entry) == 0, \
                    (path, shapes[path], sp)
    assert n > 0


def test_tuple_entries_are_the_product_of_their_axes():
    mesh = ShapeMesh((2, 16, 16), ("pod", "data", "model"))
    assert t_specs.mesh_axis_size(mesh, ("model", "data")) == 256
    assert t_specs.mesh_axis_size(mesh, ("pod", "data")) == 32
    assert t_specs.mesh_axis_size(mesh, ("pod", "absent")) == 2
    assert t_specs.mesh_axis_size(mesh, None) == 1
    assert t_specs.entry_axes(("model", "data")) == ("model", "data")
    assert t_specs.entry_axes("data") == ("data",)
    assert t_specs.entry_axes(None) == ()


# ---------------------------------------------------------------------------
# put_with_sharding / gather_shards in gloo worlds
# ---------------------------------------------------------------------------


def rank_put_gather(trees, meshes):
    """Inside a rank: each tree's leaves put under ``param_pspecs(fsdp=
    True)`` and gathered back, on each (data, model) mesh of this world."""
    import torch.distributed as dist

    from repro_torch.sharding import collectives as C
    from repro_torch.sharding import specs as S

    out = {}
    for data, model in meshes:
        mesh = multihost.make_round_mesh(data, model, device="cpu")
        for arch, tree in trees.items():
            specs = S.param_pspecs(tree, mesh, fsdp=True)
            rec = {}
            for path in tree_paths(tree):
                leaf, spec = tree, specs
                for k in path:
                    leaf, spec = leaf[k], spec[k]
                local = C.put_with_sharding(leaf, mesh, spec)
                whole = C.gather_shards(C.LocalShard(local, mesh, spec))
                rec[path] = (tuple(spec), local.numpy(), whole.numpy())
            out[(data, model, arch)] = rec
        out[("coords", data, model)] = {
            a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}
    out["rank"] = dist.get_rank()
    return out


def _smoke_tree(arch):
    cfg = smoke_variant(get_arch(arch).model)
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))

    def np_tree(t):
        if isinstance(t, dict):
            return {k: np_tree(v) for k, v in t.items()}
        return t.numpy()

    return np_tree(params)


def _expected_slice(value, spec, coords, sizes):
    for dim, entry in enumerate(spec):
        axes = t_specs.entry_axes(entry)
        n = int(np.prod([sizes[a] for a in axes])) if axes else 1
        if n == 1:
            continue
        index = 0
        for a in axes:  # the first axis named is the major one
            index = index * sizes[a] + coords[a]
        chunk = value.shape[dim] // n
        value = np.take(value, np.arange(index * chunk, (index + 1) * chunk),
                        axis=dim)
    return value


@pytest.fixture(scope="module")
def trees():
    return {a: _smoke_tree(a) for a in WORLD_ARCHS}


@pytest.fixture(scope="module")
def world2(trees, tmp_path_factory):
    work = tmp_path_factory.mktemp("lm_world2")
    return multihost.spawn_world(f"{HERE}:rank_put_gather", 2,
                                 {"trees": trees, "meshes": [(1, 2)]},
                                 timeout=WORLD_TIMEOUT, workdir=str(work))


@pytest.fixture(scope="module")
def world4(trees, tmp_path_factory):
    work = tmp_path_factory.mktemp("lm_world4")
    return multihost.spawn_world(f"{HERE}:rank_put_gather", 4,
                                 {"trees": trees, "meshes": [(2, 2)]},
                                 timeout=WORLD_TIMEOUT, workdir=str(work))


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_put_with_sharding_reassembles_lm_trees(world, trees, request):
    ranks = request.getfixturevalue(world)
    data, model = (1, 2) if world == "world2" else (2, 2)
    sizes = {"data": data, "model": model}
    two_axes = 0
    for res in ranks:
        coords = res[("coords", data, model)]
        for arch, tree in trees.items():
            rec = res[(data, model, arch)]
            assert rec.keys() == set(tree_paths(tree))
            for path, (spec, local, whole) in rec.items():
                leaf = tree
                for k in path:
                    leaf = leaf[k]
                np.testing.assert_array_equal(whole, leaf, err_msg=str(path))
                np.testing.assert_array_equal(
                    local, _expected_slice(leaf, spec, coords, sizes),
                    err_msg=f"{arch} {path} {spec}")
                two_axes += any(isinstance(e, tuple) for e in spec)
    # the embedding's ("model", "data") entry ran on every rank and arch
    assert two_axes >= len(ranks) * len(trees)
