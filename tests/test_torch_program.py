"""The port's ``launch/program.py`` Programs against the JAX package's.

Every arch x input shape on the production mesh (and, for a dense, a
hybrid and an encoder-decoder arch, on the multi-pod mesh): the port's Program
(its ``meta`` arguments, PartitionSpec trees, donation and ``meta``
record) equals JAX's, built on a duck-typed mesh with its
``NamedSharding`` wrappers stripped to the specs. JAX's distributed state
keeps ``count`` and ``version`` as int32 scalars; the port keeps them as
host ints (its apply/hold branch is a host one), read here as () int32.
The steps these Programs return are held to JAX's in
``tests/test_torch_program_{cohort,dist,serve}.py``.
"""
import jax
import numpy as np
import pytest

import repro.launch.program as j_program
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import program as t_program
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding.specs import PartitionSpec

# the multi-pod mesh for a dense, a hybrid and an encoder-decoder arch, the
# two FL modes among them (every arch's specs on it:
# tests/test_torch_lm_specs.py)
MULTI_POD_ARCHS = ("qwen1.5-110b", "hymba-1.5b", "whisper-tiny")


class _FakeMesh:
    """Duck-typed JAX mesh carrying only axis names and sizes."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.devices = np.empty(shape)


@pytest.fixture(scope="module")
def j_build_program():
    """JAX's ``build_program`` with its shardings left as PartitionSpecs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_program, "_named", lambda mesh, tree: tree)
        mp.setattr(j_program, "NamedSharding", lambda mesh, spec: spec)
        yield j_program.build_program


def _key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return getattr(k, attr)
    raise TypeError(k)


def _jax_flat(tree, leaf):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {tuple(_key(k) for k in p): leaf(v) for p, v in flat}


def _port_flat(tree, leaf, prefix=()):
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, tuple) and not isinstance(tree, PartitionSpec):
        items = (list(zip(tree._fields, tree)) if hasattr(tree, "_fields")
                 else list(enumerate(tree)))
    else:
        return {prefix: leaf(tree)}
    out = {}
    for k, v in items:
        out.update(_port_flat(v, leaf, prefix + (k,)))
    return out


def _j_sds(x):
    return tuple(x.shape), np.dtype(x.dtype).name


def _t_sds(x):
    if isinstance(x, int):  # the dist state's host count and version
        return (), "int32"
    assert x.device.type == "meta"
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


PAIRS = [(a, s, False) for a in list_archs() for s in INPUT_SHAPES
         if s not in get_arch(a).skip_shapes] + [
    (a, s, True) for a in MULTI_POD_ARCHS for s in INPUT_SHAPES
    if s not in get_arch(a).skip_shapes]


@pytest.mark.parametrize("arch,shape,multi_pod", PAIRS, ids=[
    f"{a}-{s}-{'2x16x16' if m else '16x16'}" for a, s, m in PAIRS])
def test_program_equals_jax(arch, shape, multi_pod, j_build_program):
    mesh = make_production_mesh(multi_pod=multi_pod)
    names = mesh.mesh_dim_names
    got = t_program.build_program(arch, shape, mesh, device="meta")
    want = j_build_program(arch, shape, _FakeMesh(tuple(mesh.mesh.shape),
                                                  names))
    assert (got.name, got.kind, got.donate_argnums, got.static_argnums) == (
        want.name, want.kind, want.donate_argnums, want.static_argnums)
    assert got.meta == want.meta
    assert got.step_mesh is None  # the shape-only mesh: the global step
    assert len(got.arg_sds) == len(want.arg_sds)
    for g, w in zip(got.arg_sds, want.arg_sds):
        assert _port_flat(g, _t_sds) == _jax_flat(w, _j_sds)
    for g, w in ((got.in_shardings, want.in_shardings),
                 (got.out_shardings, want.out_shardings)):
        if w is None:
            assert g is None
            continue
        assert _port_flat(g, tuple) == _jax_flat(w, tuple)


def test_skipped_shapes_raise_as_in_jax():
    with pytest.raises(ValueError, match="skips long_500k"):
        t_program.build_program("whisper-tiny", "long_500k",
                                make_production_mesh(), device="meta")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_program.build_program("hymba-1.5b", "prefill_32k",
                                make_production_mesh())
