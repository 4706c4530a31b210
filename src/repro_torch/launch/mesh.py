"""The meshes of the round substrate (the JAX package's
``launch/mesh.py``).

The port runs one process per rank, so a mesh larger than 1 x 1 needs a
``torch.distributed`` world (``launch/multihost.initialize``), and it covers
the whole world. ``make_production_mesh`` is the exception: the dry run's
production mesh (the JAX package's TPU pod layout, (data 16, model 16) and
a leading ``pod`` axis of 2 on the multi-pod mesh) as shapes and axis names
only, which is all the sharding rules read.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch import multihost
from repro_torch.utils.device import DeviceLike


class ShapeMesh:
    """A mesh of axis names and sizes, with no ranks and no process group:
    what ``sharding/specs.py::mesh_axis_size`` reads of a ``DeviceMesh``
    (``mesh_dim_names`` and ``mesh.shape``; ``mesh`` is a ``meta`` tensor,
    so nothing is allocated). A step cannot run on it; specs and per-rank
    sizes can be read from it."""

    device_type = "meta"

    def __init__(self, shape: Tuple[int, ...], names: Tuple[str, ...]):
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {shape} and names {names} differ "
                             "in length")
        self.mesh_dim_names = tuple(names)
        self.mesh = torch.empty(tuple(shape), dtype=torch.int32,
                                device="meta")

    def __repr__(self) -> str:
        return (f"ShapeMesh({tuple(self.mesh.shape)}, "
                f"{self.mesh_dim_names})")


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """The production mesh as shapes only: (16, 16) ``("data", "model")``,
    or (2, 16, 16) ``("pod", "data", "model")``."""
    if multi_pod:
        return ShapeMesh((2, 16, 16), ("pod", "data", "model"))
    return ShapeMesh((16, 16), ("data", "model"))


def make_host_mesh(model_parallel: int = 1, *, device: DeviceLike = "cuda"):
    """(world / model_parallel, model_parallel) mesh over the whole world."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % model_parallel:
        raise ValueError(f"model_parallel {model_parallel} does not divide "
                         f"the world ({world})")
    return multihost.make_round_mesh(world // model_parallel, model_parallel,
                                     device=device)


def make_round_mesh(data: int = 1, model: int = 0, *,
                    device: DeviceLike = "cuda") -> Optional[Any]:
    """(data, model) mesh for the sharded round substrate, or None for the
    single-device program.

    ``data`` carries the K-client cohort slots, ``model`` the padded flat
    parameter vector and the engine's (R, Np) flat version ring
    (``sharding/specs.ring_pspec``: R * Np / model floats a rank).
    ``model=0`` puts the rest of the world on ``model``. With a process
    group up this delegates to ``multihost.make_round_mesh``; a request
    that comes to 1 x 1 returns None. Without a group only 1 x 1 exists.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    model_ = model or max(1, world // max(data, 1))
    if max(data, 1) * model_ == 1:
        return None
    if not dist.is_initialized():
        raise ValueError(f"mesh ({data}, {model_}) needs a torch.distributed "
                         "world of that many ranks: call "
                         "multihost.initialize first")
    return multihost.make_round_mesh(data, model, device=device)


def batch_axes_for(mesh) -> tuple:
    """The data-parallel axes of a mesh (cohort/batch sharding)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
