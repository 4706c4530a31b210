"""The meshes of the round substrate (the JAX package's
``launch/mesh.py``).

The port runs one process per rank, so a mesh larger than 1 x 1 needs a
``torch.distributed`` world (``launch/multihost.initialize``), and it covers
the whole world. ``make_production_mesh`` (the TPU pod mesh of the LM dry
run) is not ported here: it comes with the dry run (Slice F, ROADMAP.md).
"""
from __future__ import annotations

from typing import Any, Optional

import torch.distributed as dist

from repro_torch.launch import multihost
from repro_torch.utils.device import DeviceLike


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
