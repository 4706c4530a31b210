"""Multi-process execution substrate on ``torch.distributed``.

One process per rank and one device per rank, every rank running the same
program (the JAX package's single-program multi-controller, its
``launch/multihost.py``). ``initialize`` brings up the process group and
``make_round_mesh`` builds the ``("data", "model")`` ``DeviceMesh`` over the
whole world, ranks laid out row-major: rank ``r`` at ``(r // model, r %
model)``. Every rank walks the same seeded host event heap, so the round's
host metadata agrees without communication.

The collectives, the put/fetch helpers and the coordinator gate live in
``sharding/collectives.py`` (the core layers import them from there) and
are re-exported here, so a launcher reaches the whole substrate through
this module.

Backends: ``gloo`` by default. Ranks that share one card must use it
(NCCL refuses two ranks on one device). ``nccl`` is for a rank per card;
it is untested here (the card's machine has one card).

``spawn_world`` starts a world of rank processes that each run one
function (``python -m repro_torch.launch.multihost``), and kills the rest
of the world on the first rank that fails or at a timeout.
"""
from __future__ import annotations

import argparse
import datetime
import importlib
import importlib.util
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.sharding.collectives import (  # noqa: F401 (re-exported)
    COLLECTIVE_STATS,
    LocalShard,
    all_gather_cat,
    barrier,
    fetch_replicated,
    gather_shards,
    is_coordinator,
    local_slice,
    mesh_device,
    mesh_spans_processes,
    put_replicated,
    put_with_sharding,
    reset_collective_stats,
    sum_in_rank_order,
)
from repro_torch.sharding.specs import DATA_AXIS, MODEL_AXIS
from repro_torch.utils.device import DeviceLike, resolve_device

DEFAULT_TIMEOUT_S = 120.0


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               *, backend: Optional[str] = None,
               timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """Bring up the process group for this rank. Idempotent per process.

    ``coordinator_address`` is ``host:port`` (a TCP store) or a URL such as
    ``file:///path/to/store`` or ``tcp://host:port``. ``backend`` defaults to
    ``gloo``; ``nccl`` binds the rank to card ``process_id % device_count``.
    Every collective waits at most ``timeout`` seconds, so a rank that died
    leaves the others with an error, not a hang.
    """
    if dist.is_initialized():
        return
    backend = backend or "gloo"
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout))


def make_round_mesh(data: int = 0, model: int = 0, *,
                    device: DeviceLike = "cuda"):
    """The ``("data", "model")`` ``DeviceMesh`` over the whole world.

    Ranks are laid out row-major. ``data=0`` puts one rank on each data row
    (``model`` 1 unless given); ``model=0`` spreads the world over ``model``
    after ``data``. ``data`` must divide the world, and the mesh covers it.
    ``device`` names the ranks' device type (``cuda`` unless asked
    otherwise); ranks sharing one card all use the current device.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call multihost.initialize first")
    world = dist.get_world_size()
    if data == 0:
        data = world // model if model else world
    if data < 1 or world % data:
        raise ValueError(f"data axis ({data}) must divide the world ({world})")
    if model == 0:
        model = world // data
    if data * model != world:
        raise ValueError(f"mesh ({data}, {model}) must cover the world of "
                         f"{world} ranks")
    dev = resolve_device(device)
    if dev.type == "cuda":
        # bind before the mesh is built, so DeviceMesh keeps the choice
        torch.cuda.set_device(torch.cuda.current_device()
                              if dev.index is None else dev.index)
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


# ---------------------------------------------------------------------------
# worlds of rank processes
# ---------------------------------------------------------------------------


def spawn_world(target: str, world: int, kwargs: Dict[str, Any], *,
                timeout: float, workdir: Optional[str] = None) -> List[Any]:
    """Run ``target`` (``"path/to/file.py:function"`` or ``"module:function"``)
    in ``world`` rank processes joined by a gloo group over a file store, and
    return each rank's result in rank order.

    Every rank calls ``function(**kwargs)`` after ``initialize``; what it
    returns is pickled back. ``workdir`` (a temporary directory by default)
    holds the store, the arguments, each rank's log and its result. On the
    first rank that exits non-zero, or at ``timeout`` seconds, the rest of
    the world is killed and this raises with the end of every rank's log.
    Each rank runs PyTorch's CPU operations on one thread (the ranks share
    the host's cores).
    """
    work = Path(tempfile.mkdtemp(prefix="world_") if workdir is None
                else workdir)
    work.mkdir(parents=True, exist_ok=True)
    args_path = work / "kwargs.pkl"
    with open(args_path, "wb") as f:
        pickle.dump(kwargs, f)
    store = work / "store"
    if store.exists():
        store.unlink()
    src = str(Path(__file__).resolve().parents[2])
    run_env = dict(os.environ)
    run_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, run_env.get("PYTHONPATH", "")) if p)
    run_env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs, logs = [], []
    for rank in range(world):
        log = open(work / f"rank{rank}.log", "wb")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.multihost",
             "--target", target, "--rank", str(rank), "--world", str(world),
             "--store", f"file://{store}", "--kwargs", str(args_path),
             "--out", str(work / f"rank{rank}.pkl")],
            stdout=log, stderr=subprocess.STDOUT, env=run_env))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {codes[bad[0]]}"
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failed = f"world timed out after {timeout:.0f} s"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for log in logs:
            log.close()
    if failed:
        tails = []
        for rank in range(world):
            text = (work / f"rank{rank}.log").read_text(errors="replace")
            tails.append(f"--- rank {rank} ---\n{text[-3000:]}")
        raise RuntimeError(f"{target}: {failed}\n" + "\n".join(tails))
    results = []
    for rank in range(world):
        with open(work / f"rank{rank}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _load_target(target: str) -> Callable:
    where, fn_name = target.rsplit(":", 1)
    if where.endswith(".py"):
        path = Path(where).resolve()
        spec = importlib.util.spec_from_file_location(
            f"_world_target_{path.stem}", path)
        module = importlib.util.module_from_spec(spec)
        sys.path.insert(0, str(path.parent))
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, fn_name)


def _rank_main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="one rank of spawn_world")
    ap.add_argument("--target", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--kwargs", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    with open(args.kwargs, "rb") as f:
        kwargs = pickle.load(f)
    fn = _load_target(args.target)
    initialize(args.store, args.world, args.rank)
    try:
        result = fn(**kwargs)
        barrier()
    finally:
        dist.destroy_process_group()
    with open(args.out + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(args.out + ".tmp", args.out)
    return 0


if __name__ == "__main__":
    # the module is imported again under its package name, so the process
    # group lives in one module object whichever way a rank reaches it
    from repro_torch.launch import multihost as _mh

    sys.exit(_mh._rank_main())
