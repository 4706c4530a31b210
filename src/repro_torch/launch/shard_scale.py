"""The sharded round substrate across mesh shapes (the counterpart of the
JAX package's ``benchmarks/bench_shard_scale.py``).

    PYTHONPATH=src python -m repro_torch.launch.shard_scale --device cpu
    PYTHONPATH=src python -m repro_torch.launch.shard_scale   # on the card

Each (data, model) shape of ``SHAPES`` (1x1, 1x2, 1x4, 2x2) runs in a
world of its own (``launch/multihost.spawn_world``: one process per rank,
gloo). Per shape it prints:

* the sharded server pass's microseconds a round (K = 16 buffered updates
  of a 2^20-parameter vector, ``batched`` mode: K2 + K3 on each rank's
  slice) beside the single-rank pass on the whole vectors in the same
  process;
* ``run_vectorized`` events/s and ``num_launches`` (logistic regression on
  ``paper-fig1``, 32 clients x 64, K = 8, M = 1, B = 8), where the launch
  count must not grow with the world;
* the ring bytes a rank holds against the replicated equivalent;
* the host milliseconds a round spent in collectives
  (``sharding/collectives.COLLECTIVE_STATS``: staging through the host and
  waits for the device included).

Ranks that share one card time-slice it, and on the CPU they share its
cores, so the rates measure program structure (collectives, launches,
memory a rank), not scale-out. ``--device cuda`` (the default) raises
without a card.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.utils.device import resolve_device

SHAPES = ((1, 1), (1, 2), (1, 4), (2, 2))  # (data, model)
WORLD_TIMEOUT_S = 900.0


def _logreg_loss(p, batch):
    bx, by = batch
    logits = bx.reshape(bx.shape[0], -1) @ p["w"] + p["b"]
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, by[:, None].long())), {}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_us(fn, dev: torch.device, iters: int, warmup: int = 2) -> float:
    from repro_torch.sharding.collectives import barrier

    for _ in range(warmup):
        fn()
    _sync(dev)
    barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / iters * 1e6


def rank_run(data: int, model: int, device: str, quick: bool) -> Dict:
    """One rank's measurements on a (data, model) mesh (``spawn_world``)."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.server_pass import (
        apply_server_round,
        flatten_tree,
        local_columns,
        make_flat_spec,
    )
    from repro_torch.core.version_store import (
        ring_device_bytes,
        state_tensors,
    )
    from repro_torch.launch import multihost
    from repro_torch.sharding import collectives
    from repro_torch.sim import get_scenario
    from repro_torch.sim.engine import init_version_ring, run_vectorized

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = multihost.make_round_mesh(data, model, device=device)
    fl = FLConfig(weighting="paper")
    out: Dict = {"data": data, "model": model}

    # the flat server pass: K buffered updates on an n-parameter vector
    k, n = 16, (1 << 18 if quick else 1 << 20)
    params = {"w": torch.zeros((n,), device=dev)}
    spec = make_flat_spec(params, 0, mesh)
    g = torch.Generator().manual_seed(0)
    bases = (0.1 * torch.randn((k, spec.n_padded), generator=g)).to(dev)
    deltas = (0.01 * torch.randn((k, spec.n_padded), generator=g)).to(dev)
    losses = torch.linspace(0.5, 2.0, k, device=dev)
    sizes = torch.linspace(10.0, 50.0, k, device=dev)
    taus = torch.arange(k, dtype=torch.float32, device=dev)
    x = flatten_tree(spec, params)
    shard = (local_columns(spec, x), local_columns(spec, bases),
             local_columns(spec, deltas))
    iters = 5 if quick else 20
    collectives.reset_collective_stats()
    out["server_pass_us"] = _time_us(lambda: apply_server_round(
        *shard, losses, sizes, taus, fl, mode="batched", mesh=mesh), dev,
        iters)
    out["server_pass_collective_us"] = (
        collectives.COLLECTIVE_STATS["seconds"] / (iters + 2) * 1e6)
    out["server_pass_single_us"] = _time_us(lambda: apply_server_round(
        x, bases, deltas, losses, sizes, taus, fl, mode="batched"), dev,
        iters)

    # the ring a rank holds, at the server pass's width
    _, ring = init_version_ring(params, fl, mesh=mesh)
    out["ring_bytes"] = {
        "per_rank": sum(t.numel() * t.element_size()
                        for t in state_tensors(ring)),
        "quoted": ring_device_bytes(fl, spec, getattr(spec, "model_shards",
                                                      1)),
        "replicated_equivalent": (fl.max_staleness + 1) * spec.n_padded * 4}
    del ring, bases, deltas

    # the engine end to end: the launch count must not grow with the world
    sc = get_scenario("paper-fig1")
    efl = FLConfig(num_clients=32, buffer_size=8, local_steps=1,
                   local_lr=0.05, batch_size=8)
    rounds = 4 if quick else 8
    rng = np.random.default_rng(0)
    ep = {"w": (rng.standard_normal((784, 10)) * 0.05).astype(np.float32),
          "b": np.zeros(10, np.float32)}

    def engine():
        clients, _ = sc.make_dataset(32, samples_per_client=64, seed=0)
        return run_vectorized(_logreg_loss, ep, clients, efl, rounds,
                              scenario=sc, seed=0, mesh=mesh, device=device)

    engine()  # warm-up
    collectives.reset_collective_stats()
    collectives.barrier()
    t0 = time.perf_counter()
    res = engine()
    _sync(dev)
    dt = time.perf_counter() - t0
    out["engine"] = {
        "rounds": res.server_rounds, "events": res.num_events,
        "events_per_s": res.num_events / dt, "rounds_per_s": rounds / dt,
        "num_launches": res.num_launches, "seconds": dt,
        "collective_ms_per_round":
            collectives.COLLECTIVE_STATS["seconds"] / rounds * 1e3,
        "collectives_per_round":
            collectives.COLLECTIVE_STATS["calls"] / rounds}
    return out


def run(device: str = "cuda", quick: bool = False) -> Dict[str, Dict]:
    """Every shape of ``SHAPES`` in a world of its own; rank 0's record
    per shape."""
    from repro_torch.launch.multihost import spawn_world

    resolve_device(device)
    records: Dict[str, Dict] = {}
    for data, model in SHAPES:
        with tempfile.TemporaryDirectory() as work:
            ranks = spawn_world(
                "repro_torch.launch.shard_scale:rank_run", data * model,
                {"data": data, "model": model, "device": device,
                 "quick": quick},
                timeout=WORLD_TIMEOUT_S, workdir=work)
        r = ranks[0]
        key = f"{data}x{model}"
        records[key] = r
        e = r["engine"]
        rb = r["ring_bytes"]
        print(f"  {key}: server pass {r['server_pass_us']:.1f} us/round "
              f"(single rank {r['server_pass_single_us']:.1f}, collectives "
              f"{r['server_pass_collective_us']:.1f}); engine "
              f"{e['events_per_s']:.1f} events/s, {e['rounds_per_s']:.2f} "
              f"rounds/s, {e['num_launches']} launches, collectives "
              f"{e['collective_ms_per_round']:.3f} ms/round "
              f"({e['collectives_per_round']:g} a round); ring "
              f"{rb['per_rank']:,d} B a rank (quoted {rb['quoted']:,d}, "
              f"replicated {rb['replicated_equivalent']:,d})", flush=True)
        if rb["per_rank"] != rb["quoted"]:
            raise RuntimeError(f"{key}: ring bytes {rb['per_rank']} vs "
                               f"quoted {rb['quoted']}")
    launches = {k: r["engine"]["num_launches"] for k, r in records.items()}
    if len(set(launches.values())) != 1:
        raise RuntimeError(f"num_launches grew with the world: {launches}")
    print(f"  launch count across shapes: {launches}")
    return records


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--quick", action="store_true",
                    help="2^18 parameters, 4 engine rounds")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.device == "cuda":
        import subprocess

        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
    run(args.device, args.quick)
    return 0


if __name__ == "__main__":
    sys.exit(main())
