"""Quickstart on the PyTorch port: contribution-aware async FL on LeNet.

The port's counterpart of the JAX package's ``examples/quickstart.py``:
8 heterogeneous clients x 300 samples train LeNet under a named
client-behavior scenario (default ``paper-fig1``), K=4, M=4 local steps,
B=32, for 20 rounds, once with the paper's weighting and once with
uniform FedBuff, on identical client timelines (per-client seeded
duration streams). Prints each run's accuracy curve and its round-log
telemetry (``sim.metrics.summarize``).

    python -m repro_torch.launch.quickstart [--scenario NAME] [--list]
        [--engine vectorized|legacy] [--device cuda|cpu] [--rounds 20]
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core import run_async
from repro_torch.models import apply_lenet, init_lenet, lenet_loss
from repro_torch.sim import get_scenario, metrics, registry
from repro_torch.utils.device import DeviceLike, resolve_device

NUM_CLIENTS = 8
WEIGHTINGS = ("paper", "fedbuff")


def run(scenario: str = "paper-fig1", engine: str = "vectorized",
        device: DeviceLike = "cuda", rounds: int = 20,
        params: Optional[Any] = None, **run_kw) -> Dict[str, Dict]:
    """Both weightings on ``device``; returns weighting -> {"result":
    SimResult, "telemetry": summarize(...)}. ``params`` defaults to the
    port's ``init_lenet`` from seed 0 (the parity tests pass the JAX
    init's, converted); ``run_kw`` goes to ``run_async``."""
    dev = resolve_device(device)
    sc = get_scenario(scenario)
    _, (x_test, y_test) = sc.make_dataset(
        num_clients=NUM_CLIENTS, samples_per_client=300, seed=0)
    if params is None:
        params = init_lenet(torch.Generator().manual_seed(0))
    xt = torch.from_numpy(x_test[:512]).to(dev)
    yt = torch.from_numpy(y_test[:512]).to(dev)

    def eval_fn(p):
        with torch.no_grad():
            acc = (apply_lenet(p, xt).argmax(-1) == yt).float().mean()
        return {"acc": float(acc)}

    out = {}
    for weighting in WEIGHTINGS:
        # fresh datasets per run: the batch streams are stateful
        clients, _ = sc.make_dataset(num_clients=NUM_CLIENTS,
                                     samples_per_client=300, seed=0)
        fl = FLConfig(num_clients=NUM_CLIENTS, buffer_size=4, local_steps=4,
                      local_lr=0.05, batch_size=32, weighting=weighting)
        res = run_async(lenet_loss, params, clients, fl, total_rounds=rounds,
                        eval_fn=eval_fn, eval_every=5, scenario=sc, seed=0,
                        engine=engine, device=dev, **run_kw)
        tele = metrics.summarize(res.round_log, NUM_CLIENTS)
        curve = " ".join(f"r{h['round']}:{h['acc']:.2f}" for h in res.history)
        print(f"{weighting:8s} | {curve} | sim_time={res.sim_time:.1f} "
              f"tau_mean={tele['tau_mean']:.2f} "
              f"gini={tele['participation_gini']:.2f}")
        out[weighting] = {"result": res, "telemetry": tele}
    return out


def main(argv=None) -> Optional[Dict[str, Dict]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="paper-fig1",
                    choices=sorted(registry()))
    ap.add_argument("--list", action="store_true",
                    help="print the scenario registry and exit")
    ap.add_argument("--engine", default="vectorized",
                    choices=["vectorized", "legacy"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rounds", type=int, default=20)
    a = ap.parse_args(argv)
    if a.list:
        for name, sc in sorted(registry().items()):
            print(f"{name:20s} {sc.description}")
        return None
    return run(scenario=a.scenario, engine=a.engine, device=a.device,
               rounds=a.rounds)


if __name__ == "__main__":
    main()
