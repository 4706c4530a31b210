"""The paper's Fig. 1 comparison on the PyTorch port.

LeNet on the synthetic Fashion-MNIST stand-in, 30 clients x 1500 samples,
non-IID Dirichlet split, buffered-async server with K=10, under a named
client scenario (default ``paper-fig1``). Every protocol sees the same
per-client duration streams, so the same client timelines:

  ca-afl (paper)   : eq. 3/4/5 contribution-aware weighting
  fedbuff          : uniform 1/K averaging
  polynomial       : (1+tau)^-0.5 staleness discount
  fedasync (K=1)   : fully-async polynomial mixing
  fedavg (sync)    : synchronous straggler-bound FedAvg
  fedavg (sync,C=K): FedAvg sampling only K clients per round

Prints accuracy per eval round and rounds/time to 95% of the best final
accuracy.

    python -m repro_torch.launch.paper_experiment [--quick] [--rounds N]
        [--scenario paper-fig1] [--device cuda]
"""
from __future__ import annotations

import argparse
from typing import Dict

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core import run_async, run_sync
from repro_torch.models import apply_lenet, init_lenet, lenet_loss
from repro_torch.sim import get_scenario, registry
from repro_torch.sim.base import SimResult
from repro_torch.utils.device import DeviceLike, resolve_device


def run(num_clients: int = 30, samples_per_client: int = 1500,
        rounds: int = 40, noise: float = 1.2, buffer_k: int = 10,
        seed: int = 0, quick: bool = False, scenario: str = "paper-fig1",
        device: DeviceLike = "cuda") -> Dict[str, SimResult]:
    """Run every protocol of Fig. 1; returns name -> SimResult."""
    dev = resolve_device(device)
    if quick:
        num_clients, samples_per_client, rounds = 10, 300, 12
        buffer_k = 4
    sc = get_scenario(scenario)
    _, (xt, yt) = sc.make_dataset(num_clients,
                                  samples_per_client=samples_per_client,
                                  seed=seed, noise=noise)
    params = init_lenet(torch.Generator().manual_seed(seed))
    xt = torch.from_numpy(xt[:1024]).to(dev)
    yt = torch.from_numpy(yt[:1024]).to(dev)

    def eval_fn(p):
        with torch.no_grad():
            acc = (apply_lenet(p, xt).argmax(-1) == yt).float().mean()
        return {"acc": float(acc)}

    base = dict(num_clients=num_clients, local_steps=4, local_lr=0.05,
                batch_size=32, global_lr=1.0)
    protocols = {
        "ca-afl(paper)": ("async", FLConfig(buffer_size=buffer_k,
                                            weighting="paper", **base)),
        "fedbuff": ("async", FLConfig(buffer_size=buffer_k,
                                      weighting="fedbuff", **base)),
        "polynomial": ("async", FLConfig(buffer_size=buffer_k,
                                         weighting="polynomial", **base)),
        "fedasync(K=1)": ("async", FLConfig(buffer_size=1,
                                            weighting="polynomial", **base)),
        "fedavg(sync)": ("sync", FLConfig(buffer_size=num_clients,
                                          weighting="fedbuff", **base)),
        "fedavg(sync,C=K)": ("sync", FLConfig(buffer_size=buffer_k,
                                              clients_per_round=buffer_k,
                                              weighting="fedbuff", **base)),
    }

    results = {}
    for name, (mode, fl) in protocols.items():
        # fresh datasets per protocol: the batch streams are stateful
        clients, _ = sc.make_dataset(num_clients,
                                     samples_per_client=samples_per_client,
                                     seed=seed, noise=noise)
        if mode == "async":
            runner, r = run_async, rounds
        else:
            # full-participation sync rounds scaled for comparable work;
            # the C=K variant does K updates/round like the async runs
            runner = run_sync
            r = (rounds if fl.clients_per_round
                 else max(3, rounds * buffer_k // num_clients))
        res = runner(lenet_loss, params, clients, fl, r, eval_fn=eval_fn,
                     eval_every=max(1, rounds // 20), seed=seed, scenario=sc,
                     device=dev)
        results[name] = res
        curve = " ".join(f"r{h['round']}:{h['acc']:.3f}" for h in res.history)
        print(f"  {name:16s} {curve}")

    final = {n: r.history[-1]["acc"] for n, r in results.items()}
    target = 0.95 * max(final.values())
    print(f"\n  target acc = {target:.3f} (95% of best final)")
    for name, res in results.items():
        rt = res.rounds_to_target("acc", target)
        tt = res.time_to_target("acc", target)
        print(f"  {name:16s} final={final[name]:.3f} rounds_to_target={rt} "
              f"time_to_target={'-' if tt is None else round(tt, 1)}")
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--scenario", default="paper-fig1",
                    choices=sorted(registry()))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(rounds=a.rounds, quick=a.quick, scenario=a.scenario, device=a.device)


if __name__ == "__main__":
    main()
