#!/usr/bin/env python3
"""How far a compressed version ring moves the paper's run from the f32 ring.

Runs the vectorized engine at the paper's config (LeNet, 30 clients x 1500
samples, K=10, M=4, B=32, scenario paper-fig1, seed 0) for 10 rounds once
with the f32 ring and once with ``--codec``, from the same seeded init, and
prints one JSON object comparing the two runs:

- ``weights_max_rel_dev`` / ``weights_max_abs_dev``: the largest relative /
  absolute difference of an eq. 3 weight, over all rounds and clients;
- ``weights_outside``: how many weights miss ``|a - b| <= 5e-3 + 0.05 |b|``
  (the codec tolerance of ``tests/test_version_store.py``), of ``weights_n``;
- ``drift``: ``||p_codec - p_f32|| / ||p_f32 - p_0||`` over all parameters
  (the gap between the final models over how far training moved the f32
  one), and ``leaf_drift``, the same per parameter leaf;
- ``acc``: eval accuracy on 1,024 held-out samples every 5 rounds, per run.

``--package jax`` runs the JAX package (``src/repro``) on its default
backend; ``--package torch`` runs the PyTorch port (``src/repro_torch``) on
``--device``. Each run imports only the package it drives. Each package
makes its own seeded LeNet init (``PRNGKey(0)`` / ``Generator().manual_seed(0)``),
so the two packages' numbers are of the same measurement, not the same run.

    PYTHONPATH=src python scripts/codec_drift.py --package jax [--codec int8]
    PYTHONPATH=src python scripts/codec_drift.py --package torch --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

SAMPLES_PER_CLIENT = 1500
ROUNDS = 10
EVAL_N = 1024
WEIGHT_RTOL, WEIGHT_ATOL = 0.05, 5e-3


def _jax_runner(device):
    import jax
    import jax.numpy as jnp

    from repro.configs.lenet_fmnist import PAPER_FL
    from repro.models.lenet import apply_lenet, init_lenet, lenet_loss
    from repro.sim.engine import run_vectorized
    from repro.sim.scenarios import get_scenario

    sc = get_scenario("paper-fig1")
    init = init_lenet(jax.random.PRNGKey(0))

    def run(codec, rounds):
        clients, (xt, yt) = sc.make_dataset(
            PAPER_FL.num_clients, samples_per_client=SAMPLES_PER_CLIENT,
            seed=0, noise=1.2)
        x, y = jnp.asarray(xt[:EVAL_N]), jnp.asarray(yt[:EVAL_N])
        acc = jax.jit(lambda p: jnp.mean(
            (jnp.argmax(apply_lenet(p, x), -1) == y).astype(jnp.float32)))
        fl = dataclasses.replace(PAPER_FL, ring_codec=codec)
        res = run_vectorized(lenet_loss, init, clients, fl, rounds,
                             eval_fn=lambda p: {"acc": float(acc(p))},
                             eval_every=5, seed=0, scenario=sc,
                             capture_state=True)
        return res, res.final_state.params

    return run, jax.tree.map(np.asarray, init)


def _torch_runner(device):
    import torch

    from repro_torch.configs import PAPER_FL
    from repro_torch.core import run_async
    from repro_torch.models import apply_lenet, init_lenet, lenet_loss
    from repro_torch.sim import get_scenario

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sc = get_scenario("paper-fig1")
    init = init_lenet(torch.Generator().manual_seed(0))

    def run(codec, rounds):
        clients, (xt, yt) = sc.make_dataset(
            PAPER_FL.num_clients, samples_per_client=SAMPLES_PER_CLIENT,
            seed=0, noise=1.2)
        x = torch.from_numpy(xt[:EVAL_N]).to(device)
        y = torch.from_numpy(yt[:EVAL_N]).to(device)
        fl = dataclasses.replace(PAPER_FL, ring_codec=codec)
        res = run_async(lenet_loss, init, clients, fl, rounds,
                        eval_fn=lambda p: {"acc": float(
                            (apply_lenet(p, x).argmax(-1) == y)
                            .float().mean())},
                        eval_every=5, seed=0, scenario=sc,
                        engine="vectorized", device=device,
                        capture_state=True)
        return res, res.final_state.params

    return run, {l: {k: v.numpy() for k, v in p.items()}
                 for l, p in init.items()}


def compare(ref, ref_params, got, got_params, init) -> dict:
    """The drift of run ``got`` from run ``ref`` (same timeline); params
    are nested dicts of arrays (host numpy or CPU tensors)."""
    rel, ab, outside, n = 0.0, 0.0, 0, 0
    for a, b in zip(got.round_log, ref.round_log):
        if a["clients"] != b["clients"] or a["tau"] != b["tau"]:
            raise RuntimeError(f"timelines differ at v{b['version']}")
        wa = np.asarray(a["weights"], np.float64)
        wb = np.asarray(b["weights"], np.float64)
        diff = np.abs(wa - wb)
        rel = max(rel, float(np.max(diff / np.abs(wb))))
        ab = max(ab, float(np.max(diff)))
        outside += int(np.sum(diff > WEIGHT_ATOL + WEIGHT_RTOL * np.abs(wb)))
        n += wa.size
    leaf = {}
    gap = moved = 0.0
    for layer in sorted(init):
        for key in sorted(init[layer]):
            p0 = np.asarray(init[layer][key], np.float64)
            pr = np.asarray(ref_params[layer][key], np.float64)
            pg = np.asarray(got_params[layer][key], np.float64)
            leaf[f"{layer}/{key}"] = float(np.linalg.norm(pg - pr)
                                           / np.linalg.norm(pr - p0))
            gap += float(np.sum((pg - pr) ** 2))
            moved += float(np.sum((pr - p0) ** 2))
    return {"weights_max_rel_dev": rel, "weights_max_abs_dev": ab,
            "weights_outside": outside, "weights_n": n,
            "drift": float(np.sqrt(gap / moved)),
            "leaf_drift": leaf, "leaf_drift_max": max(leaf.values()),
            "acc": {"f32": [h["acc"] for h in ref.history],
                    "codec": [h["acc"] for h in got.history]}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", required=True, choices=["jax", "torch"])
    ap.add_argument("--device", default="cuda",
                    help="the port's device (--package torch only)")
    ap.add_argument("--codec", default="int8", choices=["int8", "delta"])
    a = ap.parse_args(argv)
    runner = _jax_runner if a.package == "jax" else _torch_runner
    run, init = runner(a.device)
    t = time.perf_counter()
    ref, ref_params = run("f32", ROUNDS)
    got, got_params = run(a.codec, ROUNDS)
    out = {"package": a.package,
           "device": a.device if a.package == "torch" else "jax-default",
           "codec": a.codec, "rounds": ROUNDS,
           **compare(ref, ref_params, got, got_params, init),
           "seconds": time.perf_counter() - t}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
