"""Training launcher: contribution-aware async FL rounds over a language
model (port of the JAX package's ``launch/train.py``).

Each round is one ``make_cohort_step(model.loss)`` call: C cohort slots
train M local steps from the base they pulled (``torch.func.grad`` under
``vmap``, through K5 and K6 and their backward kernels on the card), the
eq. 4 probe evaluates the current model on each slot's fresh batch, and
the server pass (K1 in fused mode) applies eq. 3 + 5 over the slots that
arrived. The arrival schedule (which slots' uploads are buffered each
round) comes from the same heterogeneous latency model as the event-driven
simulator, so the rounds reproduce realistic staleness. Weights are random,
from the port's own init on a seeded ``torch.Generator``; the token batches
come from ``numpy.random.default_rng(seed)``, as in the JAX launcher.

``TrainLoop`` holds the state and runs one round at a time; ``main`` and
``chip_smoke.py`` both drive it (the card run passes a config whose depth
is cut). ``--trace-out`` writes each round's phases (``cohort_step`` and
the spans inside it, ``obs/trace.py``) beside ``host_sync`` and
``checkpoint``.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
      --smoke --rounds 3 --device cpu
"""
from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_arch, smoke_variant
from repro_torch.configs.base import INPUT_SHAPES, FLConfig, ModelConfig
from repro_torch.core.cohort import init_cohort_state, make_cohort_step
from repro_torch.core.round_body import round_bytes
from repro_torch.data.synthetic import make_lm_token_stream
from repro_torch.launch.cli import (
    ObsStack,
    add_obs_flags,
    add_ring_codec_flag,
    add_seed_flag,
)
from repro_torch.models.model import build_model
from repro_torch.obs.trace import NULL_TRACER, Tracer
from repro_torch.sim.scenarios import LatencyModel
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.tree import tree_leaves

logger = logging.getLogger("repro_torch.launch.train")


def arrival_schedule(num_slots: int, k: int, latency: LatencyModel,
                     rounds: int, seed: int = 0) -> np.ndarray:
    """(rounds, num_slots) 0/1 masks: the K slots with the earliest
    completion times arrive each round (straggler slots roll over)."""
    rng = np.random.default_rng(seed)
    remaining = np.array([latency.sample(rng, i) for i in range(num_slots)])
    out = np.zeros((rounds, num_slots), np.float32)
    for r in range(rounds):
        order = np.argsort(remaining)
        arrive = order[:k]
        out[r, arrive] = 1.0
        t = remaining[arrive].max()
        remaining = remaining - t
        for i in arrive:
            remaining[i] = latency.sample(rng, i)
    return out


def make_batches(cfg, cohort, m, b, bp, seq, rng):
    """Synthetic non-IID LM batches for one round (host-side numpy)."""
    def toks(lead):
        n = int(np.prod(lead))
        t = make_lm_token_stream(cfg.vocab_size, seq, n,
                                 seed=int(rng.integers(1 << 30)))
        return t.reshape(*lead, seq + 1)

    text = seq - (cfg.num_patches or 0)
    local = toks((cohort, m, b))
    probe = toks((cohort, bp))
    batch = {
        "local": {"tokens": local[..., :text], "labels": local[..., 1:text + 1]},
        "probe": {"tokens": probe[..., :text], "labels": probe[..., 1:text + 1]},
    }
    if cfg.num_patches:
        batch["local"]["patches"] = rng.normal(
            size=(cohort, m, b, cfg.num_patches, cfg.d_model)).astype(np.float32)
        batch["probe"]["patches"] = rng.normal(
            size=(cohort, bp, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        batch["local"]["frames"] = rng.normal(
            size=(cohort, m, b, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
        batch["probe"]["frames"] = rng.normal(
            size=(cohort, bp, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return batch


def check_fits(cfg: ModelConfig, params: Any, cohort: int,
               capacity: int) -> None:
    """Raise if a round of ``cohort`` slots cannot fit ``capacity`` bytes.
    The config is never cut here: the caller picks a depth or a mesh."""
    need = round_bytes(params, cohort)
    if need > capacity:
        n = sum(leaf.numel() for leaf in tree_leaves(params))
        raise RuntimeError(
            f"{cfg.name}: a cohort round of {cohort} slots over {n:,} params "
            f"({cfg.num_layers} layers) holds {need / 2**30:.1f} GiB "
            f"at its peak; the card has {capacity / 2**30:.1f} GiB. One card "
            f"cannot train this config: cut num_layers or the cohort, or "
            f"shard it over a mesh.")


class TrainLoop:
    """The launcher's state: the model, the cohort state, the step, the
    arrival schedule and the host rng that makes the batches.

    ``params`` replaces the port's init (a test hands in JAX's weights);
    ``tracer`` records the step's spans (``make_cohort_step``).
    On the card a config whose round cannot fit raises (``check_fits``).
    ``round(r)`` runs round ``r`` (0-based) and returns its metrics as
    tensors on the device; nothing in it waits for the device. The host
    seconds its batch took to make are left in ``batch_s``.
    """

    PROBE_BATCH = 2

    def __init__(self, cfg: ModelConfig, fl: FLConfig, *, cohort: int,
                 batch: int, seq: int, rounds: int, seed: int = 0,
                 device: DeviceLike = "cuda", params: Any = None,
                 tracer: Tracer = NULL_TRACER):
        self.device = resolve_device(device)
        self.cfg, self.fl = cfg, fl
        self.cohort, self.batch, self.seq = cohort, batch, seq
        self.model = build_model(cfg, self.device)
        if self.device.type == "cuda":
            check_fits(cfg, self.model.init(None), cohort,
                       torch.cuda.get_device_properties(
                           self.device).total_memory)
        latency = LatencyModel.heterogeneous(cohort, seed=seed)
        self.schedule = arrival_schedule(cohort, fl.buffer_size, latency,
                                         rounds, seed=seed)
        self.rng = np.random.default_rng(seed)
        if params is None:
            params = self.model.init(
                torch.Generator(device=self.device).manual_seed(seed))
        self.state = init_cohort_state(params, cohort)
        self.step = make_cohort_step(self.model.loss, fl, device=self.device,
                                     tracer=tracer)
        self.sizes = torch.as_tensor(self.rng.integers(500, 2000, cohort),
                                     dtype=torch.float32)
        self.batch_s = 0.0

    def next_batch(self, r: int) -> Dict[str, Any]:
        batch = make_batches(self.cfg, self.cohort, self.fl.local_steps,
                             self.batch, self.PROBE_BATCH, self.seq, self.rng)
        batch["arrival"] = self.schedule[r]
        batch["data_sizes"] = self.sizes
        return batch

    def round(self, r: int) -> Dict[str, torch.Tensor]:
        t = time.perf_counter()
        batch = self.next_batch(r)
        self.batch_s = time.perf_counter() - t
        self.state, metrics = self.step(self.state, batch)
        return metrics


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + tiny shapes (CPU-runnable)")
    ap.add_argument("--cohort", type=int, default=4)
    ap.add_argument("--buffer-k", type=int, default=3)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--weighting", default="paper")
    add_seed_flag(ap)
    add_ring_codec_flag(
        ap, help_suffix=" — int8/delta shrink the R-deep version ring "
                        "for large models")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint path (coordinator-gated: only "
                         "process 0 writes)")
    ap.add_argument("--ckpt-every", type=int, default=5)
    # multi-process: the same flags on every process
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (brings up "
                         "torch.distributed through launch/multihost.py)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    add_obs_flags(ap)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    # a full-width round fills most of the card in blocks of a few GiB: the
    # allocator's expandable segments keep its cache from fragmenting (read
    # at the first CUDA allocation, so before any)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    device = resolve_device(args.device)
    obs = ObsStack.from_args(args)

    if args.coordinator and args.num_processes > 1:
        from repro_torch.launch.multihost import initialize
        initialize(args.coordinator, args.num_processes, args.process_id)

    arch = get_arch(args.arch)
    shape = INPUT_SHAPES[args.shape]
    cfg = smoke_variant(arch.model) if args.smoke else arch.model
    cohort = args.cohort if args.smoke else 16
    seq = args.seq if args.smoke else shape.seq_len
    b = args.batch if args.smoke else shape.global_batch // cohort
    fl = FLConfig(buffer_size=args.buffer_k, local_steps=2, local_lr=5e-3,
                  weighting=args.weighting, ring_codec=args.ring_codec)
    loop = TrainLoop(cfg, fl, cohort=cohort, batch=b, seq=seq,
                     rounds=args.rounds, seed=args.seed, device=device,
                     tracer=obs.tracer)

    from repro_torch.launch.program import make_io_hooks
    log, eval_metrics, maybe_save = make_io_hooks(
        ckpt_path=args.ckpt, ckpt_every=args.ckpt_every, log_fn=logger.info,
        registry=obs.registry, tracer=obs.tracer, sink=obs.sink)

    history: List[Dict[str, float]] = []
    for r in range(args.rounds):
        t0 = time.time()
        mets = eval_metrics(loop.round(r))
        history.append(mets)
        log(f"round {r + 1}: fresh_loss={mets['fresh_loss_mean']:.4f} "
            f"|u|^2={mets['update_sq_norm']:.3e} "
            f"arrivals={int(loop.schedule[r].sum())} "
            f"({time.time() - t0:.1f}s)")
        maybe_save(r + 1, {"params": loop.state.global_params,
                           "version": loop.state.version})
        obs.round_hook(r + 1)
    version = int(loop.state.version)
    log(f"done; global version = {version}")
    obs.finish(args.rounds)
    return {"version": version, "history": history}


if __name__ == "__main__":
    main()
