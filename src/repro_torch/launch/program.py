"""Coordinator-gated IO of the training loops (the JAX package's
``launch/program.py::make_io_hooks``).

The JAX module also builds the dry-run ``Program``s (lowered train / prefill
/ decode steps per mesh); those come with the port's dry run.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np


def make_io_hooks(*, ckpt_path: Optional[str] = None, ckpt_every: int = 0,
                  log_fn: Callable[[str], None] = print,
                  registry: Optional[Any] = None,
                  tracer: Optional[Any] = None,
                  sink: Optional[Any] = None):
    """Coordinator-gated IO for multi-process training loops, reporting into
    the observability plane.

    Returns ``(log, eval_metrics, maybe_save)``:

    * ``log(msg)`` emits only on process 0 (every process may call it);
      with a ``sink`` (``obs.JsonlSink`` / ``InMemorySink``) each message is
      also emitted as a structured ``{"event": "log", ...}`` record (the
      sink applies its own coordinator gate);
    * ``eval_metrics(metrics)`` fetches a dict of tensors to host floats
      (every process must call it: a sharded leaf is gathered, a
      collective), returning the dict everywhere so control flow stays the
      same on every process; the fetch is a ``host_sync`` span and every
      metric lands in a ``train_<name>`` registry gauge;
    * ``maybe_save(step, tree)`` writes ``ckpt_path`` every ``ckpt_every``
      steps through the coordinator-gated ``checkpoint.save_checkpoint``
      (again: call it on every process), timed as a ``checkpoint`` span
      and counted in the registry.
    """
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.obs.metrics import default_registry
    from repro_torch.obs.trace import NULL_TRACER, SPAN_CHECKPOINT, SPAN_HOST_SYNC
    from repro_torch.sharding.collectives import fetch_replicated, is_coordinator

    reg = registry if registry is not None else default_registry()
    tr = tracer if tracer is not None else NULL_TRACER
    syncs = reg.counter("train_host_syncs_total")
    ckpts = reg.counter("train_checkpoints_total")

    def log(msg: str) -> None:
        if sink is not None:
            sink.emit({"event": "log", "msg": msg})
        if is_coordinator():
            log_fn(msg)

    def eval_metrics(metrics: Any) -> Dict[str, float]:
        with tr.span(SPAN_HOST_SYNC, what="eval_metrics"):
            syncs.inc()
            host = fetch_replicated(metrics)
        out = {k: float(np.asarray(v)) for k, v in host.items()}
        for k, v in out.items():
            reg.gauge(f"train_{k}").set(v)
        return out

    def maybe_save(step: int, tree: Any) -> bool:
        if not ckpt_path or not ckpt_every or step % ckpt_every:
            return False
        with tr.span(SPAN_CHECKPOINT, step=step):
            ckpts.inc()
            save_checkpoint(ckpt_path, tree, step=step)
        return True

    return log, eval_metrics, maybe_save
