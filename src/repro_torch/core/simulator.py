"""Simulation entry points: ``run_async``, ``run_vectorized``,
``run_async_legacy`` and ``run_sync``.

The engine modules are imported inside the runners: ``repro_torch.sim.
engine`` depends on ``repro_torch.core``, so a module-level import here
would cycle.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

from repro_torch.configs.base import FLConfig
from repro_torch.sim.base import SimResult
from repro_torch.sim.scenarios import LatencyModel
from repro_torch.utils.device import DeviceLike

def run_async(loss_fn: Callable, init_params: Any, clients: Sequence,
              fl: FLConfig, total_rounds: int,
              eval_fn: Optional[Callable[[Any], Dict]] = None,
              eval_every: int = 5,
              latency: Optional[LatencyModel] = None,
              seed: int = 0,
              engine: str = "vectorized",
              device: DeviceLike = "cuda",
              **kw) -> SimResult:
    """Simulate buffered-async FL for ``total_rounds`` server rounds.

    Runs on CUDA unless ``device="cpu"``; raises ``RuntimeError`` when CUDA
    is asked for and absent. ``engine="vectorized"`` (default) runs each
    K-upload window as one K-client batch; ``engine="legacy"`` replays the
    per-event loop; ``engine="population"`` keeps the client state machine
    on the device (``sim/population.py``: counter-based draws, top-k
    windows; ``clients`` may be a ``DevicePool``). The first two accept
    ``scenario=``, ``behavior=``, ``trace=`` and ``record_trace=``; the
    population engine takes ``scenario=`` only. The vectorized and
    population engines also take ``rounds_per_launch=``, ``registry=``,
    ``tracer=``, the checkpoint arguments, ``mesh=`` and ``shard_ring=``
    (``sim/engine.py``, ``sim/population.py``), which pass through.
    """
    if engine == "vectorized":
        from repro_torch.sim.engine import run_vectorized as runner
    elif engine == "legacy":
        from repro_torch.sim.legacy import run_async_legacy as runner
    elif engine == "population":
        from repro_torch.sim.population import run_population as runner
    else:
        raise ValueError(f"unknown engine {engine!r}; "
                         "valid: 'vectorized', 'legacy', 'population'")
    return runner(loss_fn, init_params, clients, fl, total_rounds,
                  eval_fn=eval_fn, eval_every=eval_every, latency=latency,
                  seed=seed, device=device, **kw)


def run_vectorized(*args, **kw) -> SimResult:
    """See ``repro_torch.sim.engine.run_vectorized`` (lazy wrapper)."""
    from repro_torch.sim.engine import run_vectorized as f
    return f(*args, **kw)


def run_async_legacy(*args, **kw) -> SimResult:
    """See ``repro_torch.sim.legacy.run_async_legacy``."""
    from repro_torch.sim.legacy import run_async_legacy as f
    return f(*args, **kw)


def run_sync(*args, **kw) -> SimResult:
    """See ``repro_torch.sim.legacy.run_sync``."""
    from repro_torch.sim.legacy import run_sync as f
    return f(*args, **kw)
