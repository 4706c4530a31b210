"""Host-side simulation types (numpy) and the engines (imported on demand).

``scenarios`` — registry of named, composable client-behavior models.
``traces``    — record/replay of client timelines.
``base``      — ``SimResult`` and the round-log / eval helpers.
``engine``    — the vectorized round engine (``run_vectorized``).
``legacy``    — the per-event loop (``run_async_legacy``) and synchronous
                FedAvg (``run_sync``).
``metrics``   — round-log telemetry (``summarize``; numpy).
``arrivals``  — continuous-arrival upload streams for the serving loop
                (``TrafficGenerator``, ``draw_upload``; host code).
``population`` — the device-resident client state machine for
                million-client scenarios (``run_population``,
                ``collect_windows``, ``DevicePool``, the counter twins);
                its names are exported here, as the JAX package's are.

``engine`` and ``legacy`` are not imported here; import
``repro_torch.sim.engine`` or ``repro_torch.sim.legacy`` for them.
"""
from repro_torch.sim import metrics  # noqa: F401
from repro_torch.sim.arrivals import TrafficGenerator, draw_upload  # noqa: F401
from repro_torch.sim.base import SimResult, make_batches, resolve_behavior  # noqa: F401
from repro_torch.sim.population import (  # noqa: F401
    CounterBehavior,
    CounterDataset,
    DevicePool,
    PopulationEngineState,
    collect_windows,
    make_counter_clients,
    population_state_from_tree,
    population_state_to_tree,
    run_population,
)
from repro_torch.sim.scenarios import (  # noqa: F401
    ClientBehavior,
    LatencyModel,
    Scenario,
    get_scenario,
    register,
    registry,
)
from repro_torch.sim.traces import EventTrace  # noqa: F401
