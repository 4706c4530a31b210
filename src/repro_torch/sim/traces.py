"""Record / replay of simulation timelines (DESIGN.md §4).

A client's upload timeline is independent of the server protocol: each
client trains, uploads after a sampled duration, immediately re-pulls and
repeats — so upload ``k`` of client ``i`` lands at the same sim-time no
matter the buffer size K or weighting policy. An ``EventTrace`` therefore
only needs the per-client *duration draws* (in consumption order) and the
*dropped upload indices*; replaying those through ``ClientBehavior`` puts
paper / FedBuff / FedAsync / sync FedAvg on byte-identical client
timelines, which is the precondition for a fair wall-clock comparison.

Format (JSON, versioned):

    {"version": 1, "num_clients": N, "seed": s, "scenario": "name",
     "durations": [[d_00, d_01, ...], ...],   # per client, draw order
     "drops": [[cid, k], ...],                 # uploads that were lost
     "events": [[t, cid, k, round], ...]}      # optional upload log

``events`` is a human-readable upload log the engine appends for
debugging/plotting; replay only consumes ``durations`` + ``drops``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

from repro_torch.sim.scenarios import ClientBehavior, Scenario

TRACE_VERSION = 1


@dataclasses.dataclass
class EventTrace:
    num_clients: int
    seed: int
    scenario: str
    durations: List[List[float]]  # per-client draws, consumption order
    drops: List[Tuple[int, int]]  # (client, upload index) lost uploads
    events: List[Tuple[float, int, int, int]]  # (t, cid, k, server_round)

    # ------------------------------------------------------------------
    @staticmethod
    def from_behavior(behavior: ClientBehavior,
                      events: Optional[List[Tuple[float, int, int, int]]] = None
                      ) -> "EventTrace":
        log = behavior.drain_log()
        return EventTrace(num_clients=behavior.num_clients,
                          seed=behavior.seed,
                          scenario=behavior.scenario.name,
                          durations=log["durations"],
                          drops=[tuple(d) for d in log["drops"]],
                          events=list(events or []))

    def replay_behavior(self, scenario: Scenario) -> ClientBehavior:
        """A ``ClientBehavior`` that re-issues this trace's draws verbatim.

        ``scenario`` supplies the deterministic parts (availability gating);
        durations and drops come from the trace, so protocols compared on
        the returned behavior see identical client timelines.
        """
        b = ClientBehavior(scenario, self.num_clients, self.seed)
        b._replay_dur = [list(d) for d in self.durations]
        b._replay_drops = frozenset(tuple(d) for d in self.drops)
        return b

    # ------------------------------------------------------------------
    def to_json(self) -> Dict:
        return {"version": TRACE_VERSION, "num_clients": self.num_clients,
                "seed": self.seed, "scenario": self.scenario,
                "durations": self.durations,
                "drops": [list(d) for d in self.drops],
                "events": [list(e) for e in self.events]}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)
        return path

    @staticmethod
    def load(path: str) -> "EventTrace":
        with open(path) as f:
            obj = json.load(f)
        if obj.get("version") != TRACE_VERSION:
            raise ValueError(f"unsupported trace version {obj.get('version')!r}")
        return EventTrace(
            num_clients=int(obj["num_clients"]), seed=int(obj["seed"]),
            scenario=str(obj["scenario"]),
            durations=[[float(x) for x in d] for d in obj["durations"]],
            drops=[(int(c), int(k)) for c, k in obj["drops"]],
            events=[(float(t), int(c), int(k), int(r))
                    for t, c, k, r in obj["events"]])
