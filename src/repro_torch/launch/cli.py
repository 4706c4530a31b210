"""Shared launcher flag surface (DESIGN.md §12): a copy of the JAX
package's ``launch/cli.py``.

Scenario/seed/ring-codec plus the observability plane's flags live in
ONE builder here, consumed by the serving launchers (serve_fl and the
transport client client_fl), so the shared surface cannot drift: a flag
rename or a new default lands everywhere or nowhere.

``ObsStack.from_args`` is the runtime counterpart: it turns the obs
flags into the registry / tracer / windowed profiler / JSONL sink
quartet every launcher wires the same way (periodic snapshot flush per
round, final snapshot + trace write at exit).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
from typing import Optional

logger = logging.getLogger("repro_torch.launch.cli")


def add_scenario_flags(ap: argparse.ArgumentParser, *,
                       clients: int = 32) -> None:
    """--scenario/--clients/--samples-per-client/--seed: the seeded
    client population every scenario-driven launcher builds."""
    ap.add_argument("--scenario", default="paper-fig1")
    ap.add_argument("--clients", type=int, default=clients)
    ap.add_argument("--samples-per-client", type=int, default=64)
    add_seed_flag(ap)


def add_seed_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--seed", type=int, default=0)


def add_ring_codec_flag(ap: argparse.ArgumentParser,
                        help_suffix: str = "") -> None:
    ap.add_argument("--ring-codec", default="f32",
                    choices=("f32", "int8", "delta"),
                    help="version-store codec (core/version_store.py, "
                         "DESIGN.md §11)" + help_suffix)


def add_obs_flags(ap: argparse.ArgumentParser) -> None:
    """The observability plane's flag quartet (DESIGN.md §9), identical
    on every launcher."""
    ap.add_argument("--log-level", default="info",
                    help="debug/info/warning/error (obs.configure_logging)")
    ap.add_argument("--trace-out", default=None,
                    help="write Chrome-trace-event JSON of the round "
                         "lifecycle here (perfetto-loadable)")
    ap.add_argument("--metrics-out", default=None,
                    help="append JSONL metrics snapshots here "
                         "(coordinator-gated)")
    ap.add_argument("--flush-every", type=int, default=8,
                    help="rounds between metrics-out snapshots")
    ap.add_argument("--profile-dir", default=None,
                    help="torch.profiler capture directory (windowed: "
                         "obs.WindowedProfiler)")
    ap.add_argument("--profile-every", type=int, default=0,
                    help="rounds between device-profile windows (0 = off)")
    ap.add_argument("--profile-window", type=int, default=1,
                    help="rounds each device-profile window stays open")


@dataclasses.dataclass
class ObsStack:
    """The wired obs plane for one launcher process."""

    registry: "MetricsRegistry"
    tracer: "Tracer"
    profiler: "WindowedProfiler"
    sink: Optional["JsonlSink"]
    trace_out: Optional[str]
    metrics_out: Optional[str]
    flush_every: int

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "ObsStack":
        from repro_torch.obs import (JsonlSink, MetricsRegistry, Tracer,
                               WindowedProfiler, configure_logging)

        configure_logging(args.log_level)
        return cls(
            registry=MetricsRegistry(),
            tracer=Tracer(enabled=bool(args.trace_out)),
            profiler=WindowedProfiler(args.profile_dir,
                                      every=args.profile_every,
                                      window=args.profile_window),
            sink=JsonlSink(args.metrics_out) if args.metrics_out else None,
            trace_out=args.trace_out, metrics_out=args.metrics_out,
            flush_every=args.flush_every)

    def round_hook(self, version: int) -> None:
        """Once per applied round: windowed profiler + periodic flush."""
        from repro_torch.obs import emit_snapshot

        self.profiler.on_round(version)
        if self.sink is not None and self.flush_every \
                and version % self.flush_every == 0:
            emit_snapshot(self.sink, self.registry, version=version)
            self.sink.flush()

    def finish(self, version: int) -> None:
        """Final snapshot + trace write + close, same order everywhere."""
        from repro_torch.obs import emit_snapshot

        self.profiler.close()
        if self.sink is not None:
            emit_snapshot(self.sink, self.registry, version=version,
                          final=True)
            self.sink.close()
            logger.info("metrics JSONL -> %s", self.metrics_out)
        if self.trace_out:
            self.tracer.write(self.trace_out)
            logger.info("chrome trace (%d events) -> %s",
                        len(self.tracer.events), self.trace_out)
