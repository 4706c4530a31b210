"""Structured event sinks + the repo-wide stdlib-logging configurator.

A copy of the JAX package's ``obs/sink.py``. ``JsonlSink`` is the durable
export surface of the observability plane: one JSON object per line,
append-only, so a job can diff snapshots across runs and a multi-process
merge can concatenate per-process files. Writes are **gated on process 0
by default** (``is_process_zero``, which is
``sharding/collectives.is_coordinator``: rank 0, or True when no process group
is up) — every process may emit, one writes. ``InMemorySink`` is the test
double with identical semantics minus the filesystem.

``configure_logging`` is the single place log format and level are
decided: launchers expose ``--log-level`` and call it once; library
modules just ``logging.getLogger(__name__)``. Idempotent — the second
caller adjusts the level instead of stacking handlers.
"""
from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, Callable, Dict, List, Optional

LOG_FORMAT = "%(asctime)s %(levelname)-7s %(name)s: %(message)s"
LOG_DATEFMT = "%H:%M:%S"

_configured = False


def configure_logging(level: str = "info",
                      stream=None) -> logging.Logger:
    """Install the repo's one log format on the root logger and set the
    level (``debug``/``info``/``warning``/``error`` or a numeric
    string). Returns the ``repro_torch`` namespace logger. Safe to call
    repeatedly: later calls only move the level."""
    global _configured
    lvl = (int(level) if str(level).isdigit()
           else getattr(logging, str(level).upper(), None))
    if not isinstance(lvl, int):
        raise ValueError(f"unknown log level {level!r}")
    root = logging.getLogger()
    if not _configured:
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(logging.Formatter(LOG_FORMAT, LOG_DATEFMT))
        root.addHandler(handler)
        _configured = True
    root.setLevel(lvl)
    logger = logging.getLogger("repro_torch")
    logger.setLevel(lvl)
    return logger


def is_process_zero() -> bool:
    """The process-0 gate: ``sharding/collectives.is_coordinator``."""
    from repro_torch.sharding.collectives import is_coordinator

    return is_coordinator()


class InMemorySink:
    """Test double: events land in ``.events`` (always, no gate) so
    assertions see exactly what a JSONL file would contain."""

    def __init__(self):
        self.events: List[Dict[str, Any]] = []

    def emit(self, event: Dict[str, Any]) -> None:
        self.events.append(dict(event))

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class JsonlSink:
    """Append-only JSONL event sink, gated on process 0.

    The file is opened lazily on the first gated-through ``emit`` so a
    process other than 0 never creates (or truncates) the path. ``gate``
    is injectable for tests; ``stamp=True`` (default) adds a ``t``
    wall-clock field to every event.
    """

    def __init__(self, path: str, gate: Optional[Callable[[], bool]] = None,
                 stamp: bool = True):
        self.path = path
        self._gate = gate if gate is not None else is_process_zero
        self._stamp = stamp
        self._f = None
        self._gated: Optional[bool] = None

    def emit(self, event: Dict[str, Any]) -> None:
        if self._gated is None:
            self._gated = bool(self._gate())
        if not self._gated:
            return
        if self._f is None:
            self._f = open(self.path, "a")
        if self._stamp and "t" not in event:
            event = {**event, "t": time.time()}
        self._f.write(json.dumps(event) + "\n")

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def emit_snapshot(sink, registry, *, kind: str = "metrics_snapshot",
                  **extra) -> None:
    """One snapshot event of ``registry`` into ``sink`` — the periodic
    flush the launchers schedule (serve_fl --metrics-out)."""
    sink.emit({"event": kind, **extra, "metrics": registry.snapshot()})
