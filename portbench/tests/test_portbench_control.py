"""The control (the reference in float8 in the program's place) fails one
of each cell's own numbers at the cell's committed limits, at a size a
test run holds: smoke widths in bf16, as the configurations state their
precision. The chip readings at the cells' own sizes are in PERF.md."""
from __future__ import annotations

import time

import pytest

import conftest
import portbench.run as run
from portbench.control import control_readings
from portbench.harness.bench import HERE, load_json

KINDS = ["hymba-train", "moe-train", "prefill"]


@pytest.mark.parametrize("kind", KINDS)
def test_the_control_fails_the_cells_limits(monkeypatch, kind):
    for cfg in (conftest.HYMBA_SMOKE, conftest.MOE_SMOKE):
        monkeypatch.setitem(cfg, "param_dtype", "bfloat16")
        monkeypatch.setitem(cfg, "compute_dtype", "bfloat16")
        monkeypatch.setitem(cfg, "num_layers", 4)
        monkeypatch.setitem(cfg, "train_layers", 4)
    cell = conftest.smoke_cell(kind)
    cell.limits = load_json(HERE / "cells" / f"{cell.name}.json")["limits"]
    ctx = run.Context(cell, 2**31 + 3, 0.1, False, "cpu", time.perf_counter())
    out = cell.driver().run(ctx)
    got = control_readings(cell, ctx, out, "fp8")
    assert any(got[k] > lim for k, lim in cell.limits.items()), got
