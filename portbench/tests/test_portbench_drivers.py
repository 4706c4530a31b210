"""Whole runs of each cell's driver at smoke width on the CPU (the look for
a chip skipped): ``correct`` is true on the program as it is, and false
with the timed path broken underneath, once for each fault the cell can
have. The limits are the cell's own numbers, at 1e-3 (float32 smoke runs
read ~1e-6)."""
from __future__ import annotations

import json
import time

import pytest
import torch

import portbench.run as run
from conftest import smoke_cell
from portbench.harness.bench import HERE, load_json

TRAIN = ["hymba-train", "moe-train"]


def cell_with_own_numbers(kind):
    cell = smoke_cell(kind)
    own = load_json(HERE / "cells" / f"{cell.name}.json")["limits"]
    cell.limits = {name: 1e-3 for name in own}
    return cell


def execute(cell, seed=2**31 + 11):
    return run.execute(cell, seed, 0.2, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("kind", TRAIN + ["prefill"])
def test_a_sound_run_is_correct(kind):
    out = execute(cell_with_own_numbers(kind))
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    json.dumps(out)


def wrap_step(monkeypatch, fault):
    import repro_torch.core.cohort as cohort

    real = cohort.make_cohort_step

    def make(loss_fn, fl, **kw):
        step = real(loss_fn, fl, **kw)

        def broken(state, batch):
            return fault(step, state, batch)

        return broken

    monkeypatch.setattr(cohort, "make_cohort_step", make)


def unchanged(step, state, batch):
    return state, step(state, batch)[1]


def half_batch(step, state, batch):
    def cut(part):
        s = part["tokens"].shape[-1] // 2
        return {k: v[..., :s] for k, v in part.items()}

    batch = dict(batch, local=cut(batch["local"]), probe=cut(batch["probe"]))
    return step(state, batch)


def update_altered(step, state, batch):
    new, met = step(state, batch)
    from repro_torch.utils.tree import tree_map

    x = tree_map(lambda a, b: (b + 1.5 * (a - b)).to(a.dtype),
                 new.global_params, state.global_params)
    return new._replace(global_params=x), met


@pytest.mark.parametrize("kind", TRAIN)
@pytest.mark.parametrize("fault", [unchanged, half_batch, update_altered],
                         ids=["state-unchanged", "half-batch", "answer-altered"])
def test_a_broken_round_is_not_correct(monkeypatch, kind, fault):
    wrap_step(monkeypatch, fault)
    out = execute(cell_with_own_numbers(kind))
    assert not out["correct"], out["checks"]


def prefill_half(real):
    def broken(self, params, batch, window=None):
        one = real(self, params, {"tokens": batch["tokens"][:1]}, window)
        return one.expand(batch["tokens"].shape[0], -1, -1)
    return broken


def prefill_altered(real):
    def broken(self, params, batch, window=None):
        out = real(self, params, batch, window).clone()
        out[0, -1, 0] += 1.0
        return out
    return broken


@pytest.mark.parametrize("fault", [prefill_half, prefill_altered],
                         ids=["half-batch", "answer-altered"])
def test_a_broken_prefill_is_not_correct(monkeypatch, fault):
    from repro_torch.models.model import Model

    monkeypatch.setattr(Model, "prefill_logits", fault(Model.prefill_logits))
    out = execute(cell_with_own_numbers("prefill"))
    assert not out["correct"], out["checks"]


def test_without_a_card_the_run_exits_nonzero_and_prints_nothing(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "hymba-prefill-s32k", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
