"""A later cell, configuration, mix or per-layer metric is new files and new
entries: the harness finds each by name, and nothing existing changes."""
from __future__ import annotations

import json
import shutil

from portbench.harness.bench import HERE, ROOT, Cell, benchmark


def test_every_cell_of_the_benchmark_loads():
    bench = benchmark()
    for w in bench["workloads"]:
        cell = Cell(w["name"], bench)
        assert cell.driver().run
        assert cell.limits
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert cell.per_layer and [r for _, r in cell.readers()]


def test_new_files_are_found_by_name(tmp_path):
    base = tmp_path / "portbench"
    for d in ("drivers", "metrics", "harness"):
        shutil.copytree(HERE / d, base / d)
    for d in ("configs", "mixes", "cells"):
        (base / d).mkdir(parents=True)
    cfg = json.loads((HERE / "configs" / "hymba-1.5b.json").read_text())
    cfg.update(name="new-model", num_layers=4)
    (base / "configs" / "new-model.json").write_text(json.dumps(cfg))
    mix = json.loads((HERE / "mixes" / "prefill-b2-s32k.json").read_text())
    mix.update(seq=4096)
    (base / "mixes" / "prefill-b2-s4k.json").write_text(json.dumps(mix))
    (base / "cells" / "new-cell.json").write_text(
        json.dumps({"limits": {"logit_gap": 0.5}}))
    (base / "metrics" / "new_metric.prefill.py").write_text(
        "def read(facts):\n    return 42.0\n")
    bench = benchmark()
    bench["configs"].append({"name": "new-model", "source": "x",
                             "file": "portbench/configs/new-model.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new-cell", "config": "new-model",
                               "traffic": "prefill-b2-s4k", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "new_metric.prefill", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "device",
                               "moves": "prefill_tokens_per_s",
                               "workloads": ["new-cell"]})
    bench["end_to_end"][1]["workloads"].append("new-cell")
    cell = Cell("new-cell", bench, root=tmp_path)
    assert cell.config["num_layers"] == 4 and cell.mix["seq"] == 4096
    assert cell.limits == {"logit_gap": 0.5}
    assert [m["name"] for m in cell.end_to_end] == [
        "prefill_tokens_per_s", "peak_gib", "setup_s"]
    assert [(m["name"], r.read({})) for m, r in cell.readers()] == [
        ("new_metric.prefill", 42.0)]
    assert cell.driver().run
    assert ROOT.exists()
