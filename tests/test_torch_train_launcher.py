"""``launch/train.py --smoke --device cpu`` for every arch of the registry,
as the JAX launcher trains every arch (``src/repro/launch/train.py``): one
round each, finite fresh losses, the version advanced. The registry's list
is the JAX package's (pinned by ``tests/test_torch_lm.py``). With
``--trace-out`` the written trace holds the round's phases beside the I/O
hooks' spans."""
import json

import numpy as np
import pytest

from repro_torch.configs import list_archs
from repro_torch.launch import train
from repro_torch.obs import COHORT_SPAN_NAMES, validate_trace


@pytest.mark.parametrize("arch", list_archs())
def test_train_launcher_smoke_runs_every_arch(arch):
    res = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--rounds", "1", "--seq", "24", "--log-level",
                      "warning"])
    assert res["version"] == 1 and len(res["history"]) == 1
    assert np.isfinite(res["history"][0]["fresh_loss_mean"])


def test_train_launcher_trace_out_holds_the_round(tmp_path):
    out = tmp_path / "trace.json"
    train.main(["--arch", "deepseek-moe-16b", "--smoke", "--device", "cpu",
                "--rounds", "2", "--seq", "24", "--log-level", "warning",
                "--trace-out", str(out)])
    doc = json.loads(out.read_text())
    assert validate_trace(doc) > 0
    names = [e["name"] for e in doc["traceEvents"]]
    assert set(COHORT_SPAN_NAMES) <= set(names)
    assert names.count("cohort_step") == names.count("local_train") == 2
    assert "host_sync" in names
