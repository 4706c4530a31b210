"""``launch/train.py --smoke --device cpu`` for every arch of the registry,
as the JAX launcher trains every arch (``src/repro/launch/train.py``): one
round each, finite fresh losses, the version advanced. The registry's list
is the JAX package's (pinned by ``tests/test_torch_lm.py``)."""
import numpy as np
import pytest

from repro_torch.configs import list_archs
from repro_torch.launch import train


@pytest.mark.parametrize("arch", list_archs())
def test_train_launcher_smoke_runs_every_arch(arch):
    res = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--rounds", "1", "--seq", "24", "--log-level",
                      "warning"])
    assert res["version"] == 1 and len(res["history"]) == 1
    assert np.isfinite(res["history"][0]["fresh_loss_mean"])
