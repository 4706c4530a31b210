"""The benchmark's frozen copies of the traffic generators equal the
port's originals for one seed."""
from __future__ import annotations

import numpy as np

from portbench.harness import traffic


def test_token_stream_equals_the_ports():
    from repro_torch.data.synthetic import make_lm_token_stream

    a = traffic.lm_token_stream(1000, 64, 5, seed=1234)
    b = make_lm_token_stream(1000, 64, 5, seed=1234)
    np.testing.assert_array_equal(a, b)


def test_make_batches_equals_the_launchers():
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import make_batches

    cfg = get_arch("hymba-1.5b").model
    got = traffic.make_batches(cfg.vocab_size, 3, 2, 1, 2, 48,
                               np.random.default_rng(77))
    want = make_batches(cfg, 3, 2, 1, 2, 48, np.random.default_rng(77))
    for part in ("local", "probe"):
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(got[part][key], want[part][key])


def test_arrival_schedule_equals_the_launchers():
    from repro_torch.launch.train import arrival_schedule
    from repro_torch.sim.scenarios import LatencyModel

    got = traffic.arrival_schedule(
        4, 3, traffic.LatencyModel.heterogeneous(4, seed=2**31 + 5), 50,
        seed=2**31 + 5)
    want = arrival_schedule(4, 3, LatencyModel.heterogeneous(4, seed=2**31 + 5),
                            50, seed=2**31 + 5)
    np.testing.assert_array_equal(got, want)
    assert (got.sum(1) == 3).all()
