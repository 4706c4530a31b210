"""The port's copies of the numpy host modules against the JAX package's.

Data, partition, scenario and trace code is copied into ``repro_torch``
(which imports nothing of ``repro``); both packages must produce
byte-identical client datasets, test sets and client timelines from the
same seeds, or no parity test downstream could mean anything.
"""
import numpy as np
import pytest

from repro.data import dirichlet_partition as j_partition
from repro.sim.scenarios import get_scenario as j_scenario
from repro.sim.traces import EventTrace as JTrace
from repro.utils.rngstate import pack_pcg64 as j_pack
from repro_torch.data import dirichlet_partition as t_partition
from repro_torch.sim.scenarios import get_scenario as t_scenario
from repro_torch.sim.traces import EventTrace as TTrace
from repro_torch.utils.rngstate import pack_pcg64 as t_pack

PRESETS = ("paper-fig1", "diurnal-phones", "dropout-bernoulli")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", PRESETS)
def test_datasets_byte_identical(name):
    jc, (jx, jy) = j_scenario(name).make_dataset(7, samples_per_client=50,
                                                  seed=3, noise=1.2)
    tc, (tx, ty) = t_scenario(name).make_dataset(7, samples_per_client=50,
                                                  seed=3, noise=1.2)
    _same(jx, tx)
    _same(jy, ty)
    assert len(jc) == len(tc)
    for a, b in zip(jc, tc):
        _same(a.x, b.x)
        _same(a.y, b.y)
        assert a.size == b.size
        _same(j_pack([a._rng]), t_pack([b._rng]))
        # the batch streams stay in step through both draw shapes
        for _ in range(3):
            for u, v in zip(a.batches(8, 4), b.batches(8, 4)):
                _same(u, v)
            for u, v in zip(a.batch(8), b.batch(8)):
                _same(u, v)


def test_partition_byte_identical():
    labels = np.random.default_rng(0).integers(0, 10, size=2000)
    for alpha in (0.1, 1.0):
        for a, b in zip(j_partition(labels, 12, alpha, seed=5),
                        t_partition(labels, 12, alpha, seed=5)):
            _same(a, b)


@pytest.mark.parametrize("name", PRESETS)
def test_client_behavior_streams_identical(name):
    jb = j_scenario(name).behavior(9, seed=4)
    tb = t_scenario(name).behavior(9, seed=4)
    _same(jb.speed, tb.speed)
    _same(jb.comm, tb.comm)
    _same(jb.phase, tb.phase)
    t = 0.0
    for step in range(40):
        cid = step % 9
        assert jb.next_start(cid, t) == tb.next_start(cid, t)
        assert jb.duration(cid, t) == tb.duration(cid, t)
        assert jb.next_upload(cid) == tb.next_upload(cid)
        t += 0.7
    assert jb.drain_log() == tb.drain_log()
    j_state, t_state = jb.get_state(), tb.get_state()
    assert sorted(j_state) == sorted(t_state)
    for key in j_state:
        _same(j_state[key], t_state[key])


def test_trace_json_identical():
    jb = j_scenario("dropout-bernoulli").behavior(5, seed=1)
    tb = t_scenario("dropout-bernoulli").behavior(5, seed=1)
    for cid in range(5):
        for _ in range(6):
            jb.duration(cid)
            tb.duration(cid)
            jb.next_upload(cid)
            tb.next_upload(cid)
    assert (JTrace.from_behavior(jb).to_json()
            == TTrace.from_behavior(tb).to_json())
