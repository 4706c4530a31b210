"""The port's compressed version store against the JAX package's.

Same numpy rows go through both packages' codecs: int8 codes, scale and
zero are compared exactly, as are the delta codec's idx, val, base and
write count through normal writes and base refreshes (ties in the top-m
selection break toward the lower index in both). The layouts and byte
quotes must agree, and the port's allocation must equal its quote.

The whole slice: the port's ``run_vectorized`` under int8 and delta against
the JAX engine with the same codec, on the 6-client config of
``tests/test_torch_engine.py`` and with its tolerances (round log rtol 1e-4
/ atol 1e-7, final params atol 1e-5, eval accuracy exact). A resumed port
run is bit-identical to the uninterrupted one, and an engine checkpoint
the JAX package wrote restores into the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_checkpoint as j_save
from repro.configs.base import FLConfig as JFL
from repro.core import version_store as jvs
from repro.core.server_pass import make_flat_spec as j_spec
from repro.models.lenet import apply_lenet as j_apply
from repro.models.lenet import init_lenet as j_init
from repro.models.lenet import lenet_loss as j_loss
from repro.sim.engine import engine_state_to_tree as j_state_to_tree
from repro.sim.engine import run_vectorized as j_run
from repro.sim.scenarios import get_scenario as j_scenario
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.base import FLConfig as TFL
from repro_torch.core import run_async
from repro_torch.core import version_store as tvs
from repro_torch.core.server_pass import make_flat_spec as t_spec
from repro_torch.models import apply_lenet, lenet_loss, params_from_jax
from repro_torch.sim.engine import (
    engine_state_from_tree,
    engine_state_to_tree,
    init_version_ring,
)
from repro_torch.sim.scenarios import get_scenario as t_scenario

FL = dict(num_clients=6, buffer_size=3, local_steps=2, local_lr=0.05,
          batch_size=8, max_staleness=4)
LOG_FIELDS = ("sq_dists", "staleness_deg", "stat_effect", "weights")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0)))


def _specs(d=4000, block=256):
    return (j_spec({"w": jnp.zeros(d)}, block),
            t_spec({"w": torch.zeros(d)}, block))


def _row(spec, seed):
    """A flat row with a constant block, a block of exact rounding ties and
    the zero padding tail (ties for the delta top-m)."""
    rng = np.random.default_rng(seed)
    row = np.zeros(spec.n_padded, np.float32)
    d = spec.n
    row[:d] = rng.normal(size=d) * rng.uniform(0.01, 10.0)
    row[256:512] = 1.5
    row[512:768] = np.round(rng.normal(size=256) * 4.0) / 8.0
    return row


# ---------------------------------------------------------------------------
# codecs against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_codes_scale_zero_equal_jax(seed):
    js, ts = _specs()
    rows = [_row(js, seed * 10 + i) for i in range(3)]
    jst = jvs.Int8Codec(256).init_state(js, jnp.asarray(rows[0]), 4)
    tst = tvs.Int8Codec(256).init_state(ts, torch.from_numpy(rows[0]), 4)
    for slot, row in ((1, rows[1]), (3, rows[2])):
        jst = jvs.Int8Codec(256).encode(js, jst, slot, jnp.asarray(row))
        tst = tvs.Int8Codec(256).encode(ts, tst, slot, torch.from_numpy(row))
    for field in ("codes", "scale", "zero"):
        want = np.asarray(getattr(jst, field))
        got = getattr(tst, field).numpy()
        assert got.dtype == want.dtype
        assert int(np.sum(got != want)) == 0, field
    slots = np.asarray([3, 1, 0])
    np.testing.assert_array_equal(
        tvs.Int8Codec(256).decode(ts, tst, torch.from_numpy(slots)).numpy(),
        np.asarray(jvs.Int8Codec(256).decode(js, jst, jnp.asarray(slots))))


def test_int8_error_bounded_by_half_step():
    """|decode(encode(v)) - v| <= scale/2 + rounding slack per entry."""
    _, spec = _specs()
    codec = tvs.Int8Codec(qblock=256)
    row = torch.from_numpy(_row(spec, 7))
    state = codec.init_state(spec, torch.zeros(spec.n_padded), 4)
    state = codec.encode(spec, state, 2, row)
    out = codec.decode(spec, state, torch.tensor([2]))[0]
    err = (out - row).abs().numpy().reshape(-1, 256)
    v = row.numpy().reshape(-1, 256)
    step = (v.max(axis=1) - v.min(axis=1)) / 254.0
    assert np.all(err.max(axis=1) <= step * 0.5 + 1e-6)


def test_int8_constant_block_is_exact():
    """A zero-range block stores scale 0 and decodes to the constant."""
    _, spec = _specs(512)
    codec = tvs.Int8Codec(qblock=256)
    row = torch.full((spec.n_padded,), 3.25)
    state = codec.init_state(spec, row, 2)
    assert float(state.scale.abs().max()) == 0.0
    out = codec.decode(spec, state, torch.tensor([0]))[0]
    assert torch.equal(out, row)


def test_delta_encode_and_refresh_equal_jax():
    """Seven writes into a depth-4 ring with a refresh every 3: idx, val,
    base and writes equal JAX's after every write (ties included)."""
    js, ts = _specs(1000)
    jc, tc = jvs.DeltaCodec(0.05, 3), tvs.DeltaCodec(0.05, 3)
    base = _row(js, 3)
    jst = jc.init_state(js, jnp.asarray(base), 4)
    tst = tc.init_state(ts, torch.from_numpy(base), 4)
    rng = np.random.default_rng(4)
    refreshed = 0
    for w in range(7):
        row = base + (rng.normal(size=js.n_padded) * 0.01).astype(np.float32)
        row[rng.integers(0, js.n, 5)] += 1.0
        row[js.n:] = 0.0
        slot = (w + 1) % 4
        jst = jc.encode(js, jst, slot, jnp.asarray(row))
        tst = tc.encode(ts, tst, slot, torch.from_numpy(row))
        for field in ("base", "idx", "val", "writes"):
            want = np.asarray(getattr(jst, field))
            got = getattr(tst, field).numpy()
            assert got.dtype == want.dtype, field
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"write {w} {field}")
        assert tst.host_writes == int(jst.writes) == w + 1
        refreshed += int(np.array_equal(np.asarray(jst.base), row))
        x = torch.from_numpy(rng.normal(size=js.n_padded).astype(np.float32))
        slots = np.asarray([slot, (slot + 3) % 4])
        np.testing.assert_allclose(
            tc.distance_sq(ts, tst, torch.from_numpy(slots), x).numpy(),
            np.asarray(jc.distance_sq(js, jst, jnp.asarray(slots),
                                      jnp.asarray(x.numpy()))),
            rtol=1e-5, atol=1e-5)
    assert refreshed == 2  # writes 3 and 6


@pytest.mark.parametrize("codec", ["f32", "int8", "delta"])
def test_layout_and_bytes_equal_jax_on_lenet(jax_params, codec):
    """LeNet at the paper's ring depth (R = 33): the layout and the byte
    quote equal JAX's, and the port allocates exactly the quote."""
    fl = dict(max_staleness=32, ring_codec=codec)
    tparams = params_from_jax(jax_params, "cpu")
    js = j_spec(jax.tree.map(jnp.asarray, jax_params), 0)
    spec, state = init_version_ring(tparams, TFL(**fl))
    jcodec, tcodec = jvs.resolve_codec(JFL(**fl)), tvs.resolve_codec(TFL(**fl))
    assert tcodec.expected_layout(spec, 33) == jcodec.expected_layout(js, 33)
    quote = tvs.ring_device_bytes(TFL(**fl), spec)
    assert quote == jvs.ring_device_bytes(JFL(**fl), js)
    assert quote == {"f32": 6_488_064, "int8": 1_672_704,
                     "delta": 845_524}[codec]
    assert sum(t.numel() * t.element_size()
               for t in tvs.state_tensors(state)) == quote


# ---------------------------------------------------------------------------
# codec-aware restore errors
# ---------------------------------------------------------------------------


def _host_ring(codec):
    params = {"w": torch.zeros(1000)}
    fl = TFL(**FL, ring_codec=codec)
    _, state = init_version_ring(params, fl)
    return params, tvs.ring_state_to_host(fl, state)


@pytest.mark.parametrize("written,restored,needles", [
    ("int8", "f32", ("'int8'", "ring_codec='f32'", "ring:")),
    ("f32", "int8", ("f32 matrix", "ring_codec='int8'", "codes:", "scale:")),
    ("delta", "int8", ("'delta'", "ring_codec='int8'")),
])
def test_restore_errors_name_the_codec(written, restored, needles):
    params, host = _host_ring(written)
    with pytest.raises(ValueError) as e:
        init_version_ring(params, TFL(**FL, ring_codec=restored), rows=host)
    for needle in needles:
        assert needle in str(e.value)


def test_restore_errors_name_field_and_layout():
    params, host = _host_ring("delta")
    del host["idx"]
    with pytest.raises(ValueError, match="missing field 'idx'"):
        init_version_ring(params, TFL(**FL, ring_codec="delta"), rows=host)
    params, host = _host_ring("int8")
    host["scale"] = host["scale"][:, :-1]
    with pytest.raises(ValueError, match="'int8' ring field 'scale'"):
        init_version_ring(params, TFL(**FL, ring_codec="int8"), rows=host)
    with pytest.raises(ValueError, match="f32 ring shape"):
        init_version_ring(params, TFL(**FL),
                          rows=np.zeros((3, 17), np.float32))


# ---------------------------------------------------------------------------
# the engine under each codec
# ---------------------------------------------------------------------------


def _data(pkg_scenario):
    return pkg_scenario("paper-fig1").make_dataset(6, samples_per_client=64,
                                                   seed=0, noise=1.2)


def _evals(xt, yt):
    x, y = xt[:64], yt[:64]
    j_ev = jax.jit(lambda p: jnp.mean(
        (jnp.argmax(j_apply(p, x), -1) == y).astype(jnp.float32)))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    return (lambda p: {"acc": float(j_ev(p))},
            lambda p: {"acc": float((apply_lenet(p, tx).argmax(-1) == ty)
                                    .float().mean())})


def _jax_run(jax_params, fl, rounds, **kw):
    clients, (xt, yt) = _data(j_scenario)
    return j_run(j_loss, jax.tree.map(jnp.asarray, jax_params), clients,
                 JFL(**fl), rounds, eval_fn=_evals(xt, yt)[0], eval_every=2,
                 seed=0, scenario=j_scenario("paper-fig1"),
                 rounds_per_launch=2, capture_state=True, **kw)


def _port_run(jax_params, fl, rounds, **kw):
    clients, (xt, yt) = _data(t_scenario)
    return run_async(lenet_loss, params_from_jax(jax_params, "cpu"), clients,
                     TFL(**fl), rounds, eval_fn=_evals(xt, yt)[1],
                     eval_every=2, seed=0, scenario=t_scenario("paper-fig1"),
                     rounds_per_launch=2, device="cpu", capture_state=True,
                     **kw)


@pytest.mark.parametrize("codec,weighting,extra", [
    ("int8", "paper", {}),
    ("int8", "fedbuff", {}),
    ("int8", "fedasync_hinge", {"ring_qblock": 64}),
    ("delta", "paper", {}),
    ("delta", "polynomial", {"ring_base_refresh": 2}),
    ("delta", "multiplicative", {"ring_delta_density": 0.2}),
])
def test_engine_matches_jax_per_codec(jax_params, codec, weighting, extra):
    fl = dict(FL, ring_codec=codec, weighting=weighting, **extra)
    want = _jax_run(jax_params, fl, 4)
    got = _port_run(jax_params, fl, 4)
    assert got.server_rounds == want.server_rounds == 4
    assert (got.num_events, got.sim_time) == (want.num_events, want.sim_time)
    for a, b in zip(got.round_log, want.round_log):
        assert (a["version"], a["clients"], a["tau"], a["k"]) == \
            (b["version"], b["clients"], b["tau"], b["k"])
        for f in LOG_FIELDS:
            np.testing.assert_allclose(a[f], b[f], rtol=1e-4, atol=1e-7,
                                       err_msg=f"v{a['version']} {f}")
    assert [(h["round"], h["time"], h["acc"]) for h in got.history] == \
        [(h["round"], h["time"], h["acc"]) for h in want.history]
    for layer, leaves in want.final_state.params.items():
        for key, v in leaves.items():
            np.testing.assert_allclose(got.final_params[layer][key].numpy(),
                                       np.asarray(v), rtol=0, atol=1e-5)
    ring = got.final_state.ring
    assert str(ring["codec"]) == codec
    assert {k: v.shape for k, v in ring.items()} == \
        {k: np.shape(v) for k, v in want.final_state.ring.items()}


@pytest.mark.parametrize("codec", ["f32", "int8", "delta"])
def test_port_resume_is_bit_identical(jax_params, codec, tmp_path):
    """Capture at round 3 (off the eval cadence), save, load, resume to 6:
    round log, history, params and ring equal the uninterrupted run."""
    fl = dict(FL, ring_codec=codec)
    full = _port_run(jax_params, fl, 6)
    half = _port_run(jax_params, fl, 3)
    assert half.history[-1]["round"] == 3  # the trailing forced eval
    tree = engine_state_to_tree(half.final_state)
    path = str(tmp_path / f"{codec}.npz")
    save_checkpoint(path, tree, step=3)
    loaded, step = load_checkpoint(path, like=tree)
    assert step == 3
    resumed = _port_run(jax_params, fl, 6,
                        init_state=engine_state_from_tree(loaded))
    assert resumed.round_log == full.round_log
    assert resumed.history == full.history
    assert resumed.num_events == full.num_events
    for layer, leaves in full.final_params.items():
        for key, v in leaves.items():
            assert torch.equal(resumed.final_params[layer][key], v)
    a, b = resumed.final_state.ring, full.final_state.ring
    if codec == "f32":
        a, b = {"ring": a}, {"ring": b}
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("codec", ["int8", "delta"])
def test_jax_checkpoint_restores_into_port(jax_params, codec, tmp_path):
    """An engine checkpoint written by the JAX package loads through the
    port's ``load_checkpoint``/``engine_state_from_tree`` with its ring
    arrays equal, and the port resumes from it."""
    fl = dict(FL, ring_codec=codec)
    jax_half = _jax_run(jax_params, fl, 2)
    path = str(tmp_path / "jax.npz")
    j_save(path, j_state_to_tree(jax_half.final_state), step=2)
    like = engine_state_to_tree(_port_run(jax_params, fl, 2).final_state)
    loaded, step = load_checkpoint(path, like=like)
    state = engine_state_from_tree(loaded)
    assert step == 2 and state.version == 2
    want = jax_half.final_state.ring
    assert state.ring.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(state.ring[key], np.asarray(want[key]))
    _, ring = init_version_ring(params_from_jax(jax_params, "cpu"),
                                TFL(**fl), rows=state.ring)
    host = tvs.ring_state_to_host(TFL(**fl), ring)
    for key in want:
        np.testing.assert_array_equal(host[key], np.asarray(want[key]))
    resumed = _port_run(jax_params, fl, 4, init_state=state)
    assert resumed.server_rounds == 4 and len(resumed.round_log) == 4
    assert resumed.round_log[:2] == state.round_log


def test_unknown_codec_raises(jax_params):
    with pytest.raises(ValueError, match="ring_codec"):
        init_version_ring(params_from_jax(jax_params, "cpu"),
                          dataclasses.replace(TFL(**FL), ring_codec="lz4"))
