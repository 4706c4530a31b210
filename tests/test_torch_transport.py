"""The port's serving transport against the JAX package's, on the CPU.

Pinned to ``repro.transport`` and ``repro.launch.serve_fl``: wire frames,
int8 payloads and both digests byte-equal to JAX's for the same inputs; a
frame encoded by either package decodes in the other; the ``params_sha256``
of ``params_from_jax(init)`` equal to JAX's digest of the init. Then the
port on its own, as ``tests/test_transport.py`` holds JAX's: tcp/http
served params byte-identical to the in-process twin, a concurrent client
fleet's fold journal replaying to the live digest, a wrong seed detected,
offers from many threads reconciling, and ``pull`` hammered while the
fold thread applies (every pulled ``(version, params)`` hashes to the
digest recorded at that version's apply: the test that in-place updates
would fail). The port's ``replay_journal`` replays a JAX run's journal with
every sha verified and the same tau sequence (params within rtol 2e-5 /
atol 1e-6: the same f32 folds in two frameworks). The launchers' flag
surface equals JAX's plus ``--device``, and the socket launchers run end to
end as subprocesses (server, two clients, replay: the same digest).
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFL
from repro.core.serving import ServeConfig as JServeConfig
from repro.core.serving import ServingController as JController
from repro.launch import client_fl as j_client_fl
from repro.launch import serve_fl as j_serve_fl
from repro.models.lenet import init_lenet as j_init_lenet
from repro.sim.arrivals import draw_upload as j_draw_upload
from repro.transport import wire as j_wire
from repro_torch.configs.base import FLConfig
from repro_torch.core.serving import (
    Admission,
    AggregatorService,
    ServeConfig,
    ServingController,
    Upload,
    tree_from_wire,
    tree_to_wire,
)
from repro_torch.launch import client_fl, serve_fl
from repro_torch.launch.serve_fl import _attach_journal, replay_journal
from repro_torch.models import params_from_jax
from repro_torch.sim.arrivals import draw_upload
from repro_torch.transport import wire
from repro_torch.transport.client import RemoteAggregator, run_client
from repro_torch.transport.server import AggregatorServer

ROOT = Path(__file__).resolve().parents[1]
PARAMS = {"w": np.array([1.0, -1.0, 0.5, 2.0], np.float32)}


def _quad_loss(params, batch):
    x, y = batch
    return torch.mean((x @ params["w"] - y) ** 2), {}


def _j_quad_loss(params, batch):
    x, y = batch
    return jnp.mean((x @ params["w"] - y) ** 2), {}


class QuadDataset:
    """Seeded sequential-draw dataset (numpy) speaking the ClientDataset
    batch protocol for the quad problem, re-creatable from (cid,)."""

    def __init__(self, cid: int, size: int = 16):
        self.size = size
        self._rng = np.random.default_rng(1234 + cid)

    def batch(self, b):
        x = self._rng.normal(size=(b, 4)).astype(np.float32)
        return x, (x @ np.arange(1.0, 5.0)).astype(np.float32)

    def batches(self, b, m):
        xs, ys = zip(*[self.batch(b) for _ in range(m)])
        return np.stack(xs), np.stack(ys)


def _fl(cls=FLConfig, **kw):
    for key, val in dict(buffer_size=2, local_steps=1, local_lr=0.1,
                         max_staleness=8, batch_size=4).items():
        kw.setdefault(key, val)
    return cls(**kw)


def _ctrl(fl=None, **kw):
    kw.setdefault("adapt_every", 0)
    kw.setdefault("service_time", 0.0)
    return ServingController(_quad_loss, PARAMS, fl or _fl(),
                             ServeConfig(**kw), device="cpu")


def _tensors():
    rng = np.random.default_rng(0)
    return {"a": rng.normal(size=(3, 5)).astype(np.float32),
            "b": np.arange(7, dtype=np.int64),
            "c": rng.normal(size=(4096,)).astype(np.float32)}


# ---------------------------------------------------------------------------
# the copied wire module against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["f32", "int8"])
def test_frames_byte_identical_to_jax(codec):
    meta = {"detail": {"nested": [1, 2.5, "x"], "ok": True}}
    frame = wire.encode_message("offer", meta, _tensors(), codec=codec,
                                qblock=128)
    assert frame == j_wire.encode_message("offer", meta, _tensors(),
                                          codec=codec, qblock=128)
    for enc, dec in ((wire, j_wire), (j_wire, wire)):  # cross-decoding
        kind, m2, t2 = dec.decode_message(
            enc.encode_message("offer", meta, _tensors(), codec=codec))
        kind_ref, _, t_ref = enc.decode_message(
            enc.encode_message("offer", meta, _tensors(), codec=codec))
        assert kind == kind_ref == "offer" and m2 == meta
        for name in t_ref:
            assert t2[name].dtype == t_ref[name].dtype
            np.testing.assert_array_equal(t2[name], t_ref[name])


def test_upload_digests_byte_identical_to_jax():
    t_ds, j_ds = QuadDataset(3), QuadDataset(3)
    for seq in range(3):
        up = draw_upload(t_ds, 3, _fl(), base_version=seq, t=0.5, seq=seq)
        j_up = j_draw_upload(j_ds, 3, _fl(JFL), base_version=seq, t=0.5,
                             seq=seq)
        assert wire.payload_sha256(up) == j_wire.payload_sha256(j_up)
        meta, tensors = up.to_wire()
        j_meta, j_tensors = j_up.to_wire()
        assert wire.encode_message("offer", meta, tensors) == \
            j_wire.encode_message("offer", j_meta, j_tensors)


def test_params_digest_of_converted_init_equals_jax():
    import jax

    init = j_init_lenet(jax.random.PRNGKey(0))
    port = params_from_jax(jax.tree.map(np.asarray, init), "cpu")
    assert wire.params_sha256(5, port) == j_wire.params_sha256(5, init)
    tensors = {}
    skel = tree_to_wire("params", port, tensors)
    assert all(isinstance(v, np.ndarray) for v in tensors.values())
    back = tree_from_wire(skel, tensors)
    assert wire.params_sha256(5, back) == j_wire.params_sha256(5, init)


def test_schema_errors_and_int8_bound():
    frame = bytearray(wire.encode_message("offer", {}))
    frame[2:4] = (wire.SCHEMA_VERSION + 1).to_bytes(2, "big")
    with pytest.raises(wire.WireError, match="schema"):
        wire.decode_message(bytes(frame))
    with pytest.raises(wire.WireError):
        wire.decode_message(b"XX" + b"\x00" * 32)
    full = wire.encode_message("offer", {}, _tensors())
    with pytest.raises(wire.WireError):
        wire.decode_message(full[: len(full) // 2])
    i8 = wire.encode_message("offer", {}, _tensors(), codec="int8")
    assert len(full) >= 3 * len(i8) - 200
    _, _, t2 = wire.decode_message(i8)
    c = _tensors()["c"]
    assert np.abs(t2["c"] - c).max() <= (c.max() - c.min()) / 255.0
    np.testing.assert_array_equal(t2["b"], _tensors()["b"])


def test_upload_and_admission_wire_roundtrip():
    up = draw_upload(QuadDataset(0), 0, _fl(), base_version=3, t=1.5, seq=7)
    _, meta, tensors = wire.decode_message(
        wire.encode_message("offer", *up.to_wire()))
    up2 = Upload.from_wire(meta, tensors)
    assert (up2.client_id, up2.base_version, up2.seq) == (0, 3, 7)
    assert wire.payload_sha256(up2) == wire.payload_sha256(up)
    adm = Admission(accepted=False, reason="queue_full", retry_after=1.25)
    assert Admission.from_wire(adm.to_wire()) == adm


# ---------------------------------------------------------------------------
# the port's socket path
# ---------------------------------------------------------------------------


def _drive(service: AggregatorService, pump, ds, fl, uploads=6):
    for seq in range(uploads):
        version, _params = service.pull()
        up = draw_upload(ds, 0, fl, base_version=version, t=float(seq),
                         seq=seq)
        assert service.offer(up, float(seq)).accepted
        pump()
    return service.pull()


@pytest.mark.parametrize("transport", ["tcp", "http"])
def test_socket_params_byte_identical_to_twin(transport):
    fl = _fl()
    twin = _ctrl(fl)
    v_twin, p_twin = _drive(twin, lambda: twin.pump(1e9), QuadDataset(0), fl)
    ctrl = _ctrl(fl)
    srv = AggregatorServer(ctrl, transport=transport)
    srv.start()
    try:
        client = RemoteAggregator("127.0.0.1", srv.port, transport=transport)
        v_sock, p_sock = _drive(client, lambda: ctrl.pump(srv.clock()),
                                QuadDataset(0), fl)
        snap = client.snapshot()
        client.close()
    finally:
        srv.shutdown()
    assert v_sock == v_twin == 3 and snap["version"] == 3
    assert p_sock["w"].tobytes() == p_twin["w"].numpy().tobytes()
    assert wire.params_sha256(v_sock, p_sock) == \
        wire.params_sha256(v_twin, p_twin)


def test_concurrent_clients_replay_to_same_digest(tmp_path):
    """The fold loop runs on a thread that is not the main one (the device
    work of every fold with it); the journal replays to the live digest."""
    fl = _fl(max_staleness=100)
    rounds, n_clients = 3, 3
    ctrl = _ctrl(fl, queue_capacity=64)
    journal = tmp_path / "folds.jsonl"
    with open(journal, "w") as f:
        _attach_journal(ctrl, f)
        srv = AggregatorServer(ctrl, transport="tcp")
        srv.start()
        folder = threading.Thread(
            target=srv.serve,
            kwargs={"stop": lambda: ctrl.version >= rounds, "poll": 0.01},
            daemon=True)
        folder.start()

        def one_client(cid):
            svc = RemoteAggregator("127.0.0.1", srv.port, seed=cid)
            try:
                run_client(svc, QuadDataset(cid), cid, fl, uploads=8,
                           stop_at_version=rounds, seed=cid)
            finally:
                svc.close()

        threads = [threading.Thread(target=one_client, args=(c,))
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        folder.join(timeout=60)
        srv.shutdown()
    assert not folder.is_alive() and ctrl.version >= rounds
    assert not any(t.is_alive() for t in threads)
    entries = [json.loads(line) for line in journal.open()]
    assert len(entries) >= rounds * fl.buffer_size
    replay = _ctrl(fl, queue_capacity=64)
    folded = replay_journal(str(journal), replay,
                            [QuadDataset(c) for c in range(n_clients)], fl)
    assert folded == len(entries)
    assert wire.params_sha256(*replay.pull()) == \
        wire.params_sha256(*ctrl.pull())


def test_replay_detects_wrong_seed(tmp_path):
    fl = _fl()
    ctrl = _ctrl(fl)
    journal = tmp_path / "folds.jsonl"
    with open(journal, "w") as f:
        _attach_journal(ctrl, f)
        up = draw_upload(QuadDataset(0), 0, fl, base_version=0, t=0.0, seq=0)
        assert ctrl.offer(up, 0.0).accepted
        ctrl.pump(0.0)
    with pytest.raises(ValueError, match="sha mismatch"):
        replay_journal(str(journal), _ctrl(fl), [QuadDataset(99)], fl)


def test_concurrent_offers_reconcile():
    fl = _fl(max_staleness=1000)
    ctrl = _ctrl(fl, queue_capacity=16)
    per_thread, n_threads = 30, 4
    errors = []

    def hammer(tid):
        ds = QuadDataset(tid)
        try:
            for i in range(per_thread):
                ctrl.offer(draw_upload(ds, tid, fl, base_version=0, t=0.0,
                                       seq=i), 0.0)
                v, p = ctrl.pull()
                assert v >= 0 and p is not None
                ctrl.snapshot()
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=hammer, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads):
        ctrl.pump(0.0)
    for t in threads:
        t.join(timeout=60)
    ctrl.pump(0.0)
    assert not errors
    c = ctrl.counters
    assert c["admitted"] + c["rejected_queue_full"] \
        + c["dropped_stale_ingress"] == per_thread * n_threads
    assert c["folded"] == c["admitted"]
    assert ctrl.version == c["folded"] // ctrl.k


def test_pulled_params_stay_those_of_their_version():
    """``pull`` from worker threads while the fold thread applies: each
    pulled pair, serialised outside the lock as the transport does,
    hashes to the digest recorded when that version was applied."""
    fl = _fl(max_staleness=1000, buffer_size=1)
    ctrl = _ctrl(fl, queue_capacity=256, k_min=1)  # an apply every fold
    digests = {0: wire.params_sha256(*ctrl.pull())}
    pulled, stop = [], threading.Event()
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def puller():
            while not stop.is_set():
                v, p = ctrl.pull()
                tensors = {}
                tree_to_wire("params", p, tensors)  # outside the lock
                pulled.append((v, tensors))

        threads = [threading.Thread(target=puller) for _ in range(6)]
        for t in threads:
            t.start()
        ds = QuadDataset(0)
        for i in range(40):
            ctrl.offer(draw_upload(ds, 0, fl, base_version=ctrl.version,
                                   t=0.0, seq=i), 0.0)
            ctrl.pump(0.0)
            digests[ctrl.version] = wire.params_sha256(*ctrl.pull())
        stop.set()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert ctrl.version == 40 and len(pulled) > 40
    for v, tensors in pulled:
        assert wire.params_sha256(v, {"w": tensors["params.w"]}) == \
            digests[v]


def test_port_replays_a_jax_journal(tmp_path):
    """A JAX controller's fold journal (a scenario stream with staleness)
    replayed by the port's ``replay_journal``: every sha verifies, the tau
    sequence is the live run's, and the params land on JAX's."""
    fl_kw = dict(buffer_size=3, max_staleness=6, local_steps=2,
                 local_lr=0.05, batch_size=4)
    j_ctrl = JController(_j_quad_loss, {"w": jnp.asarray(PARAMS["w"])},
                         _fl(JFL, **fl_kw), JServeConfig(adapt_every=0))
    journal = tmp_path / "jax_folds.jsonl"
    n, j_fl = 3, _fl(JFL, **fl_kw)
    datasets = [QuadDataset(c) for c in range(n)]
    drawn, pulled = [0] * n, [0] * n
    with open(journal, "w") as f:
        j_serve_fl._attach_journal(j_ctrl, f)
        for step in range(18):
            cid = step % n
            if step % 5 == 4:  # a draw that never reaches the server
                j_draw_upload(datasets[cid], cid, j_fl, base_version=0,
                              t=0.0)
                drawn[cid] += 1
            up = j_draw_upload(datasets[cid], cid, j_fl,
                               base_version=pulled[cid], t=0.1 * step,
                               seq=drawn[cid])
            drawn[cid] += 1
            assert j_ctrl.offer(up, 0.1 * step).accepted
            j_ctrl.pump(0.1 * step)
            if step % 2:  # every other upload re-pulls: staleness varies
                pulled[cid] = j_ctrl.version
    entries = [json.loads(line) for line in journal.open()]
    assert max(e["tau"] for e in entries) >= 1
    ctrl = _ctrl(_fl(**fl_kw))
    taus = []
    ctrl.fold_hook = lambda up, tau: taus.append(tau)
    folded = replay_journal(str(journal), ctrl,
                            [QuadDataset(c) for c in range(n)],
                            _fl(**fl_kw))
    assert folded == len(entries) == 18
    assert taus == [e["tau"] for e in entries]
    assert ctrl.version == j_ctrl.version == 6
    np.testing.assert_allclose(ctrl.params["w"].numpy(),
                               np.asarray(j_ctrl.params["w"]), rtol=2e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------


def _options(parser):
    return {opt: (act.default, tuple(act.choices) if act.choices else None)
            for opt, act in parser._option_string_actions.items()}


def test_launcher_flag_surface_matches_jax():
    """serve_fl and client_fl take JAX's flags with JAX's defaults and
    choices; serve_fl adds ``--device`` (default cuda)."""
    t_serve, j_serve = _options(serve_fl.build_parser()), \
        _options(j_serve_fl.build_parser())
    assert set(t_serve) - set(j_serve) == {"--device"}
    assert t_serve["--device"] == ("cuda", ("cuda", "cpu"))
    for opt, val in j_serve.items():
        assert t_serve[opt] == val, opt
    assert _options(client_fl.build_parser()) == \
        _options(j_client_fl.build_parser())
    shared = ("--scenario", "--clients", "--samples-per-client", "--seed",
              "--log-level", "--trace-out", "--metrics-out", "--flush-every",
              "--profile-dir", "--profile-every", "--profile-window")
    for opt in shared:
        assert t_serve[opt] == _options(client_fl.build_parser())[opt]


def test_socket_launchers_end_to_end(tmp_path):
    """``serve_fl --transport tcp`` with two ``client_fl`` subprocesses,
    then ``serve_fl --replay-journal``: the same params digest."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    common = ["--clients", "8", "--samples-per-client", "32"]
    port_file, journal = tmp_path / "port.txt", tmp_path / "folds.jsonl"
    server = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_fl", *common,
         "--device", "cpu", "--transport", "tcp", "--port", "0",
         "--port-file", str(port_file), "--rounds", "3", "--buffer-k", "4",
         "--adapt-every", "0", "--journal-out", str(journal),
         "--max-wall-time", "120", "--json", "--log-level", "warning"],
        env=env, stdout=subprocess.PIPE, text=True)
    clients = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.client_fl", *common,
         "--cid", str(c), "--port-file", str(port_file), "--uploads", "12",
         "--stop-at-version", "3", "--log-level", "warning"],
        env=env, stdout=subprocess.PIPE, text=True) for c in range(2)]
    try:
        live = json.loads(server.communicate(timeout=180)[0])
        for c in clients:  # a client that pulls after the server shut down
            c.communicate(timeout=60)  # loses that race: it must not hang
    finally:
        for proc in [server] + clients:
            proc.kill()
            proc.wait()
    assert server.returncode == 0 and live["version"] >= 3
    replay = json.loads(subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_fl", *common,
         "--device", "cpu", "--buffer-k", "4", "--replay-journal",
         str(journal), "--json", "--log-level", "warning"],
        env=env, capture_output=True, text=True, timeout=180,
        check=True).stdout)
    assert replay["replayed"] == live["folded"]
    assert replay["params_sha256"] == live["params_sha256"]


def test_tree_to_wire_takes_tensors():
    """Tensor leaves serialise as host numpy arrays in sorted-name order and
    come back as the same tree."""
    tensors = {}
    skel = tree_to_wire("params", {"b": torch.ones(2), "a": (torch.zeros(3),
                                                             torch.ones(1))},
                        tensors)
    assert list(tensors) == ["params.a.0", "params.a.1", "params.b"]
    assert all(isinstance(v, np.ndarray) for v in tensors.values())
    back = tree_from_wire(skel, tensors)
    assert isinstance(back["a"], tuple)
    assert [x.shape for x in back["a"] + (back["b"],)] == [(3,), (1,), (2,)]


@pytest.mark.parametrize("journaled", [False, True])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_serve_fl_numerics_set_and_restore_backend_flags(device, journaled):
    """TF32 is off on the card (the config is f32); a journaled run adds
    deterministic cuDNN and, on the CPU, one thread; every flag goes back.
    The flags are plain settings, so this holds on a machine with no card."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul

    def flags():
        return (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
                cudnn.benchmark, torch.get_num_threads())

    saved = flags()
    threads = max(2, saved[4])
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = cudnn.benchmark = True
        cudnn.deterministic = False
        torch.set_num_threads(threads)
        before = flags()
        with serve_fl.numerics(torch.device(device), journaled):
            inside = flags()
        assert flags() == before
    finally:
        (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
         cudnn.benchmark, _) = saved
        torch.set_num_threads(saved[4])
    on_card = device == "cuda"
    assert inside[:2] == (not on_card, not on_card)
    assert inside[2:4] == ((True, False) if journaled else (False, True))
    assert inside[4] == (1 if journaled and not on_card else threads)
