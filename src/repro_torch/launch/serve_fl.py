"""Always-on FL serving launcher: continuous-arrival aggregation rounds
(the JAX package's ``launch/serve_fl.py`` on the port).

Runs the ``core/serving.py`` controller as a long-lived endpoint behind
one of three ingresses (DESIGN.md §12):

* ``--transport inproc`` (default) — the deterministic in-process twin:
  a ``sim/`` scenario acts as the traffic generator, client uploads
  arrive on seeded per-client timelines, everything runs on the sim
  clock with no sockets. This is the CI serving smoke lane.
* ``--transport tcp`` / ``--transport http`` — a real
  ``transport.AggregatorServer``: framed-TCP or HTTP listener threads
  feed the controller's thread-safe offer queue while THIS thread runs
  the single-threaded fold loop on wall-clock time. Real clients
  (``launch/client_fl.py``) connect over loopback or the network.

Either way uploads pass admission control (bounded ingress queue,
staleness drops, queue-full backpressure with retry-after), fold through
the streaming round body, and the adaptive controller tunes K toward
``--target-latency``.

Loopback parity (the §12 gate): ``--journal-out j.jsonl`` records every
fold (client, draw seq, base version, payload sha) in fold order;
``--replay-journal j.jsonl`` reconstructs that exact fold sequence from
the seeded datasets IN PROCESS and reports the resulting
``params_sha256`` — byte-equal to the live transport run's digest when
the wire (f32) and the fold math are faithful. Parity replay requires
the live run to use ``--adapt-every 0`` (a fixed K; the adaptive
controller's wall-clock inputs are not journaled).

The observability plane (DESIGN.md §9) hangs off the shared obs flags
(``launch/cli.py``): ``--trace-out`` Chrome-trace spans (round
lifecycle + transport decode/offer spans), ``--metrics-out`` JSONL
snapshots, ``--profile-dir/--profile-every`` windowed device captures,
``--log-level``.

The folds run on ``--device`` (``cuda`` by default, which raises without
a card; ``cpu`` on request); LeNet's params come from the port's
``init_lenet`` on a generator seeded with ``--seed``. The config is f32,
so on the card TF32 is off for cuDNN and matmuls, in a live run and its
replay alike. With ``--journal-out`` or ``--replay-journal`` the CPU runs
one intra-op thread, so a live run and its replay fold to the same bytes,
and cuDNN runs deterministically (``cudnn.deterministic``, no autotuning;
a guard, ``launch/replay_probe.py`` measures whether it is needed). ``run``
puts every such setting back when it returns.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve_fl --scenario paper-fig1 \
      --clients 32 --rounds 20 --weighting fedasync_hinge --json
  PYTHONPATH=src python -m repro_torch.launch.serve_fl --transport tcp \
      --port 0 --port-file port.txt --rounds 4 --adapt-every 0 \
      --journal-out folds.jsonl --json
  PYTHONPATH=src python -m repro_torch.launch.serve_fl --device cpu \
      --replay-journal folds.jsonl --json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import time
from typing import Any, Dict, Iterator, List, Optional, TextIO, Tuple

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.serving import ServeConfig, ServingController, serve_stream
from repro_torch.launch.cli import (
    ObsStack,
    add_obs_flags,
    add_ring_codec_flag,
    add_scenario_flags,
)
from repro_torch.models.lenet import init_lenet, lenet_loss
from repro_torch.sim import get_scenario
from repro_torch.sim.arrivals import TrafficGenerator, draw_upload
from repro_torch.utils.device import resolve_device

logger = logging.getLogger("repro_torch.launch.serve_fl")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    add_scenario_flags(ap)
    ap.add_argument("--weighting", default="paper")
    ap.add_argument("--buffer-k", type=int, default=8,
                    help="initial K (the adaptive controller moves it)")
    ap.add_argument("--max-staleness", type=int, default=12)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8)
    add_ring_codec_flag(
        ap, help_suffix="; the streaming path keeps only the O(R) scalar "
                        "update-norm ring, so this is provenance + parity "
                        "with engine runs of the same FLConfig")
    # serving knobs
    ap.add_argument("--queue-capacity", type=int, default=64)
    ap.add_argument("--service-time", type=float, default=0.0,
                    help="modeled sim-time to fold one upload (0 = free)")
    ap.add_argument("--target-latency", type=float, default=2.0)
    ap.add_argument("--k-min", type=int, default=2)
    ap.add_argument("--k-max", type=int, default=64)
    ap.add_argument("--adapt-every", type=int, default=4,
                    help="rounds between K adjustments (0 = fixed K; "
                         "required for journal parity replay)")
    # transport ingress (DESIGN.md §12)
    ap.add_argument("--transport", default="inproc",
                    choices=("inproc", "tcp", "http"),
                    help="inproc = scenario-driven deterministic twin; "
                         "tcp/http = real socket ingress for client_fl")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="listen port (0 = ephemeral; see --port-file)")
    ap.add_argument("--port-file", default=None,
                    help="write the bound port here once listening "
                         "(atomic rename), so --port 0 orchestration "
                         "can find the server")
    ap.add_argument("--max-wall-time", type=float, default=None,
                    help="wall-clock bound for the transport fold loop "
                         "(safety net when clients die early)")
    ap.add_argument("--journal-out", default=None,
                    help="record every fold (cid/seq/base_version/sha) "
                         "as JSONL, in fold order — the parity replay "
                         "input")
    ap.add_argument("--replay-journal", default=None,
                    help="re-fold a recorded journal in-process from the "
                         "seeded datasets and report params_sha256 "
                         "(ignores --transport)")
    # run bounds (a service has no natural end; at least one must bind)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--max-events", type=int, default=None)
    ap.add_argument("--max-time", type=float, default=None,
                    help="sim-time horizon (inproc only)")
    ap.add_argument("--json", action="store_true",
                    help="dump the full metrics dict as JSON")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the folds run (cuda raises without a card)")
    add_obs_flags(ap)
    return ap


def _attach_journal(ctrl: ServingController, f: TextIO) -> None:
    """Journal every fold, in fold order. Runs on the aggregator thread
    (pump's single owner), so plain writes are race-free."""
    from repro_torch.transport import wire

    def hook(upload, tau: int) -> None:
        f.write(json.dumps({
            "cid": int(upload.client_id), "seq": int(upload.seq),
            "base_version": int(upload.base_version), "tau": int(tau),
            "sent_at": float(upload.sent_at),
            "sha": wire.payload_sha256(upload)}) + "\n")

    ctrl.fold_hook = hook


def replay_journal(path: str, ctrl: ServingController, clients,
                   fl: FLConfig) -> int:
    """Re-fold a recorded journal from the seeded datasets.

    Each entry's upload is reconstructed via the shared ``draw_upload``
    (skipped seqs — uploads that were drawn but never folded, e.g.
    dropped as stale — consume their dataset draws and are discarded),
    sha-verified against the journal, then offered + pumped with a
    FIXED K, reproducing the live run's fold order and taus exactly.
    Returns the number of folds replayed.
    """
    drawn = [0] * len(clients)
    folded = 0
    with open(path) as f:
        for line in f:
            e = json.loads(line)
            cid, seq = int(e["cid"]), int(e["seq"])
            ds = clients[cid]
            # burn the client's skipped draws so seq-th draw aligns
            while drawn[cid] < seq:
                draw_upload(ds, cid, fl, base_version=0, t=0.0)
                drawn[cid] += 1
            if drawn[cid] > seq:
                raise ValueError(
                    f"journal out of order: client {cid} seq {seq} after "
                    f"{drawn[cid]} draws")
            up = draw_upload(ds, cid, fl,
                             base_version=int(e["base_version"]),
                             t=float(e["sent_at"]), seq=seq)
            drawn[cid] += 1
            from repro_torch.transport import wire
            sha = wire.payload_sha256(up)
            if sha != e["sha"]:
                raise ValueError(
                    f"journal sha mismatch for client {cid} seq {seq}: "
                    f"replay {sha[:12]} != recorded {e['sha'][:12]} "
                    "(seed/scenario/flags differ from the live run?)")
            adm = ctrl.offer(up, float(e["sent_at"]))
            if not adm.accepted:
                raise ValueError(
                    f"replay rejected client {cid} seq {seq} "
                    f"({adm.reason}); the live run folded it — config "
                    "mismatch")
            ctrl.pump(float(e["sent_at"]))
            folded += 1
    return folded


def _write_port_file(path: str, port: int) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(port))
    os.replace(tmp, path)  # atomic: readers never see a partial write


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Parse ``argv``, serve, and return the metrics dict."""
    return run(build_parser().parse_args(argv))[1]


@contextlib.contextmanager
def numerics(device: torch.device, journaled: bool) -> Iterator[None]:
    """Set the backend flags the folds run under, and put them back.

    On the card TF32 is off (the config is f32). A journaled run (written
    or replayed) must fold to the live run's bytes: no cuDNN algorithm
    choice that varies from run to run and, on the CPU, one intra-op
    thread (a multi-threaded BLAS may split a sum another way from one
    process to the next).
    """
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
             cudnn.benchmark, torch.get_num_threads())
    try:
        if device.type == "cuda":
            cudnn.allow_tf32 = matmul.allow_tf32 = False
        if journaled:
            cudnn.deterministic, cudnn.benchmark = True, False
            if device.type == "cpu":
                torch.set_num_threads(1)
        logger.info("numerics on %s: cudnn.allow_tf32=%s matmul.allow_tf32=%s"
                    " cudnn.deterministic=%s cudnn.benchmark=%s, %d CPU "
                    "threads", device, cudnn.allow_tf32, matmul.allow_tf32,
                    cudnn.deterministic, cudnn.benchmark,
                    torch.get_num_threads())
        yield
    finally:
        (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
         cudnn.benchmark, threads) = saved
        torch.set_num_threads(threads)


def run(args: argparse.Namespace
        ) -> Tuple[ServingController, Dict[str, Any]]:
    """Serve (or replay) as ``args`` say, under ``numerics``; returns the
    controller and the metrics dict (``params_sha256`` included)."""
    device = resolve_device(args.device)
    with numerics(device, bool(args.journal_out or args.replay_journal)):
        return serve(args, device)


def serve(args: argparse.Namespace, device: torch.device
          ) -> Tuple[ServingController, Dict[str, Any]]:
    """``run`` under the backend flags the caller has set."""
    obs = ObsStack.from_args(args)

    fl = FLConfig(num_clients=args.clients, buffer_size=args.buffer_k,
                  max_staleness=args.max_staleness,
                  local_steps=args.local_steps, batch_size=args.batch,
                  weighting=args.weighting, ring_codec=args.ring_codec)
    cfg = ServeConfig(queue_capacity=args.queue_capacity,
                      service_time=args.service_time,
                      target_round_latency=args.target_latency,
                      k_min=args.k_min, k_max=args.k_max,
                      adapt_every=args.adapt_every)
    sc = get_scenario(args.scenario)
    clients, _ = sc.make_dataset(args.clients,
                                 samples_per_client=args.samples_per_client,
                                 seed=args.seed)

    params = init_lenet(torch.Generator().manual_seed(args.seed))

    if args.replay_journal:
        # parity replay is in-process by construction: fixed K, free
        # service, fold-per-offer — the journal IS the event stream
        cfg = ServeConfig(queue_capacity=args.queue_capacity,
                          service_time=0.0,
                          target_round_latency=args.target_latency,
                          k_min=args.k_min, k_max=args.k_max,
                          adapt_every=0)
        ctrl = ServingController(lenet_loss, params, fl, cfg,
                                 registry=obs.registry, tracer=obs.tracer,
                                 device=device)
        t0 = time.perf_counter()
        folded = replay_journal(args.replay_journal, ctrl, clients, fl)
        out = ctrl.snapshot()
        out["seconds"] = time.perf_counter() - t0
        out["replayed"] = folded
        _finish(args, obs, ctrl, out)
        return ctrl, out

    ctrl = ServingController(lenet_loss, params, fl, cfg,
                             registry=obs.registry, tracer=obs.tracer,
                             device=device)
    journal = open(args.journal_out, "w") if args.journal_out else None
    if journal is not None:
        _attach_journal(ctrl, journal)

    try:
        if args.transport == "inproc":
            out = _serve_inproc(args, obs, ctrl, sc, clients, fl)
        else:
            out = _serve_transport(args, obs, ctrl)
    finally:
        if journal is not None:
            journal.close()
            logger.info("fold journal -> %s", args.journal_out)
    _finish(args, obs, ctrl, out)
    return ctrl, out


def _serve_inproc(args, obs: ObsStack, ctrl: ServingController, sc,
                  clients, fl: FLConfig) -> Dict[str, Any]:
    behavior = sc.behavior(args.clients, seed=args.seed)
    gen = TrafficGenerator(clients, behavior, fl)
    logger.info("serving scenario=%s clients=%d weighting=%s K0=%d "
                "target_latency=%s", sc.name, args.clients, args.weighting,
                ctrl.k, args.target_latency)
    t0 = time.perf_counter()
    out = serve_stream(ctrl, gen, max_rounds=args.rounds,
                       max_events=args.max_events, max_time=args.max_time,
                       round_hook=obs.round_hook)
    if ctrl.device.type == "cuda":
        torch.cuda.synchronize()  # the wall time covers the device's work
    dt = time.perf_counter() - t0
    out["seconds"] = dt
    out["uploads_per_sec"] = out["folded"] / dt if dt > 0 else 0.0
    logger.info("admission: admitted=%d queue_full=%d stale_ingress=%d "
                "stale_queue=%d lost=%d retries=%d queue_depth_max=%d",
                out["admitted"], out["rejected_queue_full"],
                out["dropped_stale_ingress"], out["dropped_stale_queue"],
                out["lost_in_transit"], out["retries_scheduled"],
                out["queue_depth_max"])
    return out


def _serve_transport(args, obs: ObsStack,
                     ctrl: ServingController) -> Dict[str, Any]:
    from repro_torch.transport.server import AggregatorServer

    srv = AggregatorServer(ctrl, transport=args.transport, host=args.host,
                           port=args.port, registry=obs.registry,
                           tracer=obs.tracer)
    if args.port_file:
        _write_port_file(args.port_file, srv.port)
    srv.start()
    logger.info("serving %s on %s:%d until version >= %d%s",
                args.transport, args.host, srv.port, args.rounds,
                f" or {args.max_wall_time}s" if args.max_wall_time else "")
    t0 = time.perf_counter()

    def stop() -> bool:
        if ctrl.version >= args.rounds:
            return True
        return bool(args.max_wall_time
                    and time.perf_counter() - t0 > args.max_wall_time)

    try:
        srv.serve(stop=stop, round_hook=obs.round_hook)
    finally:
        srv.shutdown()
    dt = time.perf_counter() - t0
    out = ctrl.snapshot()
    out["seconds"] = dt
    out["uploads_per_sec"] = out["folded"] / dt if dt > 0 else 0.0
    out["transport"] = args.transport
    out["port"] = srv.port
    return out


def _finish(args, obs: ObsStack, ctrl: ServingController,
            out: Dict[str, Any]) -> None:
    from repro_torch.transport import wire

    version, params = ctrl.pull()
    out["params_sha256"] = wire.params_sha256(version, params)
    logger.info("%d rounds / %d uploads folded in %.2fs -> %.1f uploads/s",
                out["rounds"], out["folded"], out["seconds"],
                out.get("uploads_per_sec", 0.0))
    logger.info("round latency p50=%.3fs p99=%.3fs, cadence mean=%.3fs, "
                "arrival rate=%.2f/s, K -> %d; params_sha256=%s",
                out["round_latency_p50"], out["round_latency_p99"],
                out["round_cadence_mean"], out["arrival_rate"], out["k"],
                out["params_sha256"][:16])
    obs.finish(ctrl.version)
    if args.json:
        print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
