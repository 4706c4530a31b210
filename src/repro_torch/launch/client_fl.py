"""FL client launcher: one real client against a serve_fl transport (the
JAX package's ``launch/client_fl.py`` on the port).

The socket-side half of the loopback smoke (DESIGN.md §12): builds the
SAME seeded scenario datasets as the server (``--scenario/--seed`` must
match), picks its ``--cid`` slice, connects a ``RemoteAggregator`` over
tcp or http, and runs the ``transport.client.run_client`` lifecycle —
pull, draw the seeded local round, offer, honor queue-full
``retry_after`` hints by re-offering the SAME (now staler) upload,
re-pull after every admit/stale-drop. Connection loss is retried with
jittered exponential backoff, so the client survives a server that
comes up late or restarts.

Exits once ``--uploads`` draws are spent, the pulled version reaches
``--stop-at-version``, or ``--max-wall-time`` elapses — whichever is
first. Prints its ledger (drawn/admitted/retries/dropped_stale/
reconnects) as JSON on stdout.

A client only draws numpy batches and ships them: it never touches a
device (the server folds on its own), so it initialises no CUDA context.

Example (against serve_fl --transport tcp --port-file port.txt):
  PYTHONPATH=src python -m repro_torch.launch.client_fl --port-file port.txt \
      --cid 3 --uploads 16 --stop-at-version 4
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time

from repro_torch.configs.base import FLConfig
from repro_torch.launch.cli import ObsStack, add_obs_flags, add_scenario_flags
from repro_torch.sim import get_scenario
from repro_torch.transport.client import RemoteAggregator, run_client

logger = logging.getLogger("repro_torch.launch.client_fl")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    add_scenario_flags(ap)
    ap.add_argument("--cid", type=int, required=True,
                    help="this client's index into the scenario population")
    # local-round shape: MUST match the server's flags for parity
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8)
    # endpoint
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--port-file", default=None,
                    help="poll this file for the server's bound port "
                         "(serve_fl --port-file); overrides --port")
    ap.add_argument("--port-wait", type=float, default=30.0,
                    help="seconds to wait for --port-file to appear")
    ap.add_argument("--transport", default="tcp", choices=("tcp", "http"))
    ap.add_argument("--wire-codec", default="f32",
                    choices=("f32", "int8"),
                    help="upload payload codec (f32 = bit-exact parity; "
                         "int8 = per-block affine, ~4x smaller)")
    # lifecycle
    ap.add_argument("--uploads", type=int, default=16,
                    help="max local rounds to draw")
    ap.add_argument("--stop-at-version", type=int, default=0,
                    help="exit once the pulled model reaches this version "
                         "(0 = never; set to the server's --rounds)")
    ap.add_argument("--think-time", type=float, default=0.0,
                    help="modeled local-training wall time per round")
    ap.add_argument("--max-wall-time", type=float, default=0.0)
    # reconnect budget
    ap.add_argument("--max-retries", type=int, default=8)
    ap.add_argument("--backoff-base", type=float, default=0.05)
    ap.add_argument("--backoff-cap", type=float, default=2.0)
    add_obs_flags(ap)
    return ap


def _resolve_port(args) -> int:
    if not args.port_file:
        if not args.port:
            raise SystemExit("need --port or --port-file")
        return args.port
    deadline = time.monotonic() + args.port_wait
    while time.monotonic() < deadline:
        if os.path.exists(args.port_file):
            text = open(args.port_file).read().strip()
            if text:
                return int(text)
        time.sleep(0.05)
    raise SystemExit(f"--port-file {args.port_file} did not appear within "
                     f"{args.port_wait}s")


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    obs = ObsStack.from_args(args)

    fl = FLConfig(num_clients=args.clients, local_steps=args.local_steps,
                  batch_size=args.batch)
    sc = get_scenario(args.scenario)
    clients, _ = sc.make_dataset(args.clients,
                                 samples_per_client=args.samples_per_client,
                                 seed=args.seed)
    if not 0 <= args.cid < len(clients):
        raise SystemExit(f"--cid {args.cid} outside population "
                         f"[0, {len(clients)})")

    port = _resolve_port(args)
    svc = RemoteAggregator(args.host, port, transport=args.transport,
                           codec=args.wire_codec,
                           max_retries=args.max_retries,
                           backoff_base=args.backoff_base,
                           backoff_cap=args.backoff_cap,
                           seed=args.seed)
    logger.info("client %d -> %s://%s:%d (codec=%s, uploads<=%d)",
                args.cid, args.transport, args.host, port,
                args.wire_codec, args.uploads)
    try:
        stats = run_client(svc, clients[args.cid], args.cid, fl,
                           uploads=args.uploads,
                           stop_at_version=args.stop_at_version,
                           think_time=args.think_time,
                           max_wall_time=args.max_wall_time,
                           seed=args.seed)
    finally:
        svc.close()
    stats["cid"] = args.cid
    stats["reconnects"] = svc.reconnects
    for k, v in stats.items():
        obs.registry.gauge("client_" + k, cid=args.cid).set(float(v))
    obs.finish(0)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
