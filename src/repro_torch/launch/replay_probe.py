"""Does a fold journal's replay need deterministic cuDNN to give the live
run's params digest?

Runs ``serve_fl --transport inproc --adapt-every 0 --journal-out`` once at
the launcher's defaults (the live run), then replays its journal, each
replay in a process of its own: three times as ``serve_fl
--replay-journal`` (``cudnn.deterministic`` on, as the launcher sets it
for a journaled run) and three times under the same flags with
``cudnn.deterministic`` off. TF32 is off in every run (``serve_fl.numerics``),
so the two kinds of replay differ in that one flag. Prints the card's name
and power limit first (on ``--device cuda``) and one JSON object last: the
live digest, each replay's digest, and how many of each kind equal the live
one.

    PYTHONPATH=src python -m repro_torch.launch.replay_probe --device cuda
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from repro_torch.launch import serve_fl
from repro_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[3]
REPLAYS = 3  # of each kind


def _digest(cmd: List[str]) -> str:
    """Run ``cmd`` (a process that prints serve_fl's ``--json`` dict) and
    return its ``params_sha256``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=600, check=True).stdout
    return json.loads(out)["params_sha256"]


def loose_replay(journal: str, device: str) -> Dict[str, Any]:
    """Replay ``journal`` in this process as ``serve_fl --replay-journal``
    does, but with ``cudnn.deterministic`` off."""
    args = serve_fl.build_parser().parse_args(
        ["--device", device, "--replay-journal", journal])
    dev = resolve_device(device)
    with serve_fl.numerics(dev, journaled=True):
        torch.backends.cudnn.deterministic = False
        _, out = serve_fl.serve(args, dev)
    return out


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--loose-replay", default=None, metavar="JOURNAL",
                    help="replay JOURNAL in this process with "
                         "cudnn.deterministic off and print serve_fl's "
                         "--json dict (the probe's own subprocess)")
    args = ap.parse_args(argv)
    if args.loose_replay:
        out = loose_replay(args.loose_replay, args.device)
        print(json.dumps(out))
        return out

    resolve_device(args.device)  # raise here, not in a subprocess
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    py = [sys.executable, "-m"]
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        journal = str(Path(tmp) / "folds.jsonl")
        live = _digest(py + ["repro_torch.launch.serve_fl", "--device",
                             args.device, "--adapt-every", "0",
                             "--journal-out", journal, "--json"])
        strict = [_digest(py + ["repro_torch.launch.serve_fl", "--device",
                                args.device, "--replay-journal", journal,
                                "--json"])
                  for _ in range(REPLAYS)]
        loose = [_digest(py + ["repro_torch.launch.replay_probe", "--device",
                               args.device, "--loose-replay", journal])
                 for _ in range(REPLAYS)]
    result = {"device": args.device, "live": live,
              "deterministic_replays": strict,
              "nondeterministic_replays": loose,
              "deterministic_equal": sum(d == live for d in strict),
              "nondeterministic_equal": sum(d == live for d in loose)}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
