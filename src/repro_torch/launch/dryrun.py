"""Dry run: every (arch x input shape) on the production mesh, as a run of
its Program's step on ``meta`` tensors (the JAX package's
``launch/dryrun.py``, which lowers and compiles on 512 placeholder
devices).

A ``meta`` run proves that every builder produces a step that traces at
the production shapes, and that every spec divides its dim on the mesh; it
allocates nothing and computes nothing. The record keeps the JAX record's
keys where they mean something without XLA:

* ``ok`` / ``skipped`` (``arch.skip_shapes``) / ``error`` and ``trace``;
* ``trace_s``: the build and the meta run, in place of ``lower_s`` and
  ``compile_s``;
* ``memory``: ``argument_size_in_bytes`` per rank (each leaf's bytes over
  the product of the mesh axes its spec names), ``output_size_in_bytes``
  per rank from ``out_shardings`` where the Program gives them, else
  global (``output_size_basis`` says which), ``alias_size_in_bytes`` the
  donated arguments' per-rank bytes. No temp, code or accessed bytes:
  meta tensors have no allocator and no compiler;
* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count over the
  global step (matmuls only: K6's scan and every elementwise op count 0)
  plus K5's, 4 D a visible (query, key) pair and head forward and 10 D
  backward (``flops_counted`` says so); ``flops_per_device`` is an even
  split over the mesh. Neither is XLA's ``cost_analysis()``;
* ``collective_bytes``: None. The JAX package parses the collectives that
  XLA's partitioner inserts (``launch/hlo.py``); the port has no
  partitioner, and its explicit collectives are counted at run time
  (``sharding/collectives.py::COLLECTIVE_STATS``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch hymba-1.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import get_arch, list_archs
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.program import DRYRUN_FL, build_program
from repro_torch.sharding.specs import PartitionSpec, mesh_axis_size

FLOPS_COUNTED = "matmul+K5 formula, global"
COLLECTIVES_REASON = ("no partitioner: the port's collectives are explicit "
                      "and counted at run time (COLLECTIVE_STATS)")


def _parse_overrides(items):
    out = {}
    for it in items or []:
        k, v = it.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("true", "True"):
            v = True
        if v in ("false", "False"):
            v = False
        out[k] = v
    return out


def visible_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs of one (b, h) that K5's mask lets through: key j
    is visible to query i where ``(not causal or i >= j) and (window == 0
    or j > i - window)``."""
    if causal:
        if not window:
            return s * (s + 1) // 2
        w = min(window, s)
        return w * (w + 1) // 2 + (s - w) * w
    if not window or window >= s:
        return s * s
    # non-causal band: query i sees keys max(0, i - window + 1) .. s - 1
    return s * s - (s - window) * (s - window + 1) // 2


def k5_flops(calls) -> int:
    """K5's operations over the recorded meta calls: 4 D a visible pair and
    head forward (QK^T and PV), 10 D backward."""
    total = 0
    for direction, (b, s, h, d), _, causal, window in calls:
        per = 4 if direction == "forward" else 10
        total += per * d * visible_pairs(s, causal, window) * b * h
    return total


def _spec_leaves(tree: Any, spec: Any) -> Iterator[Tuple[Any, PartitionSpec]]:
    """(leaf, spec) pairs of a tree and its spec tree; a spec over a subtree
    applies to each of its leaves."""
    if isinstance(spec, PartitionSpec):
        for leaf in _leaves(tree):
            yield leaf, spec
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _spec_leaves(tree[key], spec[key])
    elif isinstance(tree, (tuple, list)):
        for t, sp in zip(tree, spec, strict=True):
            yield from _spec_leaves(t, sp)
    else:
        raise TypeError(f"spec {spec!r} for leaf {type(tree).__name__}")


def _leaves(tree: Any) -> Iterator[Any]:
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree


def _nbytes(leaf: Any) -> int:
    """A tensor's bytes; a host int (the dist state's count and version) is
    kept on the host and holds none on a device."""
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return 0


def rank_bytes(tree: Any, spec: Any, mesh) -> int:
    """Bytes of ``tree`` on one rank: each leaf's bytes over the product of
    the mesh axes its spec names."""
    total = 0
    for leaf, sp in _spec_leaves(tree, spec):
        shards = 1
        for entry in sp:
            shards *= mesh_axis_size(mesh, entry)
        total += _nbytes(leaf) // shards
    return total


def run_one(arch_id: str, shape_name: str, multi_pod: bool,
            verbose: bool = True, model_overrides: Optional[dict] = None,
            fl=None) -> Dict[str, Any]:
    rec: Dict[str, Any] = {
        "arch": arch_id, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "ok": False,
        "model_overrides": model_overrides or {}}
    arch = get_arch(arch_id)
    if shape_name in arch.skip_shapes:
        rec.update(skipped=True, reason=f"skip per DESIGN.md: {arch.notes[:80]}")
        rec["ok"] = True
        if verbose:
            print(f"[dryrun] SKIP {arch_id} x {shape_name} (by design)")
        return rec
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        t0 = time.perf_counter()
        prog = build_program(arch_id, shape_name, mesh, fl=fl,
                             model_overrides=model_overrides, device="meta")
        fa_ops.flash_attention.meta_calls.clear()
        with FlopCounterMode(display=False) as counter:
            out = prog.step_fn(*prog.arg_sds)
        trace_s = time.perf_counter() - t0
        k5 = k5_flops(fa_ops.flash_attention.meta_calls)
        fa_ops.flash_attention.meta_calls.clear()
        devices = int(mesh.mesh.numel())
        args = prog.arg_sds
        mem = {"argument_size_in_bytes": sum(
            rank_bytes(a, s, mesh) for a, s in zip(args, prog.in_shardings,
                                                    strict=True))}
        if prog.out_shardings is not None:
            mem["output_size_in_bytes"] = rank_bytes(out, prog.out_shardings,
                                                     mesh)
            basis = "per rank, from out_shardings"
        else:
            mem["output_size_in_bytes"] = sum(_nbytes(t) for t in _leaves(out))
            basis = "global: the Program gives no out_shardings"
        mem["alias_size_in_bytes"] = sum(
            rank_bytes(args[i], prog.in_shardings[i], mesh)
            for i in prog.donate_argnums)
        flops = float(counter.get_total_flops() + k5)
        rec.update(
            ok=True, trace_s=round(trace_s, 2), flops=flops,
            flops_k5=float(k5), flops_per_device=flops / devices,
            flops_counted=FLOPS_COUNTED, collective_bytes=None,
            collective_bytes_reason=COLLECTIVES_REASON, memory=mem,
            output_size_basis=basis, meta=prog.meta)
        if verbose:
            print(f"[dryrun] OK {arch_id} x {shape_name} mesh={rec['mesh']} "
                  f"trace={rec['trace_s']}s flops={flops:.3e} "
                  f"(K5 {k5:.3e}) per-rank args "
                  f"{mem['argument_size_in_bytes'] / 2**30:.3f} GiB")
            print(f"         memory: {mem} (output {basis})")
    except Exception as e:  # noqa: BLE001 — a failure here is a finding
        rec.update(error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[dryrun] FAIL {arch_id} x {shape_name}: {rec['error']}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--out", default=None, help="directory for per-pair JSON")
    ap.add_argument("--tag", default=None, help="suffix for output JSON names")
    ap.add_argument("--model-override", action="append", default=[],
                    help="k=v ModelConfig overrides (perf experiments)")
    ap.add_argument("--fl-override", action="append", default=[],
                    help="k=v FLConfig overrides (perf experiments)")
    args = ap.parse_args(argv)
    overrides = _parse_overrides(args.model_override)
    fl = None
    fl_over = _parse_overrides(args.fl_override)
    if fl_over:
        fl = dataclasses.replace(DRYRUN_FL, **fl_over)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    n_fail = 0
    for multi in meshes:
        for a in archs:
            for s in shapes:
                rec = run_one(a, s, multi, model_overrides=overrides, fl=fl)
                n_fail += 0 if rec["ok"] else 1
                if args.out:
                    os.makedirs(args.out, exist_ok=True)
                    suffix = f"_{args.tag}" if args.tag else ""
                    tag = f"{a}_{s}_{'multi' if multi else 'single'}{suffix}.json"
                    with open(os.path.join(args.out, tag), "w") as f:
                        json.dump(rec, f, indent=1)
    print(f"[dryrun] done; failures: {n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
