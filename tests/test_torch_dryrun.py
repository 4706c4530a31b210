"""The port's dry run (``launch/dryrun.py``) and the meta rule of K5 and K6.

* On ``meta`` tensors K5's and K6's wrappers, forward and backward, return
  empty meta outputs of the plain versions' shapes and dtypes (held
  against the plain versions on small CPU tensors), directly, under
  ``torch.func.grad`` and under ``vmap``; no launch is counted.
* A one-layer full-width Hymba-1.5B prefill at S 4096 runs on meta in
  under 2 s (the plain scan walked S steps in Python: 11.2 s).
* The dry-run records of hymba-1.5b and qwen1.5-110b x four shapes on the
  single-pod mesh, as ``python -m repro_torch.launch.dryrun`` writes them,
  are ``ok``; whisper-tiny's long_500k and every LeNet shape are skipped,
  as the JAX package's ``skip_shapes`` say.
* The per-rank argument bytes equal a sum over the leaves' local shapes,
  and K5's FLOPs equal 4 D x visible pairs x heads x B x layers, both
  computed here apart from the dry run's code.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.func import grad, vmap

from repro.configs import get_arch as j_get_arch
from repro_torch.configs import get_arch
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.kernels.ssm_scan import ops as ss_ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.program import build_program
from repro_torch.models import Model
from repro_torch.sharding.specs import PartitionSpec, mesh_axis_size

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("hymba-1.5b", "qwen1.5-110b")


def _meta(t):
    return torch.empty_like(t, device="meta")


def _sig(ts):
    return [(tuple(t.shape), t.dtype) for t in ts]


def _launches():
    return (fa_ops.flash_attention.launches,
            fa_ops.flash_attention_bwd.launches,
            ss_ops.selective_scan.launches, ss_ops.selective_scan_bwd.launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_on_meta_has_the_plain_shapes(dtype):
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(2, 24, n, 32, generator=g).to(dtype)
                   for n in (4, 2, 2, 4))
    before = _launches()
    o, lse = fa_ops.flash_attention_lse(q, k, v, window=8)
    mo, mlse = fa_ops.flash_attention_lse(*map(_meta, (q, k, v)), window=8)
    assert _sig((mo, mlse)) == _sig((o, lse))
    assert mo.device.type == mlse.device.type == "meta"
    grads = fa_ops.flash_attention_bwd(q, k, v, o, do, lse, window=8)
    mgrads = fa_ops.flash_attention_bwd(*map(_meta, (q, k, v, o, do, lse)),
                                        window=8)
    assert _sig(mgrads) == _sig(grads)

    def loss(q, k, v):
        return fa_ops.flash_attention(q, k, v, window=8).float().sum()

    vq, vk, vv = (torch.stack([t, t]) for t in (q, k, v))
    want = vmap(grad(loss, argnums=(0, 1, 2)))(vq, vk, vv)
    got = vmap(grad(loss, argnums=(0, 1, 2)))(*map(_meta, (vq, vk, vv)))
    assert _sig(got) == _sig(want)
    assert all(t.device.type == "meta" for t in got)
    assert _launches() == before


def test_k6_on_meta_has_the_plain_shapes():
    g = torch.Generator().manual_seed(1)
    x, dt, dy = (torch.randn(2, 12, 8, generator=g) for _ in range(3))
    b, c = (torch.randn(2, 12, 4, generator=g) for _ in range(2))
    for a in (-torch.rand(8, 4, generator=g),
              -torch.rand(2, 8, 4, generator=g)):
        before = _launches()
        y = ss_ops.selective_scan(x, dt, b, c, a)
        my = ss_ops.selective_scan(*map(_meta, (x, dt, b, c, a)))
        assert _sig([my]) == _sig([y]) and my.device.type == "meta"
        grads = ss_ops.selective_scan_bwd(x, dt, b, c, a, dy)
        mgrads = ss_ops.selective_scan_bwd(*map(_meta, (x, dt, b, c, a, dy)))
        assert _sig(mgrads) == _sig(grads)

        def loss(x, dt, b, c, a):
            return ss_ops.selective_scan(x, dt, b, c, a).sum()

        args = [torch.stack([t, t]) for t in (x, dt, b, c, a)]
        want = vmap(grad(loss, argnums=(0, 1, 2, 3, 4)))(*args)
        got = vmap(grad(loss, argnums=(0, 1, 2, 3, 4)))(*map(_meta, args))
        assert _sig(got) == _sig(want)
        assert _launches() == before


def test_full_width_hymba_layer_prefill_traces_fast_on_meta():
    cfg = get_arch("hymba-1.5b").model.replace(num_layers=1)
    model = Model(cfg, "meta")
    params = model.init(None)
    tokens = torch.empty((2, 4096), dtype=torch.int32, device="meta")
    model.prefill_logits(params, {"tokens": tokens[:, :64]})  # warm-up
    t0 = time.perf_counter()
    out = model.prefill_logits(params, {"tokens": tokens})
    seconds = time.perf_counter() - t0
    assert out.shape == (2, 1, cfg.vocab_size) and out.device.type == "meta"
    assert seconds < 2.0, seconds


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The CLI's records of ``ARCHS`` x four shapes on the single-pod mesh,
    one process an arch, both at once."""
    out = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--mesh", "single", "--out", str(out), "--tag", "t"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for arch in ARCHS]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    names = sorted(f.name for f in out.glob("*.json"))
    assert names == sorted(f"{a}_{s}_single_t.json" for a in ARCHS
                           for s in INPUT_SHAPES)
    return {(a, s): json.loads((out / f"{a}_{s}_single_t.json").read_text())
            for a in ARCHS for s in INPUT_SHAPES}


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_records_are_ok(records, arch, shape):
    rec = records[(arch, shape)]
    assert rec["ok"] and "error" not in rec and not rec.get("skipped"), \
        rec.get("trace")
    assert rec["mesh"] == "16x16" and rec["meta"]["shape"] == shape
    assert rec["flops"] > 0 and rec["trace_s"] >= 0
    assert rec["flops_per_device"] == rec["flops"] / 256
    assert rec["flops_counted"] == "matmul+K5 formula, global"
    assert rec["collective_bytes"] is None and rec["collective_bytes_reason"]
    mem = rec["memory"]
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "alias_size_in_bytes"}
    assert mem["argument_size_in_bytes"] > 0
    assert mem["output_size_in_bytes"] > 0
    kind = INPUT_SHAPES[shape].kind
    assert (mem["alias_size_in_bytes"] > 0) == (kind in ("train", "decode"))
    assert rec["output_size_basis"].startswith(
        "per rank" if kind == "train" else "global")
    assert rec["model_overrides"] == {}


@pytest.mark.parametrize("arch,shape", [("whisper-tiny", "long_500k")] + [
    ("lenet", s) for s in INPUT_SHAPES])
def test_dry_run_skips_as_jax(arch, shape):
    assert shape in j_get_arch(arch).skip_shapes
    rec = dryrun.run_one(arch, shape, False, verbose=False)
    assert rec["ok"] and rec["skipped"] and "reason" in rec


def _local_bytes(tree, spec, mesh):
    if isinstance(spec, PartitionSpec):
        if not isinstance(tree, torch.Tensor):
            return 0
        shape = list(tree.shape)
        for dim, entry in enumerate(spec):
            shape[dim] //= mesh_axis_size(mesh, entry)
        n = 1
        for s in shape:
            n *= s
        return n * tree.element_size()
    if isinstance(tree, dict):
        return sum(_local_bytes(tree[k], spec[k], mesh) for k in tree)
    return sum(_local_bytes(t, s, mesh) for t, s in zip(tree, spec))


@pytest.mark.parametrize("arch,shape", [("qwen1.5-110b", "train_4k"),
                                        ("qwen1.5-110b", "decode_32k"),
                                        ("hymba-1.5b", "train_4k")])
def test_argument_bytes_are_the_local_shapes(records, arch, shape):
    prog = build_program(arch, shape, make_production_mesh(), device="meta")
    mesh = make_production_mesh()
    want = sum(_local_bytes(a, s, mesh)
               for a, s in zip(prog.arg_sds, prog.in_shardings))
    mem = records[(arch, shape)]["memory"]
    assert mem["argument_size_in_bytes"] == want
    donated = sum(_local_bytes(prog.arg_sds[i], prog.in_shardings[i], mesh)
                  for i in prog.donate_argnums)
    assert mem["alias_size_in_bytes"] == donated


def test_k5_flops_are_the_band_formula(records):
    cfg = get_arch("hymba-1.5b").model
    shape = INPUT_SHAPES["prefill_32k"]
    s, w, d = shape.seq_len, cfg.attn_window, cfg.resolved_head_dim
    pairs = w * (w + 1) // 2 + (s - w) * w  # causal band of width w
    want = 4 * d * pairs * cfg.num_heads * shape.global_batch * cfg.num_layers
    assert records[("hymba-1.5b", "prefill_32k")]["flops_k5"] == want
    assert dryrun.visible_pairs(s, True, 0) == s * (s + 1) // 2
    assert dryrun.visible_pairs(7, False, 0) == 49
    assert dryrun.visible_pairs(7, False, 3) == sum(
        7 - max(0, i - 2) for i in range(7))
