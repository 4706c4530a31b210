"""Build (step_fn, argument shapes, specs) for every (arch x input shape x
mesh), and the coordinator-gated IO of the training loops (the JAX
package's ``launch/program.py``).

Program kinds (from ``ShapeConfig.kind``):
  train   -> one FL round: the replicated-client cohort step or the
             distributed-client streaming step (``ArchConfig.fl_mode``)
  prefill -> ``Model.prefill_logits`` over the full prompt
  decode  -> ``Model.decode_step``: ONE new token against a seq_len cache

``arg_sds`` are ``meta`` tensors of the arguments' shapes and dtypes (the
JAX package's ShapeDtypeStructs); ``in_shardings`` and ``out_shardings``
are trees of ``PartitionSpec`` (``sharding/specs.py``). Nothing is
allocated on a device here. ``launch/dryrun.py`` runs each step on its
``meta`` arguments; a step built for ``device="cuda"`` runs on the card on
real tensors of those shapes.

The port executes no tensor-parallel LM (nor does the JAX package's
training, which runs its step unsharded): on a shape-only mesh
(``launch/mesh.py::ShapeMesh``, the production mesh) the specs say how the
step would be split and the step is the global one
(``Program.step_mesh`` is None). A ``DeviceMesh`` of ranks is handed to
the cohort step, whose round substrate shards over it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import (
    INPUT_SHAPES,
    ArchConfig,
    FLConfig,
    ModelConfig,
    ShapeConfig,
)
from repro_torch.configs.registry import get_arch
from repro_torch.core.cohort import (
    init_cohort_state,
    init_dist_state,
    make_cohort_step,
    make_dist_step,
)
from repro_torch.launch.mesh import ShapeMesh, batch_axes_for
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import build_model
from repro_torch.sharding.specs import (
    P,
    batch_pspecs,
    cache_pspecs,
    cohort_state_pspecs,
    dist_state_pspecs,
    mesh_axis_size,
    param_pspecs,
)
from repro_torch.utils.device import DeviceLike
from repro_torch.utils.tree import tree_leaves, tree_map_with_path

# Dry-run FL hyper-parameters: M=2 local steps keeps the round FLOPs at
# 2x(fwd+bwd) per slot; K/arrivals chosen per cohort size at build time.
DRYRUN_FL = FLConfig(local_steps=2, local_lr=1e-2, weighting="paper")
PROBE_BATCH = 4


def _sds(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(int(n) for n in shape), dtype=dtype,
                       device="meta")


def _model_batch_sds(cfg: ModelConfig, lead: Tuple[int, ...], seq: int,
                     with_labels: bool = True) -> Dict[str, Any]:
    """Batch leaves with arbitrary leading dims + a seq dim."""
    emb_dtype = dtype_of(cfg.compute_dtype)
    text = seq
    batch: Dict[str, Any] = {}
    if cfg.num_patches:
        text = seq - cfg.num_patches
        batch["patches"] = _sds(lead + (cfg.num_patches, cfg.d_model), emb_dtype)
    if cfg.is_encdec:
        batch["frames"] = _sds(lead + (cfg.encoder_seq_len, cfg.d_model),
                               emb_dtype)
    batch["tokens"] = _sds(lead + (text,), torch.int32)
    if with_labels:
        batch["labels"] = _sds(lead + (text,), torch.int32)
    return batch


@dataclasses.dataclass
class Program:
    name: str
    kind: str
    step_fn: Callable
    arg_sds: Tuple[Any, ...]  # meta tensors, positional
    in_shardings: Tuple[Any, ...]  # PartitionSpec trees
    out_shardings: Any
    static_argnums: Tuple[int, ...] = ()
    donate_argnums: Tuple[int, ...] = ()
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # the mesh the step itself was built with: None is the global step
    step_mesh: Any = None


def resolve_model_cfg(arch: ArchConfig, shape_name: str) -> ModelConfig:
    """Apply per-shape variants (long_500k -> sliding-window for dense)."""
    cfg = arch.model
    if shape_name == "long_500k" and arch.long_context_window and not (
            cfg.attn_window or cfg.is_ssm_only):
        cfg = cfg.replace(attn_window=arch.long_context_window)
    return cfg


def build_program(arch_id: str, shape_name: str, mesh,
                  fl: Optional[FLConfig] = None,
                  model_overrides: Optional[Dict[str, Any]] = None, *,
                  shape: Optional[ShapeConfig] = None,
                  device: DeviceLike = "cuda") -> Program:
    """The Program of ``arch_id`` at input shape ``shape_name`` on ``mesh``.

    ``shape`` replaces the registry's ``INPUT_SHAPES[shape_name]`` (the
    card runs one data rank's share of the batch); its kind must match.
    ``device`` is where the step runs: ``"cuda"`` by default (raises
    without a card), ``"cpu"``, or ``"meta"`` for the dry run.
    """
    arch = get_arch(arch_id)
    shape = shape or INPUT_SHAPES[shape_name]
    if shape.kind != INPUT_SHAPES[shape_name].kind:
        raise ValueError(f"shape {shape} is not a {shape_name} shape")
    if shape_name in arch.skip_shapes:
        raise ValueError(f"{arch_id} skips {shape_name}: see DESIGN.md")
    cfg = resolve_model_cfg(arch, shape_name)
    if model_overrides:
        cfg = cfg.replace(**model_overrides)
    model = build_model(cfg, device)
    baxes = batch_axes_for(mesh)
    dp = int(np.prod([mesh_axis_size(mesh, a) for a in baxes]))
    fl = fl or DRYRUN_FL
    params_sds = model.init(None)
    meta = {"arch": arch_id, "shape": shape_name,
            "mesh": dict(zip(mesh.mesh_dim_names,
                             (int(n) for n in mesh.mesh.shape))),
            "params": int(sum(t.numel() for t in tree_leaves(params_sds))),
            "active_params": model.active_param_count(params_sds),
            "fl_mode": arch.fl_mode, "seq_len": shape.seq_len,
            "global_batch": shape.global_batch}

    if shape.kind == "train":
        if arch.fl_mode == "replicated":
            return _build_cohort_train(model, fl, shape, mesh, baxes, dp, meta,
                                       params_sds)
        return _build_dist_train(model, fl, shape, mesh, baxes, dp, meta,
                                 params_sds)
    if shape.kind == "prefill":
        return _build_prefill(model, shape, arch, mesh, baxes, dp, meta,
                              params_sds)
    return _build_decode(model, shape, arch, mesh, baxes, dp, meta,
                         params_sds)


def _axis(baxes):
    return baxes if len(baxes) > 1 else baxes[0]


# ---------------------------------------------------------------------------


def _build_cohort_train(model, fl, shape, mesh, baxes, dp, meta,
                        params_sds) -> Program:
    cfg = model.cfg
    cohort = dp  # one client slot per data-parallel group
    if shape.global_batch % cohort:
        raise ValueError(f"global batch {shape.global_batch} does not divide "
                         f"over {cohort} cohort slots")
    b = shape.global_batch // cohort
    m = fl.local_steps
    state_sds = init_cohort_state(params_sds, cohort)
    batch_sds = {
        "local": _model_batch_sds(cfg, (cohort, m, b), shape.seq_len),
        "probe": _model_batch_sds(cfg, (cohort, PROBE_BATCH), shape.seq_len),
        "arrival": _sds((cohort,), torch.float32),
        "data_sizes": _sds((cohort,), torch.float32),
    }
    state_specs = cohort_state_pspecs(state_sds, mesh, client_axes=baxes)
    batch_specs = batch_pspecs(batch_sds, batch_axes=baxes)
    # a mesh of ranks shards the round substrate (C-slot vmap over data,
    # flat-vector server pass over model); a shape-only mesh has no ranks
    step_mesh = None if isinstance(mesh, ShapeMesh) else mesh
    step = make_cohort_step(model.loss, fl, mesh=step_mesh,
                            device=model.device)
    metrics_specs = {"fresh_loss_mean": P(), "staleness_min": P(),
                     "weights_max": P(), "update_sq_norm": P()}
    meta.update(cohort=cohort, local_batch=b, local_steps=m)
    return Program(
        name=f"{meta['arch']}:{meta['shape']}", kind="train", step_fn=step,
        arg_sds=(state_sds, batch_sds),
        in_shardings=(state_specs, batch_specs),
        out_shardings=(state_specs, metrics_specs),
        donate_argnums=(0,), meta=meta, step_mesh=step_mesh)


def _build_dist_train(model, fl, shape, mesh, baxes, dp, meta,
                      params_sds) -> Program:
    cfg = model.cfg
    m = fl.local_steps
    # the buffer one short of full, so the step runs both the contribution
    # and the server apply (JAX's program holds both branches of its cond;
    # the port's branch is a host one on ``count``)
    state_sds = init_dist_state(params_sds, fl)._replace(
        count=fl.buffer_size - 1)
    batch_sds = {
        "local": _model_batch_sds(cfg, (m, shape.global_batch), shape.seq_len),
        "probe": _model_batch_sds(cfg, (fl.probe_batch * dp,), shape.seq_len),
        "tau": _sds((), torch.int32),
        "data_size": _sds((), torch.float32),
    }
    state_specs = dist_state_pspecs(state_sds, mesh)

    def bspec(_, t):
        n = len(t.shape)
        if n >= 2:  # (M, b, ...): shard b
            return P(None, _axis(baxes), *([None] * (n - 2)))
        return P()

    batch_specs = {
        "local": tree_map_with_path(bspec, batch_sds["local"]),
        "probe": batch_pspecs(batch_sds["probe"], batch_axes=baxes),
        "tau": P(), "data_size": P(),
    }
    step = make_dist_step(model.loss, fl, device=model.device)
    metrics_specs = {"fresh_loss": P(), "v_weight": P(), "buffered": P(),
                     "applied": P()}
    meta.update(cohort=1, local_batch=shape.global_batch, local_steps=m)
    return Program(
        name=f"{meta['arch']}:{meta['shape']}", kind="train", step_fn=step,
        arg_sds=(state_sds, batch_sds),
        in_shardings=(state_specs, batch_specs),
        out_shardings=(state_specs, metrics_specs),
        donate_argnums=(0,), meta=meta)


def make_io_hooks(*, ckpt_path: Optional[str] = None, ckpt_every: int = 0,
                  log_fn: Callable[[str], None] = print,
                  registry: Optional[Any] = None,
                  tracer: Optional[Any] = None,
                  sink: Optional[Any] = None):
    """Coordinator-gated IO for multi-process training loops, reporting into
    the observability plane.

    Returns ``(log, eval_metrics, maybe_save)``:

    * ``log(msg)`` emits only on process 0 (every process may call it);
      with a ``sink`` (``obs.JsonlSink`` / ``InMemorySink``) each message is
      also emitted as a structured ``{"event": "log", ...}`` record (the
      sink applies its own coordinator gate);
    * ``eval_metrics(metrics)`` fetches a dict of tensors to host floats
      (every process must call it: a sharded leaf is gathered, a
      collective), returning the dict everywhere so control flow stays the
      same on every process; the fetch is a ``host_sync`` span and every
      metric lands in a ``train_<name>`` registry gauge;
    * ``maybe_save(step, tree)`` writes ``ckpt_path`` every ``ckpt_every``
      steps through the coordinator-gated ``checkpoint.save_checkpoint``
      (again: call it on every process), timed as a ``checkpoint`` span
      and counted in the registry.
    """
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.obs.metrics import default_registry
    from repro_torch.obs.trace import NULL_TRACER, SPAN_CHECKPOINT, SPAN_HOST_SYNC
    from repro_torch.sharding.collectives import fetch_replicated, is_coordinator

    reg = registry if registry is not None else default_registry()
    tr = tracer if tracer is not None else NULL_TRACER
    syncs = reg.counter("train_host_syncs_total")
    ckpts = reg.counter("train_checkpoints_total")

    def log(msg: str) -> None:
        if sink is not None:
            sink.emit({"event": "log", "msg": msg})
        if is_coordinator():
            log_fn(msg)

    def eval_metrics(metrics: Any) -> Dict[str, float]:
        with tr.span(SPAN_HOST_SYNC, what="eval_metrics"):
            syncs.inc()
            host = fetch_replicated(metrics)
        out = {k: float(np.asarray(v)) for k, v in host.items()}
        for k, v in out.items():
            reg.gauge(f"train_{k}").set(v)
        return out

    def maybe_save(step: int, tree: Any) -> bool:
        if not ckpt_path or not ckpt_every or step % ckpt_every:
            return False
        with tr.span(SPAN_CHECKPOINT, step=step):
            ckpts.inc()
            save_checkpoint(ckpt_path, tree, step=step)
        return True

    return log, eval_metrics, maybe_save


def _build_prefill(model, shape, arch, mesh, baxes, dp, meta,
                   params_sds) -> Program:
    cfg = model.cfg
    fsdp = arch.fl_mode == "distributed"
    batch_sds = _model_batch_sds(cfg, (shape.global_batch,), shape.seq_len,
                                 with_labels=False)
    pspecs = param_pspecs(params_sds, mesh, fsdp=fsdp)
    bspecs = batch_pspecs(batch_sds, batch_axes=baxes)

    def step(params, batch):
        return model.prefill_logits(params, batch)

    return Program(
        name=f"{meta['arch']}:{meta['shape']}", kind="prefill", step_fn=step,
        arg_sds=(params_sds, batch_sds),
        in_shardings=(pspecs, bspecs),
        out_shardings=None, meta=meta)


def _build_decode(model, shape, arch, mesh, baxes, dp, meta,
                  params_sds) -> Program:
    cfg = model.cfg
    fsdp = arch.fl_mode == "distributed"
    b = shape.global_batch
    cache_sds = build_model(cfg, "meta").init_cache(b, shape.seq_len)
    tok_sds = _sds((b, 1), torch.int32)
    pspecs = param_pspecs(params_sds, mesh, fsdp=fsdp)
    cspecs = cache_pspecs(cache_sds, mesh, batch_axes=baxes)
    if b % dp == 0:
        tok_spec = P(_axis(baxes), None)
    else:
        tok_spec = P(None, None)  # e.g. long_500k: batch=1 cannot shard
    last = shape.seq_len - 1

    def step(params, cache, tokens, pos):
        """``pos``: an int or an integer 0-d tensor, read on the host; a
        ``meta`` one holds no value and stands for the context's last
        position (the decode's shapes do not depend on it)."""
        if isinstance(pos, torch.Tensor):
            pos = last if pos.device.type == "meta" else int(pos)
        return model.decode_step(params, cache, tokens, pos)

    meta.update(cache_len=min(shape.seq_len, cfg.attn_window or shape.seq_len))
    return Program(
        name=f"{meta['arch']}:{meta['shape']}", kind="decode", step_fn=step,
        arg_sds=(params_sds, cache_sds, tok_sds, _sds((), torch.int32)),
        in_shardings=(pspecs, cspecs, tok_spec, P()),
        out_shardings=None, donate_argnums=(1,), meta=meta)
