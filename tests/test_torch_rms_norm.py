"""The RMSNorm Function (``kernels/rms_norm``) on the CPU: its plain path
against the models' eager op chain, bit for bit, under ``torch.func``'s
transforms, and its checks.

On the CPU the Function runs the eager chain (forward) and
``torch.func.vjp`` of it (backward), so its numbers are the chain's: the
forward, dx and dw are compared with ``torch.equal``. Two exceptions,
both sums taken in another order: dw under ``vmap`` with x vmapped at dim
1 (the fold moves the calls first, then sums each call's rows), held to 2
f32 ulps of its largest entry; and a whole f32 model's gradients
(``test_model_loss_gradients_unchanged``), held to 16. The kernels
themselves run only on the card (``tests/test_torch_cuda.py``).
"""
import pytest
import torch
from torch._C._functorch import is_functorch_wrapped_tensor
from torch.func import grad, vjp, vmap

from repro_torch.configs import get_arch, smoke_variant
from repro_torch.kernels.rms_norm import kernel, ops, ref
from repro_torch.models import layers
from repro_torch.models.model import build_model
from repro_torch.utils.remat import remat, remat_scan
from repro_torch.utils.tree import tree_leaves, tree_map

DIMS = (64, 1600, 2048, 5120)
DTYPES = (torch.float32, torch.bfloat16)


def eager_rms_norm(x, weight, eps=1e-6):
    """The models' RMSNorm as eager ops: the chain the Function replaces."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


def _draw(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


def _value_and_vjp(fn, x, w, dy):
    y, pullback = vjp(fn, x, w)
    return (y,) + tuple(pullback(dy))


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


class _Counted:
    """Wraps the plain versions the Functions call: each call is counted,
    and a batched or grad-tracking tensor fails the test."""

    def __init__(self, monkeypatch):
        self.calls = {}
        self.args = {}
        for name in ("rms_norm_ref", "rms_norm_bwd_ref"):
            monkeypatch.setattr(ref, name, self._wrap(name, getattr(ref, name)))

    def _wrap(self, name, fn):
        def wrapped(*args, **kwargs):
            for t in args:
                if isinstance(t, torch.Tensor):
                    assert not is_functorch_wrapped_tensor(t), \
                        f"{name} received a wrapped tensor"
            self.calls[name] = self.calls.get(name, 0) + 1
            self.args.setdefault(name, []).append(args)
            return fn(*args, **kwargs)

        return wrapped

    def take(self):
        out, self.calls, self.args = self.calls, {}, {}
        return out


# ------------------------------------------------- the plain path, bit for bit


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("lead", [(1,), (7,), (3, 11)])
def test_function_equals_eager_chain(dtype, d, lead):
    """Forward, dx and dw equal the eager chain's at ragged row counts."""
    x = _draw(lead + (d,), dtype, 0)
    w = 0.1 * _draw((d,), torch.float32, 1)
    dy = _draw(lead + (d,), dtype, 2)
    _equal(_value_and_vjp(ops.rms_norm, x, w, dy),
           _value_and_vjp(eager_rms_norm, x, w, dy))
    y, rstd = ops.rms_norm_rstd(x, w)
    assert rstd.shape == lead and rstd.dtype == torch.float32
    _equal(ops.rms_norm_bwd(x, w, rstd, dy),
           _value_and_vjp(eager_rms_norm, x, w, dy)[1:])


def test_function_under_autograd():
    """Plain ``torch.autograd`` (no ``torch.func``) gets the same gradients."""
    x = _draw((4, 9, 64), torch.float32, 3).requires_grad_()
    w = (0.1 * _draw((64,), torch.float32, 4)).requires_grad_()
    dy = _draw((4, 9, 64), torch.float32, 5)
    ops.rms_norm(x, w).backward(dy)
    want = _value_and_vjp(eager_rms_norm, x.detach(), w.detach(), dy)
    _equal((x.grad, w.grad), want[1:])


# ---------------------------------------------------------------- under vmap


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [64, 1600])
@pytest.mark.parametrize("weight", ["per_call", "shared"])
@pytest.mark.parametrize("in_dim", [0, 1])
def test_vmap_equals_eager_chain(dtype, d, weight, in_dim):
    """vmap over 3 calls, each with its own (G = 3) or one shared weight,
    x vmapped at dim 0 or 1: y and dx bit for bit; dw per call."""
    calls = 3
    x = _draw((calls, 2, 5, d), dtype, 6).movedim(0, in_dim).contiguous()
    dy = _draw((calls, 2, 5, d), dtype, 7).movedim(0, in_dim).contiguous()
    ws = 0.1 * _draw((calls, d), torch.float32, 8)

    def run(fn):
        if weight == "per_call":
            return vmap(lambda a, b, c: _value_and_vjp(fn, a, b, c),
                        in_dims=(in_dim, 0, in_dim))(x, ws, dy)
        return vmap(lambda a, c: _value_and_vjp(fn, a, ws[0], c),
                    in_dims=(in_dim, in_dim))(x, dy)

    got, want = run(ops.rms_norm), run(eager_rms_norm)
    assert got[2].shape == (calls, d)
    if in_dim == 0:
        _equal(got, want)
        return
    _equal(got[:2], want[:2])
    # dw: the calls' rows summed in another order (module docstring)
    scale = float(want[2].abs().max())
    torch.testing.assert_close(got[2], want[2], rtol=0.0,
                               atol=2 * scale * torch.finfo(torch.float32).eps)


def test_vmap_makes_one_call_per_norm(monkeypatch):
    """vmap(grad) over 4 calls with per-call weights: one forward and one
    backward call of the plain versions for all 4, on plain tensors."""
    x = _draw((4, 3, 64), torch.bfloat16, 9)
    ws = 0.1 * _draw((4, 64), torch.float32, 10)
    counted = _Counted(monkeypatch)
    vmap(grad(lambda w, a: ops.rms_norm(a, w).float().square().sum()))(ws, x)
    assert counted.take() == {"rms_norm_ref": 1, "rms_norm_bwd_ref": 1}


def test_nested_vmap_folds_twice():
    """vmap over vmap (per-call weights at the inner level, shared at the
    outer) equals the eager chain; dw per inner and outer call."""
    x = _draw((2, 3, 4, 64), torch.float32, 11)
    dy = _draw((2, 3, 4, 64), torch.float32, 12)
    ws = 0.1 * _draw((3, 64), torch.float32, 13)

    def run(fn):
        inner = vmap(lambda a, b, c: _value_and_vjp(fn, a, b, c))
        return vmap(lambda a, c: inner(a, ws, c))(x, dy)

    got, want = run(ops.rms_norm), run(eager_rms_norm)
    assert got[2].shape == (2, 3, 64)
    _equal(got, want)


def test_fold_is_a_view(monkeypatch):
    """On a contiguous (C, b, S, d) input with per-call weights the vmap
    rule hands the plain version (and would hand the kernel) x and w
    themselves: no copy replaces the ops the Function removes. The kernel
    reads them, and the prefill's last position, at one row stride with no
    copy; rows at no single stride are the only ones it copies."""
    c, b, s, d = 4, 2, 8, 64
    x = _draw((c, b, s, d), torch.bfloat16, 14)
    ws = 0.1 * _draw((c, d), torch.float32, 15)
    counted = _Counted(monkeypatch)
    vmap(ops.rms_norm)(x, ws)
    (fx, fw, _), = counted.args["rms_norm_ref"]
    assert fx.data_ptr() == x.data_ptr() and fx.shape == x.shape
    assert fw.data_ptr() == ws.data_ptr() and fw.shape == (c, d)
    assert kernel.row_stride(fx) == d
    assert kernel.row_stride(x[:, :, -1:]) == s * d
    assert kernel.row_stride(x[:1, :1, :1]) == d
    assert kernel.row_stride(x.transpose(1, 2)) is None
    assert kernel.row_stride(x[..., ::2]) is None
    assert kernel.row_stride(x[0, 0].expand(3, s, d)) is None
    # the backward's inputs too: x as saved, dy as vmap hands it
    dy = _draw((c, b, s, d), torch.bfloat16, 16)
    vmap(lambda a, w, g: vjp(ops.rms_norm, a, w)[1](g))(x, ws, dy)
    (bx, bw, bdy, *_), = counted.args["rms_norm_bwd_ref"]
    assert bx.data_ptr() == x.data_ptr() and bw.data_ptr() == ws.data_ptr()
    assert bdy.data_ptr() == dy.data_ptr()


# -------------------------------------------------- remat and the model loss


@pytest.mark.parametrize("scan", [False, True])
def test_vmap_grad_through_remat(scan):
    """vmap(grad) of a stack of norms run through ``remat`` or
    ``remat_scan`` equals the same over the eager chain, bit for bit."""
    x = _draw((3, 2, 6, 64), torch.bfloat16, 17)
    ws = 0.1 * _draw((3, 4, 64), torch.float32, 18)

    def loss(fn):
        def layer(w, carry):
            (h,) = carry
            return (h + fn(h, w),)

        def f(w, a):
            if scan:
                (h,) = remat_scan(layer)([w[i] for i in range(4)], (a,))
            else:
                h = a
                for i in range(4):
                    (h,) = remat(lambda wi, hi: layer(wi, (hi,)))(w[i], h)
            return h.float().square().mean()

        return vmap(grad(f))(ws, x)

    _equal((loss(ops.rms_norm),), (loss(eager_rms_norm),))


@pytest.fixture(scope="module", params=["bfloat16", "float32"])
def hybrid(request):
    cfg = smoke_variant(get_arch("hymba-1.5b").model).replace(
        param_dtype=request.param, compute_dtype=request.param)
    model = build_model(cfg, "cpu")
    g = torch.Generator().manual_seed(0)
    params = model.init(g)
    # norm weights start at 0: move every leaf off its init
    params = tree_map(lambda p: p + (1e-2 * torch.randn(
        p.shape, generator=g)).to(p.dtype) if p.is_floating_point() else p,
        params)
    toks = torch.randint(0, cfg.vocab_size, (2, 2, 41), generator=g)
    return cfg, params, {"tokens": toks[..., :40], "labels": toks[..., 1:]}


@pytest.mark.parametrize("remat_block", [0, 2])
def test_model_loss_gradients_unchanged(hybrid, monkeypatch, remat_block):
    """vmap(grad(Model.loss)) of a small hybrid config over 2 clients, each
    with its own params: through the Function as through the eager chain;
    the plain versions run once per norm call for both clients, as often
    as in one client's grad.

    bf16: the same bits. f32: ``x.float()`` is x itself there, so the eager
    chain's two gradient terms of x joined the residual's one by one in
    autograd's order, where the Function adds its dx as one term: each leaf
    within 16 f32 ulps of its largest entry."""
    cfg, params, batch = hybrid
    model = build_model(cfg.replace(remat_block=remat_block), "cpu")
    stacked = tree_map(lambda p: torch.stack([p, p.flip(0) if p.dim() else p]),
                       params)
    loss_grad = grad(lambda p, b: model.loss(p, b)[0])
    counted = _Counted(monkeypatch)
    got = vmap(loss_grad)(stacked, batch)
    calls = counted.take()
    loss_grad(params, {k: v[0] for k, v in batch.items()})
    assert calls == counted.take()
    norms = 4 * cfg.num_layers + 1  # norm1, fuse_norm_a/s, norm2; final
    assert calls["rms_norm_ref"] >= norms
    monkeypatch.setattr(layers, "rms_norm_fn", eager_rms_norm)
    want = vmap(loss_grad)(stacked, batch)
    if cfg.compute_dtype == "bfloat16":
        _equal(tree_leaves(got), tree_leaves(want))
        return
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(
            g, w, rtol=0.0,
            atol=16 * float(w.abs().max()) * torch.finfo(torch.float32).eps)


def test_prefill_calls_each_norm_once(hybrid, monkeypatch):
    """``prefill_logits`` of L hybrid layers: 4 L + 1 norm calls (the last
    position's final norm), each on plain tensors. On the card these are
    the kernel's launches."""
    cfg, params, batch = hybrid
    counted = _Counted(monkeypatch)
    build_model(cfg, "cpu").prefill_logits(params,
                                           {"tokens": batch["tokens"][0]})
    assert counted.take() == {"rms_norm_ref": 4 * cfg.num_layers + 1}


# ------------------------------------------------------------ meta and checks


def test_meta_tensors_give_shapes_and_no_launch():
    ops.reset_launches()
    x = torch.empty((2, 5, 64), dtype=torch.bfloat16, device="meta")
    ws = torch.empty((3, 64), dtype=torch.float32, device="meta")
    y = ops.rms_norm(x, torch.empty((64,), device="meta"))
    assert y.shape == x.shape and y.dtype == x.dtype and y.is_meta
    xs = torch.empty((3, 2, 5, 64), dtype=torch.bfloat16, device="meta")
    dw = vmap(grad(lambda w, a: ops.rms_norm(a, w).float().sum()))(ws, xs)
    assert dw.shape == (3, 64) and dw.is_meta
    assert (ops.rms_norm.launches, ops.rms_norm_bwd.launches) == (0, 0)


@pytest.mark.parametrize("x_shape,x_dtype,w_shape,w_dtype,error", [
    ((4, 64), torch.float16, (64,), torch.float32, TypeError),
    ((4, 64), torch.float64, (64,), torch.float32, TypeError),
    ((4, 64), torch.bfloat16, (64,), torch.bfloat16, TypeError),
    ((4, 64), torch.float32, (32,), torch.float32, ValueError),
    ((4, 64), torch.float32, (3, 64), torch.float32, ValueError),
    ((4, 64), torch.float32, (2, 2, 64), torch.float32, ValueError),
    ((4, 0), torch.float32, (0,), torch.float32, ValueError),
    ((2, ops.MAX_D + 1), torch.float32, (ops.MAX_D + 1,), torch.float32,
     ValueError),
])
def test_bad_inputs_raise(x_shape, x_dtype, w_shape, w_dtype, error):
    x = torch.zeros(x_shape, dtype=x_dtype)
    w = torch.zeros(w_shape, dtype=w_dtype)
    with pytest.raises(error):
        ops.rms_norm(x, w)


def test_no_rows():
    """An input with no rows (a VLM's text positions when the sequence
    holds only patches) gives empty outputs and a zero dw."""
    x = torch.zeros((2, 0, 64))
    ws = torch.ones((2, 64))
    y, dx, dw = vmap(lambda a, w: _value_and_vjp(ops.rms_norm, a, w, a))(x, ws)
    assert y.shape == dx.shape == x.shape and torch.equal(dw, torch.zeros(2, 64))


def test_backward_checks_its_inputs():
    x = torch.zeros((4, 64))
    w = torch.zeros((64,))
    with pytest.raises(ValueError):
        ops.rms_norm_bwd(x, w, torch.zeros(4), torch.zeros((4, 64),
                                                           dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        ops.rms_norm_bwd(x, w, torch.zeros(3), torch.zeros((4, 64)))
    with pytest.raises(RuntimeError):  # not differentiable twice
        grad(lambda a: grad(lambda b: ops.rms_norm(b, w).sum())(a).sum())(x)


def test_functorch_private_api_is_there():
    """The norm takes torch.func's levels itself through functorch's private
    API (``utils/fold.py``); a torch release that renames a name of it fails
    here, naming the release and the name."""
    from repro_torch.utils import fold

    missing = fold.missing_functorch_names()
    assert not missing, (f"torch {torch.__version__} lacks functorch's "
                         f"private {', '.join(missing)}")
    with pytest.raises(NotImplementedError, match="vmap, grad and vjp"):
        torch.func.jvp(lambda a: ops.rms_norm(a, torch.zeros(8)),
                       (torch.ones(2, 8),), (torch.ones(2, 8),))
