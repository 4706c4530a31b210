"""The cohort round's memory repair changes no number.

The flat vectors are written leaf by leaf into one f32 buffer instead of
``cat`` + ``F.pad`` over per-leaf f32 copies; the cohort body takes the
slots' pulled bases as a tree and flattens them (and x) after the local
training. Every check here is exact (``torch.equal``): the repair moves
where a value is made, never how. Also the allocator-trace replay of
``launch/round_memory.py`` and the launcher's fit check, on the CPU.
"""
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_arch
from repro_torch.configs.base import FLConfig
from repro_torch.core.round_body import make_round_body, round_bytes
from repro_torch.core.server_pass import (
    flatten_stacked,
    flatten_stacked_sub,
    flatten_tree,
    make_flat_spec,
)
from repro_torch.launch import round_memory
from repro_torch.launch.train import check_fits
from repro_torch.models.model import build_model
from repro_torch.utils.tree import tree_leaves, tree_map, tree_sub


def _tree(dtype_b, k=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    lead = () if k is None else (k,)

    def t(*shape, dtype=torch.float32):
        return torch.randn(lead + shape, generator=g).to(dtype)

    return {"a": {"w": t(3, 5), "b": t(5, dtype=dtype_b)},
            "c": t(7, 2, dtype=dtype_b), "d": t(1)}


def _old_flat(spec, tree, k=None):
    """The layout before the repair: per-leaf f32 copies, cat, pad."""
    if k is None:
        flat = torch.cat([x.to(torch.float32).reshape(-1)
                          for x in tree_leaves(tree)])
    else:
        flat = torch.cat([x.to(torch.float32).reshape(k, -1)
                          for x in tree_leaves(tree)], dim=1)
    return F.pad(flat, (0, spec.n_padded - spec.n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_n", [0, 64, 1000])
def test_flatten_matches_cat_pad_layout(dtype, block_n):
    """f32 and bf16 leaves, padded to n_padded (0: the default tile)."""
    params = _tree(dtype)
    spec = make_flat_spec(params, block_n)
    assert spec.n_padded > spec.n
    assert torch.equal(flatten_tree(spec, params), _old_flat(spec, params))
    a, b = _tree(dtype, k=3, seed=1), _tree(dtype, k=3, seed=2)
    assert torch.equal(flatten_stacked(spec, a), _old_flat(spec, a, 3))
    assert torch.equal(flatten_stacked_sub(spec, a, b),
                       _old_flat(spec, tree_sub(a, b), 3))


def _bf16_loss(params, batch):
    x, y = batch
    h = torch.tanh(x.to(torch.bfloat16) @ params["w1"]) @ params["w2"]
    return torch.mean((h.float() - y) ** 2), {}


@pytest.mark.parametrize("arrival", [[1.0, 1.0, 1.0], [1.0, 0.0, 1.0]])
def test_cohort_body_with_base_tree_equals_flat_bases(arrival):
    """The cohort shape of the round body, bf16 params: bases as a tree
    and x made inside (the cohort step's call) against the flat bases and
    x made before (the call before the repair): the same bits."""
    g = torch.Generator().manual_seed(0)
    k = 3
    params = {"w1": torch.randn(6, 9, generator=g).to(torch.bfloat16),
              "w2": torch.randn(9, 2, generator=g).to(torch.bfloat16)}
    bases = tree_map(lambda p: (p[None] + 0.1 * torch.randn(
        (k,) + p.shape, generator=g)).to(p.dtype), params)
    client = tree_map(lambda p: (p + 0.05 * torch.randn(
        p.shape, generator=g)).to(p.dtype), bases)
    fl = FLConfig(buffer_size=k, local_steps=2, local_lr=0.05)
    spec = make_flat_spec(params)
    body = make_round_body(_bf16_loss, fl, "cpu", spec)
    local = (torch.randn(k, 2, 4, 6, generator=g),
             torch.randn(k, 2, 4, 2, generator=g))
    probe = (torch.randn(k, 4, 6, generator=g),
             torch.randn(k, 4, 2, generator=g))
    sizes, taus = torch.linspace(10.0, 30.0, k), torch.arange(3.0)
    mask = torch.tensor(arrival)
    old = body(params, flatten_tree(spec, params),
               flatten_stacked(spec, bases), local, probe, sizes, taus,
               client_params=client, arrival_mask=mask)
    new = body(params, None, bases, local, probe, sizes, taus,
               client_params=client, arrival_mask=mask)
    for i in range(2):  # the new params, the slots' end params
        for a, b in zip(tree_leaves(old[i]), tree_leaves(new[i])):
            assert torch.equal(a, b)
    for key in old[2]:
        assert torch.equal(old[2][key], new[2][key]), key


def test_live_at_peak_replays_a_trace():
    """Blocks from before the trace count under the state; the peak's live
    set is kept by site and block size."""
    frames = [{"filename": "/x/src/repro_torch/core/a.py", "line": 3,
               "name": "f"}]
    events = [{"action": "alloc", "addr": 1, "size": 10, "frames": frames},
              {"action": "free_requested", "addr": 99, "size": 4},
              {"action": "alloc", "addr": 2, "size": 5, "frames": []},
              {"action": "alloc", "addr": 3, "size": 10, "frames": frames},
              {"action": "free_requested", "addr": 1, "size": 10},
              {"action": "free_completed", "addr": 1, "size": 10},
              {"action": "alloc", "addr": 4, "size": 2, "frames": frames}]
    peak, sites, blocks = round_memory.live_at_peak(events, 100)
    assert peak == 121
    assert sites == {round_memory.STATE: 96,
                     "repro_torch/core/a.py:3 (f)": 20,
                     round_memory.OTHER: 5}
    assert blocks["repro_torch/core/a.py:3 (f)"] == {10: 2}


def test_round_bytes_and_the_fit_check():
    """14 + 14 C bytes a bf16 parameter; one full-width layer of
    qwen1.5-110b (3.9 B params) or arctic-480b (13.4 B) does not fit an 80
    GiB card at C = 2, one of deepseek-moe-16b does; the error names the
    config and is never a quiet cut."""
    card = 80 * 2**30
    for arch, fits in (("deepseek-moe-16b", True), ("qwen1.5-110b", False),
                       ("arctic-480b", False)):
        cfg = get_arch(arch).model.replace(num_layers=1)
        meta = build_model(cfg, "cpu").init(None)
        n = sum(leaf.numel() for leaf in tree_leaves(meta))
        assert n * 42 <= round_bytes(meta, 2) <= n * 42 * 1.01  # a few f32
        if fits:
            check_fits(cfg, meta, 2, card)
        else:
            with pytest.raises(RuntimeError, match=arch):
                check_fits(cfg, meta, 2, card)
    bf16 = {"w": torch.empty(4, dtype=torch.bfloat16)}
    assert round_bytes(bf16, 2) == 4 * (14 + 14 * 2)
    assert round_bytes({"w": torch.empty(4)}, 3) == 4 * (16 + 20 * 3)
