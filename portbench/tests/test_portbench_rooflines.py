"""The operation and byte counts reproduce PERF.md §6's bound column, and
the model FLOP counts the issue's figures."""
from __future__ import annotations

import pytest

from portbench.flops import lm as lm_flops
from portbench.harness.bench import load_json
from portbench.harness.peaks import flops_peak, hbm_rate
from portbench.rooflines import bound_s
from portbench.rooflines import kernels as rk

CARD = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("work, ms", [
    (rk.k1(16_777_219, 16, 16), 0.6811),
    (rk.k5_bwd(4, 2048, 25, 5, 64, 1024), 0.1018),
    (rk.k6_bwd(4, 2048, 3200, 16, a_rows=4), 0.1576),
    (rk.k5_fwd(2, 4096, 25, 5, 64, 1024), 0.0475),
    (rk.k6_fwd(2, 4096, 3200, 16), 0.0943),
    (rk.k5_bwd(2, 4096, 25, 5, 64, 0), 0.2715),
])
def test_bounds_match_perf_md(work, ms):
    assert round(bound_s(work, CARD) * 1e3, 4) == ms


def test_visible_pairs():
    assert rk.visible_pairs(4, 0) == 10
    assert rk.visible_pairs(4, 2) == 1 + 2 + 2 + 2
    assert rk.visible_pairs(3, 8) == 6


def test_peaks_by_card_name():
    assert hbm_rate(CARD) == 3.35e12
    assert hbm_rate("NVIDIA H100 NVL") == 3.9e12
    assert flops_peak(CARD, "bfloat16") == 989e12
    with pytest.raises(ValueError):
        hbm_rate("NVIDIA A100-SXM4-80GB")


def test_model_flops_of_the_cells():
    from portbench.harness.bench import ROOT

    hymba = load_json(ROOT / "portbench/configs/hymba-1.5b.json")
    moe = load_json(ROOT / "portbench/configs/deepseek-moe-16b.json")
    mix = load_json(ROOT / "portbench/mixes/cohort-c4-k3-s2048.json")
    # ~4.5e13 a round at 6 layers (the issue's figure)
    assert 4.4e13 < lm_flops.train_round(hymba, 6, mix) < 4.8e13
    pre = load_json(ROOT / "portbench/mixes/prefill-b2-s32k.json")
    assert 2.1e14 < lm_flops.prefill_request(hymba, 32, pre) < 2.3e14
    # the MoE counts the 6 routed experts a token reaches, not all 64
    d, f = 2048, 1408
    assert lm_flops.layer_weights(moe) == 4 * d * d + d * 64 + 3 * d * f * 8
