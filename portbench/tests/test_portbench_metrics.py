"""Each per-layer metric's reader on a canned profiler capture, and the
reduction of a capture's events (busy union, idle gaps named by the host
operation that covers them)."""
from __future__ import annotations

import pytest

from portbench.harness.bench import HERE, benchmark, load_module
from portbench.harness.trace import Capture, reduce_events

MS = 1e-3


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py", "m_" + name.replace(".", "_"))


def canned():
    ops = {
        "void (anonymous namespace)::fused_server_kernel<true>(float)": (2, 20 * MS),
        "void (anonymous namespace)::fa_bwd_dq_sm90<64>(x)": (10, 30 * MS),
        "void (anonymous namespace)::fa_bwd_dkdv_sm90<64, 3>(x)": (10, 50 * MS),
        "void (anonymous namespace)::ss_bwd_kernel<16>(x)": (10, 100 * MS),
        "void (anonymous namespace)::flash_fwd_sm90<64>(x)": (20, 40 * MS),
        "void (anonymous namespace)::selective_scan_kernel<16>(x)": (20, 60 * MS),
        "void at::native::vectorized_elementwise_kernel<8, add>(x)": (500, 200 * MS),
        "Memcpy DtoD (Device -> Device)": (4, 10 * MS),
        "nvjet_tst_320x128_64x3": (100, 300 * MS),
    }
    cap = Capture(ops, busy_s=0.8, window_s=1.0, gaps={"aten::empty": 0.1},
                  units=2)
    return {"capture": cap, "units": 2, "unit_wall_s": 0.5,
            "host_enqueue_s": [0.4, 0.6], "flops_per_unit": 1e14,
            "peak_flops": 1e15,
            "kernel_bounds": {"k1": 5 * MS, "k5_bwd": 8 * MS, "k6_bwd": 10 * MS,
                              "k5_fwd": 4 * MS, "k6_fwd": 6 * MS}}


EXPECTED = {
    "host_enqueue_ms.train": 500.0,
    "train_mfu": 20.0,
    "prefill_mfu": 20.0,
    "elementwise_ms.train": 105.0,  # (200 + 10) ms over 2 rounds
    "k1_roofline.train": 50.0,  # 5 ms x 2 / 20 ms
    "k5_bwd_roofline.train": 20.0,  # 8 x 2 / (30 + 50)
    "k6_bwd_roofline.train": 20.0,
    "k5_fwd_roofline.prefill": 20.0,
    "k6_fwd_roofline.prefill": 20.0,
    "device_idle_share.train": 20.0,
    "device_idle_share.prefill": 20.0,
}


def test_every_benchmark_metric_has_a_reader_and_a_case():
    names = {m["name"] for m in benchmark()["per_layer"]}
    assert names == set(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_canned_capture(name):
    assert reader(name).read(canned()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_with_nothing_to_read_returns_nothing(name):
    facts = {"capture": Capture({}, 0.0, 0.0, {}, 0), "units": 0,
             "host_enqueue_s": [], "unit_wall_s": None, "kernel_bounds": {},
             "flops_per_unit": 1.0, "peak_flops": 1.0}
    assert reader(name).read(facts) is None


def test_reduce_events_unions_the_device_and_names_gaps():
    device = [("k1", 0.0, 10.0), ("k2", 5.0, 20.0), ("k1", 30.0, 40.0),
              ("k3", 50.0, 55.0)]
    host = [("step", 0.0, 60.0), ("aten::empty", 21.0, 29.0),
            ("cudaLaunchKernel", 44.0, 46.0)]
    cap = reduce_events(device, host, window_s=60e-6, units=1)
    assert cap.busy_s == pytest.approx(35e-6)
    assert cap.ops["k1"] == (2, pytest.approx(20e-6))
    assert cap.gaps == {"aten::empty": pytest.approx(10e-6),
                        "cudaLaunchKernel": pytest.approx(10e-6)}
    b = cap.breakdown()
    assert b["device_ops"][0][0] == "k1"
    assert len(b["idle_gaps"]) == 2
