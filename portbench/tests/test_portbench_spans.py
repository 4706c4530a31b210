"""``harness/spans.py``: the idle gaps between merged device intervals put
down to the program's spans on hand-made intervals, and the readers of its
facts (None where there is nothing to read)."""
from __future__ import annotations

import pytest

from portbench.harness import spans


def test_merge_joins_overlapping_and_touching_intervals():
    assert spans.merge([(5, 7), (0, 2), (1, 3), (3, 4), (9, 9)]) == [
        [0, 4], [5, 7], [9, 9]]


def test_idle_goes_to_the_spans_covering_each_gap_middle():
    device = [(0, 10), (30, 40), (35, 50), (80, 90), (200, 210)]
    # gaps: 10-30 (middle 20), 50-80 (65), 90-200 (145)
    host = [("cohort_step", 0, 140), ("local_train", 5, 70),
            ("local_forward", 15, 25), ("local_forward", 60, 68),
            ("probe", 70, 100)]
    got = spans.attribute_idle(device, host)
    assert got["idle_ns"] == 20 + 30 + 110
    assert got["inside"] == {"cohort_step": 50, "local_train": 50,
                             "local_forward": 50}
    assert got["innermost"] == {"local_forward": 50, spans.NO_SPAN: 110}


def test_a_gap_counts_once_for_a_name_and_a_long_span_is_found():
    device = [(0, 1), (1000, 1001)]  # one gap, middle 500.5
    host = [("server_pass", 0, 2000), ("server_pass", 400, 600),
            ("resync", 2000, 2100)]
    got = spans.attribute_idle(device, host)
    assert got["inside"] == {"server_pass": 999}
    assert got["innermost"] == {"server_pass": 999}
    assert spans.attribute_idle([(0, 1)], host) == {
        "idle_ns": 0, "inside": {}, "innermost": {}}


FACTS = {"spans": {"rounds": 2,
                   "host_ns": {"local_train": 3_000_000, "probe": 1_000_000},
                   "device_ms": {"moe_dispatch": 1.5, "moe_combine": 2.5},
                   "idle_ns": 4_000_000,
                   "inside": {"local_train": 3_000_000},
                   "innermost": {"local_forward": 3_000_000,
                                 spans.NO_SPAN: 1_000_000}}}


@pytest.mark.parametrize("read,want", [
    (lambda f: spans.host_ms(f, "local_train"), 1.5),
    (lambda f: spans.host_ms(f, "probe"), 0.5),
    (lambda f: spans.host_ms(f, "server_pass"), None),
    (lambda f: spans.device_ms(f, "moe_dispatch", "moe_combine"), 2.0),
    (lambda f: spans.device_ms(f, "server_pass"), None),
    (lambda f: spans.idle_ms(f, "local_train"), 1.5),
    (lambda f: spans.idle_ms(f, "probe"), 0.0),
])
def test_readers(read, want):
    assert read(FACTS) == want
    assert read({}) is None and read({"spans": None}) is None
