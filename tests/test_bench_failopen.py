"""bench.py's fail-open measurement loop: the metric
must be emitted after warmup + the FIRST timed segment, every refinement
re-emits, and an expired deadline stops refinement but never suppresses
the first emission.  Pure-logic test: fake fn/inputs, no device."""

import importlib.util
import io
import json
import pathlib
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent


def _load_bench():
    spec = importlib.util.spec_from_file_location("bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _CollectMetrics:
    def __init__(self):
        self.records = []

    def emit(self, metric, value, unit="", **extra):
        self.records.append({"metric": metric, "value": value,
                             "unit": unit, **extra})


def _run(deadline_offset, max_segments=None):
    bench = _load_bench()
    if max_segments is not None:
        bench.MAX_SEGMENTS = max_segments
    m = _CollectMetrics()

    def fn(x, st):
        return x * 2.0, st

    def make_round(r):
        return [np.full(4, r, np.float32)]

    bench._deadline_segments(
        m, "fake_metric", fn, make_round, [None],
        samples_per_round=1_000_000, rounds_per_segment=1, floor=1.0,
        deadline=time.perf_counter() + deadline_offset)
    return m.records


def test_emits_after_first_segment_even_with_expired_deadline():
    # deadline already passed: exactly one emission (the provisional one),
    # never zero — the fail-open contract.
    recs = _run(deadline_offset=-100.0)
    assert len(recs) == 1
    assert recs[0]["segments_completed"] == 1
    assert recs[0]["quality"] == "provisional"
    assert recs[0]["value"] > 0


def test_refines_and_reemits_with_time_available():
    recs = _run(deadline_offset=300.0, max_segments=3)
    assert len(recs) == 3
    assert [r["segments_completed"] for r in recs] == [1, 2, 3]
    assert recs[0]["quality"] == "provisional"
    assert recs[-1]["quality"] == "final"
    # every record carries the raw per-segment values for variance audit
    assert len(recs[-1]["runs"]) == 3


def test_stress_mode_counts_missing_metrics():
    # main() returns the number of metrics that emitted nothing; with a
    # zero budget every child is killed before devices come up, so all 4
    # must be counted missing — and the process must not raise.
    bench = _load_bench()
    missing = bench.main({name: 3.0 for name in bench.ORDER})
    assert missing == len(bench.ORDER)
