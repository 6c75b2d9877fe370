"""The benchmark's own arithmetic: the generator, the device's busy time
as a union of intervals, the bounds."""
from pathlib import Path
import sys

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.lib import bounds, gen, stats, trace  # noqa: E402

POINTS = {"points": "uniform_unit_square", "masses": "dirichlet1"}
CLOSED = {"batch": 2, "pool": 3, "sizes": {"law": "fixed", "m": 40, "n": 50}}
FIXED = dict(CLOSED, pool=6, set_seed=11)


def _flat(calls):
    out = []
    for c in calls:
        for i in c.instances:
            out += [i.x, i.y, i.nu, i.mu]
    return out


@pytest.mark.parametrize("params", [CLOSED, FIXED], ids=["pool", "fixed"])
@pytest.mark.parametrize("seed", [0, 2**31 + 7, 3_000_000_000_123, -5])
def test_the_generator_is_deterministic_for_a_seed(params, seed):
    a = gen.make_calls(POINTS, params, seed)
    b = gen.make_calls(POINTS, params, seed)
    for u, v in zip(_flat(a), _flat(b)):
        np.testing.assert_array_equal(u, v)
    other = gen.make_calls(POINTS, params, seed + 1)
    assert not all(np.array_equal(u.instances[0].x, v.instances[0].x)
                   for u, v in zip(a, other))


def test_instances_have_the_configured_law():
    inst = gen.make_calls(POINTS, CLOSED, 7)[0].instances[0]
    assert inst.x.shape == (40, 2) and inst.y.shape == (50, 2)
    assert inst.x.dtype == np.float32 and 0 <= inst.x.min() < inst.x.max() < 1
    assert abs(float(inst.nu.sum()) - 1) < 1e-5 and inst.mu.min() > 0
    plain = gen.make_calls({"points": "uniform_unit_square"}, CLOSED, 7)
    assert plain[0].instances[0].nu is None
    with pytest.raises(ModuleNotFoundError):
        gen.make_calls({"points": "no_such_law"}, CLOSED, 7)


def test_a_fixed_pool_is_the_same_for_every_seed_in_another_order():
    runs = [gen.make_calls(POINTS, FIXED, s) for s in (1, 2, 3)]
    keys = [[c.instances[0].x.tobytes() for c in r] for r in runs]
    assert sorted(keys[0]) == sorted(keys[1]) == sorted(keys[2])
    assert keys[0] != keys[1] or keys[0] != keys[2]
    again = gen.make_calls(POINTS, FIXED, 2)
    assert [c.instances[0].x.tobytes() for c in again] == keys[1]


def test_the_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    assert stats.spread([9, 10, 10, 11, 12, 10]) == pytest.approx(
        (11.25 - 9.75) / 10)


def test_busy_time_is_the_union_of_intervals():
    iv = [(0.0, 1.0), (0.5, 1.5), (2.0, 3.0), (2.2, 2.4), (9.0, 12.0)]
    assert trace.union_seconds(iv, 0.0, 10.0) == pytest.approx(3.5)
    # clipped to the window
    assert trace.union_seconds(iv, 1.0, 2.5) == pytest.approx(1.0)
    assert trace.idle_gaps(iv, 0.0, 10.0) == [(1.5, 2.0), (3.0, 9.0)]


class _Ev:
    def __init__(self, name, dev, s, d):
        self._n, self._dev, self._s, self._d = name, dev, s, d

    def name(self):
        return self._n

    def activity_type(self):
        return "gpu_user_annotation" if "portbench" in self._n else "kernel"

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


def test_a_trace_summary_counts_overlap_once_and_charges_gaps():
    ms = 1_000_000
    evs = [_Ev(trace.WINDOW_SPAN, False, 0, 100 * ms),
           _Ev(trace.WINDOW_SPAN, True, 0, 100 * ms),     # its device mirror
           _Ev(trace.CALL_SPAN, True, 5 * ms, 50 * ms),
           _Ev("k1", True, 10 * ms, 20 * ms), _Ev("k2", True, 20 * ms, 20 * ms),
           _Ev("MemcpyDtoH", True, 60 * ms, 5 * ms),
           _Ev("aten::nonzero", False, 40 * ms, 20 * ms),
           _Ev("k3", True, 200 * ms, 5 * ms)]          # outside the window
    t = trace.summarize(evs)
    assert t.window_s == pytest.approx(0.1)
    assert t.busy_s == pytest.approx(0.035)
    assert t.kernel_s == pytest.approx(0.04) and t.launches == 2
    gaps = dict((k, v) for k, v in t.idle_gaps)
    assert gaps["aten::nonzero"] == pytest.approx(0.02)
    assert sum(gaps.values()) == pytest.approx(0.1 - 0.035)


def test_the_bounds_are_chip_smokes_arithmetic():
    # chip_smoke's PERF rows: cost_matrix 10 000^2 d=2 0.1195 ms, the
    # dense slack_propose round 0.1135 ms (95 % of the rows live)
    assert 1e3 * bounds.cost_bound_s("euclidean", 1, 10_000, 10_000, 2) \
        == pytest.approx(0.1195, abs=5e-5)
    assert 1e3 * bounds.propose_bound_s(1, 10_000, 10_000, 9_500) \
        == pytest.approx(0.1135, abs=5e-5)
    assert 1e3 * bounds.cost_bound_s("l1", 1, 2048, 2048, 784) \
        == pytest.approx(0.1963, abs=5e-5)
    b = bounds.solve_bound_s("euclidean", 16, 1024, 1024, 2)
    assert b == pytest.approx(bounds.cost_bound_s("euclidean", 16, 1024,
                                                  1024, 2)
                              + bounds.propose_bound_s(16, 1024, 1024,
                                                       16 * 1024))
