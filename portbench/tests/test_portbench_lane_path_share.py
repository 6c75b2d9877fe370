"""The lane-path share's reader (``metrics/kernels.lane_path_share.*``) on
hand-made span lists: 100, 0, a share between, and None."""
from pathlib import Path
import sys

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.lib.harness import load_file  # noqa: E402

SOLO = load_file("metrics", "kernels.lane_path_share.solo")


def _solve(launches, lane=None):
    s = {"name": "solve", "span_id": launches, "parent_id": None,
         "dur_s": 0.01, "launches": {"fused_assignment_phases": launches}}
    if lane is not None:
        s["fused_assignment"] = {"lane_path": lane}
    return s


OT_SOLVE = {"name": "solve", "span_id": 7, "parent_id": None,
            "dur_s": 0.01, "launches": {"fused_ot_phases": 1}}
CHUNK = {"name": "driver.chunk", "span_id": 99, "parent_id": 1,
         "dur_s": 0.001}


@pytest.mark.parametrize("spans,want", [
    ([_solve(1, 1), CHUNK, _solve(1, 1)], 100.0),
    ([_solve(1, 0), _solve(1, 0)], 0.0),
    ([_solve(3, 1), _solve(1, 0)], 25.0),
    ([], None),                                          # no spans
    ([CHUNK], None),                                     # no solve span
    ([OT_SOLVE], None),                                  # no such launch
    ([_solve(2), _solve(1)], None),                      # no counter
])
def test_the_share_of_per_lane_launches(spans, want):
    assert SOLO.share(spans) == want


def test_the_batch_metric_is_the_same_reader(monkeypatch):
    batch = load_file("metrics", "kernels.lane_path_share.batch")
    share = load_file("metrics", "driver.sync_wait_share.solo")
    monkeypatch.setattr(share, "recorded", lambda: [_solve(2, 2)])
    assert batch.read(None) == SOLO.read(None) == 100.0
    monkeypatch.setattr(share, "recorded", lambda: [])
    assert batch.read(None) is None
