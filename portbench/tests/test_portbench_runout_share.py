"""The run-out share's reader (``metrics/driver.runout_share.*``) on
hand-made span lists: 0, 100, a share between, and None."""
from pathlib import Path
import sys

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.lib.harness import load_file  # noqa: E402

SOLO = load_file("metrics", "driver.runout_share.solo")


def _solve(chunks, runouts=None):
    s = {"name": "solve", "span_id": chunks, "parent_id": None,
         "dur_s": 0.01, "chunks": chunks}
    if runouts is not None:
        s["runouts"] = runouts
    return s


CHUNK = {"name": "driver.chunk", "span_id": 99, "parent_id": 1,
         "dur_s": 0.001}


@pytest.mark.parametrize("spans,want", [
    ([_solve(46), CHUNK, _solve(45)], 0.0),            # no counter
    ([_solve(46, 0)], 0.0),
    ([_solve(1, 1), CHUNK, _solve(1, 1)], 100.0),
    ([_solve(1, 1), _solve(3)], 25.0),
    ([], None),
    ([CHUNK, {"name": "costs.build", "span_id": 5, "parent_id": None,
              "dur_s": 0.001}], None),                  # no solve span
    ([_solve(0)], None),                                # no chunk
])
def test_the_share_of_run_out_chunks(spans, want):
    assert SOLO.share(spans) == want


def test_the_batch_metric_is_the_same_reader(monkeypatch):
    batch = load_file("metrics", "driver.runout_share.batch")
    share = load_file("metrics", "driver.sync_wait_share.solo")
    monkeypatch.setattr(share, "recorded", lambda: [_solve(2, 2)])
    assert batch.read(None) == SOLO.read(None) == 100.0
    monkeypatch.setattr(share, "recorded", lambda: [])
    assert batch.read(None) is None
