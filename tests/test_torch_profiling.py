"""``live_at_peak`` on a hand-made allocator trace: it finds the peak of
the bytes allocated during the recording and groups what is live there by
site and block size."""
import pytest

pytest.importorskip("torch")

from repro_torch.launch.profiling import live_at_peak  # noqa: E402


def _alloc(addr, size, *files):
    return {"action": "alloc", "addr": addr, "size": size,
            "frames": [{"filename": f, "line": 7, "name": "fn"}
                       for f in files]}


def _free(addr, size):
    return {"action": "free_requested", "addr": addr, "size": size}


def test_live_at_peak_groups_the_blocks_live_at_the_peak():
    rev = "/src/repro_torch/core/reversible.py"
    trace = [_alloc(1, 100, rev, "/src/repro_torch/train/trainer.py"),
             _alloc(2, 50),                     # an engine thread's block
             _free(2, 50),
             _free(9, 400),                     # allocated before recording
             _alloc(3, 100, "/other/lib.py", rev),
             _alloc(4, 30),
             _free(4, 30), _free(1, 100),
             _alloc(5, 120, rev),                # below the peak of 230
             {"action": "free_completed", "addr": 5, "size": 120}]
    peak, rows = live_at_peak({"device_traces": [trace]})
    assert peak == 230
    assert rows == [(200, 2, 100, "core/reversible.py:7 fn"),
                    (30, 1, 30, "no Python frame")]
    assert live_at_peak({"device_traces": [trace]}, top=1)[1] == rows[:1]
