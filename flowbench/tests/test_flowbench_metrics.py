"""Each metric reader on a synthetic record and trace gives the value
worked out by hand, and reads nothing where its layer left nothing; the
roofline byte counts equal hand counts on tiny tables."""

from types import SimpleNamespace

import pytest
import torch

from flowbench import harness, roofline, trace
from flowbench.peaks import HBM_BYTES_S

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def _ev(name, start, end, dev, annot=False, thread=1):
    return SimpleNamespace(name=name, device_type=dev, is_user_annotation=annot,
                           thread=thread,
                           time_range=SimpleNamespace(start=start, end=end))


class _Prof:
    def __init__(self, events):
        self._e = events

    def events(self):
        return self._e


def _summary():
    return trace.summarize(_Prof([
        _ev("void onepass_kernel<true>(Params)", 0, 10, CUDA),
        _ev("consumer_kernel(Params)", 5, 15, CUDA),
        _ev("Memcpy DtoH (Device -> Pageable)", 20, 30, CUDA),
        _ev("flowbench.step", 0, 50, CUDA, annot=True),
        _ev("flowbench.step", 0, 50, CPU),
        _ev("aten::nonzero", 1, 40, CPU),
        _ev("aten::other_thread", 0, 50, CPU, thread=2),
    ]), steps=2)


def test_summarize_known_trace():
    s = _summary()
    assert s["busy_s"] == pytest.approx(25e-6)
    assert s["span_s"] == pytest.approx(50e-6)
    assert s["kernels"] == 2
    # Idle gaps (15, 20) and (30, 50), named by the stepping thread's
    # innermost open range: aten::nonzero until 40, the step's own after.
    gaps = dict(s["idle_gaps"])
    assert gaps == {"aten::nonzero": pytest.approx(15e-6),
                    "flowbench.step": pytest.approx(10e-6)}
    assert [n for n, _ in s["device_ops"]][0].startswith("void onepass")
    assert trace.kernel_seconds(s, trace.B3_KERNEL) == (1, pytest.approx(1e-5))


def _record(**kw):
    rec = dict(steps=4, batch=100, window_s=2.0, setup_s=7.5,
               lat_s=[0.010, 0.020, 0.030, 0.040],
               walk_s=[0.004, 0.008, 0.012, 0.016],
               n_miss_window=[10, 20, 30, 40],
               prune={"fallbacks_total": 30, "classified_total": 120})
    rec.update(kw)
    return rec


def test_readers_known_values():
    s = _summary()
    s.update(b3_bytes=HBM_BYTES_S * 5e-6, b3_calls=1,
             b1_bytes=HBM_BYTES_S * 2.5e-6, b1_calls=1)
    rec = _record(trace=s)
    want = {"pkts_per_s": 200.0, "setup_s": 7.5,
            "walk_ms": 10.0, "engine_host_ms": 15.0,
            "miss_share": 0.25, "prune_fallback_share": 0.25,
            "b3_roofline": 50.0, "b1_roofline": 25.0,
            "device_idle_share": 0.5, "launches_per_step": 1.0}
    for name, v in want.items():
        assert harness.reader(name)(rec) == pytest.approx(v), name


def test_readers_read_nothing_without_their_layer():
    rec = _record(walk_s=[], prune={}, trace={})
    for name in ("walk_ms", "engine_host_ms", "prune_fallback_share",
                 "b3_roofline", "b1_roofline", "device_idle_share",
                 "launches_per_step"):
        assert harness.reader(name)(rec) is None, name


def test_b1_bytes_hand_count():
    tabs = [torch.zeros((4, w), dtype=torch.int32) for w in (2, 2, 2, 3, 3, 3)]
    iv = torch.tensor([[0, 1, 2, 0, 1, 2, 3, 0],
                       [0, 1, 1, 1, 1, 2, 2, 0],
                       [3, 1, 2, 0, 1, 2, 3, 0]], dtype=torch.int32)
    io = 3 * 8 * 4 * 2
    # distinct rows: t0 {0,3} t1 {1} t2 {1,2} t3 {0,1} t4 {1} t5 {2}
    plain = io + 4 * (2 * 2 + 1 * 2 + 2 * 2 + 2 * 3 + 1 * 3 + 1 * 3)
    assert roofline.b1_bytes(tabs, iv, False) == plain
    # svcref: table 5 reads columns 5 and 6: {2, 3}.
    assert roofline.b1_bytes(tabs, iv, True) == plain + 4 * 3


def test_b3_bytes_hand_count():
    agg = [torch.tensor([[1, 0]] * 3, dtype=torch.int32) for _ in range(6)]
    bounds = [torch.zeros(5, dtype=torch.int32) for _ in range(6)]
    iso = [torch.zeros(3, dtype=torch.int32) for _ in range(2)]
    iv = torch.tensor([[0, 0, 0, 0, 0, 0, 0, 0],
                       [1, 0, 0, 1, 0, 0, 0, 0],
                       [1, 2, 0, 1, 0, 0, 0, 0]], dtype=torch.int32)
    lanes = 8 * (29 + 44) * 4
    bnd = (6 * 5 + 2 * 3) * 4
    # distinct aggregate rows x 2 words: t0 {0,1} t1 {0,2} t2..t5 {0},{0,1},{0},{0}
    rows = (2 + 2 + 1 + 2 + 1 + 1) * 2 * 4
    # one candidate superblock (0) a lane: distinct (row, 0) per table
    blocks = (2 + 2 + 1 + 2 + 1 + 1) * 128
    assert roofline.b3_bytes(agg, bounds, iso, False, 4, iv, 8) == \
        lanes + bnd + rows + blocks
