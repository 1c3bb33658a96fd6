"""The yardstick's arithmetic on numbers worked out by hand: the MDCT
roofline count, the p95, the device's idle share and the readers."""

import math
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import small  # noqa: E402
from portbench.lib import harness, roofline, trace  # noqa: E402
from portbench.traffic import serve_open  # noqa: E402


def test_mdct_counts_at_32_by_431_by_1024():
    # analysis of 430 blocks: 431 frames; synthesis of 431 frames
    flops, nbytes = roofline.mdct_analysis(32, 430, 1024)
    assert flops == 2 * 32 * 431 * 1024 * 1024 == 28_923_920_384
    assert nbytes == 4 * 32 * 1024 * (430 + 431) == 112_852_992
    flops, nbytes = roofline.mdct_synthesis(32, 431, 1024)
    assert flops == 28_923_920_384
    assert nbytes == 4 * 32 * 1024 * (431 + 432) == 113_115_136
    # bytes bind both directions: 33.69 + 33.77 us
    least = (roofline.least_seconds(*roofline.mdct_analysis(32, 430, 1024))
             + roofline.least_seconds(*roofline.mdct_synthesis(32, 431,
                                                               1024)))
    assert least == pytest.approx(112_852_992 / 3.35e12
                                  + 113_115_136 / 3.35e12)
    assert least == pytest.approx(67.45e-6, rel=1e-3)


def view(cell, summary, ops=1, counters=None):
    outcome = harness.Outcome(1, 0, {}, [], summary=summary, ops=ops,
                              counters=counters)
    return harness.TraceView(cell, outcome)


def test_mdct_roofline_reader():
    cell = harness.Cell("mono44k.batch32x10s")
    # two calls of 0.62 ms of MDCT device time, plus an elementwise kernel
    events = [("split_kernel<true, 3, false>", 0, 100),
              ("split_gemm_kernel<6>", 100, 400),
              ("scatter_kernel<float, float, false, false>", 400, 620),
              ("at::native::vectorized_elementwise_kernel<4>", 620, 900)]
    events += [(n, s + 1000, e + 1000) for n, s, e in events]
    summary = {"device": events, "host": [], "keys": {}, "window": (0, 2000)}
    t = view(cell, summary, ops=2)
    least = 67.45e-6
    assert cell.reader("mdct_roofline").read(t) == pytest.approx(
        100 * least / 0.62e-3, rel=1e-3)
    assert cell.reader("codec.other_device_ms").read(t) == pytest.approx(
        0.28)
    # no MDCT kernel in the window: nothing to read, never 0
    t = view(cell, dict(summary, device=events[3:4]), ops=2)
    assert cell.reader("mdct_roofline").read(t) is None


def test_idle_share_and_breakdown_of_synthetic_spans():
    summary = {"device": [("a", 10, 30), ("b", 20, 40), ("a", 60, 70),
                          ("c", 95, 130)],
               "host": [("portbench.window", 0, 100), ("stream.pack", 38, 65),
                        ("aten::add", 40, 45)],
               "keys": {}, "window": (0, 100)}
    # busy: [10, 40] + [60, 70] + [95, 100] (clipped) = 45 of 100
    assert trace.busy_us(summary) == 45
    assert trace.idle_percent(summary) == pytest.approx(55.0)
    b = trace.breakdown(summary)
    assert b["device_ops"][0] == ["c", pytest.approx(35e-6)]
    # gaps: [0, 10], [40, 60], [70, 95]; [40, 60] is stream.pack's
    assert b["idle_gaps"] == [["idle host", pytest.approx(25e-6)],
                              ["stream.pack", pytest.approx(20e-6)],
                              ["idle host", pytest.approx(10e-6)]]
    assert trace.idle_percent(dict(summary, device=[])) is None
    assert trace.covered([(0, 5), (1, 2), (7, 9)]) == (7, 9)


def test_p95_counts_failures_as_missing():
    lat = [i / 1000 for i in range(1, 101)]  # 1..100 ms
    assert serve_open.p95(lat) == 0.095
    assert serve_open.p95(lat[:-5] + [math.inf] * 5) == 0.095
    assert serve_open.p95(lat[:-6] + [math.inf] * 6) == math.inf
    assert serve_open.p95([0.5]) == 0.5


def test_stream_and_serve_readers():
    cell = harness.Cell("stereo48k.stream600s")
    keys = {"stream.pack": [4, 40_000.0, 44_000.0],
            "stream.step": [4, 1_000.0, 12_000.0]}
    t = view(cell, {"device": [], "host": [], "keys": keys,
                    "window": (0, 1)})
    assert cell.reader("stream.pack_ms").read(t) == 10.0
    assert cell.reader("stream.step_ms").read(t) == 3.0
    cell = small.cell("mono44k.serve_open")
    counters = {"before": {"encode_requests": 10, "encode_batches": 4,
                           "t_pack_s": 1.0},
                "after": {"encode_requests": 410, "encode_batches": 104,
                          "t_pack_s": 3.0}}
    t = view(cell, None, counters=counters)
    assert cell.reader("serve.batch_size").read(t) == 4.0
    assert cell.reader("serve.pack_ms").read(t) == 5.0
    assert cell.reader("serve.batch_size").read(view(cell, None)) is None


def test_reservoir_and_seeds():
    r = harness.Reservoir(3, 7)
    for v in range(100):
        r.offer(v)
    assert len(r.items) == 3 and all(i == v for i, v in r.items)
    again = harness.Reservoir(3, 7)
    for v in range(100):
        again.offer(v)
    assert again.items == r.items
    assert harness.sub_seed(2**40 + 3, "a", 1) == harness.sub_seed(
        2**40 + 3, "a", 1) != harness.sub_seed(2**40 + 3, "a", 2)
