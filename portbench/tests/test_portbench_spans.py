"""The readers of the program's codec stage spans and of the stream's copy
in (``codec.host_ms``, ``stream.codec_ms``, ``stream.h2d_ms``) on
synthetic trace summaries, with numbers worked out by hand."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.lib import harness  # noqa: E402

STAGES = harness.Cell("mono44k.batch32x10s").reader("codec.host_ms").STAGES
DEVICE = [("split_gemm_kernel<6>", 0, 100)]


def view(cell, summary, ops=1):
    outcome = harness.Outcome(1, 0, {}, [], summary=summary, ops=ops)
    return harness.TraceView(cell, outcome)


def summary(device=DEVICE, host=(), keys=None):
    return {"device": list(device), "host": list(host), "keys": keys or {},
            "window": (0, 10_000)}


def test_the_readers_name_the_programs_seven_stages():
    """The stage labels a CPU round trip of the program records are the
    reader's seven."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from audiocodec_tpu_torch import Codec

    codec = Codec.create(16000, filters_n=64, bark_bands_n=16, device="cpu")
    x = torch.linspace(-0.5, 0.5, 4 * 64).reshape(1, -1, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        codec.round_trip_quantized(x)
    labels = {e.name for e in prof.events() if e.is_user_annotation}
    assert len(STAGES) == 7 and labels == set(STAGES)


def test_codec_host_ms():
    cell = harness.Cell("mono44k.batch32x10s")
    read = cell.reader("codec.host_ms").read
    # two calls: each stage twice, totals (count, self us, total us)
    keys = {s: [2, 10.0, 100.0 * (i + 1)] for i, s in enumerate(STAGES)}
    keys["stream.step"] = [2, 0.0, 9_000.0]  # not a stage
    keys["aten::add"] = [50, 500.0, 500.0]
    # (100 + 200 + ... + 700) us over 2 calls
    assert read(view(cell, summary(keys=keys), ops=2)) == pytest.approx(1.4)
    # a stage missing from the window adds nothing
    del keys["quantize.dequantize"]
    assert read(view(cell, summary(keys=keys), ops=2)) == pytest.approx(1.05)


def test_codec_host_ms_finds_nothing_to_read():
    cell = harness.Cell("mono44k.batch32x10s")
    read = cell.reader("codec.host_ms").read
    keys = {s: [1, 1.0, 50.0] for s in STAGES}
    # a CPU run: no device event
    assert read(view(cell, summary(device=[], keys=keys))) is None
    assert read(view(cell, summary(keys=keys), ops=0)) is None
    # a program without the stage spans
    assert read(view(cell, summary(keys={"aten::mm": [4, 9.0, 9.0]}))) is None


def test_stream_codec_ms_counts_the_stages_inside_the_steps():
    cell = harness.Cell("stereo48k.stream600s")
    read = cell.reader("stream.codec_ms").read
    host = [
        ("portbench.window", 0, 10_000),
        ("stream.step", 1_000, 2_000),
        ("stream.h2d", 1_000, 1_100),  # not a stage
        ("mdct.analysis", 1_100, 1_300),
        ("psycho.tonality", 1_300, 1_400),
        ("quantize.quantize", 1_900, 2_000),  # ends with the step
        ("stream.pack", 2_000, 5_000),
        ("stream.step", 5_000, 6_500),
        ("mdct.analysis", 5_000, 5_600),  # starts with the step
        ("psycho.masking", 5_600, 5_800),
        ("aten::mm", 5_800, 6_400),  # not a stage
        # the flush frame's stages: outside every step
        ("mdct.analysis", 7_000, 7_500),
        ("psycho.threshold", 7_500, 7_600),
        # a stage that starts inside a step and ends after it
        ("quantize.dequantize", 6_400, 6_600),
    ]
    # (200 + 100 + 100) + (600 + 200) us over 2 steps
    assert read(view(cell, summary(host=host))) == pytest.approx(0.6)


def test_stream_codec_ms_finds_nothing_to_read():
    cell = harness.Cell("stereo48k.stream600s")
    read = cell.reader("stream.codec_ms").read
    host = [("stream.step", 0, 1_000), ("mdct.analysis", 100, 300)]
    assert read(view(cell, summary(host=host))) == pytest.approx(0.2)
    # a CPU run: no device event
    assert read(view(cell, summary(device=[], host=host))) is None
    # no step in the window
    assert read(view(cell, summary(host=host[1:]))) is None
    # steps without the stage spans (a program that has none)
    assert read(view(cell, summary(host=host[:1]))) is None


def test_stream_h2d_ms():
    cell = harness.Cell("stereo48k.stream600s")
    read = cell.reader("stream.h2d_ms").read
    keys = {"stream.h2d": [4, 40.0, 1_200.0],
            "stream.step": [4, 100.0, 16_000.0]}
    assert read(view(cell, summary(keys=keys))) == pytest.approx(0.3)
    assert read(view(cell, summary(device=[], keys=keys))) is None
    del keys["stream.h2d"]
    assert read(view(cell, summary(keys=keys))) is None
