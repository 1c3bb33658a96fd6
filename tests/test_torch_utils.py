"""The port's utils/profiling and utils/debug on the CPU, held to the JAX
package's utils where both compute the same thing (find_nonfinite) and to
tests/test_aux.py's checkify tests where torch has no checkify."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocodec_tpu.utils import debug as jax_debug
from audiocodec_tpu_torch import (Codec, codec, mdct, native, psycho, quantize,
                                  rate)
from audiocodec_tpu_torch.io import stream_container
from audiocodec_tpu_torch.utils import debug, profiling

torch.set_num_threads(1)
PACKAGE = Path(__file__).resolve().parent.parent / "audiocodec_tpu_torch"
# the codec's stage spans: none runs inside another
STAGES = ("mdct.analysis", "mdct.synthesis", "psycho.tonality",
          "psycho.masking", "psycho.threshold", "quantize.quantize",
          "quantize.dequantize")


def _codec():
    return Codec.create(16000, filters_n=64, bark_bands_n=16, device="cpu")


# -- profiling -----------------------------------------------------------------


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    codec = _codec()
    x = torch.full((1, 4 * 64, 1), 0.3)
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.span("codec.round_trip_quantized"):
            codec.round_trip_quantized(x)
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "codec.round_trip_quantized" for e in events)


def test_span_changes_nothing():
    codec = _codec()
    x = torch.linspace(-0.5, 0.5, 4 * 64).reshape(1, -1, 1)
    want = codec.round_trip_quantized(x)
    with profiling.span("label"):
        got = codec.round_trip_quantized(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _profiled(fn):
    """(fn's output, the events of a CPU profile of the call)"""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _enclosing(event):
    names, parent = [], event.cpu_parent
    while parent is not None:
        names.append(parent.name)
        parent = parent.cpu_parent
    return names


def test_span_enters_no_label_when_nothing_records(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(profiling, "record_function", refuse)
    with profiling.span("label"):
        pass
    assert profiling.span("wrapped")(lambda a: a + 1)(1) == 2
    _codec().round_trip_quantized(torch.full((1, 4 * 64, 1), 0.3))
    monkeypatch.undo()

    def labelled():
        with profiling.span("label"):
            profiling.span("wrapped")(lambda: None)()

    _, events = _profiled(labelled)
    (inner,) = [e for e in events if e.name == "wrapped"]
    assert _enclosing(inner)[0] == "label"


def test_span_ends_its_label_when_the_body_raises():
    def fail():
        with profiling.span("label"):
            raise KeyError("body")

    def run():
        with pytest.raises(KeyError):
            fail()
        with profiling.span("after"):
            pass

    _, events = _profiled(run)
    (after,) = [e for e in events if e.name == "after"]
    assert "label" not in _enclosing(after)


def test_host_stages_use_the_one_span():
    for module in (rate, stream_container, mdct, psycho, quantize, codec):
        assert module.span is profiling.span, module
    # a labelled function keeps its name and docstring
    assert quantize.quantize.__name__ == "quantize"
    assert mdct.MDCT.transform.__doc__.startswith("MDCT analysis")
    for path in PACKAGE.rglob("*.py"):
        if path.name != "profiling.py":
            assert "record_function" not in path.read_text(), path


def test_round_trip_shows_each_stage_once_none_inside_another():
    codec = _codec()
    x = torch.linspace(-0.5, 0.5, 4 * 64).reshape(1, -1, 1)
    _, events = _profiled(lambda: codec.round_trip_quantized(x))
    stages = [e for e in events if e.name in STAGES]
    assert sorted(e.name for e in stages) == sorted(STAGES)
    for e in stages:
        assert not set(_enclosing(e)) & set(STAGES), e.name


LADDER = ("ladder.ms", "ladder.tmask", "ladder.bs", "ladder.tns",
          "ladder.nf", "ladder.bwe", "ladder.intensity")
LOW = dict(ms=True, deadzone=1.0, tns=True, bs=True, nf=True, tmask=130.0,
           bwe=True, intensity=True)


def _ladder_input(blocks, seed=0):
    """[1, blocks * 1024, 2] panned tones with a click after a gap, so
    that block switching and TNS fire at 48 kHz, N=1024."""
    g = torch.Generator().manual_seed(seed)
    t = torch.arange(blocks * 1024, dtype=torch.float64) / 48000
    tone = 0.3 * torch.sin(2 * torch.pi * 440 * t) + 0.05 * torch.randn(
        t.shape, generator=g, dtype=torch.float64)
    at = 3 * 1024 + 300
    tone[at - 2048:at] = 0.0
    tone[at:at + 64] += 0.8 * torch.exp(-torch.arange(64.0) / 8)
    x = torch.stack([tone, 0.6 * tone + 0.02 * torch.randn(
        t.shape, generator=g, dtype=torch.float64)], dim=-1)
    return x[None].clamp(-0.9, 0.9).float()


def test_ladder_encode_shows_each_stage_once_none_inside_another():
    codec = Codec.create(48000, filters_n=1024, device="cpu")
    frames = codec.mdct.transform(_ladder_input(6))
    enc, events = _profiled(lambda: codec.encode_frames(frames, **LOW))
    assert bool(enc.bs_flags.any()) and bool((enc.tns_idx != 0).any())
    ladder = [e for e in events if e.name in LADDER]
    assert sorted(e.name for e in ladder) == sorted(LADDER)
    for e in ladder:
        assert not set(_enclosing(e)) & set(LADDER + STAGES), e.name
    for e in events:
        if e.name in STAGES:
            assert not set(_enclosing(e)) & set(LADDER), e.name


@pytest.mark.parametrize("kw", [{}, dict(ms=True, deadzone=0.7)],
                         ids=["archive", "ms-only-deadzone"])
def test_no_ladder_span_without_its_features(kw):
    codec = Codec.create(48000, filters_n=1024, device="cpu")
    frames = codec.mdct.transform(_ladder_input(4))
    _, events = _profiled(lambda: codec.encode_frames(frames, **kw))
    names = {e.name for e in events}
    assert not names & set(LADDER) - ({"ladder.ms"} if kw else set())


def test_stream_writer_counts_the_members_it_codes(tmp_path):
    codec = Codec.create(48000, filters_n=1024, device="cpu")
    x = _ladder_input(12, seed=3)
    path = str(tmp_path / "low.acs")
    counters = {}
    n, events = _profiled(lambda: stream_container.encode_stream(
        codec, x, path, chunk_blocks=4, counters=counters, **LOW))
    assert sum(e.name == "stream.members" for e in events) == n == 4
    chunks = [stream_container.StreamReader(path).read_chunk(i)
              for i in range(n)]
    cat = {k: np.concatenate([getattr(c, k) for c in chunks])
           for k in ("tns", "nfl", "bwe", "isg", "bsw")}
    assert counters == {
        "frames": 13,
        "tns_frames": int(np.any(cat["tns"] != 0, axis=(1, 2)).sum()),
        "nf_filled": int(np.count_nonzero(cat["nfl"])),
        "bwe_filled": int(np.count_nonzero(cat["bwe"])),
        "is_filled": int(np.count_nonzero(cat["isg"])),
        "short_frames": int(cat["bsw"].sum()),
    }
    assert counters["short_frames"] > 0 and counters["tns_frames"] > 0
    # the archive stream codes no member: no span, no member count
    counters = {}
    _, events = _profiled(lambda: stream_container.encode_stream(
        codec, x, str(tmp_path / "plain.acs"), chunk_blocks=4,
        counters=counters))
    assert counters == {}
    assert not {e.name for e in events} & {"stream.members", *LADDER}


def test_outputs_equal_with_and_without_a_recording_profiler():
    codec = _codec()
    x = torch.sin(torch.arange(8 * 64) * 0.3).reshape(1, -1, 1) * 0.4
    want = codec.round_trip_quantized(x)
    codes, delta, threshold = codec.encode_quantized(x)
    got, _ = _profiled(lambda: codec.round_trip_quantized(x))
    assert torch.equal(got, want)
    (c, d, t), _ = _profiled(lambda: codec.encode_quantized(x))
    assert torch.equal(c, codes) and torch.equal(d, delta)
    assert torch.equal(t, threshold)


def test_time_fn_returns_positive_seconds():
    x = torch.ones((64, 64))
    dt = profiling.time_fn(lambda a: a @ a, x, iters=2)
    assert 0 < dt < 10.0
    calls = []
    profiling.time_fn(lambda: calls.append(1), iters=3)
    assert len(calls) == 4  # one warm call, then iters timed ones


@pytest.mark.parametrize("spans,want", [
    ([(0, 10)], (10, 10)),
    ([(0, 10), (5, 15)], (15, 15)),          # overlapping
    ([(5, 15), (0, 10), (2, 3)], (15, 15)),  # unsorted, nested
    ([(0, 2), (2, 4)], (4, 4)),              # touching
    ([(0, 2), (6, 8)], (4, 8)),              # a gap
    ([(0, 10), (1, 2), (12, 13)], (11, 13)),
])
def test_covered(spans, want):
    assert profiling.covered(spans) == want


def test_kernel_events_of_a_cpu_trace_are_empty():
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones((16, 16))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x @ x
    assert prof.events() and profiling.kernel_events(prof) == []



def test_kernel_events_leave_out_the_labels_device_rows():
    from types import SimpleNamespace

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def event(name, device, annotation=False):
        return SimpleNamespace(name=name, device_type=device,
                               is_user_annotation=annotation)

    events = [event("psycho.masking", cpu, True),
              event("mdct.analysis", cpu, True),
              event("aten::mul", cpu),
              event("psycho.masking", cuda, True),  # kineto's label row
              event("mdct.analysis", cuda),  # a label row left unmarked
              event("split_gemm_kernel<6>", cuda),
              event("Memcpy HtoD (Pageable -> Device)", cuda)]
    prof = SimpleNamespace(events=lambda: events)
    assert [e.name for e in profiling.kernel_events(prof)] == [
        "split_gemm_kernel<6>", "Memcpy HtoD (Pageable -> Device)"]

# -- chip_smoke.py's phase 23d helpers -----------------------------------------


@pytest.mark.parametrize("kernels,plain,bad", [
    (["SNR 13.88 dB", "final mean gain: 0.460"],
     ["SNR 13.88 dB", "final mean gain: 0.460"], 0),
    # wall-clock figures and the output directory are left out
    (["level 1: 419,225 bytes  encode 63 audio-s/s  decode 142 audio-s/s",
      "1 s window at 2.0 s -> 5.4 ms vs 17 ms full decode (3x less work)",
      "input: OUT/input.wav (5.0 s)"],
     ["level 1: 419,225 bytes  encode 48 audio-s/s  decode 124 audio-s/s",
      "1 s window at 2.0 s -> 7.1 ms vs 23 ms full decode (4x less work)",
      "input: OUT/input.wav (5.0 s)"], 0),
    (["loss 17.475588"], ["loss 17.48"], 0),        # printed digits
    (["SNR 13.88 dB"], ["SNR 14.50 dB"], 1),        # beyond 1% + 0.05
    (["loss nan"], ["loss nan"], 1),                # non-finite
    (["60757 bytes"], ["60757 bytes", "extra"], 1),  # a line missing
])
def test_chip_smoke_example_comparison(tmp_path, kernels, plain, bad):
    import chip_smoke

    def numbers(lines, mode):
        out = tmp_path / mode
        return chip_smoke.example_numbers(
            [ln.replace("OUT", str(out)) for ln in lines], out)

    got = chip_smoke.example_mismatches(numbers(kernels, "k1"),
                                        numbers(plain, "p2"))
    assert len(got) == bad, got


def test_chip_smoke_checking_kernels_holds_each_call():
    """Each wrapper call, forward and backward, is recorded with its shape,
    tier, error and tolerance (here on the CPU, where a wrapper is its
    plain version), and the wrappers are restored afterwards."""
    import chip_smoke

    from audiocodec_tpu_torch import MDCT
    from audiocodec_tpu_torch.ops import cuda_mdct

    m = MDCT(256, use_kernel=True, dct_precision="highest", device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -0.5, 0.5, (2, 256 * 4, 1)).astype(np.float32)).requires_grad_()
    errors, original = {}, cuda_mdct.fold_matmul
    with chip_smoke.checking_kernels(torch, errors):
        assert cuda_mdct.fold_matmul is not original
        m.inverse_transform(m.transform(x)).sum().backward()
    assert sorted(errors) == ["fold_matmul", "fold_matmul_vjp",
                              "matmul_scatter", "matmul_scatter_vjp"]
    for name, e in errors.items():
        # on the CPU the wrapper is its plain version: no error
        assert (e["calls"], e["tier"], e["max_abs_err"], e["ratio"]) == (
            1, "highest", 0.0, 0.0), name
        assert e["tol"] > 0 and e["shapes"][0][0] == 2
    assert errors["fold_matmul"]["shapes"] == [[2, 4, 256]]
    assert cuda_mdct.fold_matmul is original
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


def test_chip_smoke_checking_kernels_holds_the_rice_coder_exactly():
    """The Rice coder's calls are held byte for byte (tolerance 0), and
    its plain version is what ``plain_kernels`` puts in its place."""
    import chip_smoke

    from audiocodec_tpu_torch.ops import cuda_rice

    codes = torch.from_numpy(np.random.default_rng(1).integers(
        -3, 4, (3, 300), dtype=np.int32))
    errors = {}
    with chip_smoke.checking_kernels(torch, errors):
        buf, nbytes = cuda_rice.rrice_encode(codes)
    assert errors == {"rrice_encode": dict(
        calls=1, shapes=[[3, 300]], ratio=0.0, tier=None, max_abs_err=0.0,
        tol=0.0)}
    assert bytes(buf[:int(nbytes)].numpy()) == native.rrice_encode(codes)
    with chip_smoke.plain_kernels():
        assert cuda_rice.rrice_encode is cuda_rice.rrice_encode_reference
    assert "rrice_encode" in chip_smoke.all_launch_counts()


# -- debug ---------------------------------------------------------------------


class TestChecked:
    """tests/test_aux.py::TestCheckify on the port."""

    def test_clean_pipeline_passes(self):
        codec = _codec()
        x = torch.ones((1, 4 * 64, 1), dtype=torch.float32) * 0.3
        checked = debug.checked(
            lambda x, g: codec.round_trip(x, g)
        )
        err, out = checked(x, torch.Generator().manual_seed(0))
        err.throw()  # no error
        assert err.get() is None
        assert out.shape == (1, 6 * 64, 1)

    def test_nan_input_caught(self):
        codec = _codec()
        x = torch.full((1, 4 * 64, 1), float("nan"), dtype=torch.float32)
        checked = debug.checked(lambda x, g: codec.round_trip(x, g))
        err, _ = checked(x, torch.Generator().manual_seed(0))
        with pytest.raises(FloatingPointError, match="non-finite"):
            err.throw()

    def test_the_first_failed_check_is_named(self):
        def pipeline(x):
            debug.assert_finite(x, "input")
            y = debug.assert_finite(x / 0.0, "ratio")
            return {"ok": x, "bad": [x, y]}

        err, out = debug.checked(pipeline)(torch.ones(3))
        assert err.get() == "ratio contains NaN/Inf"
        err, out = debug.checked(lambda x: {"ok": x, "bad": [x, x / 0]})(
            torch.ones(3))
        with pytest.raises(FloatingPointError,
                           match=r"output\['bad'\]\[1\]"):
            err.throw()
        assert debug.checked(lambda: None)()[0].get() is None


def test_assert_finite_outside_checked_returns_its_input():
    x = torch.tensor([1.0, float("nan")])
    assert debug.assert_finite(x) is x
    assert debug._CHECKS.get() is None


def test_find_nonfinite_matches_jax():
    values = {
        "good": np.ones(4, np.float32),
        "bad": np.asarray([1.0, np.nan, np.inf, 2.0], np.float32),
        "rows": [np.zeros(2, np.float32),
                 (np.asarray([np.nan, -np.inf, 0.0], np.float32),
                  np.arange(3))],
    }

    def tree(to):
        return {"good": to(values["good"]), "bad": to(values["bad"]),
                "rows": [to(values["rows"][0]),
                         (to(values["rows"][1][0]),
                          to(values["rows"][1][1]))]}

    want = jax_debug.find_nonfinite(tree(jnp.asarray))
    assert want == {"['bad']": 2, "['rows'][1][0]": 2}
    assert debug.find_nonfinite(tree(torch.from_numpy)) == want
    assert debug.find_nonfinite(tree(np.asarray)) == want


def test_find_nonfinite_walks_modules_and_named_tuples():
    from audiocodec_tpu_torch.codec import EncodedFrames

    codec = _codec()
    assert debug.find_nonfinite(codec) == {}
    codec.psycho.W[0, 0] = float("nan")
    assert debug.find_nonfinite({"codec": codec}) == {"['codec'].psycho.W": 1}
    frames = EncodedFrames(torch.zeros(2, dtype=torch.int32),
                           torch.tensor([float("inf")]), None, None)
    assert debug.find_nonfinite(frames) == {".bark16": 1}
