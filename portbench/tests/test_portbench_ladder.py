"""The ``low`` preset's cell on the CPU at small sizes: the ladder's plain
reference against the port's plain stream path in float64, its reader
against the port's writer, the cell end to end, planted faults, and the
two readers of the ladder's spans on synthetic trace summaries."""

import inspect
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.lib import harness  # noqa: E402
from portbench.reference.ladder import (MEMBERS, Ladder,  # noqa: E402
                                        LadderStream, header)

NAME = "stereo48k_low.stream600s"
PORTBENCH = Path(__file__).resolve().parents[1]
CONFIG = json.loads((PORTBENCH / "configs" / "stereo48k_low.json")
                    .read_text())
# the cell at a size a CPU test run holds: 3.5 chunks of 16 blocks
SMALL = (dict(chunk_blocks=16, stream_seconds=16 * 1024 * 3.5 / 48000),
         dict(ring=2, keep=2, chunks=2))


def small_cell() -> harness.Cell:
    c = harness.Cell(NAME)
    c.config.update(SMALL[0])
    c.workload["params"].update(SMALL[1])
    return c


def execute(seed: int = 2**31 + 11, trace: bool = False) -> dict:
    return harness.execute(small_cell(), seed, 0.6, trace, "cpu",
                           time.perf_counter())


def small_run(tmp_path, seed=5):
    cell = small_cell()
    return harness.Run(cell, seed, 1.0, False, "cpu", str(tmp_path), 0.0)


def port_stream(tmp_path, dtype, x, chunk_blocks, samples):
    """The port's stream of x at the configuration, on the CPU at
    ``dtype`` -> (path, n_chunks)."""
    from audiocodec_tpu_torch.codec import Codec
    from audiocodec_tpu_torch.io import stream_container

    kind = small_cell().traffic()
    codec = Codec.create(48000, compute_dtype=dtype, device="cpu")
    path = tmp_path / f"{dtype}.acs"
    n = stream_container.encode_stream(
        codec, x.to(dtype), str(path), chunk_blocks=chunk_blocks,
        orig_samples=samples, **kind.features(CONFIG))
    return path, n


def port_members(chunk) -> dict:
    """A port reader's chunk, named as the reference names members."""
    from audiocodec_tpu_torch import scq

    return {"codes": chunk.codes,
            "levels": scq.levels_from_bark16(chunk.bark, 4),
            "tns": chunk.tns, "nfl": chunk.nfl, "bwe": chunk.bwe,
            "isg": chunk.isg, "bsw": chunk.bsw}


@pytest.fixture(scope="module")
def ring():
    run = harness.Run(small_cell(), 7, 1.0, False, "cpu", "", 0.0)
    return run.cell.traffic().inputs(run)


def test_reference_equals_the_port_in_float64(tmp_path, ring):
    """Codes, sidecar levels and every member of each chunk and the flush,
    across chunk boundaries (the carry and the forward-masking context):
    equal, here with no tie among them."""
    from audiocodec_tpu_torch.io import stream_container

    x = ring[0].double()
    samples = x.shape[1]
    path, n = port_stream(tmp_path, torch.float64, x, 16, samples)
    reader = stream_container.StreamReader(str(path))
    ref = Ladder(CONFIG, "cpu")
    fired = {k: 0 for k in ("tns", "bsw", "nfl", "bwe", "isg")}
    for c in range(n):
        got = port_members(reader.read_chunk(c))
        want = ref.encode(x, 16 * c, len(got["codes"]))
        for k in ("codes", "levels") + MEMBERS:
            assert np.array_equal(np.asarray(got[k]), want[k].numpy()), (c, k)
        for k in fired:
            fired[k] += int(np.count_nonzero(got[k]))
        # the reference's decoder equals the port's decode but the noise
        dec = ref.decode(want)
        assert dec.shape == (len(got["codes"]), 1024, 2)
    assert all(fired.values()), fired
    assert n == 5  # four chunks and the flush


def test_reference_decode_equals_the_port_decode_without_noise():
    from audiocodec_tpu_torch import quantize
    from audiocodec_tpu_torch.codec import Codec

    run = harness.Run(small_cell(), 9, 1.0, False, "cpu", "", 0.0)
    x = run.cell.traffic().mix(run, 0)[:, :24 * 1024].double()
    ref = Ladder(CONFIG, "cpu")
    codec = Codec.create(48000, compute_dtype=torch.float64, device="cpu")
    kw = {k: v for k, v in small_cell().traffic().features(CONFIG).items()
          if k != "nf_seed"}
    enc = codec.encode_frames(codec.mdct.transform(x), **dict(kw, nf=False))
    y = codec.decode_bitstream_ms(
        enc.codes, enc.bark16, threshold_scale=CONFIG["threshold_scale"],
        dz_recon=quantize.dz_recon_offset(CONFIG["deadzone"]),
        tns_idx=enc.tns_idx, bs_flags=enc.bs_flags,
        bwe_gains=enc.bwe_gains, is_gains=enc.is_gains)
    want = ref.encode(x, 0, 25)
    assert torch.equal(want["codes"], enc.codes[0].long())
    spec = ref.decode(want)
    got = ref.base.synthesis(spec[None])
    # float64 rounding (the products' thread split), amplified by the
    # TNS inverse filter's gain: ~1e-10 in amplitude
    assert float(((y - got) ** 2).sum() / (got ** 2).sum()) < 1e-16


def test_reader_matches_the_port_writer(tmp_path, ring):
    from audiocodec_tpu_torch.io import stream_container

    x = ring[1]
    path, n = port_stream(tmp_path, torch.float32, x, 16, x.shape[1] - 100)
    s = LadderStream(path, CONFIG)
    assert s.blocks() == [16] * 4 + [1]
    assert s.meta["nsamp"] == x.shape[1] - 100
    reader = stream_container.StreamReader(str(path))
    for c in range(n):
        got, want = s.chunk(c), port_members(reader.read_chunk(c))
        for k in ("codes", "levels") + MEMBERS:
            assert np.array_equal(got[k], want[k]), (c, k)
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 1  # a payload bit: a chunk's CRC fails
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        LadderStream(path, CONFIG)


def test_reader_refuses_another_configuration(tmp_path, ring):
    from audiocodec_tpu_torch.codec import Codec
    from audiocodec_tpu_torch.io import stream_container

    codec = Codec.create(48000, device="cpu")
    plain = tmp_path / "plain.acs"
    stream_container.encode_stream(codec, ring[0], str(plain),
                                   chunk_blocks=16)
    with pytest.raises(ValueError, match="header"):
        LadderStream(plain, CONFIG)
    other = dict(CONFIG, threshold_scale=CONFIG["threshold_scale"] * 2)
    path, _ = port_stream(tmp_path, torch.float32, ring[0], 16, 0)
    with pytest.raises(ValueError, match="threshold_scale"):
        LadderStream(path, other)
    assert header(CONFIG)["dzr"] == pytest.approx(0.45)


def test_the_cell_runs_correct_on_the_cpu():
    line = execute()
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["checks"]) == {"failed", "bad", "err", "side"}
    assert set(line["metrics"]) == {"audio_s_per_s.host", "setup_s"}


def test_inputs_follow_the_seed_with_the_same_gains_and_pans(tmp_path):
    kind = small_cell().traffic()
    assert kind.pans(3) == pytest.approx([0.5, 0.9, 0.1])
    a = kind.mix(small_run(tmp_path, 2**33 + 1), 0)
    b = kind.mix(small_run(tmp_path, 2**33 + 1), 0)
    c = kind.mix(small_run(tmp_path, 2**33 + 2), 0)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (1, int(round(16 * 1024 * 3.5)), 2)
    assert a.abs().max() <= 0.9
    # correlated channels: a mix, not two independent voices
    corr = torch.corrcoef(a[0].T.double())[0, 1]
    assert 0.2 < float(corr) < 0.99


# -- planted faults ------------------------------------------------------


def tns_off(monkeypatch):
    """TNS analyses nothing: every frame unfiltered, indices zero."""
    from audiocodec_tpu_torch import codec as codec_mod

    def fn(self, spec, threshold, bs_flags):
        b, f, _, c = spec.shape
        return (torch.zeros(b, f, 8, c, dtype=torch.int8), spec, threshold)

    monkeypatch.setattr(codec_mod.Codec, "_tns", fn)


def written(change):
    """Each chunk's members altered where they are written."""

    def plant(monkeypatch):
        from audiocodec_tpu_torch.io import bitstream, stream_container

        orig = stream_container.StreamWriter.append

        def fn(*args, **kwargs):
            bound = inspect.signature(orig).bind(*args, **kwargs)
            members = bound.arguments
            for k in ("bs_flags", "is_gains"):
                members[k] = np.array(bitstream.host(members[k]))
            change(members)
            return orig(*bound.args, **bound.kwargs)

        monkeypatch.setattr(stream_container.StreamWriter, "append", fn)

    return plant


def flip_flag(kw):
    kw["bs_flags"][..., 0] = ~kw["bs_flags"][..., 0]


def zero_gains(kw):
    kw["is_gains"][...] = 0


def drop_member(monkeypatch):
    """The noise-fill member left out of the header and every chunk."""
    from audiocodec_tpu_torch.io import stream_container

    init = stream_container.StreamWriter.__init__
    append = stream_container.StreamWriter.append

    def new_init(self, *args, **kwargs):
        init(self, *args, **dict(kwargs, nf=False))

    def new_append(self, codes, bark16, tns_idx=None, nf_levels=None,
                   *args, **kwargs):
        return append(self, codes, bark16, tns_idx, None, *args, **kwargs)

    monkeypatch.setattr(stream_container.StreamWriter, "__init__", new_init)
    monkeypatch.setattr(stream_container.StreamWriter, "append", new_append)


FAULTS = {"tns-off": tns_off, "flag-flipped": written(flip_flag),
          "intensity-zeroed": written(zero_gains),
          "member-dropped": drop_member}


@pytest.mark.parametrize("plant", list(FAULTS.values()), ids=list(FAULTS))
def test_a_broken_ladder_is_not_correct(monkeypatch, plant):
    plant(monkeypatch)
    line = execute()
    assert line["correct"] is False, line["checks"]
    checks = line["checks"]
    assert any(checks[k]["value"] > checks[k]["limit"]
               for k in ("bad", "err", "side")), checks


# -- the readers of the ladder's spans -------------------------------------


def view(summary, ops=1):
    outcome = harness.Outcome(1, 0, {}, [], summary=summary, ops=ops)
    return harness.TraceView(harness.Cell(NAME), outcome)


def summary(host=(), keys=None, device=(("split_gemm_kernel<6>", 0, 9),)):
    return {"device": list(device), "host": list(host), "keys": keys or {},
            "window": (0, 10_000)}


def test_ladder_host_ms_counts_the_stages_inside_the_steps():
    read = harness.Cell(NAME).reader("ladder.host_ms").read
    host = [
        ("stream.step", 1_000, 2_000),
        ("psycho.masking", 1_000, 1_200),  # a codec stage, not the ladder's
        ("ladder.tmask", 1_200, 1_300),
        ("ladder.ms", 1_300, 1_350),
        ("ladder.bs", 1_350, 1_550),
        ("ladder.tns", 1_550, 1_800),
        ("stream.members", 2_100, 2_300),  # in the pack, not the step
        ("stream.step", 5_000, 6_000),
        ("ladder.nf", 5_000, 5_100),
        ("ladder.bwe", 5_100, 5_250),
        ("ladder.intensity", 5_900, 6_000),
        # the flush frame's stages: outside every step
        ("ladder.tns", 7_000, 7_500),
    ]
    # (100 + 50 + 200 + 250) + (100 + 150 + 100) us over 2 steps
    assert read(view(summary(host))) == pytest.approx(0.475)
    # a CPU run: no device event
    assert read(view(summary(host, device=()))) is None
    # a program without the ladder's spans
    assert read(view(summary(host[:2]))) is None


def test_ladder_members_ms():
    read = harness.Cell(NAME).reader("ladder.members_ms").read
    keys = {"stream.members": [4, 30.0, 1_000.0],
            "stream.pack": [4, 900.0, 40_000.0]}
    assert read(view(summary(keys=keys))) == pytest.approx(0.25)
    assert read(view(summary(keys=keys, device=()))) is None
    assert read(view(summary(keys={"stream.pack": [4, 1.0, 9.0]}))) is None


def test_the_readers_name_the_programs_ladder_spans(tmp_path, ring):
    """The labels a CPU stream of the program records are the readers'."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.lib import trace

    stages = harness.Cell(NAME).reader("ladder.host_ms").STAGES
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        port_stream(tmp_path, torch.float32, ring[0], 16, 0)
    s = trace.summarize(prof)
    labels = {name for name, _, _ in s["host"]}
    assert set(stages) | {"stream.members", "stream.step"} <= labels
    s["device"] = [("a kernel", 0, 1)]
    t = view(s)
    assert t.metric("ladder.host_ms").read(t) > 0
    assert t.metric("ladder.members_ms").read(t) > 0
