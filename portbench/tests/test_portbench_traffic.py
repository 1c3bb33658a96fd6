"""Each traffic kind end to end on the CPU at small sizes: its inputs, its
window, its check and the result line."""

import json

import pytest
import torch

import small
from portbench.lib import harness

CELLS = sorted(small.SIZES)


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_cpu(name):
    line = small.execute(name)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) >= {"setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}
    json.dumps(line)


def test_traced_line_has_the_window_and_breakdown():
    line = small.execute("stereo48k.stream600s", trace=True)
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert line["device"]["window_s"] > 0 and line["device"]["busy_s"] == 0
    # the program's spans are read; device metrics find nothing on a CPU
    assert set(line["metrics"]) == {"stream.pack_ms", "stream.step_ms"}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_inputs_follow_the_seed():
    kind = small.cell("mono44k.batch32x10s").traffic()

    def ring(seed):
        run = harness.Run(small.cell("mono44k.batch32x10s"), seed, 1.0,
                          False, "cpu", "", 0.0)
        return kind.inputs(run)

    a, b, c = ring(2**33 + 1), ring(2**33 + 1), ring(2**33 + 2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (2, 1024 * 24, 1) and a[0].abs().max() <= 0.9


def test_every_seed_gets_the_same_gains():
    from portbench.lib import audio

    sets = [audio.gains_db(audio.generator(seed, "cpu"), 6, "cpu")
            for seed in (2**33 + 1, 2**33 + 2, 7)]
    assert all(torch.equal(s.sort().values, sets[0].sort().values)
               for s in sets)
    assert sets[0].sort().values.tolist() == [-11.0, -9.0, -7.0, -5.0,
                                              -3.0, -1.0]
    assert not all(torch.equal(s, sets[0]) for s in sets)
    # a stream's two channels: -9 and -3 dB, whatever the seed
    for seed in range(4):
        two = audio.gains_db(audio.generator(seed, "cpu"), 2, "cpu")
        assert sorted(two.tolist()) == [-9.0, -3.0]


def test_serve_plan_keeps_sizes_and_arrivals_across_seeds():
    c = small.cell("mono44k.serve_open")
    kind = c.traffic()
    plans = [kind.plan(harness.Run(c, seed, 5.0, False, "cpu", "", 0.0))
             for seed in (1, 2)]
    (len1, sched1), (len2, sched2) = plans
    assert len1 == len2 and len(sched1) == len(sched2) == 80
    gaps = [sorted(b - a for a, b in zip([0.0] + [d for d, _ in s],
                                         [d for d, _ in s])) for s in
            (sched1, sched2)]
    assert gaps[0] == pytest.approx(gaps[1])
    assert sorted(k for _, k in sched1) == sorted(k for _, k in sched2)
    assert sched1 != sched2
    assert all(0.1 * 44100 <= n <= 44100 for n in len1)


def test_corpus_writes_wavs_the_reference_reads(tmp_path):
    c = small.cell("mono44k.corpus1000x10s")
    kind = c.traffic()
    run = harness.Run(c, 5, 1.0, False, "cpu", str(tmp_path), 0.0)
    kind.write_inputs(run, str(tmp_path / "in"))
    wav = kind.read_wav(tmp_path / "in" / "clip00004.wav")
    assert wav.shape == (22050, 1) and wav.dtype.str == "<i2"
    from audiocodec_tpu_torch.io import wav as port_wav

    data, rate = port_wav.read_wav_bytes(
        (tmp_path / "in" / "clip00004.wav").read_bytes())
    assert rate == 44100
    assert torch.equal(torch.as_tensor(data).reshape(-1),
                       torch.from_numpy(wav / 32768.0).float().reshape(-1))
