"""The constant-bitrate FEC cell on the CPU at a small size: its run end to
end, traced and not, against the plain reference (``reference/cbr.py``);
the faults planted under it, each not correct by the check it breaks; the
readers on the traced line; on the card (``-m cuda``), the control at the
small size."""

import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from audiocodec_tpu_torch.io import stream_container  # noqa: E402
from portbench.lib import harness  # noqa: E402
from portbench.reference import cbr  # noqa: E402
from portbench.reference.codec import Reference  # noqa: E402

NAME = "stereo48k_cbr.stream120s"
# the cell at a size a CPU test run holds: chunks of 64 blocks, 12 s a
# stream (9 body chunks), the level stepping every 2 s, 2 chunks checked.
# Shorter chunks miss their share by more (16 blocks: 0.11 where 64 read
# 0.01), and fewer chunks carry more of the header and the flush chunk's
# FEC copy (5 chunks of 64: 4.3% over the target)
SMALL = (dict(chunk_blocks=64, stream_seconds=12.0),
         dict(chunks=2, step_s=2.0))
PER_LAYER = ("rate.pack_ms", "rate.trials_ms", "rate.passes")


def small_cell() -> harness.Cell:
    c = harness.Cell(NAME)
    c.config.update(SMALL[0])
    c.workload["params"].update(SMALL[1])
    return c


def execute(seed: int = 2**31 + 11, trace: bool = False) -> dict:
    torch.set_num_threads(2)
    return harness.execute(small_cell(), seed, 0.3, trace, "cpu",
                           time.perf_counter())


def test_the_cell_runs_correct_on_the_cpu():
    line = execute()
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) == {"audio_s_per_s.host", "setup_s"}
    assert set(line["checks"]) == {"failed", "bad", "err", "fec_err",
                                   "rate", "chunk_rate"}
    json.dumps(line)


def test_the_traced_line_reads_the_rate_layer():
    line = execute(seed=2**35 + 3, trace=True)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == set(PER_LAYER)
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["metrics"]["rate.passes"]["value"] >= 1


def test_the_envelope_steps_and_ramps():
    kind = small_cell().traffic()
    p = dict(envelope_db=[0.0, -12.0, -6.0, -18.0], step_s=1.0,
             ramp_ms=50.0)
    env = kind.envelope(5000, 1000, p, "cpu").numpy()
    db = 20 * np.log10(env)
    np.testing.assert_allclose(db[[0, 999, 1050, 1999, 2050, 3050, 4050]],
                               [0, 0, -12, -12, -6, -18, 0], atol=1e-9)
    # a linear ramp of 50 ms from the level before
    np.testing.assert_allclose(env[1025], (1 + 10 ** (-12 / 20)) / 2)


def test_the_reference_reads_what_it_is_given(tmp_path):
    """A stream written by the program parses; its scales, chain and
    members are what the writer was given."""
    from audiocodec_tpu_torch import Codec

    cfg = dict(small_cell().config, chunk_blocks=4)
    codec = Codec.create(48000, filters_n=1024, bark_bands_n=64,
                         sidecar_grid=4, device="cpu")
    x = torch.randn(1, 3 * 4 * 1024, 2, generator=torch.Generator()
                    .manual_seed(1)) * 0.1
    path = str(tmp_path / "a.acs")
    stream_container.encode_stream(codec, x, path, chunk_blocks=4,
                                   threshold_scale=[1.5, 3.0, 0.75],
                                   deadzone=1.0, fec=4.0)
    s = cbr.CbrStream(path, cfg)
    assert s.blocks() == [4, 4, 4, 1]
    assert s.scales() == [1.5, 3.0, 0.75, 0.75]
    s.check_chain(4.0)
    assert s.member(0) is None and s.member(1).scale == 6.0
    ref = cbr.Cbr(cfg, "cpu")
    for c in range(3):
        codes, levels, scale = s.chunk(c)
        want_codes, want_levels, _ = ref.encode(x, 4 * c, 4, scale)
        assert (codes == want_codes.numpy()).mean() > 0.999
        assert (levels == want_levels.numpy()).all()
    data = Path(path).read_bytes()
    first = 8 + int.from_bytes(data[4:8], "little")
    assert sum(cbr.wire_bits(path)) == 8 * (len(data) - 16 - 8 * 4 - first)


# -- faults planted under a run ---------------------------------------------

def one_scale(monkeypatch):
    """Every chunk at one stream-global scale, the ABR search's."""
    from audiocodec_tpu_torch import rate

    def fn(codec, x, path, chunk_blocks=256, *, target_kbps, **kw):
        z = rate.resolve_deadzone(kw["deadzone"], target_kbps, x.shape[-1],
                                  codec.psycho.sample_rate)
        _, scale, _ = stream_container.encode_stream_with_target_bitrate(
            codec, x, path, chunk_blocks, target_kbps=target_kbps,
            deadzone=z, fec=kw["fec"], tolerance=kw["tolerance"])
        n_body = x.shape[1] // (chunk_blocks * codec.mdct.filters_n)
        n = stream_container.encode_stream(
            codec, x, path, chunk_blocks, threshold_scale=[scale] * n_body,
            deadzone=z, fec=kw["fec"], orig_samples=kw["orig_samples"])
        return n, [scale] * n_body, 0.0

    monkeypatch.setattr(stream_container, "encode_stream_cbr", fn)


def own_chunk_fec(monkeypatch):
    """Each FEC member made of its own chunk (at its predecessor's
    scale)."""
    orig = stream_container._ChunkEncoder._append

    def fn(self, enc, tscale, coarse):
        if coarse is not None and self._coarse is not None:
            coarse = (self._coarse[0], self._coarse[1], coarse[2])
        return orig(self, enc, tscale, coarse)

    monkeypatch.setattr(stream_container._ChunkEncoder, "_append", fn)


def fec_half_scale(monkeypatch):
    """The FEC copy at scale x 2 where the header declares x 4."""
    orig = stream_container._ChunkEncoder.__init__

    def fn(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        self._fec /= 2.0

    monkeypatch.setattr(stream_container._ChunkEncoder, "__init__", fn)


def neighbour_scale(monkeypatch):
    """Each body chunk's codes quantized at its neighbour's scale (the
    next chunk's; the last body chunk at the first's), its own on the
    wire."""
    scales = []
    stream = stream_container.encode_stream
    stepped = stream_container._ChunkEncoder._stepped

    def encode(*args, threshold_scale=1.0, **kw):
        scales[:] = np.ravel(threshold_scale).tolist()
        return stream(*args, threshold_scale=threshold_scale, **kw)

    def step(self, x, tscale):
        k = self.__dict__.setdefault("planted_k", 0)
        self.planted_k = k + 1
        return stepped(self, x, scales[(k + 1) % len(scales)])

    monkeypatch.setattr(stream_container, "encode_stream", encode)
    monkeypatch.setattr(stream_container._ChunkEncoder, "_stepped", step)


def rate_off(monkeypatch):
    """The file's rate 10% above the target."""
    orig = stream_container.encode_stream_cbr

    def fn(*args, target_kbps, **kw):
        return orig(*args, target_kbps=1.1 * target_kbps, **kw)

    monkeypatch.setattr(stream_container, "encode_stream_cbr", fn)


FAULTS = {
    "one-scale": (one_scale, "chunk_rate"),
    "own-chunk-fec": (own_chunk_fec, "fec_err"),
    "fec-x2": (fec_half_scale, "bad"),
    "neighbour-scale": (neighbour_scale, "err"),
    "rate-10%": (rate_off, "rate"),
}


@pytest.mark.parametrize("plant, check", list(FAULTS.values()),
                         ids=list(FAULTS))
def test_a_broken_path_is_not_correct(monkeypatch, plant, check):
    plant(monkeypatch)
    line = execute()
    assert line["correct"] is False, line["checks"]
    got = line["checks"][check]
    assert got["value"] > got["limit"], line["checks"]


@pytest.mark.cuda
def test_control_fails():
    if not torch.cuda.is_available():
        pytest.skip("TF32 products need the card")
    cell = small_cell()
    limit = cell.workload["limits"]["err"]
    for seed in (1, 2, 3):
        run = harness.Run(cell, seed, 30.0, False, "cuda", "", 0.0)
        control = Reference(cell.config, "cuda", torch.float32, tf32=True)
        assert cell.traffic().control(run, control) > limit
