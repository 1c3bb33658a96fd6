"""The rate layer's counters and spans on a CBR stream encode with FEC
(``stream_container.encode_stream_cbr``), on the CPU at N=256, 16 kHz, 16
Bark bands, two chunks of 4 blocks.

- ``rate.counts()`` tallies the work consistently: each search's trial
  rounds pack K x B rows and its final pass B, ``packs`` equals
  ``trials``, every search is followed by a stream encode (``passes``,
  plus a best-of re-encode at most), and ``unconverged`` says whether the
  file ended outside its tolerance.
- Under the profiler ``rate.cbr`` holds every ``rate.search`` and
  ``rate.wire``; each search holds its ``rate.analysis``, ``rate.trials``
  and ``rate.pack``; one ``rate.wire`` precedes each corrective search.
- The file's bytes are the same with a profiler recording as without.
"""

import numpy as np
import pytest
import torch

from audiocodec_tpu_torch import Codec, rate
from audiocodec_tpu_torch.io import stream_container as sc

torch.set_num_threads(1)

SR, N, BARK, CB = 16000, 256, 16, 4
TRIALS = 8
# a tolerance tighter than the first pass reaches, so that the corrective
# passes (and their re-reads of the index) run
KW = dict(chunk_blocks=CB, target_kbps=40.0, fec=4.0, tolerance=0.002,
          trials_per_round=TRIALS, deadzone="auto")


def signal():
    """Two chunks of stereo tones over noise, the second 12 dB quieter."""
    rng = np.random.default_rng(5)
    t = np.arange(2 * CB * N) / SR
    x = (0.3 * np.sin(2 * np.pi * 440 * t)[:, None]
         + 0.05 * np.sin(2 * np.pi * 3100 * t)[:, None]
         + 0.03 * rng.normal(size=(t.size, 2)))
    x[CB * N:] *= 10.0 ** (-12.0 / 20.0)
    return torch.from_numpy(np.clip(x, -1, 1).astype(np.float32)[None])


@pytest.fixture(scope="module")
def encodes(tmp_path_factory):
    """(counts, return value, bytes) of the plain encode, and the profiled
    encode's events and bytes."""
    from torch.profiler import ProfilerActivity, profile

    tmp = tmp_path_factory.mktemp("cbr")
    codec = Codec.create(SR, filters_n=N, bark_bands_n=BARK, device="cpu")
    x = signal()
    rate.reset_counts()
    got = sc.encode_stream_cbr(codec, x, str(tmp / "a.acs"), **KW)
    counts = rate.counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sc.encode_stream_cbr(codec, x, str(tmp / "b.acs"), **KW)
    data = [(tmp / name).read_bytes() for name in ("a.acs", "b.acs")]
    return counts, got, data, prof.events()


def test_counts_are_consistent(encodes):
    c, (n_chunks, scales, kbps), _, _ = encodes
    assert n_chunks == 3 and len(scales) == 2
    body = 2  # the search's clips: one a body chunk
    assert c["searches"] >= 2  # the tolerance forces a corrective pass
    assert c["packs"] == c["trials"] == (
        (c["rounds"] - c["searches"]) * TRIALS * body + c["searches"] * body)
    assert c["rounds"] >= 2 * c["searches"]  # a grid and the final pass
    assert c["searches"] <= c["passes"] <= c["searches"] + 1
    assert c["unconverged"] == int(
        abs(kbps - KW["target_kbps"]) > KW["tolerance"] * KW["target_kbps"])


def test_spans_nest_and_bytes_do_not_change(encodes):
    c, _, (plain, profiled), events = encodes
    assert plain == profiled

    def within(inner, outer):
        return (outer.time_range.start <= inner.time_range.start
                and inner.time_range.end <= outer.time_range.end)

    def named(name):
        return [e for e in events if e.name == name]

    (cbr,) = named("rate.cbr")
    searches, wires = named("rate.search"), named("rate.wire")
    assert len(searches) == c["searches"] and len(wires) == len(searches) - 1
    assert all(within(e, cbr) for e in searches + wires)
    for name in ("rate.analysis", "rate.trials", "rate.pack"):
        found = named(name)
        assert found and all(any(within(e, s) for s in searches)
                             for e in found)
    assert len(named("rate.analysis")) == len(searches)
    assert len(named("rate.trials")) == len(named("rate.pack")) == c[
        "rounds"]
