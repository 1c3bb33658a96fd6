"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run is driven on the
CPU, once for each fault the cell can have. One card and no model: no
exchange between chips to leave out, no training state to leave unchanged
(the stream's carry is its state)."""

import numpy as np
import pytest
import torch

import small
from audiocodec_tpu_torch import codec as codec_mod
from audiocodec_tpu_torch import streaming
from audiocodec_tpu_torch.io import bitstream, stream_container


def half_round_trip(monkeypatch):
    """Half of each batch left out: its rows come back as zeros."""
    orig = codec_mod.Codec.round_trip_quantized

    def fn(self, x, drown=0.0):
        out = orig(self, x[: x.shape[0] // 2], drown)
        return torch.cat([out, torch.zeros_like(out)])[: x.shape[0]]

    monkeypatch.setattr(codec_mod.Codec, "round_trip_quantized", fn)


def altered_round_trip(monkeypatch):
    """Every answer altered where it is made: one block of each clip."""
    orig = codec_mod.Codec.round_trip_quantized

    def fn(self, x, drown=0.0):
        out = orig(self, x, drown).clone()
        out[:, 2048:3072] = 0.0
        return out

    monkeypatch.setattr(codec_mod.Codec, "round_trip_quantized", fn)


def stale_carry(monkeypatch):
    """The stream's step returns its state (the carried block) unchanged."""
    orig = streaming.mdct_stream_step

    def fn(mdct, carry, chunk):
        _, frames = orig(mdct, carry, chunk)
        return carry, frames

    monkeypatch.setattr(streaming, "mdct_stream_step", fn)


def altered_chunk(monkeypatch):
    """Each chunk's codes altered where they are written: its first frame
    one step up."""
    orig = stream_container.StreamWriter.append

    def fn(self, codes, bark16, *args, **kwargs):
        codes = np.array(bitstream.host(codes))
        codes[..., 0, :, :] += 1
        return orig(self, codes, bark16, *args, **kwargs)

    monkeypatch.setattr(stream_container.StreamWriter, "append", fn)


def half_quantize(monkeypatch):
    """Half of each batch group left out: its rows' codes come back zero
    (all of a group of one)."""
    orig = codec_mod.Codec.quantize_frames

    def fn(self, frames, *args, **kwargs):
        out = orig(self, frames, *args, **kwargs)
        codes = out[0].clone()
        codes[codes.shape[0] // 2:] = 0
        return (codes,) + tuple(out[1:])

    monkeypatch.setattr(codec_mod.Codec, "quantize_frames", fn)


def half_encode_frames(monkeypatch):
    """Half of each corpus batch left out: its rows' codes come back
    zero."""
    orig = codec_mod.Codec.encode_frames

    def fn(self, frames, *args, **kwargs):
        enc = orig(self, frames, *args, **kwargs)
        codes = enc.codes.clone()
        codes[codes.shape[0] // 2:] = 0
        return enc._replace(codes=codes)

    monkeypatch.setattr(codec_mod.Codec, "encode_frames", fn)


def altered_container(name):
    """Each container altered where it is packed: frame 1 one step up."""

    def plant(monkeypatch):
        orig = getattr(bitstream, name)

        def fn(*args, **kwargs):
            args = list(args)
            at = 1 if name == "save" else 0
            codes = np.array(bitstream.host(args[at]))
            codes[:, 1] += 1
            args[at] = codes
            return orig(*args, **kwargs)

        monkeypatch.setattr(bitstream, name, fn)

    return plant


FAULTS = {
    "batch-half": ("mono44k.batch32x10s", half_round_trip),
    "batch-altered": ("mono44k.batch32x10s", altered_round_trip),
    "stream-stale-state": ("stereo48k.stream600s", stale_carry),
    "stream-altered": ("stereo48k.stream600s", altered_chunk),
    "serve-half": ("mono44k.serve_open", half_quantize),
    "serve-altered": ("mono44k.serve_open", altered_container("pack")),
    "corpus-half": ("mono44k.corpus1000x10s", half_encode_frames),
    "corpus-altered": ("mono44k.corpus1000x10s", altered_container("save")),
}


@pytest.mark.parametrize("name, plant", list(FAULTS.values()),
                         ids=list(FAULTS))
def test_a_broken_path_is_not_correct(monkeypatch, name, plant):
    plant(monkeypatch)
    line = small.execute(name)
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["err"]["value"] > line["checks"]["err"][
        "limit"] or line["checks"]["bad"]["value"] > 0
