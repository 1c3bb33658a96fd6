"""The plain reference against the port's plain CPU path at small sizes,
and the container readers against the port's writers."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.lib import audio  # noqa: E402
from portbench.reference import containers  # noqa: E402
from portbench.reference.codec import Err, Reference  # noqa: E402

PORTBENCH = Path(__file__).resolve().parents[1]
MONO = json.loads((PORTBENCH / "configs" / "mono44k.json").read_text())
STEREO = json.loads((PORTBENCH / "configs" / "stereo48k.json").read_text())


def port_codec(cfg, dtype=torch.float64):
    from audiocodec_tpu_torch.codec import Codec

    return Codec.create(cfg["sample_rate"], compute_dtype=dtype,
                        device="cpu")


@pytest.fixture(scope="module")
def clip():
    return audio.music(5, 2, 1024 * 24, 1, 44100, "cpu")


def test_filter_bank_equals_the_port_in_float64(clip):
    ref, codec = Reference(MONO, "cpu"), port_codec(MONO)
    spec = ref.analysis(clip)
    assert torch.allclose(codec.mdct.transform(clip.double()), spec,
                          rtol=0, atol=1e-15)
    assert torch.allclose(codec.mdct.inverse_transform(spec),
                          ref.synthesis(spec), rtol=0, atol=1e-14)
    # any run of frames equals the whole signal's
    for first, count in ((0, 3), (7, 9), (22, 3)):
        assert torch.allclose(ref.frames(clip, first, count),
                              spec[:, first:first + count], rtol=0,
                              atol=1e-15)


def test_codec_equals_the_port_in_float64(clip):
    from audiocodec_tpu_torch import scq

    ref, codec = Reference(MONO, "cpu"), port_codec(MONO)
    x = clip.double()
    assert torch.allclose(codec.round_trip_quantized(x), ref.round_trip(x),
                          rtol=0, atol=1e-14)
    codes, bark16 = codec.quantize_frames(codec.mdct.transform(x))
    got, levels, _ = ref.encode(ref.analysis(x))
    assert torch.equal(codes.long(), got)
    assert np.array_equal(scq.levels_from_bark16(bark16, 4), levels.numpy())


def test_float32_port_is_within_rounding_of_the_reference(clip):
    err = Err()
    err.add(port_codec(MONO, torch.float32).round_trip_quantized(clip),
            Reference(MONO, "cpu").round_trip(clip))
    assert err.value < 1e-8


@pytest.mark.parametrize("rle", [False, True])
def test_rice_decoders_against_the_native_coders(rle):
    from audiocodec_tpu_torch import native

    rng = np.random.default_rng(3)
    values = rng.integers(-40, 40, 3000).astype(np.int32)
    values[100:1500] = 0  # zero runs longer than a group
    values[2000:2003] = [2**31 - 1, -2**31, 1 << 20]  # escapes
    enc = native.rrice_encode if rle else native.rice_encode
    assert np.array_equal(containers.rice_decode(enc(values), 3000, rle),
                          values)
    with pytest.raises(ValueError):
        containers.rice_decode(enc(values)[:-40], 3000, rle)


def test_acz_reader_against_the_port_pack(clip):
    from audiocodec_tpu_torch import scq
    from audiocodec_tpu_torch.io import bitstream

    codec = port_codec(MONO, torch.float32)
    codes, bark16 = codec.quantize_frames(codec.mdct.transform(clip[:1]))
    blob = bitstream.pack(codes, bark16, sample_rate=44100, filters_n=1024,
                          bark_bands_n=64, alpha=0.6, window_type="vorbis",
                          entropy="rrice", sidecar_grid=4,
                          orig_samples=24000)
    got = containers.read_acz(blob, MONO)
    assert np.array_equal(got["codes"], codes.numpy())
    assert np.array_equal(got["levels"], scq.levels_from_bark16(bark16, 4))
    assert got["nsamp"] == 24000
    assert containers.read_acz(blob, MONO, decode=False)["codes"] is None
    with pytest.raises(ValueError):
        containers.read_acz(blob, STEREO)
    with pytest.raises(ValueError):
        containers.read_acz(blob[:-100], MONO)


def test_acs_reader_against_the_port_stream(tmp_path):
    from audiocodec_tpu_torch.io import stream_container

    cfg = dict(STEREO, chunk_blocks=4)
    x = audio.music(9, 1, 1024 * 12, 2, 48000, "cpu")
    codec = port_codec(cfg, torch.float32)
    path = tmp_path / "s.acs"
    stream_container.encode_stream(codec, x, str(path), chunk_blocks=4,
                                   orig_samples=1024 * 11)
    s = containers.Stream(path, cfg)
    assert s.blocks() == [4, 4, 4, 1] and s.meta["nsamp"] == 1024 * 11
    ref = Reference(cfg, "cpu")
    for i, first in enumerate((0, 4, 8, 12)):
        codes, levels = s.chunk(i)
        want, want_levels, _ = ref.encode(ref.frames(x, first, len(codes)))
        assert np.array_equal(codes, want[0].numpy())
        assert np.array_equal(levels, want_levels[0].numpy())
    data = bytearray(path.read_bytes())
    data[200] ^= 1  # a payload bit: the chunk's CRC no longer holds
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        containers.Stream(path, cfg)
