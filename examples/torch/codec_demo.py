#!/usr/bin/env python
"""Demo: encode a test signal across bitrates and print a quality table.

  python examples/torch/codec_demo.py [--input song.wav] [--out-dir /tmp/demo]
                                      [--cpu]

Without --input, synthesizes a 5 s music-like test clip. Produces one .acz
per bitrate plus a native-VBR encode, decodes each, and reports size / SNR.
Runs on the GPU; --cpu runs the kernels' plain torch versions instead.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def synth_clip(path, sr=44100, seconds=5.0):
    from audiocodec_tpu_torch.io.wav import write_wav

    rng = np.random.default_rng(0)
    t = np.arange(int(sr * seconds)) / sr
    # a phrased mix: the tonal bed breathes (loud phrases / quiet
    # valleys, like verse dynamics)...
    env = 0.12 + 0.88 * np.sin(np.pi * t) ** 2
    wave = env * (
        0.35 * np.sin(2 * np.pi * 440 * t)
        + 0.25 * np.sin(2 * np.pi * 659.3 * t)
        + 0.15 * np.sin(2 * np.pi * 880 * t) * np.sin(2 * np.pi * 3 * t)
        + 0.05 * rng.normal(size=t.size)
    )
    # ...with percussive hits IN the valleys — attacks rising out of
    # quiet are where pre-echo is audible and where TNS and block
    # switching act (hits buried in a loud bed create no contrast)
    for k in range(1, int(seconds)):
        s0 = int(k * sr) + sr // 50
        dt = np.arange(1500)
        hit = np.exp(-dt / 180.0) * rng.normal(size=1500)
        wave[s0 : s0 + 1500] += 0.7 * hit / np.abs(hit).max()
    write_wav(path, np.clip(wave, -1, 1).astype(np.float32)[:, None], sr)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", default="")
    parser.add_argument("--out-dir", default="/tmp/codec_demo")
    parser.add_argument("--bitrates", default="48,96,160")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain torch "
                             "versions; quality is the same)")
    args = parser.parse_args()

    import torch

    if not args.cpu and not torch.cuda.is_available():
        sys.exit("error: no CUDA device (pass --cpu to run on the CPU)")
    device = "cpu" if args.cpu else "cuda"

    from audiocodec_tpu_torch import metrics, native, rate
    from audiocodec_tpu_torch.codec import Codec
    from audiocodec_tpu_torch.io import bitstream

    os.makedirs(args.out_dir, exist_ok=True)
    wav = args.input or os.path.join(args.out_dir, "input.wav")
    if not args.input:
        synth_clip(wav)

    data, sr = native.decode_wav(wav)
    n = 1024
    data = data[:, : data.shape[1] - data.shape[1] % n]
    codec = Codec.create(sr, filters_n=n, bark_bands_n=64, device=device)
    x = torch.from_numpy(data).to(device)
    seconds = x.shape[1] / sr
    raw_kbps = sr * data.shape[2] * 16 / 1000

    def snr(out):
        a = data[0].astype(np.float64)
        b = out[0, n : n + x.shape[1]].cpu().numpy().astype(np.float64)
        return 10 * np.log10((a**2).sum() / ((a - b) ** 2).sum())

    def nmr(out):
        return float(metrics.nmr(codec, x, out[:, n : n + x.shape[1]]))

    hit_starts = [] if args.input else [
        int(k * sr) + sr // 50
        for k in range(1, int(seconds))
        if int(k * sr) + sr // 50 < x.shape[1] - 2000
    ]

    def pre_echo(out):
        """Error energy in the 12 ms before each synthetic hit — the
        quantity SNR cannot see (it integrates over the loud parts) and
        the reason the ladder's TNS + block switching exist."""
        if not hit_starts:
            return float("nan")
        err = out[0, n : n + x.shape[1], 0].cpu().numpy() - data[0, :, 0]
        w, g = int(0.012 * sr), int(0.001 * sr)
        return float(sum(
            (err[s0 - g - w : s0 - g] ** 2).sum() for s0 in hit_starts
        ))

    print(f"input: {wav} ({seconds:.1f} s @ {sr} Hz, {raw_kbps:.0f} kbps PCM)")
    print(f"{'mode':>12} {'kbps':>7} {'bytes':>9} {'SNR dB':>7} "
          f"{'NMR':>7} {'pre-echo':>9}")

    # native VBR
    with torch.no_grad():
        codes, bark = codec.encode_bitstream(x)
        out = codec.decode_bitstream(codes, bark)
    packed = bitstream.pack(
        codes, bark, sample_rate=sr, filters_n=n, bark_bands_n=64,
        alpha=0.6, window_type="vorbis",
    )
    kbps = len(packed) * 8 / seconds / 1000
    print(f"{'VBR':>12} {kbps:7.0f} {len(packed):9d} {snr(out):7.2f} "
          f"{nmr(out):7.3f} {pre_echo(out):9.3f}")

    # plain rate control, then the full coded-feature ladder
    # (dead zone + TNS + block switching + noise fill + temporal
    # masking — the CLI's --preset low) at the same targets
    ladders = (
        ("plain", dict()),
        ("ladder", dict(deadzone="auto", tns=True, bs=True, nf=True,
                        tmask=130.0)),
    )
    for target in (float(b) for b in args.bitrates.split(",")):
        for name, kw in ladders:
            res = rate.encode_with_target_bitrate(codec, x, target, **kw)
            path = os.path.join(
                args.out_dir, f"{int(target)}kbps_{name}.acz"
            )
            with open(path, "wb") as f:
                f.write(res.packed)
            codes2, bark2, meta = bitstream.unpack(res.packed)
            with torch.no_grad():
                out = bitstream.decode_container(codec, codes2, bark2, meta)
            label = f"{int(target)}k {name}"
            print(
                f"{label:>12} {res.kbps:7.0f} {len(res.packed):9d} "
                f"{snr(out):7.2f} {nmr(out):7.3f} {pre_echo(out):9.3f}"
            )
    print("(read all three columns: the ladder's wins concentrate where "
          "attacks rise out of quiet — less pre-echo, often better SNR "
          "at mid rates — while noise filling deliberately trades raw "
          "SNR for filled spectral holes; see benchmarks/QUALITY.md)")


if __name__ == "__main__":
    main()
