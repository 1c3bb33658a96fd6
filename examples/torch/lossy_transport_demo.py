#!/usr/bin/env python
"""Example: low-bitrate seekable streaming over a lossy transport.

The full coded-path toolbox in one run: a stereo music-like signal is
rate-controlled to a target bitrate into a seekable .acs stream with
joint mid/side stereo, temporal noise shaping (transient protection),
a rate-adaptive dead zone, and noise filling (spectral-hole repair);
then the "network" corrupts some chunks and the decoder plays through
the outage with packet-loss concealment.

  python examples/torch/lossy_transport_demo.py [--kbps 48] [--seconds 12]
                                                [--lose 3,7] [--cpu]

Prints the measured stream bitrate, SNR/NMR of the clean decode, and
what concealment preserves across the lost chunks.
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def make_music(sr: int, seconds: float) -> np.ndarray:
    """Stereo mix: sustained chord + melody + percussion transients."""
    t = np.arange(int(sr * seconds)) / sr
    rng = np.random.default_rng(42)
    chord = sum(
        0.12 * np.sin(2 * np.pi * f * t) for f in (220.0, 277.2, 329.6)
    )
    melody = 0.18 * np.sin(
        2 * np.pi * (440 + 60 * np.sin(2 * np.pi * 0.5 * t)) * t
    )
    hiss = 0.02 * rng.standard_normal(t.size)
    left = chord + melody + hiss
    right = chord - 0.5 * melody + 0.02 * rng.standard_normal(t.size)
    # percussion: short decaying bursts every ~0.7 s
    for s0 in range(sr // 2, t.size - 2000, int(0.7 * sr)):
        burst = np.exp(-np.arange(1500) / 200.0) * rng.standard_normal(1500)
        left[s0 : s0 + 1500] += 0.5 * burst / np.max(np.abs(burst))
        right[s0 : s0 + 1500] += 0.4 * burst / np.max(np.abs(burst))
    x = np.stack([left, right], axis=1)
    return (0.9 * x / np.max(np.abs(x))).astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kbps", type=float, default=96.0)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--chunk-blocks", type=int, default=64)
    ap.add_argument("--lose", default="3,7",
                    help="comma-separated chunk indices the 'network' drops")
    ap.add_argument("--fec", type=float, default=0.0,
                    help="forward error correction: each chunk carries a "
                         "redundant copy of the previous one, quantized "
                         "this many times coarser (0 = off, try 4); lost "
                         "chunks are rebuilt from real spectral data")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain torch versions)")
    args = ap.parse_args()

    import torch

    if not args.cpu and not torch.cuda.is_available():
        sys.exit("error: no CUDA device (pass --cpu to run on the CPU)")
    device = "cpu" if args.cpu else "cuda"

    from audiocodec_tpu_torch import metrics
    from audiocodec_tpu_torch.codec import Codec
    from audiocodec_tpu_torch.io import stream_container as sc

    sr, n = 44100, 1024
    codec = Codec.create(sr, filters_n=n, bark_bands_n=64, device=device)
    wave = make_music(sr, args.seconds)
    chunk = args.chunk_blocks * n
    usable = wave.shape[0] - wave.shape[0] % chunk
    x = torch.from_numpy(wave[None, :usable]).to(device)

    def decode(path, **kw):
        with torch.no_grad():
            return torch.cat(list(sc.decode_stream(codec, path, **kw)),
                             dim=1)[:, n:-n]

    path = os.path.join(tempfile.mkdtemp(), "demo.acs")
    n_chunks, tscale, kbps = sc.encode_stream_with_target_bitrate(
        codec, x, path, chunk_blocks=args.chunk_blocks,
        target_kbps=args.kbps, ms=True, tns=True, nf=True, fec=args.fec,
    )
    tools = "ms+tns+nf+deadzone" + (f"+fec{args.fec:g}" if args.fec else "")
    print(f"encoded {usable / sr:.1f}s stereo -> {n_chunks} chunks, "
          f"{os.path.getsize(path)} bytes = {kbps:.1f} kbit/s "
          f"(target {args.kbps}, scale {tscale:.2f}; {tools})")

    clean_t = decode(path)
    ev = metrics.evaluate(codec, x, clean_t)
    print(f"clean decode:     SNR {ev['snr_db']:6.2f} dB   "
          f"NMR {ev['nmr']:.3f}")
    clean = clean_t.cpu().numpy()

    # the lossy "network": corrupt the requested chunks' payloads
    with sc.StreamReader(path) as r:
        lost = sorted(
            int(i) for i in args.lose.split(",")
            if i != "" and int(i) < r.n_chunks
        )
        offs = [r._index[i] for i in lost]
    with open(path, "r+b") as f:
        for off in offs:
            f.seek(off + 12)
            f.write(b"\xde\xad\xbe\xef")
    print(f"transport drops chunks {lost} "
          f"({len(offs) * args.chunk_blocks * n / sr:.2f}s of audio)")

    out = decode(path, conceal=True).cpu().numpy()
    # quality outside the outage neighborhoods is untouched
    mask = np.ones(out.shape[1], bool)
    for i in lost:
        lo = max(0, (i * args.chunk_blocks - 1) * n)
        hi = min(out.shape[1], ((i + 1) * args.chunk_blocks + 1) * n)
        mask[lo:hi] = False
    ref = wave[None, :usable][:, mask]
    deg = out[:, mask]
    snr = 10 * np.log10(
        (ref**2).sum() / max(((ref - deg) ** 2).sum(), 1e-30)
    )
    mode = "fec-rebuilt" if args.fec else "concealed"
    print(f"{mode} decode: SNR {snr:6.2f} dB outside the outages "
          f"(finite everywhere: {np.isfinite(out).all()}; stream length "
          f"preserved: {out.shape[1] == clean.shape[1]})")
    # inside the outages: vs the CLEAN decode (what a lossless transport
    # would have played) — fec rebuilds real spectral data there,
    # concealment only extrapolates/interpolates the envelope
    inref = clean[:, ~mask]
    indeg = out[:, ~mask]
    in_snr = 10 * np.log10(
        (inref**2).sum() / max(((inref - indeg) ** 2).sum(), 1e-30)
    )
    print(f"inside the outages: {in_snr:6.2f} dB vs the clean decode"
          + ("" if args.fec else " (try --fec 4)"))


if __name__ == "__main__":
    main()
