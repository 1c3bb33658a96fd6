#!/usr/bin/env python
"""Demo: lossless archival — levels, integrity, and random access.

  python examples/torch/archival_demo.py [--input song.wav] [--seconds 30]
                                         [--cpu]

Without --input, synthesizes a music-like stereo clip. Encodes it at
level 1 (fixed-predictor ladder) and level 2 (order-searched quantized
LPC, container v3), verifies both decode bit-exactly, then demonstrates
random access: a one-second window extracted from the middle of the
archive via the per-frame bit index (`fidx`), timed against a full
decode — the work scales with the window, not the archive.

The interesting columns: level 2's ratio vs level 1 (the LPC search
earns ~5-8% on tonal-dominated material; docs/DESIGN.md §22b shows
where the entropy floor sits), and the range-decode speedup.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default="")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (level 1's selection and the "
                         "decode's integration in plain torch there)")
    args = ap.parse_args()

    import torch

    if not args.cpu and not torch.cuda.is_available():
        sys.exit("error: no CUDA device (pass --cpu to run on the CPU)")
    device = "cpu" if args.cpu else "cuda"

    from audiocodec_tpu_torch import lossless

    sr = 44100
    if args.input:
        from audiocodec_tpu_torch.io import wav as _wav

        x, sr, bits = _wav.read_wav_int(args.input)
    else:
        bits = 16
        rng = np.random.default_rng(0)
        t = np.arange(int(sr * args.seconds)) / sr
        melody = sum(
            a * np.sin(2 * np.pi * f * t + p)
            for a, f, p in [(9000, 220, 0.0), (4500, 330, 1.1),
                            (2500, 440, 0.4), (1200, 587, 2.0)]
        )
        left = (melody + rng.normal(0, 90, t.size)).astype(np.int32)
        right = (0.85 * left + rng.normal(0, 70, t.size)).astype(np.int32)
        x = np.stack([left, right], axis=1)

    raw = x.size * (bits // 8)
    secs = x.shape[0] / sr
    print(f"source: {x.shape[0]:,} samples x {x.shape[1]} ch "
          f"{bits}-bit @ {sr} Hz ({raw:,} bytes raw)\n")

    blobs = {}
    for level in (1, 2):
        t0 = time.perf_counter()
        blob = lossless.encode_lossless(x, sr, bits=bits, level=level,
                                        device=device)
        enc_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        y, _, _ = lossless.decode_lossless(blob, device=device)
        dec_s = time.perf_counter() - t0
        if not np.array_equal(y, x):
            sys.exit("error: the lossless round trip is not exact")
        d = lossless.describe(blob)
        blobs[level] = blob
        print(f"level {level}: {len(blob):,} bytes "
              f"(ratio {len(blob)/raw:.3f})  "
              f"encode {secs/enc_s:6.0f} audio-s/s  "
              f"decode {secs/dec_s:6.0f} audio-s/s  "
              f"[v{d['version']}, integrity={d['integrity']}, "
              f"seekable={d['seekable']}]")

    # random access: 1 s from the middle, via the fidx bit index
    blob = blobs[2]
    mid = x.shape[0] // 2
    t0 = time.perf_counter()
    window, _, _ = lossless.decode_lossless(blob, start=mid, count=sr,
                                            device=device)
    t_win = time.perf_counter() - t0
    t0 = time.perf_counter()
    full, _, _ = lossless.decode_lossless(blob, device=device)
    t_full = time.perf_counter() - t0
    if not np.array_equal(window, full[mid:mid + sr]):
        sys.exit("error: the window differs from the full decode's rows")
    print(f"\nrandom access: 1 s window at {mid/sr:.1f} s -> "
          f"{t_win*1e3:.1f} ms vs {t_full*1e3:.0f} ms full decode "
          f"({t_full/max(t_win, 1e-9):.0f}x less work), bit-exact")


if __name__ == "__main__":
    main()
