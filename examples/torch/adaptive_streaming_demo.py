#!/usr/bin/env python
"""Network-adaptive live streaming demo.

Simulates a link whose budget fluctuates (congestion waves + a hard
outage dip), drives a LIVE cbr encode session against the real codec
server, and adapts each chunk's rate-control scale from the measured
size of the previous chunks — the classic ABR control loop, except the
adaptation knob is the codec's own threshold scale riding the .acs CBR
wire format, so the emitted stream plays in any decoder.

  python examples/torch/adaptive_streaming_demo.py [--cpu] [--seconds 12]

Prints one row per chunk: the link budget, the scale the controller
chose, the chunk's actual kbps, and whether it fit. Ends by decoding
the full emitted stream and reporting its quality.

Expected misses: the cold-start chunk (no size history yet) and any
budget below the chunk's entropy floor (~28 kbps here — container
framing + the sidecar put a hard floor under a chunk's size no scale
can cross; rate.py's offline search hits the same wall).
"""

from __future__ import annotations

import argparse
import io
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain torch versions)")
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--chunk-blocks", type=int, default=32)
    args = ap.parse_args()

    import torch

    if not args.cpu and not torch.cuda.is_available():
        sys.exit("error: no CUDA device (pass --cpu to run on the CPU)")
    device = "cpu" if args.cpu else "cuda"

    from audiocodec_tpu_torch import metrics, serve
    from audiocodec_tpu_torch.codec import Codec
    from audiocodec_tpu_torch.io import stream_container as sc

    sr, n = 44100, 1024
    codec = Codec.create(sr, filters_n=n, bark_bands_n=64, device=device)
    chunk = args.chunk_blocks * n
    chunk_s = chunk / sr

    # program material: tonal bed + noise + periodic attacks
    rng = np.random.default_rng(0)
    samples = int(sr * args.seconds) // chunk * chunk
    t = np.arange(samples) / sr
    x = (0.3 * np.sin(2 * np.pi * 330 * t)
         + 0.1 * np.sin(2 * np.pi * 991 * t)
         + 0.04 * rng.standard_normal(samples))
    for s0 in range(sr // 2, samples - 2000, sr):
        hit = np.exp(-np.arange(1200) / 150.0) * rng.standard_normal(1200)
        x[s0 : s0 + 1200] += 0.5 * hit / np.abs(hit).max()
    x = np.clip(x, -1, 1).astype(np.float32)

    n_chunks = samples // chunk
    # link budget in kbps: slow congestion wave + one hard outage
    budget = 96 + 64 * np.sin(np.linspace(0, 3 * np.pi, n_chunks))
    budget[n_chunks // 2 : n_chunks // 2 + 2] = 24.0  # outage dip

    with serve.CodecServer(
        codec, sr, port=0, max_batch=4, max_wait_ms=5.0
    ) as server, serve.Client(port=server.port) as c:
        parts = [c.begin_stream(channels=1,
                                chunk_blocks=args.chunk_blocks,
                                cbr=True)]
        # secant controller in (log2 scale, kbps) — the same locally
        # linear model rate.py's offline search uses: estimate the
        # slope from the last two (scale, size) points and aim each
        # chunk at 90 % of the NEXT chunk's budget
        scale = 2.0
        history = []  # (log2 scale, kbps)
        print(f"{'chunk':>5} {'budget':>7} {'scale':>7} {'kbps':>7} fit")
        over = 0
        for k in range(n_chunks):
            blob = c.feed(x[k * chunk : (k + 1) * chunk][:, None],
                          threshold_scale=scale)
            parts.append(blob)
            kbps = len(blob) * 8 / chunk_s / 1000
            fit = kbps <= budget[k]
            over += not fit
            print(f"{k:>5} {budget[k]:>7.0f} {scale:>7.2f} {kbps:>7.1f} "
                  f"{'ok' if fit else 'OVER'}")
            history.append((np.log2(scale), kbps))
            target = 0.9 * (budget[k + 1] if k + 1 < n_chunks
                            else budget[k])
            if len(history) >= 2 and history[-1][0] != history[-2][0]:
                (l1, k1), (l2, k2) = history[-2], history[-1]
                slope = (k2 - k1) / (l2 - l1)  # kbps per doubling (<0)
                slope = min(slope, -5.0)
                l_next = history[-1][0] + (target - kbps) / slope
            else:
                l_next = history[-1][0] + (
                    1.5 if kbps > target else -0.5
                )
            # rate-limit the adaptation (max 2 doublings per chunk):
            # the secant is only locally valid, and a hard budget jump
            # would otherwise slingshot the scale far past it
            l_next = float(np.clip(
                l_next, history[-1][0] - 2.0, history[-1][0] + 2.0
            ))
            scale = float(np.clip(2.0 ** l_next, 0.25, 1024.0))
        parts.append(c.finish_stream())

    stream = b"".join(parts)
    total_kbps = len(stream) * 8 / (samples / sr) / 1000
    with torch.no_grad():
        dec = torch.cat(list(sc.decode_stream(codec, io.BytesIO(stream))),
                        dim=1)[:, n : n + samples]  # skip the framing pad
    xs = torch.from_numpy(x[None, :, None]).to(device)
    snr = float(metrics.snr_db(xs, dec))
    print(f"\nstream: {len(stream)} bytes (~{total_kbps:.0f} kbit/s "
          f"avg), {over}/{n_chunks} chunks over budget, decode SNR "
          f"{snr:.2f} dB — plays in ANY .acs decoder")


if __name__ == "__main__":
    main()
