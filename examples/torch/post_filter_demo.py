#!/usr/bin/env python
"""Example: train the MDCT-domain decoder post-filter and measure the gain.

Encodes audio at a coarse (low-bitrate) quantization scale, trains the
post-filter (models/post_filter.py) against the real codec chain, then
compares held-out decode SNR with and without enhancement.

  python examples/torch/post_filter_demo.py [--steps 400] [--scale 8] [--cpu]

Gains are strongest where the filter has structure to exploit: coarse
scales and narrow-band tonal content. Wider N spreads the tones over more
near-silent bins and needs longer training / richer data to match. The
MDCT kernels take N in multiples of 256 (``--filters-n 256``); the default
N=64 runs the MDCT's plain torch path on the GPU too.
"""

import argparse
import functools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def tonal_batch(rng, batch, samples, sr):
    f = rng.uniform(300, 3000, (batch, 2))
    a = rng.uniform(0.2, 0.4, (batch, 2))
    ph = rng.uniform(0, 2 * np.pi, (batch, 2))
    t = np.arange(samples)
    x = sum(
        a[:, i : i + 1] * np.sin(2 * np.pi * f[:, i : i + 1] / sr * t[None]
                                 + ph[:, i : i + 1])
        for i in range(2)
    )
    return x[:, :, None].astype(np.float32)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--scale", type=float, default=8.0,
                        help="threshold scale (higher = coarser/lower rate)")
    parser.add_argument("--filters-n", type=int, default=64)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain torch "
                             "versions)")
    args = parser.parse_args()

    import torch

    if not args.cpu and not torch.cuda.is_available():
        sys.exit("error: no CUDA device (pass --cpu to run on the CPU)")
    device = "cpu" if args.cpu else "cuda"

    from audiocodec_tpu_torch import quantize as _q
    from audiocodec_tpu_torch.codec import Codec
    from audiocodec_tpu_torch.models import post_filter as pf
    from audiocodec_tpu_torch.parallel import mesh as _mesh

    sr, n = 16000, args.filters_n
    codec = Codec.create(sr, filters_n=n, bark_bands_n=32, device=device)
    cfg = pf.PostFilter(filters_n=n, hidden_n=2 * n)
    mesh = _mesh.make_mesh(devices=[device] if args.cpu else None)
    step, make_opt = pf.make_train_step(
        codec, cfg, functools.partial(torch.optim.Adam, lr=1e-3),
        threshold_scale=args.scale, mesh=mesh,
    )
    params = pf.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg, device=device)
    opt = make_opt(list(params.values()))

    samples = 16 * n
    batch = _mesh.pad_batch_to(8, mesh.shape["dp"])
    for i in range(args.steps):
        rng = np.random.default_rng(i)
        x = torch.from_numpy(tonal_batch(rng, batch, samples, sr)).to(device)
        loss = step(params, opt, x)
        if i % 100 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.6f}")

    held = torch.from_numpy(
        tonal_batch(np.random.default_rng(9999), 4, samples, sr)).to(device)
    with torch.no_grad():
        spec = codec.mdct.transform(held)
        thr = codec.psycho.global_masking_threshold(
            spec, codec.psycho.tonality(spec)
        ) * args.scale
        codes, delta = _q.quantize(spec, thr)
        raw_out = codec.decode_quantized(codes, delta)
        enh_out = pf.decode_enhanced(codec, cfg, params, codes, delta)

    def snr(decoded):
        out = decoded.cpu().numpy()[:, n:-n]
        ref = held.cpu().numpy()
        return 10 * np.log10(
            (ref**2).sum() / max(((ref - out) ** 2).sum(), 1e-30)
        )

    raw = snr(raw_out)
    enh = snr(enh_out)
    print(f"held-out decode SNR at {args.scale}x threshold scale: "
          f"raw {raw:.2f} dB -> enhanced {enh:.2f} dB (+{enh - raw:.2f})")


if __name__ == "__main__":
    main()
