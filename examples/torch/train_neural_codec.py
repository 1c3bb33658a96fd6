#!/usr/bin/env python
"""Example: train the neural spectral autoencoder (models/spectral_ae.py).

A SoundStream-style bottleneck codec in the spectral domain: MDCT frames
-> encoder MLP -> quantizable low-dim latent -> decoder MLP -> frames,
trained end to end through the REAL differentiable codec chain (MDCT +
psychoacoustic masking threshold) with a waveform + noise-to-mask loss,
data-parallel over every visible GPU.

  python examples/torch/train_neural_codec.py [--steps 300] [--latent-n 16]
                                              [--cpu]

Prints train loss, then held-out reconstruction SNR and the discrete code
rate of the trained bottleneck.
"""

import argparse
import functools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def make_batch(rng, batch, samples, sr):
    """Sine mixtures — a stand-in for a real corpus loader (io/wav.py +
    parallel/pipeline.py feed real audio the same way). Dither stays
    below the perceptual loss's NMR floor: random noise is not
    reproducible by a generative bottleneck, so audible-level dither
    would put an unlearnable term in the loss."""
    t = np.arange(samples) / sr
    freqs = rng.uniform(200, 4000, size=(batch, 2))
    amps = rng.uniform(0.2, 0.45, size=(batch, 2))
    x = (
        amps[:, :1] * np.sin(2 * np.pi * freqs[:, :1] * t[None])
        + amps[:, 1:] * np.sin(2 * np.pi * freqs[:, 1:] * t[None])
        + 0.002 * rng.normal(size=(batch, samples))
    )
    return x[:, :, None].astype(np.float32)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=800)
    parser.add_argument("--filters-n", type=int, default=256)
    parser.add_argument("--latent-n", type=int, default=32)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--clips", type=int, default=16,
                        help="size of the fixed training corpus")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain torch "
                             "versions)")
    args = parser.parse_args()

    import torch

    if not args.cpu and not torch.cuda.is_available():
        sys.exit("error: no CUDA device (pass --cpu to run on the CPU)")
    device = "cpu" if args.cpu else "cuda"

    from audiocodec_tpu_torch.codec import Codec
    from audiocodec_tpu_torch.models import spectral_ae as sae
    from audiocodec_tpu_torch.parallel import mesh as _mesh

    sr, n = 16000, args.filters_n
    codec = Codec.create(sr, filters_n=n, bark_bands_n=32, device=device)
    cfg = sae.SpectralAE(
        filters_n=n, hidden_n=16 * args.latent_n, latent_n=args.latent_n
    )
    print(
        f"bottleneck: {n} bands -> {cfg.latent_n} dims "
        f"({cfg.bits_per_frame():.0f} bits/frame/ch ~= "
        f"{cfg.bits_per_frame() * sr / n / 1000:.1f} kbit/s per channel)"
    )

    mesh = _mesh.make_mesh(devices=[device] if args.cpu else None)
    dp = mesh.shape["dp"]
    batch = _mesh.pad_batch_to(args.batch, dp)
    samples = 16 * n

    init = torch.Generator(device=device).manual_seed(0)
    params = sae.init_params(init, cfg, device=device)
    step, make_opt = sae.make_train_step(
        codec, cfg, functools.partial(torch.optim.Adam, lr=1e-3),
        mesh=mesh,
    )
    opt = make_opt(list(params.values()))

    # a fixed finite corpus trained over epochs (how a real corpus-loader
    # run looks) — per-frame spectral MLPs generalize poorly to unseen
    # random phases, so an infinite fresh-batch stream never converges
    rng = np.random.default_rng(0)
    corpus = torch.from_numpy(np.concatenate(
        [make_batch(rng, batch, samples, sr)
         for _ in range(max(1, args.clips // batch))]
    )).to(device)
    noise = torch.Generator(device=device)
    for i in range(args.steps):
        sel = (i * batch) % corpus.shape[0]
        x = corpus[sel : sel + batch]
        loss = step(params, opt, x, noise.manual_seed(i))
        if i % 100 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.6f}")

    # evaluation with the DISCRETE (rounded) latent code on the corpus
    held = corpus[:4]
    with torch.no_grad():
        spec = codec.mdct.transform(held)
        recon = sae.apply(cfg, params, spec, quantized=True)
        out = codec.mdct.inverse_transform(recon)[:, n:-n]
    err = float(torch.sum((out - held) ** 2))
    snr = 10 * np.log10(float(torch.sum(held**2)) / max(err, 1e-30))
    print(f"quantized-latent reconstruction SNR: {snr:.2f} dB")


if __name__ == "__main__":
    main()
