#!/usr/bin/env python
"""Example: train the RVQ neural codec (models/rvq.py over spectral_ae).

The modern discrete-code bottleneck (SoundStream/EnCodec shape): MDCT
frames -> encoder MLP -> residual-vector-quantized latent (learned
codebooks, straight-through gradients, EMA k-means codebook updates) ->
decoder MLP -> frames, trained through the REAL differentiable codec
chain, data-parallel over every visible GPU.

  python examples/torch/train_rvq_codec.py [--steps 300] [--stages 4] [--cpu]

Prints train loss, then held-out reconstruction SNR from the PACKED
discrete codes and the true code rate (stages * log2(K) bits/frame).
"""

import argparse
import functools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def make_batch(rng, batch, samples, sr):
    t = np.arange(samples) / sr
    freqs = rng.uniform(200, 4000, size=(batch, 2))
    amps = rng.uniform(0.2, 0.45, size=(batch, 2))
    x = (
        amps[:, :1] * np.sin(2 * np.pi * freqs[:, :1] * t[None])
        + amps[:, 1:] * np.sin(2 * np.pi * freqs[:, 1:] * t[None])
        # dither stays BELOW the NMR floor: random noise is not
        # reproducible by a generative bottleneck, so audible-level
        # dither would put an unlearnable term in the perceptual loss
        + 0.002 * rng.normal(size=(batch, samples))
    )
    return x[:, :, None].astype(np.float32)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--warmup", type=int, default=500,
                        help="continuous-bottleneck steps before the "
                             "quantizer engages (prevents VQ collapse)")
    parser.add_argument("--filters-n", type=int, default=256)
    parser.add_argument("--latent-n", type=int, default=32)
    parser.add_argument("--stages", type=int, default=4)
    parser.add_argument("--codebook-size", type=int, default=256)
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
    from audiocodec_tpu_torch.models import rvq as _rvq
    from audiocodec_tpu_torch.models import spectral_ae as sae
    from audiocodec_tpu_torch.parallel import mesh as _mesh

    sr, n = 16000, args.filters_n
    codec = Codec.create(sr, filters_n=n, bark_bands_n=32, device=device)
    cfg = sae.SpectralAE(
        filters_n=n, hidden_n=16 * args.latent_n, latent_n=args.latent_n
    )
    rcfg = _rvq.RVQ(
        stages=args.stages, codebook_size=args.codebook_size,
        dim=args.latent_n,
    )
    print(
        f"RVQ bottleneck: {n} bands -> {rcfg.dim} dims, "
        f"{rcfg.stages}x{rcfg.codebook_size} codewords "
        f"({rcfg.bits_per_frame():.0f} bits/frame/ch ~= "
        f"{rcfg.bits_per_frame() * sr / n / 1000:.2f} kbit/s per channel; "
        f"scalar grid would cost {cfg.bits_per_frame():.0f} bits/frame)"
    )

    mesh = _mesh.make_mesh(devices=[device] if args.cpu else None)
    dp = mesh.shape["dp"]
    batch = _mesh.pad_batch_to(args.batch, dp)
    samples = 16 * n

    params = sae.init_params(torch.Generator(device=device).manual_seed(0),
                             cfg, device=device)
    rvq_state = _rvq.init_state(
        torch.Generator(device=device).manual_seed(1), rcfg, device=device)
    step, make_opt = _rvq.make_train_step(
        codec, cfg, rcfg, functools.partial(torch.optim.Adam, lr=1e-3),
        warmup_steps=args.warmup, mesh=mesh,
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
    reseeds = torch.Generator(device=device)
    for i in range(args.steps):
        sel = (i * batch) % corpus.shape[0]
        x = corpus[sel : sel + batch]
        loss = step(params, rvq_state, opt, x, reseeds.manual_seed(i), i)
        if i % 100 == 0 or i == args.steps - 1:
            tag = " (warmup)" if i < args.warmup else ""
            print(f"step {i:4d}  loss {float(loss):.6f}{tag}")

    # evaluation through the PACKED discrete code path on the corpus
    held = corpus[:4]
    codes = _rvq.encode_discrete(codec, cfg, rcfg, params, rvq_state, held)
    payload = _rvq.pack_codes(rcfg, codes.cpu().numpy())
    back = _rvq.unpack_codes(rcfg, payload, tuple(codes.shape))
    out = _rvq.decode_discrete(
        codec, cfg, rcfg, params, rvq_state, torch.from_numpy(back).to(device)
    )[:, n:-n]
    err = float(torch.sum((out - held) ** 2))
    snr = 10 * np.log10(float(torch.sum(held**2)) / max(err, 1e-30))
    true_kbps = len(payload) * 8 / (4 * samples / sr) / 1000
    print(
        f"packed-code reconstruction SNR: {snr:.2f} dB "
        f"at {true_kbps:.2f} kbit/s on-disk"
    )


if __name__ == "__main__":
    main()
