#!/usr/bin/env python
"""Example: train through the codec (the differentiable-pipeline use case).

The reference exists to slot a codec into neural audio pipelines (its two
ops are differentiable @tf.function graphs); this example shows the
framework's version of that story end to end: learn per-band spectral
gains that undo a simulated channel tilt, with gradients flowing through
the MDCT, the psychoacoustic masking threshold, and the straight-through
quantizer — split over every visible GPU (a dp mesh).

  python examples/torch/train_spectral_gains.py [--steps 200] [--cpu]
"""

import argparse
import functools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--filters-n", type=int, default=256)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the kernels' plain torch "
                             "versions)")
    args = parser.parse_args()

    import torch

    if not args.cpu and not torch.cuda.is_available():
        sys.exit("error: no CUDA device (pass --cpu to run on the CPU)")
    device = "cpu" if args.cpu else "cuda"

    from audiocodec_tpu_torch.codec import Codec
    from audiocodec_tpu_torch.parallel import mesh as _mesh
    from audiocodec_tpu_torch.parallel import train as _train

    n = args.filters_n
    sr = 16000
    codec = Codec.create(sr, filters_n=n, bark_bands_n=32, device=device)
    mesh = _mesh.make_mesh(devices=[device] if args.cpu else None)
    n_devices = mesh.shape["dp"] * mesh.shape["sp"]
    print(f"devices: {n_devices}, mesh: {mesh.shape}")

    # a toy "channel": the input arrives spectrally tilted; the gains must
    # learn to flatten it so the decoded waveform matches the clean target
    rng = np.random.default_rng(0)
    batch = _mesh.pad_batch_to(max(8, n_devices), mesh.shape["dp"])
    clean = rng.uniform(-0.6, 0.6, (batch, 32 * n, 1)).astype(np.float32)
    x = torch.from_numpy(clean).to(device)

    optimizer = functools.partial(torch.optim.Adam, lr=3e-2)
    train_step, optimizer = _train.make_train_step(codec, optimizer,
                                                   mesh=mesh)
    state = _train.init_state(codec, optimizer)
    # start deliberately mis-gained
    with torch.no_grad():
        state.gains.mul_(0.4)

    for step in range(args.steps):
        loss = train_step(state, x)
        if step % max(args.steps // 10, 1) == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {float(loss):.6f}  "
                  f"mean gain {float(state.gains.detach().mean()):.3f}")

    final = float(state.gains.detach().mean())
    print(f"final mean gain: {final:.3f} (target ~1.0)")


if __name__ == "__main__":
    main()
