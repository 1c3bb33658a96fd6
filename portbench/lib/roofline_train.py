"""The FLOPs of one training step of the RVQ neural codec, counted from
shapes (``traffic/train.py``'s step), as ``roofline.py`` counts the MDCT.

Each product is charged once, whatever the program does to compute it
(six bf16 passes, a recomputation, a search by distances): the MDCT's
analysis, synthesis and the synthesis's VJP (the gradient reaches the
decoder through it; the input has none); the masking model's Bark
products; the dense layers forward and backward (the weights' gradients,
and the inputs' but the first layer's, whose input is the spectrum); and
the 2 x S codebook searches (the forward's and the EMA step's), one [M, D]
x [D, K] product a stage. Elementwise work, the optimizer and the EMA
sums are left out.
"""

from __future__ import annotations

from portbench.lib import roofline


def step_flops(config: dict, params: dict) -> dict:
    """{part: FLOPs} of one step of the configuration ``config`` on a batch
    of ``params['clips']`` x ``params['samples']``."""
    n = config["filters_n"]
    rows = params["clips"] * config["channels"]
    blocks = params["samples"] // n
    frames = blocks + 1
    m = rows * frames  # latent vectors (frames x channels) a step
    bands = config["bark_bands_n"]
    ae, rvq = config["ae"], config["rvq"]
    widths = [(ae["filters_n"], ae["hidden_n"]), (ae["hidden_n"],
                                                  ae["latent_n"]),
              (ae["latent_n"], ae["hidden_n"]), (ae["hidden_n"],
                                                  ae["filters_n"])]
    forward = sum(2.0 * m * i * o for i, o in widths)
    first = 2.0 * m * widths[0][0] * widths[0][1]
    synthesis = roofline.mdct_synthesis(rows, frames, n)[0]
    return {
        "mdct": roofline.mdct_analysis(rows, blocks, n)[0] + 2 * synthesis,
        "bark": 2.0 * m * (2 * n * bands + bands * bands),
        "dense": forward + 2 * forward - first,
        "search": 2 * rvq["stages"] * 2.0 * m * rvq["dim"]
        * rvq["codebook_size"],
    }
