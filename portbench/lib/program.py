"""The system under test, built from a configuration file."""

from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32}


def codec(config: dict, device):
    """``Codec.create`` of the configuration, as the command line's
    ``_build_codec`` builds it."""
    from audiocodec_tpu_torch.codec import Codec

    return Codec.create(
        sample_rate=config["sample_rate"],
        filters_n=config["filters_n"],
        bark_bands_n=config["bark_bands_n"],
        alpha=config["alpha"],
        window_type=config["window_type"],
        compute_dtype=DTYPES[config["compute_dtype"]],
        dct_precision=config["dct_precision"],
        kernel_design=config["kernel_design"],
        sidecar_grid=config["sidecar_grid"],
        device=device,
    )
