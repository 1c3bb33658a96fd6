"""Neural model families built on the differentiable codec (counterpart
of ``audiocodec_tpu.models``; the RVQ codebooks are not ported)."""

from audiocodec_tpu_torch.models import post_filter, spectral_ae  # noqa: F401
from audiocodec_tpu_torch.models.post_filter import PostFilter  # noqa: F401
from audiocodec_tpu_torch.models.spectral_ae import (  # noqa: F401
    SpectralAE,
    init_params,
    make_train_step,
    perceptual_loss,
)
