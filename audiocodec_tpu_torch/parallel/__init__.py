"""Training on one device (counterpart of ``audiocodec_tpu.parallel``;
the meshes, the sharded corpus encode and multi-device training are not
ported)."""

from audiocodec_tpu_torch.parallel import train
from audiocodec_tpu_torch.parallel.train import (
    TrainState,
    init_state,
    make_train_step,
    perceptual_loss,
)

__all__ = ["train", "TrainState", "init_state", "make_train_step",
           "perceptual_loss"]
