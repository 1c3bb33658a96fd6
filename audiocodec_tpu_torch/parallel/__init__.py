"""Scale-out on the devices of one process (counterpart of
``audiocodec_tpu.parallel``): (dp, sp) meshes of ``torch.device``s, the
corpus encode split data-parallel over them, the prefetching corpus
loaders (``parallel.pipeline``), and the training step on one device.

Not ported yet: ``multihost``, sequence parallelism (``sp`` > 1, refused by
``make_mesh``), and the ``mesh`` argument of the training steps (sharded
training on ``torch.distributed``).
"""

from audiocodec_tpu_torch.parallel import train
from audiocodec_tpu_torch.parallel.corpus import (
    encode_corpus,
    make_corpus_encoder,
)
from audiocodec_tpu_torch.parallel.mesh import make_mesh, pad_batch_to
from audiocodec_tpu_torch.parallel.train import (
    TrainState,
    init_state,
    make_train_step,
    perceptual_loss,
)

__all__ = ["train", "TrainState", "init_state", "make_train_step",
           "perceptual_loss", "make_mesh", "pad_batch_to", "encode_corpus",
           "make_corpus_encoder"]
