"""Scale-out (counterpart of ``audiocodec_tpu.parallel``): (dp, sp) meshes
of ``torch.device``s, sequence parallelism over a row's devices
(``parallel.sequence``), the corpus encode split over a mesh, the
prefetching corpus loaders (``parallel.pipeline``), the training step
(``mesh=`` shards it dp x sp and averages over a process group) and
multi-process initialization (``parallel.multihost``).
"""

from audiocodec_tpu_torch.parallel import multihost, sequence, train
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

__all__ = ["train", "multihost", "sequence", "TrainState", "init_state",
           "make_train_step", "perceptual_loss", "make_mesh", "pad_batch_to",
           "encode_corpus", "make_corpus_encoder"]
