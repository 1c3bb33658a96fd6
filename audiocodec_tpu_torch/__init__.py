"""audiocodec_tpu_torch — the PyTorch/CUDA port of audiocodec_tpu.

The quantized codec path, the noise-injection codec (MDCT, psychoacoustic
model, quantizer, masked noise) and training through the codec
(``quantize.quantize_ste``, ``parallel.train``, ``models``), with
hand-written Hopper kernels for the MDCT's analysis and synthesis (mono and
radix designs; each the other's backward) and for the masked noise. Every
entry point builds on the card unless the caller passes ``device="cpu"``.
It imports torch and numpy, never jax or audiocodec_tpu.
"""

from audiocodec_tpu_torch import quantize
from audiocodec_tpu_torch.codec import Codec
from audiocodec_tpu_torch.mdct import MDCT
from audiocodec_tpu_torch.psycho import PsychoacousticModel

__all__ = ["Codec", "MDCT", "PsychoacousticModel", "quantize"]
