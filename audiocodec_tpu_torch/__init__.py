"""audiocodec_tpu_torch — the PyTorch/CUDA port of audiocodec_tpu.

The quantized codec path and the noise-injection codec (MDCT,
psychoacoustic model, quantizer, masked noise) with hand-written Hopper
kernels for the MDCT's analysis and synthesis (mono and radix designs) and
for the masked noise. It imports torch and numpy, never jax or
audiocodec_tpu.
"""

from audiocodec_tpu_torch import quantize
from audiocodec_tpu_torch.codec import Codec
from audiocodec_tpu_torch.mdct import MDCT
from audiocodec_tpu_torch.psycho import PsychoacousticModel

__all__ = ["Codec", "MDCT", "PsychoacousticModel", "quantize"]
