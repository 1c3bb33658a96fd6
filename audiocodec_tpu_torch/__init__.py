"""audiocodec_tpu_torch — the PyTorch/CUDA port of audiocodec_tpu.

The quantized codec path, the noise-injection codec (MDCT, psychoacoustic
model in parity and calibrated modes, temporal masking, quantizer, masked
noise), training through the codec (``quantize.quantize_ste``,
``parallel.train``, ``models``), the discrete RVQ codec (``models.rvq``) and
the int8 probe (``probes.int8_probe``), with hand-written Hopper kernels for
the MDCT's analysis and synthesis (mono and radix designs; each the other's
backward), for the masked noise and for the probe's three GEMM bodies. Every
entry point builds on the card unless the caller passes ``device="cpu"``.
It imports torch and numpy, never jax or audiocodec_tpu.
"""

from audiocodec_tpu_torch import quantize
from audiocodec_tpu_torch.codec import Codec
from audiocodec_tpu_torch.mdct import MDCT
from audiocodec_tpu_torch.psycho import PsychoacousticModel

__all__ = ["Codec", "MDCT", "PsychoacousticModel", "quantize"]
