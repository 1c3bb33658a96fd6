"""audiocodec_tpu_torch — the PyTorch/CUDA port of audiocodec_tpu.

The quantized codec path, the bitstream path with its feature ladder
(``Codec.encode_frames`` -> ``EncodedFrames`` -> ``decode_bitstream[_ms]``:
the scq sidecar grid, TNS, block switching, noise fill, bandwidth extension
and intensity stereo), long-form streaming (``streaming``: the chunked
MDCT with carried state; ``io.stream_container``: the seekable ``.acs``
container with seek, FEC, DTX, concealment and ABR/CBR rate control),
lossless archival (``lossless``), quality metrics and BS.1770 loudness
(``metrics``), polyphase resampling (``resample``), the command line
(``python -m audiocodec_tpu_torch``: encode, decode, roundtrip, eval,
resample, info), the reference library's signatures (``compat``),
profiler spans and traces (``utils.profiling``), non-finite checks
(``utils.debug``), the noise-injection codec (MDCT, psychoacoustic model in parity and calibrated
modes, temporal masking, quantizer, masked noise), training through the codec (``quantize.quantize_ste``,
``parallel.train``, ``models``), the discrete RVQ codec (``models.rvq``) and
the int8 probe (``probes.int8_probe``), with hand-written Hopper kernels for
the MDCT's analysis and synthesis (mono and radix designs; each the other's
backward), for the masked noise and for the probe's three GEMM bodies. Every
entry point builds on the card unless the caller passes ``device="cpu"``.
It imports torch and numpy, never jax or audiocodec_tpu.
"""

from audiocodec_tpu_torch.codec import Codec, EncodedFrames
from audiocodec_tpu_torch.mdct import MDCT
from audiocodec_tpu_torch.psycho import PsychoacousticModel
from audiocodec_tpu_torch.resample import Resampler
from audiocodec_tpu_torch import lossless
from audiocodec_tpu_torch import metrics
from audiocodec_tpu_torch import nf
from audiocodec_tpu_torch import quantize
from audiocodec_tpu_torch import tns

__version__ = "0.4.0"  # keep in sync with pyproject.toml

__all__ = [
    "Codec", "EncodedFrames", "MDCT", "PsychoacousticModel", "Resampler",
    "lossless", "metrics", "nf", "quantize", "tns",
    "__version__",
]
