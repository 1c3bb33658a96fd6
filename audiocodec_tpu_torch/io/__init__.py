"""Audio I/O of the port: WAV read/write (``wav``) and the ``.acz``
container (``bitstream``)."""

from audiocodec_tpu_torch.io.wav import read_wav, write_wav

__all__ = ["read_wav", "write_wav"]
