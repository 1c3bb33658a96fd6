"""Audio I/O of the port: WAV read/write (``wav``), the ``.acz``
container (``bitstream``) and the seekable ``.acs`` stream container
(``stream_container``)."""

from audiocodec_tpu_torch.io.wav import read_wav, write_wav

__all__ = ["read_wav", "write_wav"]
