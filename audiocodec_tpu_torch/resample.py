"""Polyphase sample-rate conversion (counterpart of
``audiocodec_tpu/resample.py``).

A rational-ratio (L/M) windowed-sinc polyphase resampler: for output rate
L/M times the input rate (L, M coprime), the zero-stuff -> lowpass ->
decimate pipeline collapses to ``y[bL+i] = sum_u h[iM - uL + c] *
x[bM + u]`` — every block of M input samples produces L output samples
through one [W_in, L] matrix of filter taps (c centers the filter so
output n sits at time n*M/L). The windows of W_in samples at stride M are
a view of the padded input (``unfold``), so the whole conversion is one
product of that view with the taps, at one of the port's precision tiers
(``ops/dct.matmul``: ``highest`` keeps TF32 off, ``default`` rounds the
operands to bfloat16). No zero-stuffed intermediate at rate fs*L; the
product does copy the windows, W_in/M times the input (1.2x from 44.1 to
48 kHz, 32x from 48 to 16 kHz).

The prototype lowpass is a Kaiser-windowed sinc designed in numpy float64
on the host and downcast once; cutoff min(fs_in, fs_out)/2 with unity
passband gain. Quality defaults (zeros=16 sinc zero-crossings, Kaiser
beta 8.6) give a ~90 dB stopband and <0.01 dB passband ripple.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from audiocodec_tpu_torch.ops.dct import PRECISIONS, matmul
from audiocodec_tpu_torch.utils import dtypes as _dtypes


def _taps(up: int, down: int, zeros: int, beta: float) -> tuple:
    """The float64 [L, W_in] tap matrix of an L/M resampler and its
    left pad (-u_min)."""
    # In the fs_in*L domain: cutoff at min Nyquist, gain L to undo the
    # zero-stuffing loss, Kaiser window for the stopband.
    half = zeros * max(up, down)  # taps per side at the upsampled rate
    t_total = 2 * half + 1
    k = np.arange(t_total, dtype=np.float64)
    cutoff = 1.0 / max(up, down)  # as a fraction of fs_in*L Nyquist
    h = up * cutoff * np.sinc(cutoff * (k - half))
    h = h * np.kaiser(t_total, beta)

    # y[bL+i] = sum_u h[iM - uL + c] x[bM+u], c = half. Global u-range
    # over i in [0, L): u_min = ceil(-c/L), u_max = floor(((L-1)M+c)/L).
    c = half
    u_min = math.ceil(-c / up)
    u_max = math.floor(((up - 1) * down + c) / up)
    window_n = u_max - u_min + 1
    mat = np.zeros((up, window_n), dtype=np.float64)
    u = np.arange(u_min, u_max + 1)
    for i in range(up):
        idx = i * down - u * up + c
        valid = (idx >= 0) & (idx < t_total)
        mat[i, valid] = h[idx[valid]]
    return mat, -u_min


@dataclasses.dataclass(frozen=True)
class Resampler:
    """Polyphase rational resampler. Build with :meth:`create`; apply with
    :meth:`resample`.

    :param sr_in: input sample rate in Hz.
    :param sr_out: output sample rate in Hz.
    :param up: interpolation factor L = sr_out / gcd.
    :param down: decimation factor M = sr_in / gcd.
    :param pad_left: zeros prepended so the first window's context exists.
    :param window_n: input window W_in feeding each L-sample output block.
    :param zeros: sinc zero-crossings per side (filter quality).
    :param beta: Kaiser window beta.
    :param kernel: [L, 1, W_in] taps in ``compute_dtype`` on the device
        (the JAX package's conv layout).
    """

    sr_in: int
    sr_out: int
    up: int
    down: int
    pad_left: int
    window_n: int
    zeros: int
    beta: float
    compute_dtype: torch.dtype
    precision: str
    kernel: torch.Tensor

    @classmethod
    def create(
        cls,
        sr_in: int,
        sr_out: int,
        *,
        zeros: int = 16,
        beta: float = 8.6,
        compute_dtype=torch.float32,
        precision: str = "highest",
        device="cuda",
    ) -> "Resampler":
        """Design the taps on the host and place them on ``device``: the
        card unless the caller asks for the CPU."""
        if sr_in <= 0 or sr_out <= 0:
            raise ValueError(
                f"sample rates must be positive, got {sr_in} -> {sr_out}"
            )
        if precision not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {sorted(PRECISIONS)}, "
                f"got {precision!r}"
            )
        dtype = _dtypes.canonicalize_compute_dtype(compute_dtype)
        g = math.gcd(sr_in, sr_out)
        up, down = sr_out // g, sr_in // g
        if up == down:
            # identity: resample() short-circuits; a 1-tap kernel keeps
            # the object well-formed
            kernel = torch.ones((1, 1, 1), dtype=dtype, device=device)
            return cls(
                sr_in=sr_in, sr_out=sr_out, up=1, down=1, pad_left=0,
                window_n=1, zeros=zeros, beta=beta, compute_dtype=dtype,
                precision=precision, kernel=kernel,
            )
        if max(up, down) > 1024:
            raise ValueError(
                f"rate ratio {sr_out}/{sr_in} reduces to {up}/{down}; "
                "phases > 1024 would need an impractically large filter "
                "bank — resample in two stages or pick related rates"
            )
        mat, pad_left = _taps(up, down, zeros, beta)
        kernel = torch.from_numpy(mat[:, None, :]).to(device, dtype)
        return cls(
            sr_in=sr_in, sr_out=sr_out, up=up, down=down,
            pad_left=pad_left, window_n=mat.shape[1], zeros=zeros,
            beta=beta, compute_dtype=dtype, precision=precision,
            kernel=kernel,
        )

    def out_length(self, samples_n: int) -> int:
        """Output sample count for an input of ``samples_n`` samples."""
        return samples_n * self.up // self.down

    def _blocks(self, rows: torch.Tensor, n_blocks: int) -> torch.Tensor:
        """rows [R, >= (n_blocks-1)*M + W_in] (window 0 at index 0) ->
        [R, n_blocks*L]: each window of W_in samples at stride M times the
        taps."""
        win = rows.unfold(1, self.window_n, self.down)[:, :n_blocks]
        y = matmul(win, self.kernel[:, 0, :].T, self.precision)
        return y.to(rows.dtype).reshape(rows.shape[0], n_blocks * self.up)

    def resample(self, x: torch.Tensor) -> torch.Tensor:
        """[B, samples, C] at sr_in -> [B, out_length(samples), C] at
        sr_out. Output sample n sits at input time n*down/up (the filter's
        group delay is compensated), so a resampled pure tone aligns with
        its analytic counterpart.
        """
        if x.ndim != 3:
            raise ValueError(
                f"expected [batch, samples, channels], got shape "
                f"{tuple(x.shape)}"
            )
        _dtypes.check_input_dtype(x, self.compute_dtype, "resample input")
        if self.up == self.down:
            return x
        b, s, ch = x.shape
        out_n = self.out_length(s)
        n_blocks = -(-out_n // self.up)  # blocks of L output samples
        # the windows must cover [u_min, (n_blocks-1)*M + u_max]
        need = (n_blocks - 1) * self.down + self.window_n
        pad_right = max(0, need - (s + self.pad_left))
        rows = x.permute(0, 2, 1).reshape(b * ch, s)
        rows = torch.nn.functional.pad(rows, (self.pad_left, pad_right))
        y = self._blocks(rows, n_blocks)[:, :out_n]
        return y.reshape(b, ch, out_n).permute(0, 2, 1)


def resample_waveform(
    x: torch.Tensor, sr_in: int, sr_out: int, **kwargs
) -> torch.Tensor:
    """One-shot convenience: build a :class:`Resampler` on x's device and
    apply it."""
    kwargs.setdefault("device", x.device)
    return Resampler.create(sr_in, sr_out, **kwargs).resample(x)


class StreamingResampler:
    """Chunked front end of :class:`Resampler`.

    Feed arbitrary-length chunks with :meth:`step`; the internal buffer
    carries the filter history and the rational-phase position, so the
    concatenated outputs equal the one-shot :meth:`Resampler.resample`
    of the concatenated inputs exactly (the same tap matrix sees the
    same window values). :meth:`flush` zero-pads the tail and emits the
    remaining samples so the total output length is exactly
    ``out_length(total_input)``. The buffer stays on the resampler's
    device.
    """

    def __init__(self, resampler: Resampler):
        self._r = resampler
        self._buf = None  # [B, buffered, C] in compute dtype
        self._in_total = 0
        self._out_total = 0

    def _identity(self):
        return self._r.up == self._r.down

    def step(self, chunk: torch.Tensor) -> torch.Tensor:
        """Consume a [B, s, C] chunk; return all output samples that are
        now fully determined (possibly zero-length on short chunks)."""
        r = self._r
        if chunk.ndim != 3:
            raise ValueError(
                f"expected [batch, samples, channels], got "
                f"{tuple(chunk.shape)}"
            )
        _dtypes.check_input_dtype(chunk, r.compute_dtype, "chunk")
        if self._identity():
            self._in_total += chunk.shape[1]
            self._out_total += chunk.shape[1]
            return chunk
        chunk = chunk.to(r.kernel.device)
        if self._buf is None:
            # buffer index 0 is stream position u_min (= -pad_left):
            # block b's window is buf[b*M : b*M + W_in] forever after
            b, _, ch = chunk.shape
            self._buf = chunk.new_zeros((b, r.pad_left, ch))
        self._buf = torch.cat([self._buf, chunk], dim=1)
        self._in_total += chunk.shape[1]
        return self._drain()

    def _drain(self) -> torch.Tensor:
        r = self._r
        n_blocks = (self._buf.shape[1] - r.window_n) // r.down + 1
        b, _, ch = self._buf.shape
        if n_blocks <= 0:
            return self._buf.new_zeros((b, 0, ch))
        rows = self._buf.permute(0, 2, 1).reshape(b * ch, -1)
        y = r._blocks(rows, n_blocks)
        self._buf = self._buf[:, n_blocks * r.down :]
        self._out_total += n_blocks * r.up
        return y.reshape(b, ch, -1).permute(0, 2, 1)

    def flush(self) -> torch.Tensor:
        """Zero-pad and emit the buffered tail; total output is trimmed
        to exactly ``out_length(total_input)``. Resets the stream."""
        r = self._r
        if self._identity() or self._buf is None:
            self._buf = None
            self._in_total = self._out_total = 0
            return r.kernel.new_zeros((1, 0, 1))
        want = r.out_length(self._in_total)
        missing = want - self._out_total
        b, _, ch = self._buf.shape
        if missing > 0:
            # enough zeros that _drain covers the remaining blocks
            need_blocks = -(-missing // r.up)
            pad = (
                (need_blocks - 1) * r.down + r.window_n
                - self._buf.shape[1]
            )
            if pad > 0:
                self._buf = torch.cat(
                    [self._buf, self._buf.new_zeros((b, pad, ch))], dim=1
                )
            out = self._drain()[:, :missing]
        else:
            out = self._buf.new_zeros((b, 0, ch))
        self._buf = None
        self._in_total = self._out_total = 0
        return out
