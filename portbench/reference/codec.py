"""Plain reference of the codec's lossy path, in PyTorch.

Imports nothing of the program. The MDCT is the dense two-matrix form of the
windowed filter bank (Princen-Bradley window with its completion rule, a
diamond fold and an orthonormal DCT-IV scaled by 1/sqrt(4N) forward and
sqrt(4N) back); the psychoacoustic model is Zolzer's Bark-domain masking
(ch. 9: spectral flatness tonality, spreading function with the alpha
exponent, threshold in quiet); the quantizer is a mid-tread rounder with step
threshold / sqrt(3); the sidecar is the Bark intensity snapped to 2^(l/k2)
and rounded to bfloat16. The host builders below are frozen copies of plain
numpy code (docs/DESIGN.md), computed in float64.

Precision: ``dtype`` float64 is the reference. float32 with ``tf32`` on is
the lower-precision control (TF32 products for float32 work with TF32 off).
"""

from __future__ import annotations

import math

import numpy as np
import torch

DB_MAX = 120.0
EPS = 1e-14
OCT_MIN, OCT_MAX = -52, 12  # the sidecar grid's bounds in octaves


def window(n: int):
    """(first 3N/2 vorbis window coefficients, the completion ff [N/2])."""
    t = np.arange(0.5, (3 * n) // 2 + 0.5, dtype=np.float64)
    w = np.sin(np.pi / 2.0 * np.sin(np.pi / (2.0 * n) * t) ** 2)
    i = np.arange(n // 2)
    ff = ((1.0 - w[n + i] * w[n - 1 - i]) / w[i])[::-1].copy()
    return w, ff


def fold_matrix(n: int) -> np.ndarray:
    """The diamond fold F [N, N]: folded[m] = x[m] @ H0 + x[m-1] @ H1."""
    w, ff = window(n)
    h = n // 2
    f = np.zeros((n, n))
    i = np.arange(h)
    f[i, h - 1 - i] = w[i]
    f[h + i, i] = w[h + i]
    f[i, h + i] = w[n + i]
    f[h + i, n - 1 - i] = -ff[i]
    return f


def dct4(n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64) + 0.5
    return np.sqrt(2.0 / n) * np.cos(np.pi / n * np.outer(k, k))


def freq2bark(f):
    return 6.0 * np.arcsinh(np.asarray(f) / 600.0)


def bark2freq(b):
    return 600.0 * np.sinh(np.asarray(b) / 6.0)


def bark_matrices(sample_rate: float, n: int, bands: int):
    """(W [N, bands], W_inv [bands, N]): overlap of filter and Bark bands."""
    fmax = sample_rate / 2.0
    bw = freq2bark(fmax) / bands
    fw = fmax / n
    b = np.arange(bands, dtype=np.float64)[None, :]
    f = np.arange(n, dtype=np.float64)[:, None]
    lo_hz, hi_hz = bark2freq(bw * b), bark2freq(bw * (b + 1.0))
    overlap = np.clip(hi_hz, fw * f, fw * f + fw) - np.clip(lo_hz, fw * f,
                                                            fw * f + fw)
    return overlap / fw, (overlap / (hi_hz - lo_hz)).T


def spreading(bands: int, max_bark: float, alpha: float) -> np.ndarray:
    z = np.linspace(-max_bark, max_bark, 2 * bands)
    s = 15.81 + 7.5 * (z + 0.474) - 17.5 * np.sqrt(1.0 + (z + 0.474) ** 2)
    inten = 10.0 ** (alpha * s / 10.0)
    idx = (bands - np.arange(bands))[:, None] + np.arange(bands)[None, :]
    return inten[idx]


def quiet(bands: int, max_bark: float) -> np.ndarray:
    db_min = 10.0 * math.log10(EPS) + DB_MAX
    mid = max_bark / bands * (np.arange(bands) + 0.5)
    khz = bark2freq(mid) / 1000.0
    db = np.clip(3.64 * khz ** -0.8 - 6.5 * np.exp(-0.6 * (khz - 3.3) ** 2)
                 + 1e-3 * khz ** 4, db_min, DB_MAX)
    return 10.0 ** ((db - DB_MAX) / 10.0)


class Reference:
    """The codec of one configuration (a ``configs/*.json`` dict) on
    ``device`` at ``dtype``; ``tf32`` lets float32 products run in TF32."""

    def __init__(self, config: dict, device, dtype=torch.float64,
                 tf32: bool = False):
        n = int(config["filters_n"])
        if config.get("window_type", "vorbis") != "vorbis":
            raise ValueError("the reference implements the vorbis window")
        self.n = n
        self.k2 = int(config["sidecar_grid"])
        self.alpha = float(config["alpha"])
        self.device = torch.device(device)
        self.dtype = dtype
        self.tf32 = tf32
        sr = float(config["sample_rate"])
        bands = int(config["bark_bands_n"])
        f = fold_matrix(n)
        g = np.linalg.inv(f)
        d = dct4(n)
        s = math.sqrt(4.0 * n)
        h = n // 2
        h0, h1 = f.copy(), f.copy()
        h0[:, :h] = 0.0
        h1[:, h:] = 0.0
        g0, g1 = g.copy(), g.copy()
        g0[h:, :] = 0.0
        g1[:h, :] = 0.0
        max_bark = float(freq2bark(sr / 2.0))
        w, w_inv = bark_matrices(sr, n, bands)

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=self.device)

        self.a_cur, self.a_prev = t(h0 @ d / s), t(h1 @ d / s)
        self.s_cur, self.s_prev = t(d @ g0 * s), t(d @ g1 * s)
        self.w, self.w_inv = t(w), t(w_inv)
        self.spread = t(spreading(bands, max_bark, self.alpha))
        self.quiet = t(quiet(bands, max_bark))
        self.grid = t(np.linspace(0.0, max_bark, bands))
        lo, hi = OCT_MIN * self.k2, OCT_MAX * self.k2
        self.lo = lo
        table = torch.as_tensor(2.0 ** (np.arange(lo, hi + 1) / self.k2))
        # the wire's values: the grid rounded to bfloat16
        self.table = t(table.to(torch.bfloat16).to(torch.float64).numpy())

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if a.is_cuda:
            torch.backends.cuda.matmul.allow_tf32 = self.tf32
        return a @ b

    # -- filter bank ------------------------------------------------------

    def analysis(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S, C] (S a multiple of N) -> frames [B, S/N + 1, N, C]."""
        b, s, c = x.shape
        xb = x.to(self.device, self.dtype).permute(0, 2, 1).reshape(
            b, c, s // self.n, self.n)
        zero = torch.zeros_like(xb[:, :, :1])
        y = (self._mm(torch.cat([xb, zero], 2), self.a_cur)
             + self._mm(torch.cat([zero, xb], 2), self.a_prev))
        return y.permute(0, 2, 3, 1)

    def frames(self, x: torch.Tensor, first: int, count: int) -> torch.Tensor:
        """Frames first..first+count-1 of the whole signal x [B, S, C]:
        frame m covers blocks m-1 and m, blocks outside x are zeros."""
        n = self.n
        blocks = x.shape[1] // n
        lo, hi = first - 1, first + count - 1  # blocks needed, inclusive
        seg = x[:, max(lo, 0) * n:min(hi + 1, blocks) * n]
        pad_lo = n * (max(lo, 0) - lo)
        pad_hi = n * (hi + 1 - min(hi + 1, blocks))
        seg = torch.nn.functional.pad(
            seg.to(self.device, self.dtype).permute(0, 2, 1),
            (pad_lo, pad_hi)).permute(0, 2, 1)
        return self.analysis(seg)[:, 1:1 + count]

    def synthesis(self, y: torch.Tensor) -> torch.Tensor:
        """frames [B, T, N, C] -> [B, (T + 1) N, C]."""
        b, t, n, c = y.shape
        yb = y.to(self.device, self.dtype).permute(0, 3, 1, 2)
        zero = torch.zeros_like(yb[:, :, :1])
        out = (self._mm(torch.cat([yb, zero], 2), self.s_cur)
               + self._mm(torch.cat([zero, yb], 2), self.s_prev))
        return out.reshape(b, c, (t + 1) * n).permute(0, 2, 1)

    # -- psychoacoustic model ---------------------------------------------

    def _bark(self, a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        """Contract the band axis (2) of [B, T, bands, C] with m."""
        return self._mm(a.transpose(2, 3), m).transpose(2, 3)

    def bark_intensity(self, spec: torch.Tensor) -> torch.Tensor:
        """Global masking intensity per Bark band [B, T, bands, C]."""
        inten = spec ** 2
        geo = torch.exp(torch.mean(torch.log(torch.clamp_min(inten, EPS)),
                                   dim=2, keepdim=True))
        arith = torch.mean(inten, dim=2, keepdim=True) + EPS
        tonality = torch.clamp_max(
            10.0 * torch.log10(geo / arith) / -60.0, 1.0)
        offset = tonality * self.grid.reshape(1, 1, -1, 1) \
            + 9.0 * tonality + 5.5
        masked = self._bark(
            torch.clamp_min(self._bark(inten, self.w), EPS) ** self.alpha,
            self.spread) * 10.0 ** (-self.alpha * offset / 10.0)
        masking = torch.clamp_min(masked, EPS) ** (1.0 / self.alpha)
        return torch.maximum(masking, self.quiet.reshape(1, 1, -1, 1))

    def threshold(self, bark: torch.Tensor) -> torch.Tensor:
        """Bark intensities -> per-bin threshold amplitudes."""
        return torch.sqrt(torch.clamp_min(self._bark(bark, self.w_inv), EPS))

    def levels(self, bark: torch.Tensor) -> torch.Tensor:
        """Nearest sidecar grid level, int64."""
        lvl = torch.round(self.k2 * torch.log2(bark))
        return torch.clamp(lvl, self.lo, OCT_MAX * self.k2).to(torch.int64)

    def step(self, threshold: torch.Tensor) -> torch.Tensor:
        return torch.clamp_min(threshold / math.sqrt(3.0), 1e-12)

    # -- the codec --------------------------------------------------------

    def round_trip(self, x: torch.Tensor) -> torch.Tensor:
        """Codec.round_trip_quantized's result: x [B, S, C] -> [B, S + 2N,
        C]; the threshold unsnapped."""
        spec = self.analysis(x)
        delta = self.step(self.threshold(self.bark_intensity(spec)))
        return self.synthesis(torch.round(spec / delta) * delta)

    def encode(self, frames: torch.Tensor):
        """Frames -> (codes int64, sidecar levels int64, dequantized
        frames): the bitstream encode against the snapped sidecar."""
        lv = self.levels(self.bark_intensity(frames))
        delta = self.step(self.threshold(self.table[lv - self.lo]))
        codes = torch.round(frames / delta)
        return codes.to(torch.int64), lv, codes * delta

    def dequantize(self, codes, levels) -> torch.Tensor:
        """A container's codes and sidecar levels -> frames, as a decoder
        derives them."""
        codes = torch.as_tensor(np.asarray(codes), device=self.device)
        lv = torch.as_tensor(np.asarray(levels), dtype=torch.int64,
                             device=self.device)
        if lv.min() < self.lo or lv.max() > OCT_MAX * self.k2:
            raise ValueError("sidecar level outside the grid")
        delta = self.step(self.threshold(self.table[lv - self.lo]))
        return codes.to(self.dtype) * delta


class Err:
    """Error energy over reference energy, summed over every item
    compared: a flip of one code at a rounding tie weighs what it moves."""

    def __init__(self):
        self.num = 0.0
        self.den = 0.0

    def add(self, y, ref: torch.Tensor) -> None:
        y = torch.as_tensor(y).to(ref.device, torch.float64)
        ref = ref.to(torch.float64)
        if y.shape != ref.shape:
            raise ValueError(f"shape {tuple(y.shape)} != {tuple(ref.shape)}")
        self.num += ((y - ref) ** 2).sum().item()
        self.den += (ref ** 2).sum().item()

    @property
    def value(self) -> float:
        return self.num / self.den if self.den else 0.0
