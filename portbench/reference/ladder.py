"""Plain reference of the feature ladder's encode and decode, and a reader
of the ``.acs`` streams that carry it, in PyTorch and NumPy.

Written from docs/FORMATS.md (the ``tns``, ``nfl``, ``bsw``, ``bwe``,
``isg`` members and the ``.acs`` layout) and the published descriptions of
each tool (the port's module docstrings give the constants: the detector's
ratio and floors, the TNS order, gate and index grid, the level grids). It
imports nothing of the program; :class:`codec.Reference` supplies the
filter bank, the psychoacoustic model, the sidecar grid and the threshold.

The encode of frames ``first .. first + count - 1`` of a whole stereo
signal, in the order the format fixes:

1. the Bark masking intensity of each channel, spread by forward masking
   (I'_t = max over k = 0..W of lambda^k I_{t-k}, lambda = 10^(-d/10) with
   d the decay in dB a frame hop, over the frames before ``first`` too:
   what a stream carries across its chunk boundary), then the per-band min
   of the two channels, snapped to the sidecar grid;
2. mid/side: M = (L + R)/sqrt(2), S = (L - R)/sqrt(2), both quantized
   against the min channel's threshold, times the stream's scale;
3. eight-short block switching: a frame whose loudest of eight folded-time
   segments (by Parseval the sub-spectra of the orthogonal change of basis
   T = DCT4_N blockdiag(DCT4_{N/8}), channels pooled by max) exceeds 30x
   the mean of its three quietest (floored at 1e-4 of the loudest), with
   energy above 1e-12, is coded in the short basis against thresholds
   min-pooled over each group of 8 long bins;
4. TNS on the long frames: order-8 Levinson-Durbin along frequency from
   bin N/16 (autocorrelation with a 1e-6 white-noise correction), on when
   the prediction gain exceeds 1.25; reflection coefficients quantized to
   round(asin(k) / (pi/16)) in [-7, 7]; the forward filter
   e[j] = s[j] + sum a_i s[j-i] of the dequantized coefficients, zero
   history below the band; in-band thresholds times
   prod(1 - k_i^2)^(0.75/2);
5. the dead-zone quantizer: step = threshold / sqrt(3), code =
   sign(x) max(floor(|x|/step - (deadzone - 1)), 0);
6. intensity stereo: side codes at and above the crossover (~6 kHz) forced
   to zero on long frames;
7. nf levels (the fill's power matched to the zeroed energy in
   [N/16, the bwe crossover), owned bins left out), bwe gains (each
   16-bin group above ~10.5 kHz scaled from the low band's plain
   reconstruction under the copy-up map), intensity gains (the projection
   of the dropped side onto the decoder's mid, bwe fill included); every
   member zero on short frames.

The decode (without the noise fill, whose draw is no part of what is
compared) dequantizes with the dead-zone offset rho = deadzone + 0.45 - 1,
adds the bwe fill and the intensity fill, turns short frames back through
T's transpose, runs the TNS inverse filter and derotates mid/side.

Departures from a literal reading, each the format's own convention: k
is sin(idx pi/16) of a float32 argument, rounded to float32, as both
packages tabulate it; the
work runs in the reference's dtype (float64), where the program runs its
detector in float32, so a flag, an index or a level may differ at a tie.
"""

from __future__ import annotations

import json
import math
import struct
import zlib

import numpy as np
import torch

from portbench.reference import containers
from portbench.reference.codec import Reference, dct4

FACTOR = 8
DETECT_RATIO, DETECT_REL, DETECT_FLOOR = 30.0, 1e-4, 1e-12
ORDER, QMAX, GAIN_MIN = 8, 7, 1.25
GROUP = 16
RECON_POINT = 0.45  # the reconstruction point of a dead zone above 0.75


def crossover(n: int, sample_rate: int, hz: float) -> int:
    """The bin nearest ``hz`` on the 16-bin group grid."""
    g = round(hz / (sample_rate / (2.0 * n)) / GROUP)
    return int(min(max(g * GROUP, GROUP), n - GROUP))


def header(config: dict) -> dict:
    """The ``.acs`` header a stream of the configuration declares, but
    ``nsamp``."""
    n = int(config["filters_n"])
    sr = int(config["sample_rate"])
    return dict(
        sample_rate=sr, filters_n=n,
        bark_bands_n=int(config["bark_bands_n"]),
        alpha=float(config["alpha"]), window_type=config["window_type"],
        channels=int(config["channels"]), compute_dtype="float32", ms=True,
        threshold_scale=float(config["threshold_scale"]),
        bark_precision=config["dct_precision"], coder="rrice", hcrc=1,
        dzr=float(config["deadzone"]) + RECON_POINT - 1.0,
        tns={"order": ORDER, "band_start": max(ORDER + 1, n // 16)},
        nf={"band_start": n // 16, "seed": int(config["nf_seed"])},
        scq=int(config["sidecar_grid"]),
        bwe={"start": crossover(n, sr, 10500.0), "group": GROUP},
        isf={"start": crossover(n, sr, 6000.0), "group": GROUP},
        bs={"factor": FACTOR})


MEMBERS = ("tns", "nfl", "bwe", "isg", "bsw")


class Ladder:
    """The ``low`` preset's joint-stereo encode and its decode, for one
    configuration (a ``configs/*.json`` dict) on ``device`` at ``dtype``;
    ``tf32`` lets float32 products run in TF32."""

    def __init__(self, config: dict, device, dtype=torch.float64,
                 tf32: bool = False):
        self.base = base = Reference(config, device, dtype, tf32)
        self.n = n = base.n
        h = header(config)
        self.scale = h["threshold_scale"]
        self.deadzone = float(config["deadzone"])
        self.rho = h["dzr"]
        self.tns_start = h["tns"]["band_start"]
        self.nf_start = h["nf"]["band_start"]
        self.bwe_start = h["bwe"]["start"]
        self.is_start = h["isf"]["start"]
        # forward masking: decay a frame hop, and the frames it reaches back
        self.decay_db = float(config["tmask"]) * n / config["sample_rate"]
        self.window = 2 ** max(1, math.ceil(math.log2(
            math.ceil(30.0 / self.decay_db) + 1))) - 1
        m = n // FACTOR
        bd = np.kron(np.eye(FACTOR), dct4(m))
        self.t = torch.as_tensor(dct4(n) @ bd, dtype=dtype,
                                 device=base.device)
        self.t_inv = self.t.T.contiguous()
        # the copy-up map of bwe: target start + j reads source bin src[j]
        width = n - self.bwe_start
        src_width = min(width, self.bwe_start // GROUP * GROUP)
        self.src = torch.as_tensor(
            self.bwe_start - src_width + np.arange(width) % src_width,
            device=base.device)
        # k of index i at i + QMAX: the sine of the float32 product
        # i * float32(pi/16), rounded to float32 (the format's table)
        arg = np.arange(-QMAX, QMAX + 1, dtype=np.float32) * np.float32(
            math.pi / 2 / (QMAX + 1))
        self.kq = torch.as_tensor(np.sin(arg.astype(np.float64)).astype(
            np.float32), dtype=dtype, device=base.device)

    # -- helpers ----------------------------------------------------------

    def _dt(self, x):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.array(x))
        return x.to(self.base.device)

    def _owned(self):
        """bool [N, 2]: the side band intensity codes (no nf, bwe there)."""
        m = torch.zeros(self.n, 2, dtype=torch.bool, device=self.base.device)
        m[self.is_start:, 1] = True
        return m

    def _groups(self, a):
        """Sums over 16-bin groups along axis 1 of [F, W] or [F, W, C]."""
        if a.dim() == 3:  # [F, W, C]
            f, w, c = a.shape
            return a.reshape(f, w // GROUP, GROUP, c).sum(2)
        f, w = a.shape
        return a.reshape(f, w // GROUP, GROUP).sum(2)

    def lpc(self, idx):
        """int [F, order, C] indices -> taps a_1..a_order [F, C, order] of
        A(z) = 1 + sum a_i z^-i, by the step-up recursion."""
        k = self.kq[(idx.long() + QMAX)].transpose(1, 2)  # [F, C, p]
        a = torch.zeros_like(k)
        for i in range(ORDER):
            prev = a[..., :i].clone()
            a[..., :i] = prev + k[..., i:i + 1] * prev.flip(-1)
            a[..., i] = k[..., i]
        return a

    def tns_gain(self, idx):
        """The in-band threshold factor [F, 1, C] of TNS indices."""
        k = self.kq[(idx.long() + QMAX)]
        return torch.prod(1.0 - k * k, dim=1, keepdim=True) ** (
            0.75 / 2.0)

    def threshold(self, levels, idx, flags):
        """A decoder's thresholds [F, N, 2] from sidecar levels [F, bands,
        1], TNS indices and block-switch flags."""
        b = self.base
        thr = b.threshold(b.table[self._dt(levels).long() - b.lo][None])[0]
        thr = thr.expand(-1, -1, 2) * self.scale
        thr = torch.cat([thr[:, :self.tns_start],
                         thr[:, self.tns_start:] * self.tns_gain(idx)], 1)
        return self.pool(thr, flags)

    def pool(self, thr, flags):
        f, n, c = thr.shape
        short = thr.reshape(f, n // FACTOR, FACTOR, c).amin(2).repeat(
            1, FACTOR, 1)
        return torch.where(flags[:, None, None], short, thr)

    @staticmethod
    def step(thr):
        return torch.clamp_min(thr / math.sqrt(3.0), 1e-12)

    def bwe_fill(self, spec, codes, delta, gains, owned):
        """Add the replicated low band to the zero-coded bins above the
        crossover, each clamped to its own step."""
        s = self.bwe_start
        src = (codes * delta)[:, self.src]
        g = gains.to(spec.dtype)
        amp = torch.where(g > 0, 2.0 ** ((g - 128.0) / 4.0), 0.0)
        amp = amp.repeat_interleave(GROUP, dim=1)
        hole = (codes[:, s:] == 0) & ~owned[s:]
        cap = delta[:, s:]
        fill = torch.minimum(torch.maximum(amp * src, -cap), cap)
        return torch.cat([spec[:, :s], spec[:, s:] + torch.where(
            hole, fill, 0.0)], 1)

    def mid_ref(self, codes, delta, gains, owned):
        """The mid both sides project onto and scale: plain codes * steps
        with the bwe fill [F, N]."""
        plain = codes * delta
        return self.bwe_fill(plain, codes, delta, gains, owned)[..., 0]

    # -- the encode -------------------------------------------------------

    def encode(self, x: torch.Tensor, first: int, count: int) -> dict:
        """Frames ``first .. first + count - 1`` of the stereo signal x [1,
        S, 2] -> {codes [F, N, 2], levels [F, bands, 1], tns [F, order, 2],
        nfl [F, 2], bwe [F, groups, 2], isg [F, groups], bsw [F]} as int64 /
        bool tensors on the reference's device."""
        b, n = self.base, self.n
        ctx = min(self.window, first)
        frames = b.frames(x, first - ctx, ctx + count)[0]  # [F', N, 2]
        bark = b.bark_intensity(frames[None])[0]  # [F', bands, 2]
        spread = bark.clone()
        for k in range(1, self.window + 1):
            lam = 10.0 ** (-self.decay_db * k / 10.0)
            spread[k:] = torch.maximum(spread[k:], bark[:-k] * lam)
        frames, spread = frames[ctx:], spread[ctx:]
        levels = b.levels(spread.amin(-1, keepdim=True))  # [F, bands, 1]
        thr = b.threshold(b.table[levels - b.lo][None])[0]
        thr = thr.expand(-1, -1, 2) * self.scale
        r2 = 1.0 / math.sqrt(2.0)
        spec = torch.stack([(frames[..., 0] + frames[..., 1]) * r2,
                            (frames[..., 0] - frames[..., 1]) * r2], -1)
        # block switching, detected on the left/right frames
        short = b._mm(frames.transpose(1, 2), self.t)  # [F, C, N]
        seg = (short.reshape(count, 2, FACTOR, n // FACTOR) ** 2).sum(-1)
        seg = seg.amax(1)  # [F, 8]
        peak = seg.amax(-1)
        quiet = seg.sort(-1).values[:, :3].mean(-1)
        floor = torch.clamp_min(DETECT_REL * peak, 1e-30)
        flags = (peak > DETECT_RATIO * torch.maximum(quiet, floor)) & (
            seg.sum(-1) > DETECT_FLOOR)
        spec = torch.where(flags[:, None, None],
                           b._mm(spec.transpose(1, 2), self.t).transpose(
                               1, 2), spec)
        thr = self.pool(thr, flags)
        # TNS on the long frames
        idx = self.tns_analyze(spec)
        idx = torch.where(flags[:, None, None], 0, idx)
        spec = self.tns_forward(spec, idx)
        thr = torch.cat([thr[:, :self.tns_start],
                         thr[:, self.tns_start:] * self.tns_gain(idx)], 1)
        delta = self.step(thr)
        u = spec.abs() / delta
        mag = torch.clamp_min(torch.floor(u - (self.deadzone - 1.0)), 0.0)
        codes = torch.sign(spec) * mag
        owned = self._owned()
        codes = torch.where(owned & ~flags[:, None, None], 0.0, codes)
        zero = codes == 0
        # nf levels over [nf start, bwe start), owned bins left out
        lo, hi = self.nf_start, self.bwe_start
        z = (zero & ~owned)[:, lo:hi]
        e_lost = torch.where(z, spec[:, lo:hi] ** 2, 0.0).sum(1)
        e_cap = torch.where(z, delta[:, lo:hi] ** 2, 0.0).sum(1)
        a = torch.sqrt(3.0 * e_lost / torch.clamp_min(e_cap, 1e-30))
        a = torch.clamp_max(a, math.sqrt(3.0) * self.deadzone)
        lvl = torch.round(240.0 + 16.0 * torch.log2(torch.clamp_min(a,
                                                                    1e-30)))
        keep = (z.sum(1) > 0) & (a > 2.0 ** ((1 - 240.0) / 16.0))
        nfl = torch.where(keep & ~flags[:, None], lvl, 0.0).clamp(0, 255)
        # bwe gains, one a 16-bin group above the crossover
        s = self.bwe_start
        z = (zero & ~owned)[:, s:]
        src = (codes * delta)[:, self.src]
        e_lost = self._groups(torch.where(z, spec[:, s:] ** 2, 0.0))
        e_src = self._groups(torch.where(z, src ** 2, 0.0))
        g = torch.sqrt(e_lost / torch.clamp_min(e_src, 1e-30))
        lvl = torch.round(128.0 + 4.0 * torch.log2(torch.clamp_min(g,
                                                                   1e-30)))
        keep = (e_lost > 0) & (g <= 2.0 ** ((255 - 128.0) / 4.0))
        bwe = torch.where(keep & ~flags[:, None, None], lvl, 0.0).clamp(0,
                                                                       255)
        # intensity gains: the side band's projection onto the decoder's mid
        s = self.is_start
        mid = self.mid_ref(codes, delta, bwe, owned)[:, s:]
        z = zero[:, s:, 1]
        num = self._groups(torch.where(z, spec[:, s:, 1] * mid, 0.0))
        den = self._groups(torch.where(z, mid ** 2, 0.0))
        g = num / torch.clamp_min(den, 1e-30)
        mag_g = g.abs()
        lvl = torch.clamp(torch.round(88.0 + 4.0 * torch.log2(
            torch.clamp_min(mag_g, 1e-30))), 1, 100)
        lvl = torch.where(mag_g >= 2.0 ** ((1 - 88.0) / 4.0), lvl, 0.0)
        lvl = torch.where((g < 0) & (lvl > 0), lvl + 128, lvl)
        isg = torch.where(flags[:, None], 0.0, lvl)
        return {"codes": codes.long(), "levels": levels, "tns": idx,
                "nfl": nfl.long(), "bwe": bwe.long(), "isg": isg.long(),
                "bsw": flags}

    def tns_analyze(self, spec):
        """Quantized reflection indices [F, order, C] of each frame and
        channel's band, by Levinson-Durbin on its autocorrelation."""
        s = spec[:, self.tns_start:].transpose(1, 2)  # [F, C, M]
        m = s.shape[-1]
        r = torch.stack([(s[..., :m - i] * s[..., i:]).sum(-1)
                         for i in range(ORDER + 1)], -1)
        r0 = r[..., 0] * (1.0 + 1e-6) + 1e-20
        err = r0
        a = torch.zeros_like(r[..., 1:])  # a_1..a_p of the order reached
        ks = []
        for i in range(ORDER):
            acc = r[..., i + 1] + (a[..., :i] * r[..., 1:i + 1].flip(-1)
                                   ).sum(-1)
            k = torch.clamp(-acc / err, -0.999, 0.999)
            prev = a[..., :i].clone()
            a[..., :i] = prev + k[..., None] * prev.flip(-1)
            a[..., i] = k
            err = err * (1.0 - k * k)
            ks.append(k)
        on = r0 / torch.clamp_min(err, 1e-30) > GAIN_MIN
        q = torch.round(torch.asin(torch.stack(ks, -1)) / (
            math.pi / 2 / (QMAX + 1))).clamp(-QMAX, QMAX)
        return torch.where(on[..., None], q, 0.0).transpose(1, 2).long()

    def tns_forward(self, spec, idx):
        a = self.lpc(idx).transpose(1, 2)  # [F, p, C]
        band = spec[:, self.tns_start:]
        out = band.clone()
        for i in range(1, ORDER + 1):
            out[:, i:] += a[:, i - 1:i] * band[:, :-i]
        return torch.cat([spec[:, :self.tns_start], out], 1)

    def tns_inverse(self, spec, idx):
        """y[j] = e[j] - sum a_i y[j-i] along the band, one bin a step."""
        a = self.lpc(idx).flip(-1)  # [F, C, p], a_p first
        e = spec[:, self.tns_start:].transpose(1, 2)  # [F, C, M]
        y = torch.zeros(e.shape[:2] + (e.shape[-1] + ORDER,),
                        dtype=e.dtype, device=e.device)
        for j in range(e.shape[-1]):
            y[..., ORDER + j] = e[..., j] - (a * y[..., j:j + ORDER]).sum(
                -1)
        return torch.cat([spec[:, :self.tns_start],
                          y[..., ORDER:].transpose(1, 2)], 1)

    # -- the decode -------------------------------------------------------

    def decode(self, m: dict) -> torch.Tensor:
        """Members (as :meth:`encode` gives them, or as a stream holds them)
        -> the left/right spectra [F, N, 2] without the noise fill."""
        dt = self.base.dtype
        codes = self._dt(m["codes"]).to(dt)
        flags = self._dt(m["bsw"]).bool()
        idx = self._dt(m["tns"]).long()
        bwe, isg = self._dt(m["bwe"]).long(), self._dt(m["isg"]).long()
        delta = self.step(self.threshold(m["levels"], idx, flags))
        owned = self._owned()
        spec = (codes + torch.sign(codes) * self.rho) * delta
        spec = self.bwe_fill(spec, codes, delta, bwe, owned)
        s = self.is_start
        lvl = torch.clamp_max(isg & 127, 100).to(dt)
        amp = torch.where(isg >= 128, -1.0, 1.0) * 2.0 ** ((lvl - 88.0) / 4.0)
        amp = torch.where(isg > 0, amp, 0.0).repeat_interleave(GROUP, dim=1)
        mid = self.mid_ref(codes, delta, bwe, owned)[:, s:]
        side = spec[:, s:, 1] + torch.where(codes[:, s:, 1] == 0, amp * mid,
                                            0.0)
        spec = torch.cat([spec[:, :s], torch.stack([spec[:, s:, 0], side],
                                                   -1)], 1)
        spec = torch.where(flags[:, None, None], self.base._mm(
            spec.transpose(1, 2), self.t_inv).transpose(1, 2), spec)
        spec = self.tns_inverse(spec, idx)
        r2 = 1.0 / math.sqrt(2.0)
        return torch.stack([(spec[..., 0] + spec[..., 1]) * r2,
                            (spec[..., 0] - spec[..., 1]) * r2], -1)


def differ(got: dict, want: dict) -> tuple:
    """(side-information entries that differ, entries compared) over the
    members bs flags, TNS indices, nf levels, bwe and intensity gains."""
    def host(v):
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.array(v))
        return v.long().cpu()

    bad = total = 0
    for k in MEMBERS:
        a, b = host(got[k]), host(want[k])
        if a.shape != b.shape:
            raise ValueError(f"member {k} shape {tuple(a.shape)} != "
                             f"{tuple(b.shape)}")
        bad += int((a != b).sum())
        total += a.numel()
    return bad, total


class LadderStream:
    """A ``.acs`` stream of a ladder configuration: the header must declare
    the configuration's members, every chunk's CRC is checked on open."""

    def __init__(self, path, config: dict):
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != b"ACS2":
            raise ValueError(f"magic {data[:4]!r}")
        (hlen,) = struct.unpack_from("<I", data, 4)
        self.meta = meta = json.loads(data[8:8 + hlen])
        want = header(config)
        for key, value in want.items():
            if meta.get(key) != value:
                raise ValueError(f"header {key}={meta.get(key)!r}")
        extra = set(meta) - set(want) - {"nsamp"}
        if extra:
            raise ValueError(f"header declares {sorted(extra)}")
        count, index_off = struct.unpack_from("<QQ", data, len(data) - 16)
        if index_off + 8 * count + 16 != len(data):
            raise ValueError("index/trailer do not close the file")
        offsets = struct.unpack_from(f"<{count}Q", data, index_off)
        self.chunks = []  # (blocks, [codes, bark, tns, nf, bwe, isf, bs])
        pos = 8 + hlen
        for off in offsets:
            if off != pos:
                raise ValueError(f"index offset {off} != chunk at {pos}")
            (blocks,) = struct.unpack_from("<I", data, off)
            pos, crc, parts = off + 4, zlib.crc32(data[off:off + 4]), []
            # codes, bark, then the five members in wire order, each a u32
            # length and its bytes; the CRC chains every field in order
            for _ in range(7):
                (length,) = struct.unpack_from("<I", data, pos)
                body = data[pos + 4:pos + 4 + length]
                if len(body) != length:
                    raise ValueError(f"chunk at {off}: truncated")
                crc = zlib.crc32(body, zlib.crc32(data[pos:pos + 4], crc))
                parts.append(body)
                pos += 4 + length
            (got,) = struct.unpack_from("<I", data, pos)
            if got != crc:
                raise ValueError(f"chunk at {off}: CRC")
            pos += 4
            self.chunks.append((blocks, parts))
        if pos != index_off:
            raise ValueError("bytes between the last chunk and the index")

    def blocks(self) -> list:
        return [c[0] for c in self.chunks]

    def chunk(self, i: int) -> dict:
        """The members of chunk i as numpy arrays, named as
        :meth:`Ladder.encode` names them."""
        blocks, (codes, bark, tns, nf, bwe, isf, bs) = self.chunks[i]
        meta = self.meta
        n, bands = meta["filters_n"], meta["bark_bands_n"]

        def inflate(raw, dtype, shape):
            out = zlib.decompressobj().decompress(raw, int(np.prod(shape))
                                                  + 1)
            if len(out) != int(np.prod(shape)):
                raise ValueError(f"chunk {i}: member of {len(out)} bytes")
            return np.frombuffer(out, dtype=dtype).reshape(shape)

        bw = (n - meta["bwe"]["start"]) // GROUP
        iw = (n - meta["isf"]["start"]) // GROUP
        flags = np.unpackbits(np.frombuffer(bs, np.uint8))
        if flags.size != -(-blocks // 8) * 8 or flags[blocks:].any():
            raise ValueError(f"chunk {i}: block-switch bitmap")
        return {
            "codes": containers.rice_decode(codes, blocks * n * 2, True)
            .reshape(blocks, n, 2),
            "levels": containers.int2d(bark, (blocks, bands, 1), 0),
            "tns": inflate(tns, np.int8, (blocks, ORDER, 2)),
            "nfl": inflate(nf, np.uint8, (blocks, 2)),
            "bwe": inflate(bwe, np.uint8, (blocks, bw, 2)),
            "isg": inflate(isf, np.uint8, (blocks, iw)),
            "bsw": flags[:blocks].astype(bool),
        }
