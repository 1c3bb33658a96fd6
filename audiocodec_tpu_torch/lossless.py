"""Lossless archival mode: FLAC-class fixed-predictor coding (counterpart
of ``audiocodec_tpu/lossless.py``, whose containers it reads and writes).

The scheme is the classic fixed-predictor one (FLAC's -0..-4 "fast"
ladder): per frame, pick the finite-difference order 0-4 whose residual
costs fewest Rice bits, entropy-code the residuals, rebuild exactly by
integration.

Design decisions (vs FLAC's bitstream):

- **Frames are fully independent.** Instead of predicting across frame
  boundaries (which makes decode a sequential scan with carried
  context), each frame stores its own warmup as *progressive diffs*:
  residual slot j < k holds the j-th-order difference's first element,
  slots k..n-1 hold the order-k difference body. Total length stays n,
  the warmup entries are already decorrelated (only slot 0 is a raw
  sample), and every frame decodes by k cumsums with NO neighbor data —
  so decode is one batched program over frames. Cost of the choice: ~4
  extra values per frame*channel, < 0.1% of the stream.
- **Order selection is a device argmin, not a host loop.** All five
  candidate residual ladders are scored on the device (five shifted
  subtractions) with the Rice bit model min_p[n*(p+1) + sum(zigzag)/2^p];
  the per-frame winner is a gather. One device pass regardless of the
  file's length.
- **The entropy stage reuses the spectral stack**: the native
  escape-capped Rice coder and its run-length variant
  (native/entropy.cpp), picked per file post-deflate exactly like the
  codes member of the lossy container (io/bitstream.py) — run-length
  wins on silence-heavy material, plain Rice elsewhere.

Stereo decorrelates per frame over FLAC's four pairings — l/r,
mid/side (mid = (l+r)>>1, side = l-r, shared parity bit recovered from
side), left/side, and side/right — by the same bit model, with margins
that keep estimator near-ties on the file-level mode (uniform streams
keep the compact header forms).

Level 2 adds FLAC "-8"-class quantized LPC: per (frame, channel) a
native C++ analyzer (native/entropy.cpp acx_lpc_analyze) runs
Hann+Tukey windowed autocorrelation and a Levinson-Durbin ORDER SEARCH
to order 26 (each order's prediction error is a recursion by-product,
so the search is free), quantizes the winner with a per-frame adaptive
shift at 15 magnitude bits, and replaces the fixed-ladder residuals
only where the exact integer residual's estimated bits win. Winning
predictors ship sparsely: `lpco` holds (order, shift) per winning
entry, `lpcc` the concatenated int16 coefficients — a file where LPC
never wins carries zero coefficient overhead, and a file-level gate
drops the tier entirely unless its estimated savings clear the member
overhead (so level 2 can never emit a larger container than level 1).
Container version 3; version-2 streams (dense order-8 member) still
decode; level 1 keeps writing version 1.

The device programs (:func:`_select`, :func:`_reconstruct` and their
layout helpers) are plain torch functions on int32 tensors on the device
the caller names: the card unless the caller asks for the CPU. Each call
runs on the file's own frame count.

Supported depths: 16- and 24-bit integer PCM. 32-bit is rejected: a
4th-order difference of full-scale int32 overflows the int32 residual
pipeline (FLAC needs 33-bit side channels for the same reason).
"""

from __future__ import annotations

import io as _io
import zipfile
import zlib

import numpy as np
import torch

from audiocodec_tpu_torch import native
from audiocodec_tpu_torch.io.bitstream import (
    _SMALL_MEMBER_CAP,
    _bounded_member,
)

MAX_ORDER = 4
DEFAULT_FRAME = 4096  # multiple of the Rice group (256) so per-group
#                       parameters never straddle a frame boundary
_VERSION = 1
_VERSION_LPC = 2   # adds the quantized-LPC frame type (orders value 5)
_VERSION_LPC2 = 3  # sparse searched-order LPC members (lpco/lpcc)
_MAX_CHANNELS = 64
_MAX_FRAME = 1 << 16
_MAX_SAMPLES = 1 << 40  # ~70 years of 48 kHz stereo; bounds allocations

# Level-2 ("max") tier: FLAC-style quantized LPC competing per frame
# and channel against the fixed ladder.
LPC_ORDER = 8   # container v2 (legacy decode): fixed order 8...
LPC_SHIFT = 12  # ...at fixed shift 12, dense `lpc` member
LPC_MARK = MAX_ORDER + 1  # orders value flagging an LPC frame (v2 + v3)
# container v3: per-frame searched order/shift, sparse members
LPC_MAX_ORDER = 26   # encoder search ceiling (format allows 1..32)
LPC_PRECISION = 15   # coefficient magnitude bits (int16 storage)
_LPC_FORMAT_MAX_ORDER = 32
_LPC_MARGIN = 64.0   # bits a frame's LPC must win by (estimator noise)
_LPC_FILE_GATE_BITS = 4096.0  # zip member overhead the tier must clear

# what np.load and a member read raise on a malformed archive
_ZIP_ERRORS = (zipfile.BadZipFile, zlib.error, OSError, EOFError,
               NotImplementedError, RuntimeError)


# -- device side --------------------------------------------------------------


def _rice_bits(sumu: torch.Tensor, n: int) -> torch.Tensor:
    """Estimated Rice bits from per-(ladder, frame, channel) zigzag sums.

    Models each frame as one Rice group with the optimal parameter p:
    bits ~= n*(p+1) + sum(zigzag)/2^p. The real coder re-adapts p every
    256 samples and escape-caps outliers, so this slightly over-scores
    heavy-tailed frames — fine for ORDER SELECTION, which only needs the
    ranking."""
    ps = torch.arange(18, dtype=torch.float32, device=sumu.device)
    bits = (n * (ps + 1.0))[:, None] + sumu[..., None, :] / (2.0 ** ps)[:, None]
    return torch.amin(bits, dim=-2)  # [5, frames, channels]


def _select(xf: torch.Tensor):
    """Pick the cheapest predictor order per (frame, channel).

    Scores all five fixed-predictor ladders from the running difference
    alone (ladder k's zigzag sum = its body |d_k| plus the warmup heads
    |d_j[0]|, j<k — no [5, F, n, C] materialization), then builds ONLY
    the winning residual ladder in place with four masked difference
    passes.

    Each ladder's body sum is exact (int64) and rounded to float32 once,
    so the scores do not depend on a reduction order: they equal the JAX
    package's float32 sums wherever those are exact (every partial sum
    below 2^24), and may differ from them by an ulp above.

    :param xf: int32 [frames, n, channels]
    :return: (orders int32 [frames, channels],
              residuals int32 [frames, n, channels],
              best_bits float32 [frames, channels])
    """
    n = xf.shape[1]
    # Score on a sampled subset: the Rice bit model only needs each
    # candidate's mean |residual|, and 1024 samples of a 4096-sample
    # frame estimate it to well under the inter-order spread (audio is
    # near-stationary at 25 ms). The samples are FOUR 256-sample chunks
    # SPREAD across the frame (not a contiguous prefix): a frame whose
    # character changes after the prefix — a transient in the tail —
    # would otherwise pick its order and stereo pairing from the wrong
    # statistics. Differences stay within each chunk, so every chunk's
    # sums measure the same ladders the build produces. The chunk sums
    # extrapolate by n/body so the n*(p+1) unary/remainder term keeps
    # its units. The BUILD below is exact for whatever order wins.
    if n > 1024:
        offs = (
            0,
            (n // 4) // 256 * 256,
            (n // 2) // 256 * 256,
            (3 * n // 4) // 256 * 256,
        )
        d = torch.stack([xf[:, o : o + 256, :] for o in offs], dim=1)
    else:
        d = xf[:, None, :, :]  # small frames score in full
    head_acc = torch.zeros((xf.shape[0], xf.shape[2]), dtype=torch.float32,
                           device=xf.device)
    sums = []
    for k in range(MAX_ORDER + 1):
        if k:
            d = d[:, :, 1:, :] - d[:, :, :-1, :]
        ad = torch.abs(d)
        body = ad.shape[1] * ad.shape[2]
        total = torch.sum(ad, dim=(1, 2), dtype=torch.int64)
        sums.append(head_acc + total.to(torch.float32) * (n / body))
        # warmup heads |d_k[0]| come from the frame's true start
        # (chunk 0's first element)
        head_acc = head_acc + ad[:, 0, 0, :].to(torch.float32)
    sumu = torch.stack(sums) * 2.0  # [5, F, C]
    bits = _rice_bits(sumu, n)
    orders = torch.argmin(bits, dim=0).to(torch.int32)  # [F, C]

    # masked in-place differencing: after pass j, frames with order > j
    # hold head slots 0..j and the (j+1)-th difference in slots j+1..
    y = xf
    for j in range(MAX_ORDER):
        m = (orders > j)[:, None, :]
        seg = y[:, j:, :]
        dj = seg[:, 1:, :] - seg[:, :-1, :]
        y = torch.cat(
            [y[:, : j + 1, :], torch.where(m, dj, y[:, j + 1 :, :])], dim=1
        )
    return orders, y, torch.amin(bits, dim=0)


def _reconstruct(res: torch.Tensor, orders: torch.Tensor) -> torch.Tensor:
    """Invert :func:`_select`: residuals + per-frame orders -> samples.

    Four masked cumsum passes, highest order first: at pass j, frames
    whose order exceeds j integrate slots j.. (slot j holds the j-th
    difference's warmup head). One vectorized program over
    [frames, n, channels]: no scan, no carried state."""
    y = res
    for j in range(MAX_ORDER - 1, -1, -1):
        m = (orders > j)[:, None, :]
        c = torch.cumsum(y[:, j:, :], dim=1, dtype=torch.int32)
        y = torch.cat([y[:, :j, :], torch.where(m, c, y[:, j:, :])], dim=1)
    return y


def _select_stereo(xf: torch.Tensor):
    """Stereo candidate expansion on the device: [F, n, 2] l/r frames ->
    the four stored-channel candidates [l, r, mid, side] scored and
    residualized in one pass."""
    l = xf[..., 0]
    r = xf[..., 1]
    x4 = torch.stack([l, r, (l + r) >> 1, l - r], dim=-1)
    return _select(x4)


def _gather_flat(res: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Device-side wire layout: keep per-frame stored channels `idx`
    [F, P] out of res [F, n, C] and flatten frame-major, channel-second
    -> [F*P*n]. Only this (the exact values the entropy coder eats)
    crosses to the host."""
    f, n, _ = res.shape
    g = torch.gather(res, 2, idx[:, None, :].expand(f, n, idx.shape[1]))
    return g.permute(0, 2, 1).reshape(-1)


def _flatten(res: torch.Tensor) -> torch.Tensor:
    """[F, n, C] -> wire-layout [F*C*n] on device (mono/multichannel)."""
    return res.permute(0, 2, 1).reshape(-1)


def _reconstruct_flat(flat: torch.Tensor, orders: torch.Tensor
                      ) -> torch.Tensor:
    """Decode-side fusion: wire-layout residuals [F*C*n] + orders [F, C]
    -> samples [F*n, C] (unwire transpose, integration, and output
    layout on the device; no host-side transpose copies)."""
    f, c = orders.shape
    n = flat.numel() // (f * c)
    res = flat.reshape(f, c, n).permute(0, 2, 1)
    return _reconstruct(res, orders).reshape(f * n, c)


# -- LPC tier (level 2) -------------------------------------------------------
#
# The whole per-frame analysis (windowed autocorrelation, Levinson
# order search, quantization, exact residual competition) lives in ONE
# native call — native.lpc_analyze / entropy.cpp acx_lpc_analyze. The
# float64 numpy fit it replaced spent ~3x the rest of the level-2
# encode in the autocorrelation einsums alone on a few-core host.


def _lpc_pack_sparse(lorders, lshifts, lqcoef):
    """Winning predictors -> (lpco uint8 [E, 2], lpcc int16 [sum orders]).

    Entry scan order is frame-major, channel-second (numpy row-major
    over the [F, C] win mask) — decode expands in the same order."""
    win = lorders > 0
    ff, cc = np.nonzero(win)
    ords_e = lorders[ff, cc]
    lpco = np.stack([ords_e, lshifts[ff, cc]], axis=1).astype(np.uint8)
    block = lqcoef[ff, :, cc]  # [E, max_order]
    mask = np.arange(lqcoef.shape[1])[None, :] < ords_e[:, None]
    lpcc = block[mask].astype(np.int16)
    return lpco, lpcc


# -- stereo decorrelation ------------------------------------------------------


def _choose_pairs(bits4):
    """Per-frame stereo pairing from candidate scores, FLAC's four modes.

    `bits4` [F, 4] holds estimated bits for the candidates l/r/mid/side
    (device sampled-chunk floats at level 1, native exact doubles at
    level 2); each frame keeps the cheapest PAIR — l+r, mid+side,
    l+side ("left/side"), or side+r ("side/right").

    Decision discipline (the bit model is a ranking estimator, not the
    real coder, so near-ties are noise):
    1. the asymmetric pairings (left/side, side/right) must EARN their
       pick by > 64 estimated bits/frame — on symmetric material they
       tie l/r and m/s to within estimator noise (measured 0.6 bits of
       663k on an independent-stereo file);
    2. per-frame mode switching must beat the best uniform mode by
       > max(256 bits, 0.1%) in total, else the file keeps ONE mode —
       stable describe() output and no mode flapping;
    3. within a per-frame stream, departing from the file-level mode
       costs a further 64-bit margin per frame.

    :return: (smode int64 [F], stereo_mode 0/1/2,
              idx int64 [F, 2] stored-candidate picks,
              smodes uint8 [F] member or None)
    """
    comb = np.stack(
        [bits4[:, 0] + bits4[:, 1],   # 0: l/r
         bits4[:, 2] + bits4[:, 3],   # 1: mid/side
         bits4[:, 0] + bits4[:, 3],   # 2: left/side
         bits4[:, 1] + bits4[:, 3]],  # 3: side/right
        axis=1,
    )
    bias = np.asarray([0.0, 0.0, 64.0, 64.0], dtype=comb.dtype)
    cb = comb + bias
    g = int(np.argmin(cb.sum(axis=0)))
    uni_total = float(cb[:, g].sum())
    gain = uni_total - float(cb.min(axis=1).sum())
    if gain <= max(256.0, 1e-3 * uni_total):
        smode = np.full(bits4.shape[0], g, dtype=np.int64)
    else:
        pen = np.full(4, 64.0, dtype=cb.dtype)
        pen[g] = 0.0
        smode = np.argmin(cb + pen, axis=1)
    idx = np.stack(
        [np.asarray([0, 2, 0, 1])[smode],
         np.asarray([1, 3, 3, 3])[smode]], axis=1
    )  # per-frame (first, second) stored-channel picks
    if not smode.any():
        stereo_mode, smodes = 0, None
    elif (smode == 1).all():
        stereo_mode, smodes = 1, None  # pure m/s keeps the compact form
    else:
        stereo_mode, smodes = 2, smode.astype(np.uint8)
    return smode, stereo_mode, idx, smodes


def _to_ms(x):
    """Lossless mid/side: int32 [S, 2] l/r -> [S, 2] mid/side."""
    l = x[:, 0]
    r = x[:, 1]
    mid = (l + r) >> 1  # arithmetic shift = floor division
    side = l - r
    return np.stack([mid, side], axis=1)


def _from_ms(x):
    mid = x[:, 0]
    side = x[:, 1]
    l = mid + ((side + (side & 1)) >> 1)
    r = l - side
    return np.stack([l, r], axis=1)


def _from_modes(x, sm):
    """Per-sample stereo inversion for per-frame mode streams.

    :param x: int32 [S, 2] stored channel pairs
    :param sm: uint8 [S] per-sample mode: 0 l/r, 1 mid/side,
        2 left/side, 3 side(second)/right-as-first -> (r, side)
    """
    c0 = x[:, 0]
    c1 = x[:, 1]
    # mode 1 stores (mid, side); shared parity bit rides side's LSB
    l = np.where(
        sm == 1,
        c0 + ((c1 + (c1 & 1)) >> 1),
        np.where(sm == 3, c0 + c1, c0),
    )
    # modes 1 and 2 both store side second with l recovered above, so
    # r = l - side for both; mode 3 stores (r, side); mode 0 is identity
    r = np.where(sm == 0, c1, np.where(sm == 3, c0, l - c1))
    return np.stack([l, r], axis=1)


# -- container ----------------------------------------------------------------


def encode_lossless(
    x, sample_rate: int, bits: int = 16, frame: int = DEFAULT_FRAME,
    level: int = 1, device="cuda",
) -> bytes:
    """Losslessly encode integer PCM -> container bytes.

    :param x: int samples [samples, channels] (or [1, samples, channels]),
        within the given bit depth.
    :param bits: source depth, 16 or 24.
    :param level: 1 = fixed predictors (FLAC "fast" ladder; the gated
        default), 2 = additionally fit order-8 quantized LPC per frame
        and keep whichever wins per (frame, channel) — FLAC "-8"-class
        ratios at FLAC "-8"-class encode cost (the LPC fit is host
        float64 + a native exact integer filter). Decoders handle both.
    :param device: where level 1's order selection runs (the card unless
        the caller asks for the CPU); level 2 is host work throughout.
    """
    x = np.asarray(x)
    if x.ndim == 3:
        if x.shape[0] != 1:
            raise ValueError("encode_lossless takes a single clip")
        x = x[0]
    if x.ndim == 1:
        x = x[:, None]
    if x.ndim != 2 or x.shape[0] == 0:
        raise ValueError(f"want [samples, channels]; got shape {x.shape}")
    if not np.issubdtype(x.dtype, np.integer):
        raise ValueError(
            f"lossless mode takes integer PCM, not {x.dtype} (the lossy "
            "path is the one for float tensors)"
        )
    if bits not in (16, 24):
        raise ValueError(f"bits must be 16 or 24, got {bits}")
    if frame % 256 != 0 or not 256 <= frame <= _MAX_FRAME:
        raise ValueError(
            f"frame must be a multiple of 256 in [256, {_MAX_FRAME}]"
        )
    if level not in (1, 2):
        raise ValueError(f"level must be 1 or 2, got {level}")
    # bounds check on the input dtype (min/max never overflow), then ONE
    # int32 copy
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    if x.min() < lo or x.max() > hi:
        raise ValueError(f"samples outside the {bits}-bit range")
    x = np.ascontiguousarray(x, dtype=np.int32)
    n_samples, channels = x.shape
    if channels > _MAX_CHANNELS:
        raise ValueError(f"at most {_MAX_CHANNELS} channels")

    # the last frame's tail is edge-replica (zero residuals from order 1
    # up). Built as one allocation + one memcpy + one broadcast store.
    f_real = -(-n_samples // frame)
    buf = np.empty((f_real * frame, channels), dtype=np.int32)
    buf[:n_samples] = x
    buf[n_samples:] = x[-1]
    xf = buf.reshape(f_real, frame, channels)

    smodes = None
    lpco = lpcc = None
    use_l2 = level >= 2 and frame > LPC_MAX_ORDER + 1
    if use_l2:
        # Level-2 "max" tier: the WHOLE analysis runs in the native
        # engine — exact full-frame fixed-ladder scores, the stereo pair
        # choice on those exact sums (same decision discipline as the
        # device path, via _choose_pairs), then one build+LPC-search
        # pass writing the wire layout directly. No device programs: the
        # tier is autocorrelation-bound host work (int64 exact filters),
        # so the device round trip would only add transfer; it also makes
        # level-2 output deterministic across devices and equal to the
        # JAX package's. Decode is unchanged — the container decodes
        # through the same device integrator as level 1.
        if channels == 2:
            orders4, bits4 = native.lossless_score(xf, stereo4=True)
            smode, stereo_mode, idx, smodes = _choose_pairs(bits4)
            fixed_orders = np.take_along_axis(orders4, idx, axis=1)
            idx32 = idx.astype(np.int32)
        else:
            stereo_mode = 0
            fixed_orders, _ = native.lossless_score(xf)
            idx32 = None
        flat, lorders, lshifts, lqcoef, savings = native.l2_encode(
            xf, idx32, fixed_orders, do_lpc=True,
            max_order=LPC_MAX_ORDER, precision=LPC_PRECISION,
            n_windows=2, margin=_LPC_MARGIN,
        )
        orders = fixed_orders
        # file-level gate (the per-entry coefficient cost is already
        # inside `savings`; this covers the two zip members' fixed
        # overhead): a file whose LPC wins are marginal keeps the
        # version-1 form, so level 2 can never emit a LARGER container
        if (lorders > 0).any() and savings > _LPC_FILE_GATE_BITS:
            orders = np.where(lorders > 0, LPC_MARK, orders)
            lpco, lpcc = _lpc_pack_sparse(lorders, lshifts, lqcoef)
        elif (lorders > 0).any():
            # marginal wins under the gate: rebuild fixed-only (rare,
            # and the rebuild skips the LPC search entirely)
            flat, *_ = native.l2_encode(
                xf, idx32, fixed_orders, do_lpc=False,
                max_order=LPC_MAX_ORDER, precision=LPC_PRECISION,
                n_windows=2, margin=_LPC_MARGIN,
            )
    elif channels == 2:
        # per-frame stereo decorrelation, FLAC's four modes: one device
        # pass scores all of l/r/mid/side, then each frame keeps the
        # cheapest PAIR — l+r, mid+side, l+side ("left/side"), or
        # side+r ("side/right"); side alone often rides one loud
        # channel's frame
        # Only the small per-frame score/order tensors cross to the
        # host; the residual tensor stays on the device for the wire
        # gather below.
        orders4, res4, bits4 = _select_stereo(
            torch.from_numpy(xf).to(device)
        )
        orders4 = orders4.cpu().numpy()
        bits4 = bits4.cpu().numpy()
        smode, stereo_mode, idx, smodes = _choose_pairs(bits4)
        orders = np.take_along_axis(orders4, idx, axis=1)
        idx_d = torch.from_numpy(idx).to(device)
        flat = _gather_flat(res4, idx_d).cpu().numpy()
    else:
        stereo_mode = 0
        orders, res, _ = _select(torch.from_numpy(xf).to(device))
        orders = orders.cpu().numpy()
        flat = _flatten(res).cpu().numpy()

    # flat is the frame-major, channel-second wire layout (built on
    # device): each (frame, channel) run is a whole number of Rice
    # groups, so the coder's per-group parameters adapt within one
    # predictor's output, never across two. Each trial also records the
    # bit offset of every FRAME's first group (stride = one frame's
    # values) — the random-access index that makes decode_lossless's
    # start/count cost proportional to the range, 8 bytes/frame
    # (< 0.05% of a typical stream)
    c_stored = 2 if channels == 2 else channels
    fidx_stride = c_stored * frame
    pay0, idx0 = native.rice_encode_indexed(flat, fidx_stride)
    candidates = [(0, pay0)]
    fidx_by_base = {0: idx0}
    # the run-length variant only wins on zero-run-heavy residuals
    # (silence, digital black); gate its trial on zero density rather
    # than always paying a second full coding pass
    if np.count_nonzero(flat) < 0.7 * flat.size:
        pay1, idx1 = native.rrice_encode_indexed(flat, fidx_stride)
        candidates.append((1, pay1))
        fidx_by_base[1] = idx1
    # a flagged deflate pass on top of each tried coder: Rice is
    # memoryless, so PERIODIC content (a steady tone's repeating
    # residual pattern) leaves LZ redundancy on the table — measured
    # ~4x smaller on a pure sine, ~0% on dense music. The second
    # deflate only ever runs on sparse (small) payloads, so the common
    # dense case pays exactly one pass
    entropy, payload = min(candidates, key=lambda cp: len(cp[1]))
    for code, pay in candidates:
        # cheap probe before the full pass: deflate only ever wins on
        # PERIODIC content (LZ redundancy is distributed, so a 256 KiB
        # level-1 sample detects it); dense music skips the full
        # level-6 pass it can never win
        probe = pay[: 1 << 18]
        if len(zlib.compress(probe, 1)) >= 0.95 * len(probe):
            continue
        zpay = zlib.compress(pay, 6)
        if len(zpay) < len(payload):
            entropy, payload = code + 3, zpay
    # third coder family, for tonal content: width-packed raw residual
    # bytes + deflate. A steady tone's residuals repeat with its period,
    # but Rice's bit-packed stream hides that from LZ's byte matcher;
    # byte-aligned residuals deflate ~5x smaller (measured 2.4% vs 12.6%
    # of PCM on a pure sine). Gated on small residuals (Rice k <= 3) so
    # dense music skips the extra deflate pass
    if float(np.mean(np.abs(flat, dtype=np.int64))) * 2.0 < 16.0:
        # int64 abs: an exact INT32_MIN residual would wrap to a
        # negative max under int32 and select width 1, truncating the
        # written stream (caught only at decode by its own CRC)
        mx = int(np.abs(flat.astype(np.int64)).max())
        width = 1 if mx < (1 << 7) else (2 if mx < (1 << 15) else 4)
        wdt = {1: np.int8, 2: np.int16, 4: np.int32}[width]
        zraw = zlib.compress(flat.astype(wdt).tobytes(), 6)
        if len(zraw) < len(payload):
            entropy, payload = {1: 5, 2: 6, 4: 7}[width], zraw
    # verbatim escape: incompressible content (white noise) costs ~17
    # Rice bits per 16-bit sample; falling back to raw PCM bounds the
    # worst case at container overhead (the FLAC VERBATIM guarantee).
    # Members are STORED (below), so plain byte length IS the on-disk
    # metric
    raw_bytes = n_samples * channels * bits // 8
    if raw_bytes < len(payload):
        entropy, stereo_mode, payload = 2, 0, _pack_raw(x, bits)
        orders = np.zeros((0, 0), dtype=np.uint8)
        smodes = None
        lpco = lpcc = None
    extra = {} if smodes is None else {"smodes": smodes}
    if lpco is not None:
        extra["lpco"] = lpco
        extra["lpcc"] = lpcc
    # random-access index: per-frame bit offsets into the (pre-deflate)
    # Rice stream. Additive — older readers ignore it; raw/verbatim
    # payloads (entropy 2, 5-7) need none (their offsets are arithmetic)
    if entropy in (0, 1, 3, 4) and f_real > 1:
        extra["fidx"] = fidx_by_base[entropy % 3]
    # FLAC-MD5-style integrity: CRC32 of the source PCM (the _pack_raw
    # byte stream at the declared depth). Decode verifies when present,
    # catching bit rot and coder regressions the structural checks
    # cannot; the member is additive, so older readers ignore it.
    extra["pcrc"] = np.asarray(
        [zlib.crc32(_pack_raw(x, bits))], dtype=np.uint32
    )
    buf = _io.BytesIO()
    # plain savez (STORED members): Rice output is already near-optimal
    # entropy, so deflating it costs ~0.3 s per audio-minute for < 0.5%
    # — and the verbatim branch is chosen exactly when raw PCM is
    # incompressible. np.load reads stored and deflated members alike,
    # so decoders accept either
    np.savez(
        buf,
        lmeta=np.asarray(
            [
                _VERSION_LPC2 if lpco is not None else _VERSION,
                sample_rate,
                channels,
                n_samples,
                frame,
                bits,
                stereo_mode,
                entropy,
            ],
            dtype=np.int64,
        ),
        orders=np.asarray(orders, dtype=np.uint8),
        res=np.frombuffer(payload, dtype=np.uint8),
        **extra,
    )
    return buf.getvalue()


def _pack_raw(x, bits):
    """int32 [S, C] -> little-endian 16-bit or packed 24-bit PCM bytes."""
    if bits == 16:
        return x.astype("<i2").tobytes()
    u = (x.ravel() & 0xFFFFFF).astype(np.uint32)
    b = np.empty((u.size, 3), dtype=np.uint8)
    b[:, 0] = u & 0xFF
    b[:, 1] = (u >> 8) & 0xFF
    b[:, 2] = (u >> 16) & 0xFF
    return b.tobytes()


def _bounded_inflate(buf: bytes) -> bytes:
    """Inflate a flagged-deflate residual payload with the allocation
    bounded by DEFLATE's ~1030:1 ceiling (the same bound
    io/bitstream._bounded_member applies to member reads) — a tampered
    stream cannot demand more than ~1030x its own size."""
    cap = 1030 * max(len(buf), 1) + 64
    d = zlib.decompressobj()
    try:
        out = d.decompress(buf, cap)
    except zlib.error as e:
        raise ValueError(
            f"corrupt lossless container: bad deflate stream ({e})"
        ) from e
    if d.unconsumed_tail or not d.eof:
        raise ValueError(
            "corrupt lossless container: deflate stream truncated or "
            "over the expansion bound"
        )
    return out


def _unpack_raw(buf, n_samples, channels, bits):
    width = bits // 8
    if buf.size != n_samples * channels * width:
        raise ValueError(
            f"corrupt lossless container: verbatim payload {buf.size} bytes "
            f"for {n_samples}x{channels} {bits}-bit samples"
        )
    if bits == 16:
        x = np.frombuffer(buf.tobytes(), dtype="<i2").astype(np.int32)
    else:
        b = buf.reshape(-1, 3)
        x = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x = np.where(x >= 1 << 23, x - (1 << 24), x)
    return x.reshape(n_samples, channels)


def _parse_lmeta(meta):
    """Validate the untrusted header member -> its eight fields.

    THE one place header fields are bounds-checked, shared by decode and
    describe so their accept/reject behavior can never drift."""
    if meta.shape != (8,):
        raise ValueError(f"corrupt lossless container: lmeta {meta.shape}")
    version, rate, channels, n_samples, frame, bits, stereo_mode, entropy = (
        int(v) for v in meta
    )
    if version not in (_VERSION, _VERSION_LPC, _VERSION_LPC2):
        raise ValueError(f"unsupported lossless container version {version}")
    if not 0 < channels <= _MAX_CHANNELS:
        raise ValueError(f"corrupt lossless container: channels {channels}")
    if not 0 < n_samples <= _MAX_SAMPLES:
        raise ValueError(f"corrupt lossless container: n_samples {n_samples}")
    if frame % 256 != 0 or not 256 <= frame <= _MAX_FRAME:
        raise ValueError(f"corrupt lossless container: frame {frame}")
    if bits not in (16, 24):
        raise ValueError(f"corrupt lossless container: bits {bits}")
    # 0 = independent, 1 = all mid/side, 2 = per-frame (smodes member)
    if stereo_mode not in (0, 1, 2) or (stereo_mode and channels != 2):
        raise ValueError("corrupt lossless container: bad stereo mode")
    # 3/4 = rice/rrice + deflate; 5/6/7 = deflated raw residuals at
    # byte width 1/2/4
    if entropy not in (0, 1, 2, 3, 4, 5, 6, 7):
        raise ValueError("corrupt lossless container: bad entropy code")
    if not 1 <= rate <= 1 << 31:
        raise ValueError(f"corrupt lossless container: rate {rate}")
    return version, rate, channels, n_samples, frame, bits, stereo_mode, entropy


def describe(data: bytes) -> dict:
    """Header fields of a lossless container (for `info`), without
    decoding the residual stream. Raises ValueError on corrupt input."""
    try:
        z = np.load(_io.BytesIO(data), allow_pickle=False)
    except _ZIP_ERRORS as e:
        raise ValueError(f"corrupt lossless container: {e}") from e
    if not hasattr(z, "files"):
        raise ValueError("corrupt lossless container: not an npz archive")
    try:
        fields = _parse_lmeta(
            _bounded_member(z, "lmeta", len(data), _SMALL_MEMBER_CAP)
        )
    except KeyError as e:
        raise ValueError(f"corrupt lossless container: missing member {e}") from e
    except _ZIP_ERRORS as e:
        raise ValueError(f"corrupt lossless container: bad member data ({e})") from e
    else:
        has_crc = "pcrc" in getattr(z, "files", ())
        has_fidx = "fidx" in getattr(z, "files", ())
    finally:
        z.close()
    version, rate, channels, n_samples, frame, bits, stereo_mode, entropy = fields
    return {
        "version": version,
        "integrity": "crc32" if has_crc else "none",
        # entropy 2 and 5-7 are byte-addressable without an index
        "seekable": bool(has_fidx or entropy in (2, 5, 6, 7)),
        "sample_rate": rate,
        "channels": channels,
        "n_samples": n_samples,
        "frame": frame,
        "bits": bits,
        "stereo_mode": {0: "independent", 1: "mid/side",
                        2: "per-frame"}[stereo_mode],
        "entropy": {0: "rice", 1: "rrice", 2: "verbatim",
                    3: "rice+deflate", 4: "rrice+deflate",
                    5: "raw8+deflate", 6: "raw16+deflate",
                    7: "raw32+deflate"}[entropy],
    }


def decode_lossless(data: bytes, start: int = 0, count: int | None = None,
                    device="cuda"):
    """Container bytes -> (int32 samples [samples, channels], rate, bits).

    Bit-exact inverse of :func:`encode_lossless`. Raises ValueError on
    corrupt input — never a raw zipfile error, never an allocation driven
    by attacker-declared sizes (same hardening contract as
    io/bitstream.unpack).

    :param start: first sample to decode (random access). Containers
        written since round 5 carry a per-frame bit-offset index
        (`fidx`), making the DECODE work proportional to the requested
        range (for the flagged-deflate payloads, entropy 3/4, the
        deflate layer still inflates in full first — deflate has no
        random access — so those pay O(stream) inflate + O(range)
        everything else); older Rice-coded streams decode the prefix up
        to the range's last frame (still cheaper than a full
        decode+slice). The returned slice is bit-exact versus the same
        rows of a full decode.
    :param count: number of samples (default: to the end; clamped).
    :raises ValueError: when `start` is outside the stream or `count`
        is not positive.
    :param device: where the integration runs (the card unless the caller
        asks for the CPU); the samples come back as numpy.

    The whole-stream PCM CRC is only verifiable on a FULL decode;
    partial decodes rely on the structural checks (bounds-checked
    members, bit-depth range) instead."""
    try:
        z = np.load(_io.BytesIO(data), allow_pickle=False)
    except _ZIP_ERRORS as e:
        raise ValueError(f"corrupt lossless container: {e}") from e
    if not hasattr(z, "files"):
        raise ValueError("corrupt lossless container: not an npz archive")
    try:
        version, rate, channels, n_samples, frame, bits, stereo_mode, entropy = (
            _parse_lmeta(_bounded_member(z, "lmeta", len(data), _SMALL_MEMBER_CAP))
        )
        f = -(-n_samples // frame)
        total = f * frame * channels
        start = int(start)
        if start < 0 or start >= n_samples:
            raise ValueError(
                f"start {start} outside the stream's [0, {n_samples}) samples"
            )
        if count is not None and int(count) <= 0:
            raise ValueError(f"count must be positive, got {count}")
        end = n_samples if count is None else min(start + int(count), n_samples)
        full = start == 0 and end == n_samples
        f0 = start // frame
        f1 = -(-end // frame)
        payload = _bounded_member(z, "res", len(data))
        fidx = None
        if entropy in (0, 1, 3, 4) and "fidx" in getattr(z, "files", ()):
            fidx = np.asarray(
                _bounded_member(
                    z, "fidx", len(data), max(total, _SMALL_MEMBER_CAP)
                )
            )
            if fidx.shape != (f,) or not np.issubdtype(
                fidx.dtype, np.integer
            ):
                raise ValueError("corrupt lossless container: fidx member")
            fidx = fidx.astype(np.int64)
            if int(fidx[0]) != 0 or (np.diff(fidx) < 0).any() or (
                fidx < 0
            ).any():
                raise ValueError(
                    "corrupt lossless container: fidx not monotonic"
                )
        orders = None
        if entropy != 2:
            orders = np.asarray(
                _bounded_member(
                    z, "orders", len(data), max(total, _SMALL_MEMBER_CAP)
                )
            )
            if orders.shape != (f, channels):
                raise ValueError(
                    f"corrupt lossless container: orders {orders.shape} for "
                    f"{f} frames x {channels} channels"
                )
            if not np.issubdtype(orders.dtype, np.integer):
                raise ValueError(
                    f"corrupt lossless container: orders dtype {orders.dtype}"
                )
            max_order = LPC_MARK if version >= _VERSION_LPC else MAX_ORDER
            if (
                orders.max(initial=0) > max_order
                or orders.min(initial=0) < 0
            ):
                raise ValueError("corrupt lossless container: order out of range")
        smodes = None
        if entropy != 2 and stereo_mode == 2:
            smodes = np.asarray(
                _bounded_member(
                    z, "smodes", len(data), max(total, _SMALL_MEMBER_CAP)
                )
            )
            if smodes.shape != (f,):
                raise ValueError(
                    f"corrupt lossless container: smodes {smodes.shape} "
                    f"for {f} frames"
                )
            if not np.issubdtype(smodes.dtype, np.integer):
                raise ValueError(
                    f"corrupt lossless container: smodes dtype {smodes.dtype}"
                )
            if smodes.max(initial=0) > 3 or smodes.min(initial=0) < 0:
                raise ValueError(
                    "corrupt lossless container: stereo frame mode out of range"
                )
        lpc = lpco = lpcc = None
        if (
            entropy != 2
            and orders is not None
            and (orders == LPC_MARK).any()
        ):
            if version >= _VERSION_LPC2:
                n_marked = int((orders == LPC_MARK).sum())
                lpco = np.asarray(
                    _bounded_member(
                        z, "lpco", len(data), max(total, _SMALL_MEMBER_CAP)
                    )
                )
                if lpco.shape != (n_marked, 2):
                    raise ValueError(
                        f"corrupt lossless container: lpco {lpco.shape} for "
                        f"{n_marked} LPC frames"
                    )
                if not np.issubdtype(lpco.dtype, np.integer):
                    raise ValueError(
                        f"corrupt lossless container: lpco dtype {lpco.dtype}"
                    )
                lpco = lpco.astype(np.int32)
                if (
                    lpco[:, 0].min(initial=1) < 1
                    or lpco[:, 0].max(initial=1) > _LPC_FORMAT_MAX_ORDER
                    or lpco[:, 0].max(initial=0) >= frame
                    or lpco[:, 1].min(initial=0) < 0
                    or lpco[:, 1].max(initial=0) > 31
                ):
                    raise ValueError(
                        "corrupt lossless container: lpc order/shift out of "
                        "range"
                    )
                lpcc = np.asarray(
                    _bounded_member(
                        z, "lpcc", len(data), max(total, _SMALL_MEMBER_CAP)
                    )
                )
                if (
                    lpcc.ndim != 1
                    or lpcc.size != int(lpco[:, 0].sum())
                    or not np.issubdtype(lpcc.dtype, np.integer)
                ):
                    raise ValueError(
                        "corrupt lossless container: lpcc member does not "
                        "match the declared predictor orders"
                    )
                if (
                    lpcc.size
                    and (lpcc.max() > 32767 or lpcc.min() < -32768)
                ):
                    raise ValueError(
                        "corrupt lossless container: lpc coefficient out of "
                        "range"
                    )
                lpcc = lpcc.astype(np.int32)
            else:  # version 2: dense fixed-order member
                lpc = np.asarray(
                    _bounded_member(
                        z, "lpc", len(data), max(total, _SMALL_MEMBER_CAP)
                    )
                )
                if lpc.shape != (f, LPC_ORDER, channels):
                    raise ValueError(
                        f"corrupt lossless container: lpc {lpc.shape} for "
                        f"{f} frames x order {LPC_ORDER} x {channels} channels"
                    )
                if not np.issubdtype(lpc.dtype, np.integer):
                    raise ValueError(
                        f"corrupt lossless container: lpc dtype {lpc.dtype}"
                    )
                if lpc.max(initial=0) > 32767 or lpc.min(initial=0) < -32768:
                    raise ValueError(
                        "corrupt lossless container: lpc coefficient out of "
                        "range"
                    )
                lpc = lpc.astype(np.int32)
        pcrc = None
        if "pcrc" in getattr(z, "files", ()):
            pcrc_arr = np.asarray(
                _bounded_member(z, "pcrc", len(data), _SMALL_MEMBER_CAP)
            )
            if pcrc_arr.shape != (1,) or not np.issubdtype(
                pcrc_arr.dtype, np.integer
            ):
                raise ValueError("corrupt lossless container: pcrc member")
            pcrc = int(pcrc_arr[0]) & 0xFFFFFFFF
    except KeyError as e:
        raise ValueError(f"corrupt lossless container: missing member {e}") from e
    except _ZIP_ERRORS as e:
        raise ValueError(f"corrupt lossless container: bad member data ({e})") from e
    finally:
        z.close()

    if entropy == 2:
        # byte-addressable: validate the full payload size, then unpack
        # only the requested rows (a seek into a verbatim archive never
        # materializes the whole stream)
        payload = np.asarray(payload)
        width = bits // 8
        if payload.size != n_samples * channels * width:
            raise ValueError(
                f"corrupt lossless container: verbatim payload "
                f"{payload.size} bytes for {n_samples}x{channels} "
                f"{bits}-bit samples"
            )
        x = _unpack_raw(
            payload[start * channels * width : end * channels * width],
            end - start, channels, bits,
        )
    else:
        cf = channels * frame  # wire values per frame
        fr = f1 - f0
        buf = payload.tobytes()
        if entropy >= 3:
            buf = _bounded_inflate(buf)
        if entropy >= 5:
            width = {5: 1, 6: 2, 7: 4}[entropy]
            if len(buf) != total * width:
                raise ValueError(
                    f"corrupt lossless container: {len(buf)} residual "
                    f"bytes for {total} width-{width} values"
                )
            wdt = {1: np.int8, 2: "<i2", 4: "<i4"}[width]
            flat = np.frombuffer(
                buf[f0 * cf * width : f1 * cf * width], dtype=wdt
            ).astype(np.int32)
        else:
            # plain Rice spends >=1 bit/value; run-length Rice amortizes
            # a 256-zero group to ~22 bits (~96 values/byte) — same bound
            # as the spectral container's _checked_shape. Applied
            # POST-inflate so a deflated declared-huge stream cannot
            # dodge it
            if total > 96 * max(len(buf), 1):
                raise ValueError(
                    f"corrupt lossless container: {total} values declared "
                    f"from a {len(buf)}-byte residual stream"
                )
            decode = (
                native.rice_decode if entropy % 3 == 0 else native.rrice_decode
            )
            if fidx is not None and f0 > 0:
                # random access: jump straight to frame f0's group
                # header and decode only the range's values
                if int(fidx.max()) >= 8 * max(len(buf), 1):
                    raise ValueError(
                        "corrupt lossless container: fidx beyond stream"
                    )
                flat = decode(buf, fr * cf, start_bit=int(fidx[f0]))
            else:
                # no index (pre-round-5 stream) or range starts at 0:
                # decode the PREFIX through the range's last frame —
                # work proportional to f1, never the whole stream
                flat = decode(buf, f1 * cf)[f0 * cf :]
        # restrict the per-frame members to the decoded range (sparse
        # LPC members slice by prefix-summing the full mark mask, which
        # was validated against the full orders member above)
        if lpco is not None:
            mark_f = np.asarray(orders) == LPC_MARK
            e0 = int(mark_f[:f0].sum())
            e1 = int(mark_f[:f1].sum())
            c0 = int(lpco[:e0, 0].sum())
            c1 = c0 + int(lpco[e0:e1, 0].sum())
            lpco, lpcc = lpco[e0:e1], lpcc[c0:c1]
            if lpco.shape[0] == 0:
                lpco = lpcc = None
        if lpc is not None:
            lpc = np.ascontiguousarray(lpc[f0:f1])
            if not (np.asarray(orders)[f0:f1] == LPC_MARK).any():
                lpc = None
        orders = np.asarray(orders)[f0:f1]
        if smodes is not None:
            smodes = smodes[f0:f1]
        f = fr
        # the wire stream goes to the device as-is: unwiring and
        # integration run there, and the samples come back once
        mark_all = (
            (lpc is not None or lpco is not None)
            and bool((np.asarray(orders) == LPC_MARK).all())
        )
        if mark_all:
            # every run is LPC (common for tonal material at level 2):
            # the native variable-order pass below produces EVERY
            # sample, so skip the device integrator's masked cumsums
            x = np.zeros((f * frame, channels), dtype=np.int32)
        else:
            # LPC frames (orders == LPC_MARK) integrate natively below;
            # the device program sees them as order 0 (identity) and is
            # overwritten — same frame independence, different filter
            ordr = np.where(orders == LPC_MARK, 0, orders).astype(np.int32)
            x = _reconstruct_flat(
                torch.from_numpy(np.ascontiguousarray(flat, np.int32))
                .to(device),
                torch.from_numpy(ordr).to(device),
            ).cpu().numpy()
        if lpc is not None or lpco is not None:
            # LPC frames: expand the (sparse v3 / dense v2) predictor
            # members into per-(frame, channel) order/shift/coefficient
            # arrays and run ONE native variable-order pass over the
            # wire layout; the device integrator's output for those
            # runs is replaced wholesale
            mark = np.asarray(orders) == LPC_MARK
            if lpco is not None:  # v3 sparse
                maxo = int(lpco[:, 0].max())
                ordv = np.zeros((f, channels), np.int32)
                shiftv = np.zeros((f, channels), np.int32)
                qc = np.zeros((f, maxo, channels), np.int32)
                ff, cc = np.nonzero(mark)
                ordv[ff, cc] = lpco[:, 0]
                shiftv[ff, cc] = lpco[:, 1]
                cmask = (
                    np.arange(maxo)[None, :] < lpco[:, 0][:, None]
                )
                block = np.zeros((lpco.shape[0], maxo), np.int32)
                block[cmask] = lpcc
                qc[ff, :, cc] = block
            else:  # v2 dense fixed order/shift
                ordv = np.where(mark, LPC_ORDER, 0).astype(np.int32)
                shiftv = np.where(mark, LPC_SHIFT, 0).astype(np.int32)
                qc = lpc
            xl = native.lpc_reconstruct_wire(flat, ordv, shiftv, qc)
            xv = x[: f * frame].reshape(f, frame, channels)
            np.copyto(
                xv, xl.reshape(f, frame, channels),
                where=mark[:, None, :],
            )
        row0 = start - f0 * frame
        x = x[row0 : row0 + (end - start)]
        if stereo_mode == 2:
            sm = np.repeat(smodes.astype(np.uint8), frame)[
                row0 : row0 + (end - start)
            ]
            x = _from_modes(x, sm)
        elif stereo_mode:
            x = _from_ms(x)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    if x.min() < lo or x.max() > hi:
        raise ValueError("corrupt lossless container: samples exceed bit depth")
    # the PCM CRC covers the whole stream — verifiable only on a full
    # decode; partial decodes rely on the structural checks above
    if full and pcrc is not None and (
        zlib.crc32(_pack_raw(np.ascontiguousarray(x), bits)) & 0xFFFFFFFF
    ) != pcrc:
        raise ValueError(
            "lossless container integrity check failed (PCM CRC mismatch)"
        )
    return x, rate, bits


def is_lossless_bytes(data: bytes) -> bool:
    """Cheap sniff: is this blob a lossless container?"""
    try:
        with zipfile.ZipFile(_io.BytesIO(data)) as zf:
            return "lmeta.npy" in zf.namelist()
    except Exception:
        return False


def is_lossless_file(path: str) -> bool:
    try:
        with open(path, "rb") as fh:
            return is_lossless_bytes(fh.read())
    except OSError:
        return False
