"""Rate control in PyTorch (counterpart of ``audiocodec_tpu/rate.py``): encode
to a target bitrate.

The codec is natively VBR — bits follow the masking threshold. For
transport budgets, this module finds the threshold scale gamma whose packed
size hits a target bitrate: scaling every quantization step by gamma > 1
coarsens codes monotonically.

The search: every scale trial of a round is one batched quantize on the
codec's device (the K trials x B clips as K*B rows), sizes come from
actually packing each trial on the host (entropy coding included, in a
thread pool: the native coder and zlib release the GIL), and refinement
rounds re-grid each clip inside its own bracketing interval. A whole batch
of clips is rate-controlled at once, each clip converging to its own
scale.

    result = rate.encode_with_target_bitrate(codec, x, target_kbps=96)
    result.codes, result.bark16, result.threshold_scale, result.kbps

    results = rate.encode_with_target_bitrate_batch(codec, xs, 96.0)

The host spans of a search are labelled for ``torch.profiler``:
``rate.analysis``, ``rate.trials`` (the device passes of a round) and
``rate.pack`` (its packs).
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from audiocodec_tpu_torch import blockswitch as _blockswitch
from audiocodec_tpu_torch import bwe as _bwe
from audiocodec_tpu_torch import intensity as _intensity
from audiocodec_tpu_torch import native as _native
from audiocodec_tpu_torch import nf as _nf
from audiocodec_tpu_torch import quantize as _quantize
from audiocodec_tpu_torch import tns as _tns
from audiocodec_tpu_torch.io import bitstream as _bitstream

_span = torch.profiler.record_function


@dataclasses.dataclass
class RateControlResult:
    """One clip's winning encode: its payload on the host (codes and
    members numpy, the sidecar a CPU bfloat16 tensor) and its container."""

    codes: np.ndarray
    bark16: torch.Tensor
    threshold_scale: float
    kbps: float
    packed: bytes
    dz_recon: float = 0.0
    tns_idx: np.ndarray | None = None
    tns_band_start: int = 0
    nf_levels: np.ndarray | None = None
    nf_band_start: int = 0
    bs_flags: np.ndarray | None = None
    bwe_gains: np.ndarray | None = None
    bwe_start: int = 0
    is_gains: np.ndarray | None = None
    is_start: int = 0


def resolve_deadzone(deadzone, target_kbps, channels, sample_rate) -> float:
    """Resolve the dead-zone width for a target bitrate.

    "auto" picks from the target rate normalized to one 44.1 kHz channel
    (the JAX package's measured matched-rate crossover): 1.0 below 48
    kbps, 0.9 below 80, 0.7 below 120, plain rounding (0.5) above.
    """
    if deadzone != "auto":
        z = float(deadzone)
    else:
        kb = target_kbps / max(channels, 1) / (sample_rate / 44100.0)
        if kb >= 120.0:
            z = 0.5
        elif kb >= 80.0:
            z = 0.7
        elif kb >= 48.0:
            z = 0.9
        else:
            z = 1.0
    if not 0.5 <= z <= 2.0:
        raise ValueError(f"deadzone must be in [0.5, 2.0], got {z}")
    return z


def _meta(codec, ms):
    return dict(
        sample_rate=codec.psycho.sample_rate,
        filters_n=codec.mdct.filters_n,
        bark_bands_n=codec.psycho.bark_bands_n,
        alpha=codec.psycho.alpha,
        window_type=codec.mdct.window_type,
        compute_dtype=_bitstream.dtype_name(codec.mdct.compute_dtype),
        ms=ms,
        bark_precision=codec.psycho.bark_precision,
        sidecar_grid=codec.sidecar_grid,
    )


def _rows(t: torch.Tensor | None, k: int):
    """``t`` [B, ...] repeated for ``k`` trials: row k*B + b is clip b."""
    return None if t is None else t.repeat(k, *(1,) * (t.ndim - 1))


class _Trials:
    """The scale-independent analysis of a batch, done once, and the
    per-scale quantize of any number of trials as one batched pass on the
    codec's device (the port of the JAX search's jitted, vmapped
    closures)."""

    def __init__(self, codec, x, drown, ms, tmask, bs, tns, nf, bwe,
                 intensity, deadzone):
        self.z = deadzone
        self.batch = x.shape[0]
        self.dtype = codec.mdct.compute_dtype
        # One-time analysis: the bitstream-critical derivation lives in
        # Codec.analyze_for_quantization; trials only re-quantize.
        self.spec, self.bark16, self.base, self.flags = (
            codec.analyze_for_quantization(
                codec.mdct.transform(x), drown, ms=ms, tmask=tmask, bs=bs
            )
        )
        self.tns_idx, self.tns_bs = None, 0
        if tns:
            self.tns_bs = codec.tns_band_start
            idx = _tns.analyze(self.spec, self.tns_bs)
            if self.flags is not None:
                # short frames never TNS-filter (the codec's own gate)
                idx = torch.where(self.flags[:, :, None, None], 0, idx)
            self.tns_idx = idx
            self.spec = _tns.filter_forward(self.spec, idx, self.tns_bs)
        if self.flags is not None:
            # flags are scale-independent: split ONCE, every trial
            # quantizes the switched spectrum (the codec's encode order)
            self.spec = _blockswitch.split_spectrum(
                self.spec, self.flags, precision=codec.mdct.dct_precision
            )
        self.excl, self.is_bs = None, 0
        if intensity:
            if not ms:
                raise ValueError("intensity stereo requires ms=True")
            self.is_bs = codec.is_start
            self.excl = _intensity.owned_mask(
                codec.mdct.filters_n, self.is_bs, x.device
            )
        self.intensity = intensity
        # the host's copies of the scale-independent payload, for packing
        self.bark_host = self.bark16.cpu()
        self.tns_host = (None if self.tns_idx is None
                         else self.tns_idx.cpu().numpy())
        self.flags_host = (None if self.flags is None
                           else self.flags.cpu().numpy())
        self.nf_bs = codec.nf_band_start if nf else 0
        self.bwe_bs = codec.bwe_start if bwe else 0
        self.bwe = bwe

    def quantize(self, scales: np.ndarray):
        """scales [K, B] (float64) -> (spectra, codes, step sizes), each
        [K*B, frames, N, C] on the device, row k*B + b the trial k of clip
        b. The order of operations is the encoder's and the decoder's
        (Codec._decode_threshold): (threshold * scale), then the TNS gain
        compensation, then the block-switch pooling last — float products
        are not associative, and step sizes must be bit-identical on both
        sides. With intensity the forced side-band zeroing is applied
        here, so that trial sizes measure the codes the container ships.
        """
        k = scales.shape[0]
        scale = torch.from_numpy(np.ascontiguousarray(scales).reshape(-1))
        scale = scale.to(device=self.base.device, dtype=self.dtype)
        thr = _rows(self.base, k) * scale[:, None, None, None]
        flags = _rows(self.flags, k)
        if self.tns_idx is not None:
            thr = _tns.scaled_threshold(thr, _rows(self.tns_idx, k),
                                        self.tns_bs)
        if flags is not None:
            thr = _blockswitch.pool_threshold(thr, flags)
        spec = _rows(self.spec, k)
        codes, delta = _quantize.quantize(spec, thr, deadzone=self.z)
        if self.intensity:
            codes = _intensity.force_codes(codes, self.is_bs, flags)
        return spec, codes, delta

    def _short_zeroed(self, values, k):
        """Zero a member on the short block-switch frames of the rows."""
        if self.flags is None:
            return values
        mask = _rows(self.flags, k)
        return torch.where(mask.reshape(*mask.shape,
                                        *(1,) * (values.ndim - 2)),
                           0, values)

    def bwe_gains(self, spec, codes, delta, k):
        g = _bwe.analyze(spec, codes, delta, self.bwe_bs, exclude=self.excl)
        return self._short_zeroed(g, k)

    def nf_levels(self, spec, codes, delta, k):
        nfl = _nf.analyze(spec, codes, delta, self.nf_bs, deadzone=self.z,
                          band_end=self.bwe_bs if self.bwe else None,
                          exclude=self.excl)
        return self._short_zeroed(nfl, k)

    def is_gains(self, spec, codes, delta, bwe_gains, k):
        mid_ref = None
        if bwe_gains is not None:
            # project onto the bwe-reconstructed mid, exactly as the
            # shipped encode does (Codec._intensity_gains)
            mid_ref = _intensity.mid_reference(
                codes, delta, self.dtype, bwe_gains=bwe_gains,
                bwe_start=self.bwe_bs, exclude=self.excl,
            )
        g = _intensity.analyze(spec, codes, delta, self.is_bs,
                               mid_ref=mid_ref)
        return self._short_zeroed(g, k)

    def members(self, scales: np.ndarray, nf: bool = False):
        """The trials of ``scales`` [K, B] on the host: codes [K, B, frames,
        N, C] and the per-trial members (bwe gains, intensity gains, and
        with ``nf`` the noise-fill levels), each [K, B, ...] or None."""
        k = scales.shape[0]
        spec, codes, delta = self.quantize(scales)
        gains = (self.bwe_gains(spec, codes, delta, k) if self.bwe
                 else None)
        out = {"codes": codes, "bwe": gains,
               "isg": (self.is_gains(spec, codes, delta, gains, k)
                       if self.intensity else None),
               "nfl": (self.nf_levels(spec, codes, delta, k) if nf
                       else None)}
        return {name: None if v is None else
                v.cpu().numpy().reshape(k, self.batch, *v.shape[1:])
                for name, v in out.items()}


def encode_with_target_bitrate_batch(
    codec,
    x,
    target_kbps,
    drown=0.0,
    tolerance: float = 0.05,
    trials_per_round: int = 8,
    log2_scale_range=(-4.0, 10.0),
    ms: bool = False,
    deadzone="auto",
    tns: bool = False,
    nf: bool = False,
    tmask: float = 0.0,
    bs: bool = False,
    bwe: bool = False,
    intensity: bool = False,
    orig_samples: int = 0,
    lufs=None,
) -> list:
    """Rate-control every clip of a batch to ``target_kbps``.

    :param x: waveform [B, samples, channels] on the codec's device, in its
        compute dtype; every clip gets its own threshold scale.
    :param target_kbps: a scalar, or one value per clip.
    :param tolerance: relative bitrate error under which a round's grid is
        accepted for every clip and the refinement rounds stop.
    :param deadzone: zero-bin half-width (quantize.quantize), or "auto" to
        pick from the target rate (resolve_deadzone). All trials and the
        final pack share one value; its reconstruction offset is recorded
        in every container and returned as ``dz_recon``.
    :param tns: temporal noise shaping: the filter decision and taps depend
        only on the spectrum's shape, so they are computed once and every
        trial quantizes the same filtered spectrum; the indices ride every
        trial pack and the final container.
    :param nf: noise filling: levels depend on the final codes, so they are
        computed once for the winning scale and ride only the final
        container.
    :param bwe: bandwidth extension: every trial computes and packs its own
        gains, whose deflated size is a real fraction of a low-rate budget.
    :param lufs: loudness tag: a scalar for every clip, or one per clip.
    :return: list of B :class:`RateControlResult`.
    """
    batch = x.shape[0]
    target_kbps = np.asarray(target_kbps, dtype=float)
    if not (np.isfinite(target_kbps).all() and (target_kbps > 0).all()):
        raise ValueError(f"target_kbps must be positive, got {target_kbps}")
    if target_kbps.ndim > 1 or (
        target_kbps.ndim == 1 and target_kbps.shape[0] != batch
    ):
        raise ValueError(
            f"target_kbps must be a scalar or one value per clip "
            f"({batch}), got shape {target_kbps.shape}"
        )
    lufs_per_clip = None
    if lufs is not None:
        lufs_per_clip = (
            [float(v) for v in lufs]
            if np.ndim(lufs) > 0 or isinstance(lufs, (list, tuple))
            else [float(lufs)] * batch
        )
        if len(lufs_per_clip) != batch:
            raise ValueError(
                f"lufs needs one value per clip ({batch}), got "
                f"{len(lufs_per_clip)}"
            )
    seconds = x.shape[1] / codec.psycho.sample_rate
    # trials and final packs share ONE dead zone (it rides the container
    # header); per-clip targets resolve it from their mean rate
    z = resolve_deadzone(
        deadzone, float(np.mean(target_kbps)), x.shape[-1],
        codec.psycho.sample_rate,
    )
    dz_recon = _quantize.dz_recon_offset(z) if z != 0.5 else 0.0
    with torch.no_grad(), _span("rate.analysis"):
        trials = _Trials(codec, x, drown, ms, tmask, bs, tns, nf, bwe,
                         intensity, z)
    bark, tns_idx, bs_flags = (trials.bark_host, trials.tns_host,
                               trials.flags_host)
    meta = _meta(codec, ms)
    if orig_samples:
        # exact-length (gapless) round trips: the container records the
        # pre-padding sample count; trial packs carry it too so trial and
        # final sizes stay aligned
        meta["orig_samples"] = int(orig_samples)

    def pack_one(b, codes, scale, entropy="auto", nfl=None, bweg=None,
                 isg=None):
        return _bitstream.pack(
            codes[b:b + 1], bark[b:b + 1], threshold_scale=scale,
            entropy=entropy, dz_recon=dz_recon,
            tns_idx=None if tns_idx is None else tns_idx[b:b + 1],
            tns_band_start=trials.tns_bs,
            nf_levels=None if nfl is None else nfl[b:b + 1],
            nf_band_start=trials.nf_bs,
            bs_flags=None if bs_flags is None else bs_flags[b:b + 1],
            bwe_gains=None if bweg is None else bweg[b:b + 1],
            bwe_start=trials.bwe_bs,
            is_gains=None if isg is None else isg[b:b + 1],
            is_start=trials.is_bs,
            lufs=None if lufs_per_clip is None else lufs_per_clip[b],
            **meta,
        )

    # K x B trial packs between the device passes are the host's share of
    # the search: the native Rice coder and zlib release the GIL, so a
    # thread pool fans them out over the cores
    with ThreadPoolExecutor(max_workers=min(32, os.cpu_count() or 4)) as pool:
        return _search(pool, trials, pack_one, batch, seconds,
                       target_kbps, tolerance, trials_per_round,
                       log2_scale_range, dz_recon, nf)


def _search(pool, trials, pack_one, batch, seconds, target_kbps, tolerance,
            trials_per_round, log2_scale_range, dz_recon, nf):
    target_kbps = np.broadcast_to(
        np.asarray(target_kbps, dtype=float), (batch,)
    )
    # Trials must pack with the SAME coder selection the final pack ships
    # ("auto" = best of rice/rrice after deflate), or the search converges
    # on a size the container won't have
    trial_entropy = "auto" if _native.available() else "zlib"

    def sizes(log2_scales):
        """Pack every (trial, clip) concurrently; return kbps [K, B]."""
        with torch.no_grad(), _span("rate.trials"):
            got = trials.members(2.0 ** log2_scales)
        k_n = log2_scales.shape[0]
        pairs = [(k, b) for k in range(k_n) for b in range(batch)]
        with _span("rate.pack"):
            packs = list(pool.map(
                lambda kb: len(pack_one(
                    kb[1], got["codes"][kb[0]],
                    float(2.0 ** log2_scales[kb[0], kb[1]]),
                    entropy=trial_entropy,
                    bweg=None if got["bwe"] is None else got["bwe"][kb[0]],
                    isg=None if got["isg"] is None else got["isg"][kb[0]],
                )),
                pairs,
            ))
        kbps = np.empty(log2_scales.shape)
        for (k, b), nbytes in zip(pairs, packs):
            kbps[k, b] = nbytes * 8 / seconds / 1000
        return kbps

    k_trials = max(4, trials_per_round)
    lo, hi = log2_scale_range
    # Round 1: a shared log-spaced grid brackets each clip's target.
    grid1 = np.broadcast_to(
        np.linspace(lo, hi, k_trials)[:, None], (k_trials, batch)
    ).copy()
    kbps1 = sizes(grid1)

    # Refinement rounds: while any clip is outside tolerance, re-grid each
    # clip inside its tightest bracketing interval (kbps is monotone
    # nonincreasing in the scale); each round shrinks the bracket
    # ~(k_trials+1)x.
    all_grids, all_kbps = grid1, kbps1
    for _ in range(3):
        best = np.min(np.abs(all_kbps - target_kbps), axis=0)
        if bool((best <= tolerance * target_kbps).all()):
            break
        grid_next = np.empty_like(grid1)
        for b in range(batch):
            above = all_kbps[:, b] >= target_kbps[b]
            below = all_kbps[:, b] <= target_kbps[b]
            g_lo = all_grids[above, b].max() if above.any() else lo
            g_hi = all_grids[below, b].min() if below.any() else hi
            if g_hi < g_lo:
                g_lo, g_hi = g_hi, g_lo
            # interior points only — the endpoints were already probed
            grid_next[:, b] = np.linspace(g_lo, g_hi, k_trials + 2)[1:-1]
        kbps_next = sizes(grid_next)
        all_grids = np.concatenate([all_grids, grid_next], axis=0)
        all_kbps = np.concatenate([all_kbps, kbps_next], axis=0)

    # Final pass: every clip's winning scale in ONE device pass. The
    # winning scale goes straight from float64 to the compute dtype, as
    # the decoder casts the container's float64 threshold_scale.
    k_best = np.argmin(np.abs(all_kbps - target_kbps), axis=0)
    win_scales = 2.0 ** all_grids[k_best, np.arange(batch)]
    with torch.no_grad(), _span("rate.trials"):
        win = {name: None if v is None else v[0] for name, v in
               trials.members(win_scales[None, :], nf=nf).items()}
    with _span("rate.pack"):
        final_packs = list(pool.map(
            lambda b: pack_one(b, win["codes"], float(win_scales[b]),
                               nfl=win["nfl"], bweg=win["bwe"],
                               isg=win["isg"]),
            range(batch),
        ))

    def clip(v, b):
        return None if v is None else v[b:b + 1]

    return [
        RateControlResult(
            codes=win["codes"][b:b + 1],
            bark16=trials.bark_host[b:b + 1],
            threshold_scale=float(win_scales[b]),
            kbps=len(final_packs[b]) * 8 / seconds / 1000,
            packed=final_packs[b],
            dz_recon=dz_recon,
            tns_idx=clip(trials.tns_host, b),
            tns_band_start=trials.tns_bs,
            nf_levels=clip(win["nfl"], b),
            nf_band_start=trials.nf_bs,
            bs_flags=clip(trials.flags_host, b),
            bwe_gains=clip(win["bwe"], b),
            bwe_start=trials.bwe_bs,
            is_gains=clip(win["isg"], b),
            is_start=trials.is_bs,
        )
        for b in range(batch)
    ]


def reservoir_allocate(demand, budget, reservoir, floor=0.0):
    """Bit-reservoir allocation: distribute ``budget`` bits over chunks
    proportionally to ``demand`` (the bits each chunk takes at UNIFORM
    quality) while keeping the running deviation from the constant-rate
    schedule inside ``±reservoir`` bits — the transport guarantee a CBR
    buffer model needs, relaxed by one reservoir's worth of burstiness.

    With per-chunk schedule ``share = budget / n``, every prefix satisfies
    ``|sum(alloc[:i]) − i·share| ≤ reservoir``. ``reservoir = 0`` is plain
    CBR (equal shares); ``reservoir ≥ max excursion of the demand``
    reproduces the demand itself. Greedy forward waterfill: bits a chunk
    cannot spend carry forward for later chunks, with a final
    renormalization so the total lands on ``budget``.

    :param demand: per-chunk demand in bits, shape [n].
    :param budget: total bits to distribute.
    :param reservoir: max absolute excursion in bits (≥ 0).
    :param floor: minimum bits per chunk (headers/sidecar floor).
    :return: per-chunk allocation in bits, shape [n], summing to ~budget.
    """
    demand = np.asarray(demand, dtype=float)
    n = demand.shape[0]
    if n == 0:
        return demand.copy()
    budget = float(budget)
    reservoir = float(reservoir)
    if reservoir < 0 or not np.isfinite(reservoir):
        raise ValueError(f"reservoir must be finite and >= 0: {reservoir}")
    if (demand < 0).any() or demand.sum() <= 0:
        raise ValueError("demand must be nonnegative with positive sum")
    share = budget / n

    def waterfill(t):
        out = np.empty_like(t)
        carry = 0.0  # unspendable bits banked for later chunks
        dv = 0.0
        for i in range(n):
            lo = max(share - reservoir - dv, floor)
            hi = max(share + reservoir - dv, floor)
            want = t[i] + carry
            out[i] = min(max(want, lo), hi)
            carry = want - out[i]
            dv += out[i] - share
        return out

    t = demand * (budget / demand.sum())
    for _ in range(8):
        dev = np.cumsum(t) - share * np.arange(1, n + 1)
        if (np.abs(dev) <= reservoir * (1 + 1e-9) + 1e-6).all() and (
            t >= floor - 1e-9
        ).all():
            break
        t = waterfill(t)
        # bits left un-placed (or over-placed) at the end: spread the
        # residual multiplicatively and re-clamp next iteration
        if t.sum() > 0:
            t *= budget / t.sum()
    # the excursion bound is HARD (a CBR decoder-buffer model relies on
    # it); the budget is best-effort within it. The renormalization above
    # can push chunks back over the bound, so the LAST operation is a
    # clamping pass — idempotent on already-feasible schedules. Only
    # `floor` may override the bound (headers must fit).
    return waterfill(t)


def encode_with_target_bitrate(
    codec,
    x,
    target_kbps: float,
    drown=0.0,
    tolerance: float = 0.05,
    max_iters: int = 10,
    log2_scale_range=(-4.0, 10.0),
    ms: bool = False,
    deadzone="auto",
    tns: bool = False,
    nf: bool = False,
    tmask: float = 0.0,
    bs: bool = False,
    bwe: bool = False,
    intensity: bool = False,
    orig_samples: int = 0,
    lufs=None,
) -> RateControlResult:
    """Single-clip rate control (the batch path with B=1).

    :param x: waveform [1, samples, channels].
    :param max_iters: total trial budget (split over the rounds; kept for
        API compatibility with a serial bisection).
    """
    if x.shape[0] != 1:
        raise ValueError(
            "encode_with_target_bitrate takes a single clip; use "
            "encode_with_target_bitrate_batch for batches"
        )
    return encode_with_target_bitrate_batch(
        codec,
        x,
        target_kbps,
        drown=drown,
        tolerance=tolerance,
        trials_per_round=max(4, (max_iters + 1) // 2),
        log2_scale_range=log2_scale_range,
        ms=ms,
        deadzone=deadzone,
        tns=tns,
        nf=nf,
        tmask=tmask,
        bs=bs,
        bwe=bwe,
        intensity=intensity,
        orig_samples=orig_samples,
        lufs=lufs,
    )[0]
