"""Command line of the PyTorch port: encode / decode / roundtrip / eval /
resample / info (counterpart of ``audiocodec_tpu/__main__.py``, with the
same flags, defaults, presets and printed lines for these commands):

  python -m audiocodec_tpu_torch encode  in.wav  out.acz  [--filters-n 1024] ...
  python -m audiocodec_tpu_torch decode  out.acz rec.wav
  python -m audiocodec_tpu_torch roundtrip in.wav rec.wav [--drown 0.2]
  python -m audiocodec_tpu_torch eval    ref.wav rec.wav [--json]
  python -m audiocodec_tpu_torch resample in.wav out.wav --rate 48000
  python -m audiocodec_tpu_torch info   out.acz

(also installed as ``audiocodec-tpu-torch``). Every command runs on the
card: :func:`main` takes ``device="cuda"`` unless the caller passes
another (the tests pass ``device="cpu"``), and without a card it fails
with exit code 1. A WAV file is read on the host and moves to the device
once; what is written comes back once. The bulk commands (``corpus``,
``corpus-decode``) and ``serve`` are not part of the port yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def _build_codec(sample_rate, args, compute_dtype=None, bark_precision=None):
    from audiocodec_tpu_torch.codec import Codec

    if compute_dtype is None:
        compute_dtype = torch.bfloat16 if args.bf16 else torch.float32
    precision = getattr(args, "precision", "highest")
    return Codec.create(
        sample_rate=sample_rate,
        filters_n=args.filters_n,
        bark_bands_n=args.bark_bands_n,
        alpha=args.alpha,
        window_type=args.window if args.window != "none" else None,
        compute_dtype=compute_dtype,
        dct_precision=precision,
        # decode paths pass the container-recorded value: it is
        # step-size-critical (Bark sidecar expands through W_inv)
        bark_precision=bark_precision,
        # encoder-side: decode reconstructs the sidecar from the wire,
        # so decode paths never need the knob (default harmless there)
        sidecar_grid=getattr(args, "sidecar_grid", 4),
        device=args.device,
    )


def _dtype_from_meta(meta):
    """Map a container's recorded compute_dtype to the decode dtype.

    Decoding must run in the EXACT dtype the encoder derived thresholds
    in: silently downgrading float64 to float32 would change step
    sizes."""
    name = meta["compute_dtype"]
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32,
             "float64": torch.float64}.get(name)
    if dtype is None:
        raise ValueError(
            f"container records unsupported compute_dtype {name!r}; "
            "expected one of bfloat16/float32/float64"
        )
    return dtype


def _read(path, device):
    """A WAV file -> (float32 [1, samples, channels] on ``device``, rate):
    decoded on the host, one copy to the device."""
    from audiocodec_tpu_torch import native

    data, rate = native.decode_wav(path)
    return torch.from_numpy(data).to(device), rate


def _write(path, wave, rate):
    """[1, samples, channels] on any device -> a 16-bit WAV: one copy to
    the host."""
    from audiocodec_tpu_torch import native

    native.write_wav(path, wave.to(torch.float32).cpu().numpy(), rate)


def _maybe_resample(data, rate, target_rate, zeros=16):
    """Resample float32 audio [B, samples, C] to ``target_rate`` on its
    device if it differs; no-op for 0/None/matching rates. Returns (data,
    rate)."""
    if not target_rate or target_rate == rate:
        return data, rate
    from audiocodec_tpu_torch.resample import Resampler

    r = Resampler.create(rate, target_rate, zeros=zeros, device=data.device)
    return r.resample(data.to(torch.float32)), target_rate


def _maybe_normalize(wave, rate, target_lufs, recorded=None):
    """Gain the decoded audio to ``target_lufs`` integrated loudness
    (BS.1770), with a peak guard at -1 dBFS. 0/None = no-op. When the
    container recorded the source loudness (``--tag-loudness``), use it
    instead of re-measuring — one less pass, and it normalizes by the
    SOURCE loudness, unbiased by coding noise."""
    if not target_lufs:
        return wave
    from audiocodec_tpu_torch import metrics

    measured = (
        float(recorded) if recorded is not None
        else metrics.loudness_lufs(wave, rate)
    )
    gain = 10.0 ** ((float(target_lufs) - measured) / 20.0)
    peak = float(torch.abs(wave).max()) * gain
    limit = 10.0 ** (-1.0 / 20.0)
    if peak > limit:  # never clip: cap the gain at -1 dBFS true peak
        gain *= limit / peak
    print(f"loudness: {measured:.2f} LUFS -> target {target_lufs:.2f} "
          f"(gain {20*np.log10(gain):+.2f} dB)")
    return (wave * gain).to(wave.dtype)


def _slice_window(wave, rate, start, duration):
    """Trim decoded audio to [start, start+duration) seconds.

    ``duration <= 0`` means "to the end". Raises SystemExit (a CLI usage
    error, not a crash) when ``start`` is at or past the end."""
    s0 = int(round(float(start or 0.0) * rate))
    if s0 >= wave.shape[1]:
        raise SystemExit(
            f"--start {start}s is at or past the end of the decoded "
            f"audio ({wave.shape[1] / rate:.3f}s)"
        )
    if duration and duration > 0:
        s1 = min(wave.shape[1], s0 + int(round(float(duration) * rate)))
    else:
        s1 = wave.shape[1]
    return wave[:, s0:s1]


def _pad_to_blocks(data, block):
    """Zero-pad the tail to a multiple of ``block`` samples instead of
    dropping it; returns (padded, original_samples). The container
    records the original count (``nsamp``) so decode trims back —
    round trips are length-exact (gapless)."""
    orig = data.shape[1]
    if orig == 0:
        raise ValueError("input has no samples")
    pad = (-orig) % block
    if pad:
        data = torch.nn.functional.pad(data, (0, 0, 0, pad))
    return data, orig


def _refuse_lossy_flags(args, extra=()):
    """The lossy shaping ladder has no meaning when the output is exact;
    refuse rather than silently ignore a flag the user asked for."""
    for flag, attr in [
        ("--kbps", "kbps"), ("--cbr", "cbr"), ("--chunk-blocks", "chunk_blocks"),
        ("--ms", "ms"), ("--intensity", "intensity"), ("--dtx", "dtx"),
        ("--fec", "fec"), ("--preset", "preset"), ("--resample-to", "resample_to"),
        ("--bf16", "bf16"), ("--tns", "tns"), ("--nf", "nf"), ("--bwe", "bwe"),
        ("--tmask", "tmask"), ("--bs", "bs"), ("--tag-loudness", "tag_loudness"),
        ("--drown", "drown"), ("--reservoir", "reservoir"), *extra,
    ]:
        if getattr(args, attr, None):
            raise ValueError(
                f"--lossless is exact PCM coding; {flag} belongs to the "
                "lossy path and does not compose with it"
            )


def _cmd_encode_lossless(args):
    from audiocodec_tpu_torch import lossless
    from audiocodec_tpu_torch.io import wav as _wav

    _refuse_lossy_flags(args)
    x, rate, bits = _wav.read_wav_int(args.input)
    blob = lossless.encode_lossless(
        x, rate, bits=bits, level=getattr(args, "lossless_level", 1),
        device=args.device,
    )
    with open(args.output, "wb") as f:
        f.write(blob)
    raw = x.shape[0] * x.shape[1] * bits // 8
    print(
        f"{args.output}: lossless, {x.shape[0]} samples x {x.shape[1]} ch "
        f"{bits}-bit @ {rate} Hz, {len(blob)} bytes "
        f"({100.0 * len(blob) / raw:.1f}% of PCM)"
    )
    return 0


def _cmd_decode_lossless(args):
    from audiocodec_tpu_torch import lossless
    from audiocodec_tpu_torch.io import wav as _wav

    for flag, attr in [
        ("--resample-to", "resample_to"), ("--normalize-lufs", "normalize_lufs"),
        ("--bf16", "bf16"), ("--conceal", "conceal"),
    ]:
        if getattr(args, attr, None):
            raise ValueError(
                f"{flag} would modify samples; lossless decode writes the "
                "exact coded PCM (use the lossy tools on the decoded file)"
            )
    with open(args.input, "rb") as f:
        blob = f.read()
    # range-decode straight from the container: seekable streams (the
    # fidx index, or byte-addressable payloads) pay work proportional
    # to the requested window, not the archive length
    rate = lossless.describe(blob)["sample_rate"]
    start = int(round(getattr(args, "start", 0.0) * rate))
    dur = getattr(args, "duration", 0.0)
    count = int(round(dur * rate)) if dur else None
    if count is not None and count <= 0:
        raise ValueError(
            f"--duration {dur}s rounds to zero samples at {rate} Hz"
        )
    try:
        x, rate, bits = lossless.decode_lossless(
            blob, start=start, count=count, device=args.device
        )
    except ValueError as e:
        if start and "outside the stream" in str(e):
            raise ValueError(
                f"--start {args.start}s is at or past the end of the clip"
            ) from e
        raise
    _wav.write_wav_int(args.output, x, rate, bits)
    print(
        f"{args.output}: {x.shape[0]} samples x {x.shape[1]} ch "
        f"{bits}-bit @ {rate} Hz (exact)"
    )
    return 0


def cmd_encode(args):
    from audiocodec_tpu_torch.io import bitstream

    if getattr(args, "lossless", False):
        return _cmd_encode_lossless(args)
    data, rate = _read(args.input, args.device)
    data, rate = _maybe_resample(data, rate, args.resample_to)
    codec = _build_codec(rate, args)
    lufs = None
    if getattr(args, "tag_loudness", False):
        from audiocodec_tpu_torch import metrics as _metrics

        lufs = round(float(_metrics.loudness_lufs(data, rate)), 2)
    # pad (not trim) so decode can reproduce the EXACT input length via
    # the container's nsamp field (gapless round trips)
    block = args.filters_n * (args.chunk_blocks or 1)
    data, orig_samples = _pad_to_blocks(data, block)
    x = data.to(codec.mdct.compute_dtype)
    if args.ms and x.shape[2] != 2:
        raise ValueError("--ms (joint mid/side) needs a stereo input")
    if getattr(args, "reservoir", 0.0) and not (
        args.kbps and getattr(args, "cbr", False) and args.chunk_blocks
    ):
        raise ValueError(
            "--reservoir needs --cbr (with --kbps and --chunk-blocks): "
            "it redistributes a constant-rate stream's per-chunk budget"
        )
    # "auto" defers to the rate-control heuristic when --kbps is given;
    # without a rate target there is nothing to adapt to -> plain rounding
    dz = getattr(args, "deadzone", "auto")
    fixed_dz = 0.5 if dz == "auto" else float(dz)
    if getattr(args, "fec", 0.0) and not args.chunk_blocks:
        raise ValueError(
            "--fec needs --chunk-blocks (redundant copies ride the "
            ".acs stream's chunk framing)"
        )
    if getattr(args, "dtx", 0.0):
        if not args.chunk_blocks:
            raise ValueError(
                "--dtx needs --chunk-blocks (silent records are a "
                ".acs stream feature)"
            )
        if args.kbps or args.fec:
            raise ValueError(
                "--dtx is VBR-only: it does not compose with "
                "--kbps/--cbr rate control or --fec redundancy"
            )

    if args.chunk_blocks:
        from audiocodec_tpu_torch.io import stream_container

        extra = ""
        if args.kbps and getattr(args, "cbr", False):
            n_chunks, scales, kbps = stream_container.encode_stream_cbr(
                codec, x, args.output,
                chunk_blocks=args.chunk_blocks,
                target_kbps=args.kbps, drown=args.drown, ms=args.ms,
                deadzone=dz, tns=args.tns, nf=args.nf, tmask=args.tmask,
                bs=args.bs, bwe=args.bwe, intensity=args.intensity,
                fec=args.fec, reservoir_kbits=args.reservoir,
                orig_samples=orig_samples, lufs=lufs,
            )
            extra = (
                f", {kbps:.0f} kbit/s CBR, scales "
                f"{min(scales):.2f}..{max(scales):.2f}"
            )
            if args.reservoir:
                extra += f", reservoir {args.reservoir:g} kbit"
        elif args.kbps:
            n_chunks, tscale, kbps = (
                stream_container.encode_stream_with_target_bitrate(
                    codec, x, args.output,
                    chunk_blocks=args.chunk_blocks,
                    target_kbps=args.kbps, drown=args.drown, ms=args.ms,
                    deadzone=dz, tns=args.tns, nf=args.nf,
                    tmask=args.tmask, bs=args.bs, bwe=args.bwe,
                    intensity=args.intensity, fec=args.fec,
                    orig_samples=orig_samples, lufs=lufs,
                )
            )
            extra = f", {kbps:.0f} kbit/s, scale {tscale:.2f}"
        else:
            n_chunks = stream_container.encode_stream(
                codec, x, args.output,
                chunk_blocks=args.chunk_blocks, drown=args.drown,
                ms=args.ms, deadzone=fixed_dz, tns=args.tns, nf=args.nf,
                tmask=args.tmask, bs=args.bs, bwe=args.bwe,
                intensity=args.intensity, fec=args.fec,
                dtx=getattr(args, "dtx", 0.0),
                orig_samples=orig_samples, lufs=lufs,
            )
        size = os.path.getsize(args.output)
        raw = orig_samples * x.shape[2] * 2
        print(
            f"{args.input}: {orig_samples} samples @ {rate} Hz -> "
            f"{args.output} "
            f"(.acs stream, {n_chunks} chunks, {size} bytes, "
            f"{raw / size:.1f}x smaller than 16-bit PCM{extra})"
        )
        return 0

    if args.kbps:
        from audiocodec_tpu_torch import rate as _rate

        result = _rate.encode_with_target_bitrate(
            codec, x, args.kbps, drown=args.drown, ms=args.ms, deadzone=dz,
            tns=args.tns, nf=args.nf, tmask=args.tmask, bs=args.bs,
            bwe=args.bwe, intensity=args.intensity,
            orig_samples=orig_samples, lufs=lufs,
        )
        # the trial's packed bytes ARE the container — write them verbatim
        # so the measured kbps is exactly the on-disk file's
        with open(args.output, "wb") as f:
            f.write(result.packed)
        size = len(result.packed)
        raw = data.numel() * 2
        print(
            f"{args.input}: {data.shape[1]} samples @ {rate} Hz, "
            f"{data.shape[2]} ch -> {args.output} ({size} bytes, "
            f"{result.kbps:.0f} kbit/s, scale {result.threshold_scale:.2f})"
        )
        return 0

    enc = codec.encode_frames(
        codec.mdct.transform(x), args.drown, ms=args.ms,
        deadzone=fixed_dz, tns=args.tns, nf=args.nf, tmask=args.tmask,
        bs=args.bs, bwe=args.bwe, intensity=args.intensity,
    )
    from audiocodec_tpu_torch import quantize as _quantize

    size = bitstream.save(
        args.output,
        enc.codes,
        enc.bark16,
        sample_rate=rate,
        filters_n=args.filters_n,
        bark_bands_n=args.bark_bands_n,
        alpha=args.alpha,
        window_type=args.window if args.window != "none" else None,
        compute_dtype=bitstream.dtype_name(codec.mdct.compute_dtype),
        ms=args.ms,
        bark_precision=codec.psycho.bark_precision,
        sidecar_grid=codec.sidecar_grid,
        dz_recon=(
            _quantize.dz_recon_offset(fixed_dz) if fixed_dz != 0.5 else 0.0
        ),
        tns_idx=enc.tns_idx,
        tns_band_start=codec.tns_band_start,
        nf_levels=enc.nf_levels,
        nf_band_start=codec.nf_band_start,
        bs_flags=enc.bs_flags,
        bwe_gains=enc.bwe_gains,
        bwe_start=codec.bwe_start if args.bwe else 0,
        is_gains=enc.is_gains,
        is_start=codec.is_start if args.intensity else 0,
        orig_samples=orig_samples,
        lufs=lufs,
    )
    raw = orig_samples * data.shape[2] * 2  # vs 16-bit PCM
    print(
        f"{args.input}: {orig_samples} samples @ {rate} Hz, "
        f"{data.shape[2]} ch -> {args.output} ({size} bytes, "
        f"{raw / size:.1f}x smaller than 16-bit PCM)"
    )
    return 0


def cmd_eval(args):
    """Objective quality of a degraded wav vs its reference: SNR,
    segmental SNR, and noise-to-mask ratio through the codec's own
    psychoacoustic model (metrics.py)."""
    from audiocodec_tpu_torch import metrics

    ref, rrate = _read(args.reference, args.device)
    deg, drate = _read(args.degraded, args.device)
    if rrate != drate:
        raise ValueError(
            f"sample rates differ ({rrate} vs {drate} Hz); bring them "
            "together first with the `resample` command"
        )
    if ref.shape[2] != deg.shape[2]:
        raise ValueError(
            f"channel counts differ ({ref.shape[2]} vs {deg.shape[2]})"
        )
    common = min(ref.shape[1], deg.shape[1])
    common -= common % args.filters_n
    if common == 0:
        raise ValueError(
            f"no overlapping audio of at least one MDCT block "
            f"({args.filters_n} samples)"
        )
    codec = _build_codec(rrate, args)
    dtype = codec.mdct.compute_dtype
    result = metrics.evaluate(
        codec, ref[:, :common].to(dtype), deg[:, :common].to(dtype)
    )
    result["samples"] = common
    result["sample_rate"] = rrate
    result["lufs_ref"] = round(
        metrics.loudness_lufs(ref[:, :common], rrate), 2
    )
    result["lufs_deg"] = round(
        metrics.loudness_lufs(deg[:, :common], rrate), 2
    )
    if args.json:
        print(json.dumps(result))
    else:
        print(f"{args.degraded} vs {args.reference} "
              f"({common} samples @ {rrate} Hz):")
        print(f"  SNR:            {result['snr_db']:8.2f} dB")
        print(f"  segmental SNR:  {result['seg_snr_db']:8.2f} dB")
        print(f"  NMR:            {result['nmr_db']:8.2f} dB "
              f"(mean sq ratio {result['nmr']:.4f}; < 0 dB means the "
              "error mostly hides under the masking threshold)")
        print(f"  loudness:       {result['lufs_deg']:8.2f} LUFS "
              f"(reference {result['lufs_ref']:.2f}; BS.1770 integrated)")
    return 0


def cmd_resample(args):
    """Standalone polyphase sample-rate conversion, wav -> wav."""
    data, rate = _read(args.input, args.device)
    if rate == args.rate:
        print(f"{args.input} is already at {rate} Hz; copying")
    out, out_rate = _maybe_resample(data, rate, args.rate, zeros=args.zeros)
    _write(args.output, out, out_rate)
    print(
        f"{args.input}: {data.shape[1]} samples @ {rate} Hz -> "
        f"{args.output}: {out.shape[1]} samples @ {out_rate} Hz"
    )
    return 0


def _is_acs(path):
    with open(path, "rb") as f:
        return f.read(4) in (b"ACS1", b"ACS2", b"ACS3")


def _codec_from_container_meta(args, meta):
    """THE ONE place a decoding command rebuilds its codec from a
    container's recorded config: the bitstream records the encoder's
    compute dtype and Bark precision, and the decoder MUST match them so
    both sides derive identical quantization steps."""
    args.filters_n = meta["filters_n"]
    args.bark_bands_n = meta["bark_bands_n"]
    args.alpha = meta["alpha"]
    args.window = meta["window_type"] or "none"
    return _build_codec(
        meta["sample_rate"], args, _dtype_from_meta(meta),
        bark_precision=meta.get("bark_precision", "highest"),
    )


def decode_container(codec, codes, bark, meta):
    """Decode a loaded ``.acz`` container (``io.bitstream.load``'s codes,
    sidecar and meta) on the codec's device -> waveform [1, (blocks+1)*N,
    C] in the codec's compute dtype: the meta's members become
    ``decode_bitstream[_ms]``'s keywords, with the recorded band starts and
    crossovers taken verbatim (0 is a legal wire value) and the noise seed
    as its uint32 value."""
    dev = codec.mdct.wa_r.device

    def t(a):
        return None if a is None else torch.from_numpy(np.asarray(a)).to(dev)

    nfl = meta.get("nf_levels")
    kw = dict(
        threshold_scale=meta.get("threshold_scale", 1.0),
        dz_recon=meta.get("dz_recon", 0.0),
        tns_idx=t(meta.get("tns_idx")),
        tns_band_start=meta.get("tns_band_start") or None,
        nf_levels=t(nfl),
        nf_band_start=(None if nfl is None
                       else int(meta.get("nf_band_start", 0))),
        nf_seed=int(meta.get("nf_seed", 0)) & 0xFFFFFFFF,
        bs_flags=t(meta.get("bs_flags")),
        bwe_gains=t(meta.get("bwe_gains")),
    )
    if kw["bwe_gains"] is not None:
        kw["bwe_start"] = int(meta.get("bwe_start", 0))
    codes = t(codes)
    bark = bark.to(dev, torch.bfloat16)
    if meta.get("ms"):
        isg = meta.get("is_gains")
        if isg is not None:
            kw["is_gains"] = t(isg)
            kw["is_start"] = int(meta.get("is_start", 0))
        return codec.decode_bitstream_ms(codes, bark, **kw)
    return codec.decode_bitstream(codes, bark, **kw)


def cmd_decode(args):
    from audiocodec_tpu_torch import lossless as _lossless
    from audiocodec_tpu_torch.io import bitstream

    if _is_acs(args.input):
        return _decode_stream(args)
    if _lossless.is_lossless_file(args.input):
        return _cmd_decode_lossless(args)

    codes, bark, meta = bitstream.load(args.input)
    codec = _codec_from_container_meta(args, meta)
    wave = decode_container(codec, codes, bark, meta)
    n = meta["filters_n"]
    wave = wave.to(torch.float32)[:, n:-n]
    nsamp = meta.get("orig_samples", 0)
    if nsamp:
        # gapless: trim the encoder's tail padding back off
        wave = wave[:, :nsamp]
    if getattr(args, "start", 0.0) or getattr(args, "duration", 0.0):
        wave = _slice_window(
            wave, meta["sample_rate"], args.start, args.duration
        )
    wave, out_rate = _maybe_resample(
        wave, meta["sample_rate"], args.resample_to
    )
    wave = _maybe_normalize(
        wave, out_rate, getattr(args, "normalize_lufs", 0.0),
        recorded=meta.get("lufs"),
    )
    _write(args.output, wave, out_rate)
    print(
        f"{args.input} -> {args.output}: {wave.shape[1]} samples @ "
        f"{out_rate} Hz, {wave.shape[2]} ch"
    )
    return 0


def cmd_roundtrip(args):
    data, rate = _read(args.input, args.device)
    data, rate = _maybe_resample(data, rate, args.resample_to)
    codec = _build_codec(rate, args)
    data, orig_samples = _pad_to_blocks(data, args.filters_n)
    x = data.to(codec.mdct.compute_dtype)
    if args.ms and x.shape[2] != 2:
        raise ValueError("--ms (joint mid/side) needs a stereo input")
    if (args.tns or args.nf or args.tmask or args.bs or args.bwe
            or args.ms or args.intensity):
        enc = codec.encode_frames(
            codec.mdct.transform(x), args.drown, ms=args.ms,
            tns=args.tns, nf=args.nf, tmask=args.tmask, bs=args.bs,
            bwe=args.bwe, intensity=args.intensity,
        )
        kw = dict(tns_idx=enc.tns_idx, nf_levels=enc.nf_levels,
                  bs_flags=enc.bs_flags, bwe_gains=enc.bwe_gains)
        if args.ms:
            out = codec.decode_bitstream_ms(
                enc.codes, enc.bark16, is_gains=enc.is_gains, **kw
            )
        else:
            out = codec.decode_bitstream(enc.codes, enc.bark16, **kw)
    else:
        out = codec.round_trip_quantized(x, drown=args.drown)
    n = args.filters_n
    rec = out.to(torch.float32)[:, n:-n][:, :orig_samples]
    orig = data[:, :orig_samples]
    noise = float(((orig - rec) ** 2).sum())
    snr = 10 * np.log10(float((orig**2).sum()) / max(noise, 1e-30))
    _write(args.output, rec, rate)
    print(f"{args.input} -> {args.output}: SNR {snr:.2f} dB")
    return 0


def _decode_stream(args):
    from audiocodec_tpu_torch.io import stream_container

    with stream_container.StreamReader(args.input) as r:
        meta = dict(r.meta)
    codec = _codec_from_container_meta(args, meta)
    n = meta["filters_n"]
    sr = meta["sample_rate"]
    # preallocate from the chunk headers so memory stays ~1x the
    # requested window. Under --conceal the headers are untrusted:
    # unreadable or implausible entries fall back to the stream's modal
    # body size (what decode_stream will actually synthesize) instead of
    # letting one flipped u32 size a petabyte buffer.
    conceal = getattr(args, "conceal", False)
    with stream_container.StreamReader(args.input) as r:
        ch = r.meta["channels"]
        if conceal:
            # mirror decode_stream's conceal geometry exactly: modal
            # body size for every body chunk, one flush frame — chunk
            # headers are unverifiable on their own, and a concealed
            # chunk is synthesized at the modal size regardless of what
            # its (possibly corrupt) header claims
            modal = stream_container.modal_body_blocks(r)
            cb = [modal] * (r.n_chunks - 1) + [1] if r.n_chunks else []
        else:
            cb = [r.chunk_blocks(i) for i in range(r.n_chunks)]
    total_blocks = sum(cb)
    total = (total_blocks - 1) * n  # decoded samples after the pad trim
    nsamp = int(meta.get("nsamp", 0))
    if nsamp:
        # gapless: the header records the exact pre-padding length
        total = min(total, nsamp)
    start = float(getattr(args, "start", 0.0) or 0.0)
    duration = float(getattr(args, "duration", 0.0) or 0.0)
    s0 = int(round(start * sr))
    if s0 >= total:
        raise SystemExit(
            f"--start {start}s is at or past the end of the stream "
            f"({total / sr:.3f}s)"
        )
    if duration > 0:
        s1 = min(total, s0 + int(round(duration * sr)))
    else:
        s1 = total
    # chunk i's samples land at [(prior_i - 1)*n, (prior_i - 1 + cb_i)*n)
    # in trimmed output coordinates (the container's first/last n samples
    # are the round-trip pad); seek to the chunk containing s0 — entering
    # mid-stream only decodes one extra chunk for the overlap-add carry
    start_chunk, prior_sc, prior = 0, 0, 0
    for i, blocks_i in enumerate(cb):
        if (prior - 1) * n <= s0:
            start_chunk, prior_sc = i, prior
        prior += blocks_i
    # zeros, not empty: with concealed/odd-sized chunks the yielded total
    # can fall short of the header-derived estimate, and the tail must be
    # silence, not uninitialized memory
    wave = torch.zeros((1, s1 - s0, ch), dtype=torch.float32,
                       device=args.device)
    pos = (prior_sc - 1) * n
    for c in stream_container.decode_stream(
        codec, args.input, start_chunk=start_chunk, conceal=conceal,
    ):
        lo, hi = max(pos, s0), min(pos + c.shape[1], s1)
        if hi > lo:
            wave[:, lo - s0 : hi - s0] = c[:, lo - pos : hi - pos]
        pos += c.shape[1]
        if pos >= s1:
            break
    wave, out_rate = _maybe_resample(wave, sr, args.resample_to)
    wave = _maybe_normalize(
        wave, out_rate, getattr(args, "normalize_lufs", 0.0),
        recorded=meta.get("lufs"),
    )
    _write(args.output, wave, out_rate)
    window = f" [{s0 / sr:.3f}s..{s1 / sr:.3f}s]" if (s0 or s1 < total) else ""
    print(
        f"{args.input} -> {args.output}: {wave.shape[1]} samples @ "
        f"{out_rate} Hz, {wave.shape[2]} ch (stream{window})"
    )
    return 0


def cmd_info(args):
    from audiocodec_tpu_torch.io import bitstream

    if _is_acs(args.input):
        from audiocodec_tpu_torch.io import stream_container

        with stream_container.StreamReader(args.input) as r:
            meta, n_chunks = dict(r.meta), r.n_chunks
            blocks = sum(r.chunk_blocks(i) for i in range(n_chunks))
        size = os.path.getsize(args.input)
        seconds = blocks * meta["filters_n"] / meta["sample_rate"]
        kbps = size * 8 / max(seconds, 1e-9) / 1000
        print(f"{args.input} (.acs stream):")
        for k, v in meta.items():
            print(f"  {k}: {v}")
        print(f"  chunks: {n_chunks}  blocks: {blocks}  (~{seconds:.2f} s)")
        print(f"  size: {size} bytes  (~{kbps:.0f} kbit/s)")
        return 0

    from audiocodec_tpu_torch import lossless as _lossless

    with open(args.input, "rb") as fh:
        blob = fh.read()
    if _lossless.is_lossless_bytes(blob):
        d = _lossless.describe(blob)
        seconds = d["n_samples"] / d["sample_rate"]
        raw = d["n_samples"] * d["channels"] * d["bits"] // 8
        print(f"{args.input} (lossless):")
        for k, v in d.items():
            print(f"  {k}: {v}")
        print(
            f"  size: {len(blob)} bytes (~{seconds:.2f} s, "
            f"{100.0 * len(blob) / raw:.1f}% of PCM)"
        )
        return 0

    codes, bark, meta = bitstream.load(args.input)
    size = os.path.getsize(args.input)
    blocks = codes.shape[1]
    seconds = blocks * meta["filters_n"] / meta["sample_rate"]
    kbps = size * 8 / max(seconds, 1e-9) / 1000
    tns_idx = meta.pop("tns_idx", None)
    if tns_idx is not None:
        fired = int(np.any(tns_idx != 0, axis=(2,)).sum())
        meta["tns"] = (
            f"order {tns_idx.shape[2]}, band_start "
            f"{meta.get('tns_band_start')}, filtered "
            f"{fired}/{tns_idx.shape[0] * tns_idx.shape[1] * tns_idx.shape[3]}"
            " frame-channels"
        )
    meta.pop("tns_band_start", None)
    nfl = meta.pop("nf_levels", None)
    if nfl is not None:
        meta["nf"] = (
            f"band_start {meta.get('nf_band_start')}, seed "
            f"{meta.get('nf_seed')}, filled {int((np.asarray(nfl) > 0).sum())}"
            f"/{nfl.size} frame-channels"
        )
    if meta.get("lufs") is None:
        meta.pop("lufs", None)  # untagged: don't print a None row
    bsf = meta.pop("bs_flags", None)
    if bsf is not None:
        meta["bs"] = (
            f"factor {meta.get('bs_factor')}, switched "
            f"{int(np.asarray(bsf).sum())}/{bsf.size} frames"
        )
    bweg = meta.pop("bwe_gains", None)
    if bweg is not None:
        meta["bwe"] = (
            f"start bin {meta.get('bwe_start')}, replicated "
            f"{int((np.asarray(bweg) > 0).sum())}/{bweg.size} "
            "frame-groups"
        )
    isg = meta.pop("is_gains", None)
    if isg is not None:
        meta["intensity"] = (
            f"start bin {meta.get('is_start')}, panned "
            f"{int((np.asarray(isg) > 0).sum())}/{isg.size} "
            "frame-groups"
        )
    meta.pop("bwe_start", None)
    meta.pop("is_start", None)
    meta.pop("bs_factor", None)
    meta.pop("nf_band_start", None)
    meta.pop("nf_seed", None)
    print(f"{args.input}:")
    for k, v in meta.items():
        print(f"  {k}: {v}")
    print(f"  blocks: {blocks}  (~{seconds:.2f} s)")
    print(f"  size: {size} bytes  (~{kbps:.0f} kbit/s)")
    return 0


_PRESETS = {
    # attr -> value; applied only where the user left the flag at its
    # argparse default, so explicit flags always win over the preset
    "archive": {},
    "music": {"deadzone": "auto", "tns": True, "bs": True},
    "low": {"deadzone": "auto", "tns": True, "bs": True, "nf": True,
            "tmask": 130.0, "bwe": True, "intensity": True},
}

_PRESET_DEFAULTS = {
    "deadzone": "auto", "tns": False, "bs": False, "nf": False,
    "tmask": 0.0, "bwe": False, "intensity": False,
}


def _apply_preset(args, parser) -> None:
    if getattr(args, "tag_loudness", False) and args.fn is not cmd_encode:
        raise SystemExit(
            "--tag-loudness only applies to commands that write "
            "containers (encode)"
        )
    preset = getattr(args, "preset", None)
    if not preset:
        return
    for attr, value in _PRESETS[preset].items():
        if not hasattr(args, attr):
            continue
        if attr == "intensity" and not getattr(args, "ms", False):
            # intensity requires the mid/side layout: the preset only
            # turns it on for --ms encodes (an explicit --intensity on
            # a mono input still fails loudly, as it should)
            continue
        if getattr(args, attr) == _PRESET_DEFAULTS[attr]:
            setattr(args, attr, value)


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="audiocodec_tpu_torch",
        description="perceptual audio codec on an NVIDIA GPU (PyTorch/CUDA "
                    "port of audiocodec_tpu)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    def add_model_args(p):
        p.add_argument("--filters-n", type=int, default=1024)
        p.add_argument("--bark-bands-n", type=int, default=64)
        p.add_argument("--alpha", type=float, default=0.6)
        p.add_argument(
            "--window", choices=["vorbis", "sine", "none"], default="vorbis"
        )
        p.add_argument("--drown", type=float, default=0.0)
        p.add_argument("--bf16", action="store_true")
        p.add_argument(
            "--sidecar-grid", type=int, default=4,
            choices=[0, 1, 2, 4, 8],
            help="levels per octave of the Bark sidecar's log grid "
                 "(4 = 0.75 dB steps, the default — shrinks the "
                 "container's largest member ~3.4x at measured-unchanged "
                 "quality; 0 = legacy raw-bfloat16 sidecars, "
                 "byte-compatible with older decoders)",
        )
        p.add_argument(
            "--precision", choices=["highest", "high", "default", "int8"],
            default="highest",
            help="matmul precision ladder for the whole pipeline; "
                 "'default' (one bf16 pass) is ~3x faster at unchanged "
                 "quantized quality and is recorded in the container so "
                 "decoders reproduce identical step sizes. 'int8' runs "
                 "the MDCT on the int8 tensor cores (fastest; ~-0.1 dB; "
                 "the Bark matmuls stay on 'default' — only the Bark "
                 "precision is step-size-critical and recorded)",
        )
        p.add_argument(
            "--kbps", type=float, default=0.0,
            help="target bitrate (rate control via threshold scaling; "
                 "0 = native VBR)",
        )
        p.add_argument(
            "--ms", action="store_true",
            help="joint mid/side coding for stereo inputs",
        )
        p.add_argument(
            "--deadzone", default="auto",
            help="zero-bin half-width in quantizer steps (0.5 = plain "
                 "rounding, up to 2.0). 'auto' widens the zero bin at low "
                 "--kbps targets, where it measures +0.5..1.8 dB SNR at "
                 "matched bitrate; without --kbps 'auto' is plain rounding",
        )
        p.add_argument(
            "--tns", action="store_true",
            help="temporal noise shaping: whiten transient frames along "
                 "frequency before quantization so the decoder's inverse "
                 "filter concentrates quantization noise under attacks "
                 "instead of smearing it as pre-echo",
        )
        p.add_argument(
            "--nf", action="store_true",
            help="noise filling: transmit ~1 byte/frame of fill levels so "
                 "the decoder re-synthesizes quantizer-zeroed bins with "
                 "shaped noise — repairs the 'spectral holes' timbre at "
                 "low --kbps targets",
        )
        p.add_argument(
            "--bwe", action="store_true",
            help="bandwidth extension: rebuild quantizer-zeroed bins "
                 "above ~10.5 kHz by copying the decoded low band up in "
                 "frequency, scaled to transmitted per-group envelopes "
                 "(~1 byte per frame/group/channel) — restores harmonic "
                 "brightness at low --kbps targets where --nf alone "
                 "paints hiss",
        )
        p.add_argument(
            "--intensity", action="store_true",
            help="intensity stereo (needs --ms): stop coding the side "
                 "channel above ~6 kHz and transmit one signed pan gain "
                 "per frame/16-bin group instead; the decoder rebuilds "
                 "the stereo image from the mid channel. Measured "
                 "+2.7 dB SNR at matched bytes on panned content; side "
                 "content uncorrelated with the mid is dropped up "
                 "there, so reserve it for low --kbps targets",
        )
        p.add_argument(
            "--tmask", type=float, default=0.0,
            help="forward (post-)masking decay in dB per second (0 = "
                 "off; ~130 matches the literature's 100-200 ms "
                 "post-masking span). Raises masking thresholds in the "
                 "frames after a loud sound, spending fewer bits where "
                 "noise is inaudible. Encoder-side only — decoders need "
                 "no flag",
        )
        p.add_argument(
            "--preset", choices=["archive", "music", "low"], default=None,
            help="bundle of coded-path settings (each only applies where "
                 "you left the individual flag at its default): 'archive' "
                 "= plain rounding, no coding tools (bit-least-surprising"
                 "); 'music' = --deadzone auto --tns --bs (the measured "
                 "pre-echo + rate-adaptive ladder); 'low' = "
                 "music plus --nf --tmask 130 --bwe (for targets under "
                 "~64 kbps/channel: spectral-hole repair, post-masking "
                 "bit savings, and high-band replication) — and with "
                 "--ms also --intensity (pan-coded high band)",
        )
        p.add_argument(
            "--tag-loudness", action="store_true",
            help="measure the source's BS.1770 integrated loudness and "
                 "record it in the container — decode --normalize-lufs "
                 "then uses the tag instead of re-measuring",
        )
        p.add_argument(
            "--bs", action="store_true",
            help="block switching: transient frames quantize in a "
                 "time-split short basis (8 sub-spectra), confining "
                 "quantization noise to ~1/8 of the frame span — the "
                 "other pre-echo control besides --tns, and composable "
                 "with it",
        )
        p.add_argument(
            "--chunk-blocks", type=int, default=0,
            help="write a seekable .acs stream with this many MDCT blocks "
                 "per chunk (0 = monolithic .acz)",
        )
        p.add_argument(
            "--cbr", action="store_true",
            help="with --kbps and --chunk-blocks: constant bitrate — "
                 "every chunk is rate-controlled to the target "
                 "independently (one batched search) and carries its own "
                 "scale, so the local rate never drifts with content",
        )
        p.add_argument(
            "--reservoir", type=float, default=0.0, metavar="KBITS",
            help="with --cbr: bit reservoir — redistribute bits toward "
                 "hard chunks (measured by one uniform-quality ABR "
                 "pass) while the stream's running size never strays "
                 "more than KBITS kilobits from the constant-rate "
                 "schedule (0 = plain CBR; large = ABR's allocation "
                 "with per-chunk convergence)",
        )
        p.add_argument(
            "--dtx", type=float, nargs="?", const=-70.0, default=0.0,
            metavar="DBFS",
            help="with --chunk-blocks: discontinuous transmission — "
                 "chunks whose RMS sits below DBFS (default -70) become "
                 "~10-byte silent records; the decoder synthesizes "
                 "comfort noise at the recorded level. VBR streams "
                 "only (not --kbps/--cbr/--fec)",
        )
        p.add_argument(
            "--fec", type=float, nargs="?", const=4.0, default=0.0,
            metavar="SCALE",
            help="with --chunk-blocks: forward error correction for "
                 "lossy transports — every chunk also carries a coarse "
                 "redundant copy of the previous one (quantized SCALE "
                 "times coarser than the stream; default 4, measured "
                 "~10%% overhead on dense music), so decode rebuilds a "
                 "lost chunk from real spectral data instead of "
                 "concealing. Counted inside a --kbps target; decoders "
                 "use it automatically with --conceal",
        )
        p.add_argument(
            "--resample-to", type=int, default=0,
            help="resample the input to this rate before encoding "
                 "(polyphase windowed-sinc, ~90 dB stopband; 0 = keep "
                 "the file's rate)",
        )


    p = sub.add_parser("encode", help="wav -> .acz bitstream")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument(
        "--lossless", action="store_true",
        help="exact PCM coding (FLAC-class fixed predictors + Rice): "
             "decode reproduces the input bit-for-bit; 16/24-bit integer "
             "WAV only, and the lossy shaping flags do not apply",
    )
    p.add_argument(
        "--lossless-level", type=int, default=1, choices=(1, 2),
        help="1 = fixed predictors; 2 = order-searched quantized LPC "
             "per frame (FLAC -8-class ratios; native analysis, encode "
             "throughput at or above level 1; decode cost unchanged)",
    )
    add_model_args(p)
    p.set_defaults(fn=cmd_encode)

    p = sub.add_parser("decode", help=".acz bitstream -> wav")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--bf16", action="store_true")
    p.add_argument(
        "--resample-to", type=int, default=0,
        help="resample the decoded audio to this rate before writing "
             "(0 = the stream's native rate)",
    )
    p.add_argument(
        "--start", type=float, default=0.0,
        help="decode starting at this time (seconds); for .acs streams "
             "this seeks by chunk without decoding the prefix",
    )
    p.add_argument(
        "--duration", type=float, default=0.0,
        help="decode at most this many seconds (0 = to the end)",
    )
    p.add_argument(
        "--normalize-lufs", type=float, default=0.0,
        help="gain the decoded audio to this integrated loudness "
             "(BS.1770 LUFS, e.g. -16), peak-guarded at -1 dBFS "
             "(0 = off)",
    )
    p.add_argument(
        "--conceal", action="store_true",
        help="packet-loss concealment for .acs streams: synthesize "
             "corrupt chunks (spectral repetition with an energy fade) "
             "instead of failing — playback semantics",
    )
    p.set_defaults(fn=cmd_decode)

    p = sub.add_parser("roundtrip", help="wav -> wav through the codec")
    p.add_argument("input")
    p.add_argument("output")
    add_model_args(p)
    p.set_defaults(fn=cmd_roundtrip)

    p = sub.add_parser(
        "eval",
        help="objective quality (SNR / segmental SNR / NMR) of a "
             "degraded wav vs its reference",
    )
    p.add_argument("reference")
    p.add_argument("degraded")
    p.add_argument("--json", action="store_true",
                   help="one JSON line instead of the table")
    add_model_args(p)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser(
        "resample", help="polyphase sample-rate conversion, wav -> wav"
    )
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--rate", type=int, required=True,
                   help="target sample rate in Hz")
    p.add_argument("--zeros", type=int, default=16,
                   help="sinc zero-crossings per side (quality; 16 ~= "
                        "90 dB stopband)")
    p.set_defaults(fn=cmd_resample)

    p = sub.add_parser("info", help="inspect an .acz bitstream")
    p.add_argument("input")
    p.set_defaults(fn=cmd_info)
    return parser


def main(argv=None, *, device="cuda") -> int:
    """Run one command; returns the exit code. ``device`` is where the
    codec and every tensor stage run: the card unless the caller asks for
    another device. Without a card the default fails (exit code 1): the
    command line never falls back to the CPU on its own."""
    parser = _parser()
    args = parser.parse_args(argv)
    _apply_preset(args, parser)
    args.device = torch.device(device)
    if args.device.type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; this command line runs on the card",
              file=sys.stderr)
        return 1
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: file not found: {e.filename}", file=sys.stderr)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
