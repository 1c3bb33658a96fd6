"""Command line of the PyTorch port: encode / decode / roundtrip / eval /
resample / info / corpus / corpus-decode / serve (counterpart of ``audiocodec_tpu/__main__.py``, with the
same flags, defaults, presets and printed lines for these commands):

  python -m audiocodec_tpu_torch encode  in.wav  out.acz  [--filters-n 1024] ...
  python -m audiocodec_tpu_torch decode  out.acz rec.wav
  python -m audiocodec_tpu_torch roundtrip in.wav rec.wav [--drown 0.2]
  python -m audiocodec_tpu_torch eval    ref.wav rec.wav [--json]
  python -m audiocodec_tpu_torch resample in.wav out.wav --rate 48000
  python -m audiocodec_tpu_torch info   out.acz

  python -m audiocodec_tpu_torch corpus  wavs/ out/ --sample-rate 44100 [--cache c.npy]
  python -m audiocodec_tpu_torch corpus-decode out/ rec/
  python -m audiocodec_tpu_torch serve  --sample-rate 44100 --port 8477

(also installed as ``audiocodec-tpu-torch``). Every command runs on the
card: :func:`main` takes ``device="cuda"`` unless the caller passes
another (the tests pass ``device="cpu"``), and without a card it fails
with exit code 1. A WAV file is read on the host and moves to the device
once; what is written comes back once. The bulk commands split each batch
over every visible card (``parallel.mesh``) when ``device`` is "cuda".
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from audiocodec_tpu_torch.io.bitstream import decode_container


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
        out = codec.decode(codec.decode_frames(
            enc.codes, enc.bark16, ms=args.ms, tns_idx=enc.tns_idx,
            nf_levels=enc.nf_levels, bs_flags=enc.bs_flags,
            bwe_gains=enc.bwe_gains, is_gains=enc.is_gains,
        ))
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


def _corpus_mesh(device):
    """The mesh of the bulk commands: every visible card for the card
    (``device="cuda"``), else ``device`` alone."""
    from audiocodec_tpu_torch.parallel import mesh as _mesh

    if device.type == "cuda" and device.index is None:
        return _mesh.make_mesh()
    return _mesh.make_mesh(devices=[device])


def _cmd_corpus_lossless(args, paths):
    """Bulk lossless archival: one file a pool thread, each at its own rate
    and depth (no batching: the mode is bound by the entropy coders, which
    release the interpreter lock)."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    from audiocodec_tpu_torch import lossless
    from audiocodec_tpu_torch.io import wav as _wav
    from audiocodec_tpu_torch.utils.device import on_device

    _refuse_lossy_flags(args, extra=[("--cache", "cache")])
    os.makedirs(args.outdir, exist_ok=True)

    def one(path):
        x, rate, bits = _wav.read_wav_int(path)
        with on_device(args.device):
            blob = lossless.encode_lossless(
                x, rate, bits=bits, level=getattr(args, "lossless_level", 1),
                device=args.device,
            )
        base = os.path.splitext(os.path.basename(path))[0]
        with open(os.path.join(args.outdir, base + ".acz"), "wb") as f:
            f.write(blob)
        return x.shape[0] / rate, x.size * bits // 8, len(blob)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        stats = list(ex.map(one, paths))
    dt = time.perf_counter() - t0
    audio_s = sum(s for s, _, _ in stats)
    raw = sum(r for _, r, _ in stats)
    out = sum(o for _, _, o in stats)
    print(
        f"{len(paths)} files lossless -> {args.outdir}: "
        f"{out} / {raw} bytes ({100.0 * out / max(raw, 1):.1f}% of PCM), "
        f"{audio_s:.1f} audio-s in {dt:.1f} s ({audio_s / dt:.0f} audio-s/s)"
    )
    return 0


def _wav_paths(indir):
    """The directory's WAVs, sorted; ``*.wav`` and ``*.WAV`` deduplicated by
    normalized path (a case-insensitive file system matches both)."""
    import glob as _glob

    seen = set()
    paths = []
    for pat in ("*.wav", "*.WAV"):
        for p in _glob.glob(os.path.join(indir, pat)):
            key = os.path.normcase(os.path.abspath(p))
            if key not in seen:
                seen.add(key)
                paths.append(p)
    return sorted(paths)


def cmd_corpus(args):
    """Bulk-encode a directory of WAVs into one .acz a clip: the native
    thread-pool decode straight to the int16 wire, prefetched copies to the
    card (``parallel.pipeline``), the batch split over the mesh's dp rows
    (``parallel.corpus.make_corpus_encoder``: one codec replica a device),
    the payload back through pinned memory, and the packing in a thread
    pool while the card encodes the next batch.
    With --cache the decoded corpus persists as a raw PCM .npy, so repeat
    runs skip WAV parsing (``pipeline.build_corpus_cache``)."""
    from concurrent.futures import ThreadPoolExecutor

    from audiocodec_tpu_torch import codec as _codec_mod
    from audiocodec_tpu_torch import quantize as _quantize
    from audiocodec_tpu_torch.io import bitstream
    from audiocodec_tpu_torch.io.stream_container import _to_host
    from audiocodec_tpu_torch.parallel import corpus as _corpus
    from audiocodec_tpu_torch.parallel import mesh as _mesh
    from audiocodec_tpu_torch.parallel.pipeline import (
        CachedCorpusLoader,
        PrefetchingCorpusLoader,
        build_corpus_cache,
        validate_corpus_cache,
    )
    from audiocodec_tpu_torch.utils.device import dequant_wire

    paths = _wav_paths(args.indir)
    if not paths:
        raise ValueError(f"no .wav files under {args.indir}")
    if getattr(args, "lossless", False):
        if args.sample_rate:
            raise ValueError(
                "--sample-rate does not apply with --lossless: each "
                "file's own rate is preserved exactly"
            )
        return _cmd_corpus_lossless(args, paths)
    if not args.sample_rate:
        raise ValueError("--sample-rate is required for lossy corpus encode")
    if args.chunk_blocks:
        raise ValueError(
            "--chunk-blocks streams a single file to .acs; the corpus "
            "command writes per-clip .acz containers only"
        )
    if args.resample_to:
        raise ValueError(
            "--resample-to is a single-file option; preprocess the corpus "
            "with the `resample` command (the bulk loaders decode at the "
            "corpus's uniform --sample-rate)"
        )
    os.makedirs(args.outdir, exist_ok=True)

    codec = _build_codec(args.sample_rate, args)
    if args.ms and args.channels != 2:
        raise ValueError("--ms (joint mid/side) needs --channels 2")
    mesh = _corpus_mesh(args.device)
    n = args.filters_n
    dtype = codec.mdct.compute_dtype
    # batches tile the mesh's dp rows (the size rounds up; the loaders pad
    # a short final batch on the host); the cache holds the real paths
    # only, so its identity does not depend on --batch or the devices
    batch = _mesh.pad_batch_to(args.batch, mesh.shape["dp"])
    dz = getattr(args, "deadzone", "auto")
    fixed_dz = 0.5 if dz == "auto" else float(dz)
    tag_loudness = getattr(args, "tag_loudness", False)
    features = dict(ms=args.ms, tns=args.tns, nf=args.nf, tmask=args.tmask,
                    bs=args.bs, bwe=args.bwe, intensity=args.intensity)

    if args.cache:
        if not os.path.exists(args.cache):
            status = build_corpus_cache(
                paths, args.cache, clip_seconds=args.clip_seconds,
                sample_rate=args.sample_rate, channels=args.channels,
                batch_size=batch,
            )
            print(
                f"built PCM cache {args.cache} "
                f"({int((status == 0).sum())}/{len(paths)} clips ok)"
            )
        # a stale cache must fail loudly, not pack one clip's audio under
        # another clip's name (the cache is positional)
        validate_corpus_cache(
            args.cache, paths, clip_seconds=args.clip_seconds,
            sample_rate=args.sample_rate, channels=args.channels,
        )
        loader = CachedCorpusLoader(args.cache, batch_size=batch, mesh=mesh,
                                    pad_batches=True)
    else:
        loader = PrefetchingCorpusLoader(
            paths, clip_seconds=args.clip_seconds,
            sample_rate=args.sample_rate, channels=args.channels,
            batch_size=batch, mesh=mesh, wire_dtype="int16",
            pad_batches=True,
        )

    meta = dict(
        sample_rate=args.sample_rate,
        filters_n=n,
        bark_bands_n=args.bark_bands_n,
        alpha=args.alpha,
        window_type=args.window if args.window != "none" else None,
        compute_dtype=bitstream.dtype_name(dtype),
        ms=args.ms,
        bark_precision=codec.psycho.bark_precision,
        sidecar_grid=codec.sidecar_grid,
        dz_recon=(
            _quantize.dz_recon_offset(fixed_dz) if fixed_dz != 0.5 else 0.0
        ),
        tns_band_start=codec.tns_band_start,
        nf_band_start=codec.nf_band_start,
        bwe_start=codec.bwe_start if args.bwe else 0,
        is_start=codec.is_start if args.intensity else 0,
    )

    def out_path(idx):
        stem = os.path.splitext(os.path.basename(paths[idx]))[0]
        return os.path.join(args.outdir, stem + ".acz")

    def member(a, j):
        return None if a is None else a[j:j + 1]

    def pack_one(idx, enc, j, lufs_j=None):
        return bitstream.save(
            out_path(idx), enc.codes[j:j + 1], enc.bark16[j:j + 1],
            tns_idx=member(enc.tns_idx, j),
            nf_levels=member(enc.nf_levels, j),
            bs_flags=member(enc.bs_flags, j),
            bwe_gains=member(enc.bwe_gains, j),
            is_gains=member(enc.is_gains, j),
            lufs=lufs_j,
            **meta,
        )

    def write_packed(idx, data):
        with open(out_path(idx), "wb") as f:
            f.write(data)
        return len(data)

    def encode_shard(rep, shard):
        """One dp row's encode of its int16 wire: the rate search's packed
        containers (a list), or the EncodedFrames queued back to pinned
        memory; beside them the clips' loudness (None untagged)."""
        lufs = None
        if tag_loudness:
            from audiocodec_tpu_torch import metrics

            # per-clip BS.1770 loudness of the wave the encoder sees
            lufs = np.round(metrics.loudness_lufs_batch(
                dequant_wire(shard, torch.float32), args.sample_rate), 2)
        x = dequant_wire(shard, dtype)
        usable = x.shape[1] - x.shape[1] % n
        if args.kbps:
            from audiocodec_tpu_torch import rate as _rate

            # each clip converges to its own threshold scale; the search's
            # final packed container IS the output file
            return [r.packed for r in _rate.encode_with_target_bitrate_batch(
                rep, x[:, :usable], args.kbps, drown=args.drown,
                deadzone=dz, lufs=lufs, **features)], lufs
        enc = rep.encode_frames(rep.mdct.transform(x[:, :usable]),
                                args.drown, deadzone=fixed_dz, **features)
        return _to_host(tuple(enc)), lufs

    encoder = _corpus.make_corpus_encoder(codec, mesh, per_shard=encode_shard)

    def gather(parts):
        """The shards' host payloads -> one EncodedFrames, or one list of
        containers."""
        if args.kbps:
            return [p for part in parts for p in part]
        fields = []
        for host, event in parts:
            if event is not None:
                event.synchronize()
            fields.append(host)
        return _codec_mod.EncodedFrames(*(
            f[0] if f[0] is None or len(f) == 1 else torch.cat(f)
            for f in zip(*fields)))

    ok = failed = total_bytes = 0
    base = 0
    pending = []  # the previous batch's pack jobs
    with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 4)) as ex:
        with torch.no_grad():
            for shards, status in loader:
                rows = encoder(shards)
                lufs_b = [v for _, lufs in rows if lufs is not None
                          for v in lufs]
                # the card works on this batch while the host finishes
                # packing the previous one
                for f in pending:
                    total_bytes += f.result()
                    ok += 1
                pending = []
                enc_h = gather([part for part, _ in rows])
                for j in range(len(status)):
                    idx = base + j
                    if idx >= len(paths):
                        break
                    if status[j] != 0:
                        failed += 1
                        print(f"skip {paths[idx]}: decode error "
                              f"{int(status[j])}", file=sys.stderr)
                        continue
                    if args.kbps:
                        pending.append(ex.submit(write_packed, idx,
                                                 enc_h[j]))
                    else:
                        pending.append(ex.submit(
                            pack_one, idx, enc_h, j,
                            float(lufs_b[j]) if tag_loudness else None))
                base += len(status)
        for f in pending:
            total_bytes += f.result()
            ok += 1
    seconds = ok * args.clip_seconds
    kbps = total_bytes * 8 / max(seconds, 1e-9) / 1000
    print(
        f"encoded {ok}/{len(paths)} clips -> {args.outdir} "
        f"({total_bytes} bytes, ~{kbps:.0f} kbit/s avg)"
        + (f"; {failed} failed" if failed else "")
    )
    return 0 if ok else 1


def cmd_corpus_decode(args):
    """Bulk-decode a directory of .acz files to WAVs in batches: the
    mirror of ``corpus``.

    Containers unpack in a thread pool and group by what shapes or
    parameterizes the decode (channels, mid/side, dead zone, TNS order and
    band start, member presence, the noise fill's band start and seed, the
    bwe and intensity crossovers); within a group the clips sort by length
    and each batch pads with zero frames to its longest clip (a frame
    beyond a clip's end decodes to samples the trim drops: MDCT frame
    locality). Each batch carries its clips' threshold scales as a
    [B, 1, 1, 1] tensor, so rate-controlled corpora batch too. Noise-filled
    clips decode one at a time: the fill is keyed by batch position.
    Batches of at least dp clips split over the mesh's dp rows. The output
    matches a solo ``decode`` within one 16-bit LSB."""
    import glob as _glob
    from concurrent.futures import ThreadPoolExecutor

    from audiocodec_tpu_torch import lossless as _lossless
    from audiocodec_tpu_torch import native
    from audiocodec_tpu_torch.io import bitstream
    from audiocodec_tpu_torch.io import wav as _wavmod
    from audiocodec_tpu_torch.io.stream_container import _to_host
    from audiocodec_tpu_torch.parallel import corpus as _corpus
    from audiocodec_tpu_torch.utils.device import on_device

    paths = sorted(_glob.glob(os.path.join(args.indir, "*.acz")))
    if not paths:
        raise ValueError(f"no .acz files under {args.indir}")
    os.makedirs(args.outdir, exist_ok=True)

    def wav_path(p):
        base = os.path.splitext(os.path.basename(p))[0]
        return os.path.join(args.outdir, base + ".wav")

    # lossless containers (corpus --lossless) mix freely with lossy ones;
    # they decode to exact PCM at each file's own rate and depth
    ll_paths = [p for p in paths if _lossless.is_lossless_file(p)]
    if ll_paths:
        def dec_ll(p):
            with open(p, "rb") as f:
                blob = f.read()
            with on_device(args.device):
                x, rate, bits = _lossless.decode_lossless(
                    blob, device=args.device)
            _wavmod.write_wav_int(wav_path(p), x, rate, bits)

        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
            list(ex.map(dec_ll, ll_paths))
        print(f"{len(ll_paths)} lossless containers -> exact PCM wavs")
        skip = set(ll_paths)
        paths = [p for p in paths if p not in skip]
        if not paths:
            return 0

    with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 4)) as ex:
        loaded = list(ex.map(bitstream.load, paths))

    ref = loaded[0][2]
    keys = ("sample_rate", "filters_n", "bark_bands_n", "alpha",
            "window_type", "compute_dtype", "bark_precision")
    for path, (_, _, meta) in zip(paths, loaded):
        if tuple(meta[k] for k in keys) != tuple(ref[k] for k in keys):
            raise ValueError(
                f"{path} was encoded with a different codec config than "
                f"{paths[0]}; decode mixed corpora separately"
            )
    codec = _codec_from_container_meta(args, ref)
    n = ref["filters_n"]
    sr = ref["sample_rate"]
    mesh = _corpus_mesh(args.device)
    replicas = list(zip(_corpus.replicas(codec, mesh), mesh.dp_devices))
    dp = len(replicas)

    groups: dict = {}
    for idx, (codes, _, meta) in enumerate(loaded):
        ti = meta["tns_idx"]
        key = (
            codes.shape[-1], bool(meta["ms"]), float(meta["dz_recon"]),
            None if ti is None else ti.shape[2], meta["tns_band_start"],
            meta["nf_levels"] is not None, meta["nf_band_start"],
            int(meta["nf_seed"]), meta["bs_flags"] is not None,
            meta["bwe_start"] if meta["bwe_gains"] is not None else 0,
            meta["is_start"] if meta["is_gains"] is not None else 0,
        )
        groups.setdefault(key, []).append(idx)

    members = ("tns_idx", "nf_levels", "bs_flags", "bwe_gains", "is_gains")

    def stacked(sub, rows):
        """The clips of ``sub`` as one batch of ``rows`` (>= len(sub))
        rows, zero-padded to the longest clip: codes, sidecar bits, a meta
        with the members stacked, and the scales [rows, 1, 1, 1] (1 on the
        pad rows)."""
        frames = max(loaded[i][0].shape[1] for i in sub)

        def stack(arrs):
            out = np.zeros((rows, frames) + arrs[0].shape[2:],
                           arrs[0].dtype)
            for j, a in enumerate(arrs):
                out[j, :a.shape[1]] = a[0]
            return out

        codes = stack([loaded[i][0] for i in sub])
        bark = stack([bitstream.bf16_bits(loaded[i][1]) for i in sub])
        ts = np.ones((rows, 1, 1, 1), np.float64)
        for j, i in enumerate(sub):
            ts[j] = loaded[i][2]["threshold_scale"]
        meta = dict(loaded[sub[0]][2])
        for name in members:
            if meta[name] is not None:
                meta[name] = stack([loaded[i][2][name] for i in sub])
        return codes, bark, ts, meta

    def decode_rows(sub):
        """Queue one batch's decode, split over the dp rows when it holds
        at least dp clips -> [(host float32 waves, event)] a row."""
        split = dp if len(sub) >= dp else 1
        rows = -(-len(sub) // split) * split
        codes, bark, ts, meta = stacked(sub, rows)
        step = rows // split
        out = []
        for (rep, dev), r in zip(replicas, range(0, rows, step)):
            part = dict(meta, threshold_scale=torch.from_numpy(
                ts[r:r + step]))
            for name in members:
                if part[name] is not None:
                    part[name] = part[name][r:r + step]
            with on_device(dev):
                wave = bitstream.decode_container(
                    rep, codes[r:r + step],
                    bitstream.bf16_from_bits(bark[r:r + step]), part)
                out.append(_to_host((wave.to(torch.float32),)))
        return out

    def write_one(idx, wave):
        frames = loaded[idx][0].shape[1]
        out = wave[None, n:n + (frames - 1) * n]
        nsamp = loaded[idx][2].get("orig_samples", 0)
        if nsamp:
            out = out[:, :nsamp]
        native.write_wav(wav_path(paths[idx]), out, sr)

    done = 0
    with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 4)) as ex:
        jobs = []
        with torch.no_grad():
            for key, idxs in groups.items():
                has_nf = key[5]
                # longest first, so a batch's clips are of like length
                idxs = sorted(idxs, key=lambda i: -loaded[i][0].shape[1])
                # noise-filled clips: batch position keys the fill
                subs = ([[i] for i in idxs] if has_nf
                        else [idxs[j:j + args.batch]
                              for j in range(0, len(idxs), args.batch)])
                for sub in subs:
                    waves = []
                    for host, event in decode_rows(sub):
                        if event is not None:
                            event.synchronize()
                        waves.append(host[0].numpy())
                    waves = np.concatenate(waves)
                    for j, idx in enumerate(sub):
                        jobs.append(ex.submit(write_one, idx, waves[j]))
        for job in jobs:
            job.result()
            done += 1
    print(
        f"{args.indir}: decoded {done}/{len(paths)} containers -> "
        f"{args.outdir} ({len(groups)} program groups)"
    )
    return 0


def cmd_serve(args):
    """Run the dynamic-batching codec server (serve.py) until stopped
    (Ctrl-C, SIGINT)."""
    from audiocodec_tpu_torch import serve as _serve

    codec = _build_codec(args.sample_rate, args)
    server = _serve.CodecServer(
        codec, args.sample_rate,
        host=args.host, port=args.port, unix_path=args.unix_socket,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
    ).start()
    where = args.unix_socket or f"{args.host}:{server.port}"
    # flushed: a parent process reads the port from this line
    print(
        f"serving {args.sample_rate} Hz / N={args.filters_n} codec on "
        f"{where} (max batch {args.max_batch}, "
        f"wait {args.max_wait_ms} ms); Ctrl-C to stop", flush=True
    )
    try:
        while not server.wait(1.0):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
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
    if getattr(args, "tag_loudness", False) and args.fn not in (
        cmd_encode, cmd_corpus
    ):
        raise SystemExit(
            "--tag-loudness only applies to commands that write "
            "containers (encode, corpus)"
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
        "corpus", help="bulk-encode a directory of WAVs to .acz files"
    )
    p.add_argument("indir")
    p.add_argument("outdir")
    p.add_argument("--sample-rate", type=int, default=0,
                   help="corpus sample rate (no resampling is performed); "
                        "required for lossy encodes, not applicable with "
                        "--lossless (each file keeps its own rate)")
    p.add_argument("--clip-seconds", type=float, default=10.0,
                   help="uniform framing: clips truncate/zero-pad to this")
    p.add_argument("--channels", type=int, default=1)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--cache", default="",
                   help="raw-PCM cache .npy path: built on first run, "
                        "memmapped on repeat runs (skips WAV decoding)")
    p.add_argument(
        "--lossless", action="store_true",
        help="exact PCM archival of the whole directory (thread-pooled "
             "FLAC-class coding; 16/24-bit integer WAV, per-file rates)",
    )
    p.add_argument(
        "--lossless-level", type=int, default=1, choices=(1, 2),
        help="1 = fixed predictors; 2 = + order-searched per-frame "
             "quantized LPC (smaller at comparable encode speed)",
    )
    add_model_args(p)
    p.set_defaults(fn=cmd_corpus)

    p = sub.add_parser(
        "corpus-decode",
        help="bulk-decode a directory of .acz files to WAVs (batched "
             "device passes, each batch padded to its longest clip)",
    )
    p.add_argument("indir")
    p.add_argument("outdir")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--bf16", action="store_true",
                   help=argparse.SUPPRESS)  # dtype comes from the files
    p.set_defaults(fn=cmd_corpus_decode)

    p = sub.add_parser(
        "serve",
        help="serve the codec over TCP/Unix socket with dynamic batching",
    )
    p.add_argument("--sample-rate", type=int, required=True,
                   help="rate this server encodes at (clients must match)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8477)
    p.add_argument("--unix-socket", default="",
                   help="serve a Unix domain socket instead of TCP")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    add_model_args(p)
    p.set_defaults(fn=cmd_serve)

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
