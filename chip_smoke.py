#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from audiocodec_tpu_torch/csrc/;
3. hold each kernel against its plain torch version on the card, at the
   main path's shapes and at every tier the path uses, plus ``highest``;
4. run ``Codec.round_trip_quantized`` at full width (44.1 kHz, N=1024, 64
   Bark bands, 32 mono clips of 10 s) in the three configurations of
   bench.py: (a) bf16 int8, (b) bf16 default, (c) f32 default. Each kernel
   must launch exactly once per call, and the quantized SNR must be within
   0.05 dB of the same codec with its kernels swapped for their plain
   versions;
5. an f32 ``highest`` MDCT round trip through the kernels must reach
   130 dB SNR;
6. time the kernels against their plain versions with CUDA events, and the
   three configurations in audio-seconds per second with the device time of
   each of their stages.

The line before the last is a JSON object with one entry per kernel and
tier; the last line is {"ok": true, "device": {...}}. Without a CUDA device,
or without the package beside it, the script exits non-zero and prints no
result. It never imports jax.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

SAMPLE_RATE = 44100
FILTERS_N = 1024
BATCH = 32
SAMPLES = SAMPLE_RATE * 10 // FILTERS_N * FILTERS_N  # 440320: 430 blocks
SNR_MARGIN_DB = 0.05
FIDELITY_SNR_DB = 130.0
SOURCE = "audiocodec_tpu_torch/csrc/mdct_kernels.cu"
REPLACES = {
    "fold_matmul": "audiocodec_tpu/ops/pallas_mdct.py:607",
    "matmul_scatter": "audiocodec_tpu/ops/pallas_mdct.py:620",
}
# Dense peaks of an H100 SXM at 700 W (NVIDIA data sheet), TFLOP/s or TOP/s
PEAK = {"int8": 1979.0, "default": 989.0, "highest": 67.0}

CONFIGS = {
    "a": dict(compute_dtype="bfloat16", fast_bf16=True,
              dct_precision="int8", bark_precision="default"),
    "b": dict(compute_dtype="bfloat16", fast_bf16=True,
              dct_precision="default", bark_precision="default"),
    "c": dict(compute_dtype="float32", fast_bf16=False,
              dct_precision="default", bark_precision=None),
}


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def make_signal(torch, device, dtype):
    """Two tones (440 and 1320 Hz) plus white noise, each clip scaled by
    its own seeded gain: [BATCH, SAMPLES, 1]."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    t = torch.arange(SAMPLES, dtype=torch.float64) / SAMPLE_RATE
    base = (0.4 * torch.sin(2 * math.pi * 440 * t)
            + 0.3 * torch.sin(2 * math.pi * 1320 * t)
            + 0.05 * torch.randn(SAMPLES, generator=gen, dtype=torch.float64))
    gains = 0.5 + 0.5 * torch.rand(BATCH, 1, generator=gen,
                                   dtype=torch.float64)
    x = (base[None, :] * gains)[..., None].to(torch.float32)
    return x.to(device=device, dtype=dtype)


def snr_db(x, out):
    ref = x.double()
    err = ((ref - out[:, FILTERS_N:-FILTERS_N].double()) ** 2).sum()
    return float(10 * math.log10(float((ref**2).sum()) / max(float(err),
                                                             1e-300)))


def cuda_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stage_ms(torch, codec, x):
    """Device time of each stage of round_trip_quantized, run alone."""
    from audiocodec_tpu_torch import quantize

    out = {}

    def stage(name, fn):
        out[name] = cuda_ms(torch, fn, iters=10)
        return fn()

    spec = stage("transform", lambda: codec.mdct.transform(x))
    ton = stage("tonality", lambda: codec.psycho.tonality(spec))
    thr = stage("global_masking_threshold",
                lambda: codec.psycho.global_masking_threshold(spec, ton))
    codes, delta = stage("quantize", lambda: quantize.quantize(spec, thr))
    deq = stage("dequantize", lambda: quantize.dequantize(
        codes, delta, dtype=codec.mdct.compute_dtype))
    stage("inverse_transform", lambda: codec.mdct.inverse_transform(deq))
    return out


def ptxas_summary(log):
    """One line per compiled kernel from nvcc's -Xptxas=-v output: its
    (mangled) name, registers, stack frame and spills."""
    lines, name, frame = [], None, ""
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.rsplit(" ", 1)[-1]
        elif "stack frame" in ln:
            frame = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            regs = ln.split("Used", 1)[1].split(",")[0].strip()
            lines.append(f"{name}: {regs}; {frame}")
            name, frame = None, ""
    return lines


def tolerance(torch, ref, kernel, tier, dtype):
    """The CPU tests' tolerances, in the working dtype."""
    peak = float(ref.float().abs().max())
    if dtype == torch.bfloat16:
        return 2.0 * 2.0 ** (math.floor(math.log2(peak)) - 7)  # 2 bf16 ulp
    if tier == "highest":
        return 1e-6 if kernel == "fold_matmul" else 1e-4
    if tier == "int8":
        return 1e-6 * peak
    return 1e-5 * peak


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from audiocodec_tpu_torch import Codec, MDCT
    from audiocodec_tpu_torch.ops import _build, cuda_mdct

    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {kind}")

    # 2. build
    t0 = time.monotonic()
    lib_path, log = _build.build()
    _build.library()
    print(f"build: {lib_path.name} in {time.monotonic() - t0:.1f} s"
          + ("" if log else " (cached)"))
    for line in ptxas_summary(log):
        print(f"build: {line}")

    codecs = {k: Codec.create(SAMPLE_RATE, filters_n=FILTERS_N,
                              bark_bands_n=64, device=dev, **cfg)
              for k, cfg in CONFIGS.items()}
    for k, codec in codecs.items():
        check(codec.mdct.use_kernel is True,
              f"config ({k}): use_kernel='auto' did not resolve to the kernels")
    fidelity = MDCT(FILTERS_N, use_kernel=True, dct_precision="highest",
                    device=dev)

    # 3. every kernel against its plain version, at the main path's shapes
    entries = []
    cases = [(k, codecs[k].mdct) for k in "abc"] + [("highest", fidelity)]
    for label, mdct in cases:
        x = make_signal(torch, dev, mdct.kernel_dtype)
        rows = x.reshape(BATCH, SAMPLES // FILTERS_N, FILTERS_N)
        fwd_args = mdct.kernel_args("forward")
        inv_args = mdct.kernel_args("inverse")
        with torch.no_grad():
            spectrum = cuda_mdct.fold_matmul(rows, *fwd_args)
        tier = mdct.kernel_precision
        for name, inp, args, plain in (
            ("fold_matmul", rows, fwd_args, cuda_mdct.fold_matmul_reference),
            ("matmul_scatter", spectrum, inv_args,
             cuda_mdct.matmul_scatter_reference),
        ):
            kernel = getattr(cuda_mdct, name)
            got = kernel(inp, *args)
            want = plain(inp, *args)
            torch.cuda.synchronize()
            check(got.shape == want.shape == (
                BATCH, inp.shape[1] + 1, FILTERS_N),
                f"{name} {tier}: shape {tuple(got.shape)}")
            err = float((got.float() - want.float()).abs().max())
            tol = tolerance(torch, want, name, tier, inp.dtype)
            ms = cuda_ms(torch, lambda: kernel(inp, *args))
            plain_ms = cuda_ms(torch, lambda: plain(inp, *args))
            flops = 2.0 * BATCH * got.shape[1] * FILTERS_N * FILTERS_N
            tflops = flops / (ms * 1e-3) / 1e12
            peak = PEAK["highest" if tier == "high" else tier]
            dtype = str(inp.dtype).removeprefix("torch.")
            print(f"kernel {name} {tier} {dtype} {tuple(inp.shape)}: "
                  f"max_abs_err {err:.3e} (tol {tol:.3e}), {ms:.4f} ms vs "
                  f"plain {plain_ms:.4f} ms, {tflops:.1f} TF/s = "
                  f"{100 * tflops / peak:.1f}% of {peak:.0f}")
            check(err <= tol, f"{name} {tier} {dtype}: error {err} > {tol}")
            entries.append(dict(
                name=f"{name}[{tier},{dtype}]", config=label, route="cuda",
                source=SOURCE, replaces=REPLACES[name], launches=None,
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                tflops=tflops,
            ))
        del spectrum

    # 4. the main path, through the entry point a user calls
    results = {}
    for k, codec in codecs.items():
        x = make_signal(torch, dev, codec.mdct.compute_dtype)
        with torch.no_grad():
            cuda_mdct.reset_launch_counts()
            out = codec.round_trip_quantized(x)
            torch.cuda.synchronize()
            counts = cuda_mdct.launch_counts()
            check(counts == {"fold_matmul": 1, "matmul_scatter": 1},
                  f"config ({k}): launch counts {counts}")
            check(out.shape == (BATCH, SAMPLES + 2 * FILTERS_N, 1)
                  and out.dtype == codec.mdct.compute_dtype,
                  f"config ({k}): output {tuple(out.shape)} {out.dtype}")
            check(bool(torch.isfinite(out).all()),
                  f"config ({k}): non-finite output")
            snr = snr_db(x, out)
            codes = codec.encode_quantized(x)[0]
            with mock.patch.object(
                cuda_mdct, "fold_matmul", cuda_mdct.fold_matmul_reference
            ), mock.patch.object(
                cuda_mdct, "matmul_scatter",
                cuda_mdct.matmul_scatter_reference,
            ):
                plain_out = codec.round_trip_quantized(x)
                plain_codes = codec.encode_quantized(x)[0]
            plain_snr = snr_db(x, plain_out)
            same = float((codes == plain_codes).float().mean())
            rt_ms = cuda_ms(torch, lambda: codec.round_trip_quantized(x),
                            iters=10)
            stages = stage_ms(torch, codec, x)
        rate = BATCH * SAMPLES / SAMPLE_RATE / (rt_ms * 1e-3)
        results[k] = dict(snr_db=snr, plain_snr_db=plain_snr, ms=rt_ms,
                          audio_s_per_s=rate, codes_equal=same,
                          stages_ms=stages)
        print(f"config ({k}) {CONFIGS[k]}: launches {counts}, quantized SNR "
              f"{snr:.4f} dB (plain {plain_snr:.4f} dB), codes equal to "
              f"plain {100 * same:.4f}%, round_trip_quantized {rt_ms:.3f} "
              f"ms = {rate:.1f} audio-s/s; stages (ms) "
              + ", ".join(f"{s} {t:.3f}" for s, t in stages.items()))
        check(abs(snr - plain_snr) <= SNR_MARGIN_DB,
              f"config ({k}): SNR {snr} vs plain {plain_snr}")
        for e in entries:
            if e["config"] == k:
                e["launches"] = counts[e["name"].split("[")[0]]
        del x, out, plain_out, codes, plain_codes

    # 5. fidelity: an f32 highest MDCT round trip through the kernels
    x = make_signal(torch, dev, torch.float32)
    with torch.no_grad():
        cuda_mdct.reset_launch_counts()
        rt = fidelity.inverse_transform(fidelity.transform(x))
        torch.cuda.synchronize()
        counts = cuda_mdct.launch_counts()
    check(counts == {"fold_matmul": 1, "matmul_scatter": 1},
          f"fidelity: launch counts {counts}")
    fid = snr_db(x, rt)
    print(f"fidelity: f32 highest MDCT round trip SNR {fid:.2f} dB")
    check(fid >= FIDELITY_SNR_DB, f"fidelity SNR {fid} < {FIDELITY_SNR_DB}")
    for e in entries:
        if e["config"] == "highest":
            e["launches"] = counts[e["name"].split("[")[0]]

    # 6. the numbers
    print(json.dumps({"configs": results, "fidelity_snr_db": fid}))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (PhaseError, ImportError, RuntimeError, OSError,
            subprocess.CalledProcessError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
