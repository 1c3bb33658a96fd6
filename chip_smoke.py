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
   each of their stages;
7. the noise kernel against its plain version at [32, 431, 1024, 1] in
   float32 and bfloat16: its uniforms equal the plain generator's bit for
   bit, its output is within tolerance, the noise of spectrum 0 and
   threshold 1 has the moments of N(0, 1/36), and a seed reproduces its
   output while another seed does not;
8. the radix kernels against their plain versions at N=2048, [32, 215,
   2048] -> [32, 216, 2048], at ``highest`` (float32) and ``default``
   (bfloat16);
9. ``Codec.round_trip`` and ``round_trip_fast`` at full width in three
   configurations: (r) float32 ``highest``, N=1024, mono design (the
   reference's configuration); (r2) float32 ``highest``, N=2048, radix
   design; (b) bfloat16 ``fast_bf16`` ``default``, N=1024. Each kernel of
   the path launches exactly once a call, and the SNR is within 0.05 dB of
   the same codec with every kernel swapped for its plain version and the
   same seed or generator;
10. an f32 ``highest`` MDCT round trip through the radix kernels at N=2048
   must reach 125 dB and come within 1 dB of their plain versions'; the
   mono and radix designs are timed side by side at N=2048.

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
RADIX_N = 2048  # 440320 samples = 215 blocks of 2048
SNR_MARGIN_DB = 0.05
FIDELITY_SNR_DB = 130.0
RADIX_FIDELITY_SNR_DB = 125.0
RADIX_FIDELITY_MARGIN_DB = 1.0
SEED = 1234
SOURCE = "audiocodec_tpu_torch/csrc/mdct_kernels.cu"
NOISE_SOURCE = "audiocodec_tpu_torch/csrc/noise_kernel.cu"
REPLACES = {
    "fold_matmul": "audiocodec_tpu/ops/pallas_mdct.py:607",
    "matmul_scatter": "audiocodec_tpu/ops/pallas_mdct.py:620",
    "radix_fold_matmul": "audiocodec_tpu/ops/pallas_mdct.py:696",
    "radix_matmul_scatter": "audiocodec_tpu/ops/pallas_mdct.py:708",
    "add_masked_noise": "audiocodec_tpu/ops/pallas_noise.py:53",
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
# The noise-injection codec's configurations (phase 9)
NOISE_CONFIGS = {
    "r": dict(filters_n=FILTERS_N, compute_dtype="float32",
              dct_precision="highest", kernel_design="mono"),
    "r2": dict(filters_n=RADIX_N, compute_dtype="float32",
               dct_precision="highest", kernel_design="radix"),
    "b": dict(filters_n=FILTERS_N, compute_dtype="bfloat16", fast_bf16=True,
              dct_precision="default", kernel_design="mono"),
}
# The mono-vs-radix comparison at N=2048 (phase 10)
DESIGN_CONFIGS = {
    "highest-mono": dict(NOISE_CONFIGS["r2"], kernel_design="mono"),
    "highest-radix": NOISE_CONFIGS["r2"],
    "default-mono": dict(filters_n=RADIX_N, compute_dtype="bfloat16",
                         fast_bf16=True, dct_precision="default",
                         kernel_design="mono"),
    "default-radix": dict(filters_n=RADIX_N, compute_dtype="bfloat16",
                          fast_bf16=True, dct_precision="default",
                          kernel_design="radix"),
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


def snr_db(x, out, n=FILTERS_N):
    ref = x.double()
    err = ((ref - out[:, n:-n].double()) ** 2).sum()
    return float(10 * math.log10(float((ref**2).sum()) / max(float(err),
                                                             1e-300)))


def all_launch_counts():
    from audiocodec_tpu_torch.ops import cuda_mdct, cuda_noise

    return {**cuda_mdct.launch_counts(), **cuda_noise.launch_counts()}


def reset_all_launch_counts():
    from audiocodec_tpu_torch.ops import cuda_mdct, cuda_noise

    cuda_mdct.reset_launch_counts()
    cuda_noise.reset_launch_counts()


def expected_counts(**ones):
    """Every kernel's count 0, except the named ones at 1."""
    return {k: int(k in ones) for k in all_launch_counts()}


def plain_kernels():
    """Every kernel wrapper swapped for its plain version (the wrappers are
    looked up at each call)."""
    from contextlib import ExitStack

    from audiocodec_tpu_torch.ops import cuda_mdct, cuda_noise

    stack = ExitStack()
    for module, names in ((cuda_mdct, ("fold_matmul", "matmul_scatter",
                                       "radix_fold_matmul",
                                       "radix_matmul_scatter")),
                          (cuda_noise, ("add_masked_noise",))):
        for name in names:
            stack.enter_context(mock.patch.object(
                module, name, getattr(module, f"{name}_reference")))
    return stack


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


def stage_ms(torch, codec, x, noise=None):
    """Device time of each stage of round_trip_quantized, run alone; with
    ``noise`` = (name, fn(spectrum, threshold)), of the noise path whose
    noise stage that is, in place of quantize and dequantize."""
    from audiocodec_tpu_torch import quantize

    out = {}

    def stage(name, fn):
        out[name] = cuda_ms(torch, fn, iters=10)
        return fn()

    spec = stage("transform", lambda: codec.mdct.transform(x))
    ton = stage("tonality", lambda: codec.psycho.tonality(spec))
    thr = stage("global_masking_threshold",
                lambda: codec.psycho.global_masking_threshold(spec, ton))
    if noise is None:
        codes, delta = stage("quantize", lambda: quantize.quantize(spec, thr))
        deq = stage("dequantize", lambda: quantize.dequantize(
            codes, delta, dtype=codec.mdct.compute_dtype))
    else:
        deq = stage(noise[0], lambda: noise[1](spec, thr))
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
        if kernel == "radix_fold_matmul":  # the CPU tests' bound at N>=512
            return 2e-6
        return 1e-6 if kernel == "fold_matmul" else 1e-4
    if tier == "int8":
        return 1e-6 * peak
    return 1e-5 * peak


def entry(name, tier, dtype, config, n, **numbers):
    """One kernel's line of the kernels JSON (``tier`` None for the noise
    kernel, which has one); ``launches`` is filled in by the run of the
    path ``config`` names."""
    label = dtype if tier is None else f"{tier},{dtype}"
    return dict(name=f"{name}[{label}]", config=config, n=n,
                route="cuda",
                source=NOISE_SOURCE if name == "add_masked_noise" else SOURCE,
                replaces=REPLACES[name], launches=None, **numbers)


def compare_kernels(torch, mdct, label, entries):
    """Both kernels of ``mdct``'s design against their plain versions on
    the card, on the test signal cut into [BATCH, blocks, N] rows: error,
    tolerance, CUDA-event times and the rate of the products."""
    from audiocodec_tpu_torch.ops import cuda_mdct

    n = mdct.filters_n
    x = make_signal(torch, mdct.wa_r.device, mdct.kernel_dtype)
    rows = x.reshape(BATCH, SAMPLES // n, n)
    fwd_args = mdct.kernel_args("forward")
    inv_args = mdct.kernel_args("inverse")
    with torch.no_grad():
        spectrum = mdct.kernel("forward")(rows, *fwd_args)
    tier = mdct.kernel_precision
    # MACs a frame: one [N, N] product, or two [N/2, N/2] ones
    macs = n * n if mdct.kernel_design == "mono" else n * n // 2
    for direction, inp, args in (("forward", rows, fwd_args),
                                 ("inverse", spectrum, inv_args)):
        kernel = mdct.kernel(direction)
        name = kernel.__name__
        plain = getattr(cuda_mdct, f"{name}_reference")
        got = kernel(inp, *args)
        want = plain(inp, *args)
        torch.cuda.synchronize()
        check(got.shape == want.shape == (BATCH, inp.shape[1] + 1, n),
              f"{name} {tier}: shape {tuple(got.shape)}")
        err = float((got.float() - want.float()).abs().max())
        tol = tolerance(torch, want, name, tier, inp.dtype)
        ms = cuda_ms(torch, lambda: kernel(inp, *args))
        plain_ms = cuda_ms(torch, lambda: plain(inp, *args))
        tflops = 2.0 * BATCH * got.shape[1] * macs / (ms * 1e-3) / 1e12
        peak = PEAK["highest" if tier == "high" else tier]
        dtype = str(inp.dtype).removeprefix("torch.")
        print(f"kernel {name} {tier} {dtype} {tuple(inp.shape)}: "
              f"max_abs_err {err:.3e} (tol {tol:.3e}), {ms:.4f} ms vs "
              f"plain {plain_ms:.4f} ms, {tflops:.1f} TF/s = "
              f"{100 * tflops / peak:.1f}% of {peak:.0f}")
        check(err <= tol, f"{name} {tier} {dtype}: error {err} > {tol}")
        entries.append(entry(name, tier, dtype, label, n, max_abs_err=err,
                             tol=tol, ms=ms, plain_ms=plain_ms,
                             tflops=tflops))


def set_launches(entries, config, counts):
    for e in entries:
        if e["config"] == config:
            e["launches"] = counts[e["name"].split("[")[0]]


def noise_kernel_phase(torch, codecs, entries):
    """7. The noise kernel against its plain version at the main path's
    spectra, its uniforms bit for bit, its moments and its seeding."""
    from audiocodec_tpu_torch.ops import cuda_noise, philox

    for label, codec in codecs.items():
        x = make_signal(torch, codec.mdct.wa_r.device,
                        codec.mdct.compute_dtype)
        with torch.no_grad():
            spec, thr = codec._analyze(x)
        del x
        dtype = str(spec.dtype).removeprefix("torch.")
        check(spec.is_contiguous() and thr.is_contiguous(),
              f"noise ({label}): the codec's spectrum or threshold is not "
              "contiguous")
        got = cuda_noise.add_masked_noise(spec, thr, SEED)
        want = cuda_noise.add_masked_noise_reference(spec, thr, SEED)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if spec.dtype == torch.float32:
            tol = 1e-5 * float(thr.float().max())
        else:
            tol = tolerance(torch, want, "add_masked_noise", None, spec.dtype)
        ms = cuda_ms(torch, lambda: cuda_noise.add_masked_noise(spec, thr,
                                                                SEED))
        plain_ms = cuda_ms(torch, lambda: cuda_noise.add_masked_noise_reference(
            spec, thr, SEED), iters=5)
        gbs = 3 * spec.numel() * spec.element_size() / (ms * 1e-3) / 1e9
        print(f"kernel add_masked_noise {dtype} {tuple(spec.shape)}: "
              f"max_abs_err {err:.3e} (tol {tol:.3e}), {ms:.4f} ms vs plain "
              f"{plain_ms:.4f} ms, {gbs:.0f} GB/s")
        check(err <= tol, f"add_masked_noise {dtype}: error {err} > {tol}")
        entries.append(entry("add_masked_noise", None, dtype,
                             f"noise ({label})", codec.mdct.filters_n,
                             max_abs_err=err, tol=tol, ms=ms,
                             plain_ms=plain_ms, gb_per_s=gbs))
        del got, want

    dev = spec.device
    del spec, thr
    count = BATCH * (SAMPLES // FILTERS_N + 1) * FILTERS_N
    ku = cuda_noise.uniforms(SEED, count, dev)
    pu = philox.uniforms(SEED, count, dev)
    same = all(torch.equal(a, b) for a, b in zip(ku, pu))
    lo = min(float(u.min()) for u in ku)
    hi = max(float(u.max()) for u in ku)
    print(f"noise uniforms: {count} pairs equal to the plain generator bit "
          f"for bit: {same}; range [{lo:.3e}, {hi}]")
    check(same, "noise uniforms differ from the plain generator's")
    check(0.0 < lo and hi <= 1.0, f"uniforms outside (0, 1]: {lo}, {hi}")
    del ku, pu

    zero = torch.zeros(BATCH, SAMPLES // FILTERS_N + 1, FILTERS_N, 1,
                       device=dev)
    one = torch.ones_like(zero)
    z = cuda_noise.add_masked_noise(zero, one, SEED)
    zd = z.double().flatten()
    n, sigma = zd.numel(), 1.0 / 6.0
    std = float(zd.std())
    moments = dict(
        mean=float(zd.mean()), std=std,
        beyond_3_sigma=float((zd.abs() > 3 * sigma).double().mean()),
        kurtosis=float(((zd / std) ** 4).mean()),
    )
    print(f"noise moments over {n} samples: {moments}")
    check(abs(moments["mean"]) < 5 * sigma / math.sqrt(n), f"mean {moments}")
    check(abs(std / sigma - 1.0) < 0.01, f"std {moments}")
    check(0.0020 < moments["beyond_3_sigma"] < 0.0035, f"tail {moments}")
    check(abs(moments["kurtosis"] - 3.0) < 0.1, f"kurtosis {moments}")
    again = cuda_noise.add_masked_noise(zero, one, SEED)
    other = cuda_noise.add_masked_noise(zero, one, SEED + 1)
    check(torch.equal(again, z), "the same seed gave another output")
    check(float((other - z).abs().max()) > 1e-3,
          "another seed gave the same output")
    return moments


def noise_path_phase(torch, dev, entries):
    """9. round_trip and round_trip_fast at full width in the noise
    configurations: launches, SNR against the all-plain run."""
    from audiocodec_tpu_torch import Codec

    results = {}
    for k, cfg in NOISE_CONFIGS.items():
        codec = Codec.create(SAMPLE_RATE, bark_bands_n=64, device=dev, **cfg)
        n = codec.mdct.filters_n
        check(codec.mdct.use_kernel is True,
              f"noise ({k}): use_kernel='auto' did not resolve to the kernels")
        x = make_signal(torch, dev, codec.mdct.compute_dtype)
        mdct_once = {codec.mdct.kernel(d).__name__: 1
                     for d in ("forward", "inverse")}
        gen = lambda: torch.Generator(device=dev).manual_seed(SEED)  # noqa
        calls = {
            "round_trip_fast": (lambda: codec.round_trip_fast(x, SEED),
                                dict(mdct_once, add_masked_noise=1)),
            "round_trip": (lambda: codec.round_trip(x, gen()), mdct_once),
        }
        noise_stages = {
            "round_trip_fast": ("add_noise_fast", lambda s, t:
                                codec.psycho.add_noise_fast(SEED, s, t)),
            "round_trip": ("add_noise", lambda s, t:
                           codec.psycho.add_noise(gen(), s, t)),
        }
        res = {}
        with torch.no_grad():
            for name, (call, once) in calls.items():
                reset_all_launch_counts()
                out = call()
                torch.cuda.synchronize()
                counts = all_launch_counts()
                check(counts == expected_counts(**once),
                      f"noise ({k}) {name}: launch counts {counts}")
                check(out.shape == (BATCH, SAMPLES + 2 * n, 1)
                      and out.dtype == codec.mdct.compute_dtype,
                      f"noise ({k}) {name}: output {tuple(out.shape)} "
                      f"{out.dtype}")
                check(bool(torch.isfinite(out).all()),
                      f"noise ({k}) {name}: non-finite output")
                snr = snr_db(x, out, n)
                with plain_kernels():
                    plain_snr = snr_db(x, call(), n)
                ms = cuda_ms(torch, call, iters=10)
                stages = stage_ms(torch, codec, x, noise_stages[name])
                rate = BATCH * SAMPLES / SAMPLE_RATE / (ms * 1e-3)
                res[name] = dict(snr_db=snr, plain_snr_db=plain_snr, ms=ms,
                                 audio_s_per_s=rate, stages_ms=stages)
                print(f"noise ({k}) {cfg}: {name} launches {counts}, SNR "
                      f"{snr:.4f} dB (plain {plain_snr:.4f} dB), {ms:.3f} ms "
                      f"= {rate:.1f} audio-s/s; stages (ms) "
                      + ", ".join(f"{s} {t:.3f}" for s, t in stages.items()))
                check(abs(snr - plain_snr) <= SNR_MARGIN_DB,
                      f"noise ({k}) {name}: SNR {snr} vs plain {plain_snr}")
                if name == "round_trip_fast":
                    set_launches(entries, f"noise ({k})", counts)
                del out
        results[k] = res
        del x, codec
    return results


def radix_kernel_phase(torch, dev, entries):
    """8. The radix kernels against their plain versions at N=2048, and the
    mono kernels there at ``highest`` for comparison."""
    from audiocodec_tpu_torch import MDCT

    for k in ("highest-radix", "default-radix", "highest-mono"):
        label = "noise (r2)" if k == "highest-radix" else f"design {k}"
        compare_kernels(torch, MDCT(use_kernel=True, device=dev,
                                    **DESIGN_CONFIGS[k]), label, entries)


def design_phase(torch, dev, entries):
    """10. The f32 highest round trip through the radix kernels, against
    their plain versions, and the two designs timed side by side in
    round_trip_fast at N=2048."""
    from audiocodec_tpu_torch import Codec, MDCT

    fid_mdct = MDCT(use_kernel=True, device=dev,
                    **DESIGN_CONFIGS["highest-radix"])
    x = make_signal(torch, dev, torch.float32)
    with torch.no_grad():
        reset_all_launch_counts()
        rt = fid_mdct.inverse_transform(fid_mdct.transform(x))
        torch.cuda.synchronize()
        counts = all_launch_counts()
        with plain_kernels():
            plain_rt = fid_mdct.inverse_transform(fid_mdct.transform(x))
    check(counts == expected_counts(radix_fold_matmul=1,
                                    radix_matmul_scatter=1),
          f"radix fidelity: launch counts {counts}")
    fid, plain_fid = snr_db(x, rt, RADIX_N), snr_db(x, plain_rt, RADIX_N)
    print(f"radix fidelity: f32 highest MDCT round trip at N={RADIX_N} SNR "
          f"{fid:.2f} dB (plain {plain_fid:.2f} dB)")
    check(fid >= RADIX_FIDELITY_SNR_DB,
          f"radix fidelity SNR {fid} < {RADIX_FIDELITY_SNR_DB}")
    check(fid >= plain_fid - RADIX_FIDELITY_MARGIN_DB,
          f"radix fidelity SNR {fid} more than "
          f"{RADIX_FIDELITY_MARGIN_DB} dB below plain {plain_fid}")
    del rt, plain_rt

    designs = {}
    for k, cfg in DESIGN_CONFIGS.items():
        codec = Codec.create(SAMPLE_RATE, bark_bands_n=64, device=dev, **cfg)
        xk = x.to(codec.mdct.compute_dtype)
        with torch.no_grad():
            reset_all_launch_counts()
            codec.round_trip_fast(xk, SEED)
            torch.cuda.synchronize()
            counts = all_launch_counts()
            ms = cuda_ms(torch, lambda: codec.round_trip_fast(xk, SEED),
                         iters=10)
        set_launches(entries, f"design {k}", counts)
        rate = BATCH * SAMPLES / SAMPLE_RATE / (ms * 1e-3)
        designs[k] = dict(round_trip_fast_ms=ms, audio_s_per_s=rate)
        print(f"design {k} at N={RADIX_N}: round_trip_fast {ms:.3f} ms = "
              f"{rate:.1f} audio-s/s")
        del codec, xk
    return dict(radix_fidelity_snr_db=fid, radix_plain_fidelity_snr_db=plain_fid,
                designs_n2048=designs)


def noise_phases(torch, dev, entries):
    """Phases 7-10."""
    from audiocodec_tpu_torch import Codec

    kernel_codecs = {
        k: Codec.create(SAMPLE_RATE, bark_bands_n=64, device=dev,
                        **NOISE_CONFIGS[k])
        for k in ("r", "b")
    }
    moments = noise_kernel_phase(torch, kernel_codecs, entries)
    del kernel_codecs
    radix_kernel_phase(torch, dev, entries)
    configs = noise_path_phase(torch, dev, entries)
    return dict(noise_moments=moments, noise_configs=configs,
                **design_phase(torch, dev, entries))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from audiocodec_tpu_torch import Codec, MDCT
    from audiocodec_tpu_torch.ops import _build

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
        compare_kernels(torch, mdct, label, entries)

    # 4. the main path, through the entry point a user calls
    results = {}
    for k, codec in codecs.items():
        x = make_signal(torch, dev, codec.mdct.compute_dtype)
        with torch.no_grad():
            reset_all_launch_counts()
            out = codec.round_trip_quantized(x)
            torch.cuda.synchronize()
            counts = all_launch_counts()
            check(counts == expected_counts(fold_matmul=1, matmul_scatter=1),
                  f"config ({k}): launch counts {counts}")
            check(out.shape == (BATCH, SAMPLES + 2 * FILTERS_N, 1)
                  and out.dtype == codec.mdct.compute_dtype,
                  f"config ({k}): output {tuple(out.shape)} {out.dtype}")
            check(bool(torch.isfinite(out).all()),
                  f"config ({k}): non-finite output")
            snr = snr_db(x, out)
            codes = codec.encode_quantized(x)[0]
            with plain_kernels():
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
        set_launches(entries, k, counts)
        del x, out, plain_out, codes, plain_codes

    # 5. fidelity: an f32 highest MDCT round trip through the kernels
    x = make_signal(torch, dev, torch.float32)
    with torch.no_grad():
        reset_all_launch_counts()
        rt = fidelity.inverse_transform(fidelity.transform(x))
        torch.cuda.synchronize()
        counts = all_launch_counts()
    check(counts == expected_counts(fold_matmul=1, matmul_scatter=1),
          f"fidelity: launch counts {counts}")
    fid = snr_db(x, rt)
    print(f"fidelity: f32 highest MDCT round trip SNR {fid:.2f} dB")
    check(fid >= FIDELITY_SNR_DB, f"fidelity SNR {fid} < {FIDELITY_SNR_DB}")
    set_launches(entries, "highest", counts)

    # 7-10. the noise-injection codec and its kernels
    noise = noise_phases(torch, dev, entries)

    # 6. the numbers
    print(json.dumps({"configs": results, "fidelity_snr_db": fid, **noise}))
    for e in entries:
        check(e["launches"], f"{e['name']}: no launch in the path's run")
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
