#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from audiocodec_tpu_torch/csrc/; each of the
   eight ``tc_kernel`` instances and the three ``probe_kernel`` ones
   (bf16, int8, int8g) must hold warpgroup MMA (HGMMA or IGMMA) and TMA
   load (UTMALDG) instructions in its SASS (cuobjdump), each
   ``split_gemm_kernel`` instance (the split tiers and the radix products)
   bf16 HGMMA into float32 (``HGMMA.*.F32.BF16``) and UTMALDG, and no
   FFMA or WMMA GEMM (``ffma_gemm_kernel``, ``mma_gemm_kernel``) is left
   in the library;
3. hold each kernel against its plain torch version on the card, at the
   main path's shapes and at every tier the path uses, plus ``highest``
   and ``high`` (the int8 tiers bit for bit); the mono kernels also at 5
   rows of 1, 127 and 129 frames (tiles of 64 or 128 frames, no full
   wave), with their registers, spills and shared memory, and the bare
   product's time through ``torch.matmul`` (bf16) and ``torch._int_mm``
   (int8) beside them as yardsticks the port never calls;
4. run ``Codec.round_trip_quantized`` at full width (44.1 kHz, N=1024, 64
   Bark bands, 32 mono clips of 10 s) in the three configurations of
   bench.py: (a) bf16 int8, (b) bf16 default, (c) f32 default. Each kernel
   must launch exactly once per call, and the quantized SNR must be within
   0.05 dB of the same codec with its kernels swapped for their plain
   versions;
5. an f32 ``highest`` MDCT round trip through the kernels must reach
   130 dB SNR (the ``high`` one is printed);
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
   (bfloat16), and the mono kernels there at ``highest``, ``high``,
   ``default`` and int8 (bit for bit);
9. ``Codec.round_trip`` and ``round_trip_fast`` at full width in three
   configurations: (r) float32 ``highest``, N=1024, mono design (the
   reference's configuration); (r2) float32 ``highest``, N=2048, radix
   design; (b) bfloat16 ``fast_bf16`` ``default``, N=1024. Each kernel of
   the path launches exactly once a call, and the SNR is within 0.05 dB of
   the same codec with every kernel swapped for its plain version and the
   same seed or generator;
10. an f32 ``highest`` MDCT round trip through the radix kernels at N=2048
   must reach 125 dB and come within 1 dB of their plain versions'; the
   mono and radix designs are timed side by side in ``round_trip_fast`` at
   N=2048, at ``highest`` and bf16 ``default``, and the mono design at
   ``high`` and int8 (its one-pass kernels run K in two passes there);
11. each VJP (``ops/cuda_mdct.py`` ``*_vjp``: the other direction's kernel
   on the block-reversed cotangent) against ``torch.autograd.grad``
   through its plain forward version on the same seeded cotangent, at the
   main path's shapes: mono [32, 430, 1024] at f32 ``highest``, f32
   ``high``, f32 ``default``, bf16 ``default`` and int8 (straight-through:
   against the ``default`` forward on the dequantized matrix), radix [32,
   215, 2048] at f32 ``highest`` and bf16 ``default``; each timed against
   its plain version and a conv1d / conv_transpose1d call of the same
   function;
12. training at full width (32 mono clips of 10 s, 64 Bark bands), Adam
   1e-3: ``SpectralAE(1024, 512, 64, 1/32)`` in (r) f32 ``highest`` and (b)
   bf16 ``default``, the per-band-gain trainer in (r2) f32 ``highest``
   N=2048 radix and (a) bf16 int8, ``PostFilter(1024, 512)`` in (c) f32
   ``default``. Each step launches the analysis, the synthesis and the
   synthesis VJP once and no other kernel; the first step's loss and
   gradients agree with the all-plain step's (``TRAIN_TOL``); five steps
   stay finite; ms per step, training audio-s/s and peak memory;
13. the gradient of ``inverse_transform(transform(x))`` with respect to
   the waveform in every configuration of phase 11 ((r) and (r2) among
   them), which fires both VJPs, against the all-plain gradient;
14. the int8 probe (``python -m audiocodec_tpu_torch.probes.int8_probe``,
   x [14336, 1024] float32 @ the DCT-IV matrix) through its entry point,
   which must launch each of its three kernels (bf16, int8, int8g); each
   kernel against its plain version at 14336 rows and at 1, 127 and 1000
   (int8 and int8g bit for bit, bf16 within 1e-5 of the peak), its SNR
   within 0.05 dB of its plain version's, with ``torch.matmul`` (bf16,
   on x already in bf16, and after ``x.to(bfloat16)``, the library path
   from the same float32 x, with the bytes each moves) and
   ``torch._int_mm`` (int8) at the same shape as library calls, and each
   kernel's shared memory equal to ``cuda_probe.shared_bytes``;
15. the discrete RVQ codec at full width in (r): ``SpectralAE(1024, 512,
   64, 1/32)`` + ``RVQ(4, 1024, 64)``. Serving (``encode_discrete``,
   ``pack_codes``, ``unpack_codes``, ``decode_discrete``) launches the
   analysis and the synthesis once, the codes survive the pack bit for
   bit, at least 99.9% of them equal the all-plain encode's, and the
   decode is within the synthesis tolerance of the all-plain decode of the
   same codes; three training steps (``warmup_steps=1``) each launch the
   analysis, the synthesis and its VJP once, and the first step's loss
   and gradients meet ``TRAIN_TOL`` against the all-plain step; ms,
   audio-s/s and peak memory.

Each kernel line names the device functions its tier runs and carries its
bound (the larger of its operations over the card's peak for the tier and
its bytes over 3.35 TB/s; at ``highest``/``high`` the operations are the
split tiers' six bf16 passes, with the float32 FFMA figure beside it) and
the time of one PyTorch call computing the same function where there is
one. The line before the last is a JSON object with one entry per kernel
and tier; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside it, the script exits non-zero and prints no
result. It never imports jax.
"""

from __future__ import annotations

import dataclasses
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
PROBE_SOURCE = "audiocodec_tpu_torch/csrc/probe_kernels.cu"
# the probe's variants -> their kernel instances, in the order of the
# variant codes (csrc/probe_kernels.cu ``Variant``)
PROBE_VARIANTS = {"bf16": "BF16", "int8": "INT8", "int8_grouped": "INT8G"}
PROBE_RAGGED_ROWS = (1, 127, 1000)
REPLACES = {
    **{f"probe_{v}": "benchmarks/pallas_int8_probe.py:108"
       for v in PROBE_VARIANTS},
    "fold_matmul": "audiocodec_tpu/ops/pallas_mdct.py:607",
    "matmul_scatter": "audiocodec_tpu/ops/pallas_mdct.py:620",
    "radix_fold_matmul": "audiocodec_tpu/ops/pallas_mdct.py:696",
    "radix_matmul_scatter": "audiocodec_tpu/ops/pallas_mdct.py:708",
    "add_masked_noise": "audiocodec_tpu/ops/pallas_noise.py:53",
    "fold_matmul_vjp": "audiocodec_tpu/ops/pallas_mdct.py:641",
    "matmul_scatter_vjp": "audiocodec_tpu/ops/pallas_mdct.py:675",
    "radix_fold_matmul_vjp": "audiocodec_tpu/ops/pallas_mdct.py:729",
    "radix_matmul_scatter_vjp": "audiocodec_tpu/ops/pallas_mdct.py:760",
}
# Dense peaks of an H100 SXM at 700 W (NVIDIA data sheet), TFLOP/s or TOP/s:
# int8 and bf16 on the tensor cores, float32 FFMA beside them; and its
# memory rate, TB/s
PEAK = {"int8": 1979.0, "default": 989.0, "float32": 67.0}
MEMORY_TB_S = 3.35
# Operations an element of the noise kernel: Philox4x32-10 (10 rounds of
# 2 32x32->64-bit products, 2 xors and 2 key additions) and Box-Muller
# (log, sqrt, cos, a few products), counted against the float32 rate
NOISE_OPS_PER_ELEMENT = 130

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
    "int8-mono": dict(filters_n=RADIX_N, compute_dtype="bfloat16",
                      fast_bf16=True, dct_precision="int8",
                      kernel_design="mono"),
    "high-mono": dict(NOISE_CONFIGS["r2"], kernel_design="mono",
                      dct_precision="high"),
}

# The VJPs' tiers (phase 11) and the MDCTs of the gradient paths (phases
# 12-13), by label: (r), (c), (b), (a) and (r2) are the configurations of
# phases 4 and 9, (h) the mono f32 ``high`` tier, (b2) the radix bf16 tier
VJP_CASES = {
    "r": NOISE_CONFIGS["r"],
    "h": dict(NOISE_CONFIGS["r"], dct_precision="high"),
    "c": dict(filters_n=FILTERS_N, compute_dtype="float32",
              dct_precision="default"),
    "b": NOISE_CONFIGS["b"],
    "a": dict(filters_n=FILTERS_N, compute_dtype="bfloat16", fast_bf16=True,
              dct_precision="int8"),
    "r2": NOISE_CONFIGS["r2"],
    "b2": DESIGN_CONFIGS["default-radix"],
}
# The trainers of phase 12, on the codec of the VJP case of the same label
TRAIN_CONFIGS = {"r": "spectral_ae", "b": "spectral_ae", "r2": "gains",
                 "a": "gains", "c": "post_filter"}
# (loss rtol, gradient atol as a share of each gradient's peak) of a
# training step through the kernels against the all-plain step: float32
# tiers agree to a few float32 ulps of the spectrum, bfloat16 ones to a few
# bf16 ulps, which the quantizer's rounding and the nonlinearities carry on
TRAIN_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (1e-2, 5e-2)}
# The discrete codec of phase 15, on the codec of configuration (r)
RVQ_AE = dict(filters_n=FILTERS_N, hidden_n=512, latent_n=64,
              latent_step=1 / 32)
RVQ_CFG = dict(stages=4, codebook_size=1024, dim=64)
RVQ_CODES_EQUAL = 0.999
RVQ_TRAIN_STEPS = 3


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
    from audiocodec_tpu_torch.ops import cuda_mdct, cuda_noise, cuda_probe

    return {**cuda_mdct.launch_counts(), **cuda_noise.launch_counts(),
            **cuda_probe.launch_counts()}


def reset_all_launch_counts():
    from audiocodec_tpu_torch.ops import cuda_mdct, cuda_noise, cuda_probe

    cuda_mdct.reset_launch_counts()
    cuda_noise.reset_launch_counts()
    cuda_probe.reset_launch_counts()


def expected_counts(**ones):
    """Every kernel's count 0, except the named ones at 1."""
    return {k: int(k in ones) for k in all_launch_counts()}


def plain_kernels():
    """Every kernel wrapper and VJP swapped for its plain version (the
    wrappers are looked up at each call, by the MDCT's autograd Functions
    too)."""
    from contextlib import ExitStack

    from audiocodec_tpu_torch.ops import cuda_mdct, cuda_noise

    stack = ExitStack()
    mdct_names = [k.__name__ for k in cuda_mdct.KERNELS + cuda_mdct.VJPS]
    for module, names in ((cuda_mdct, mdct_names),
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
    (mangled) name, registers, barriers and static shared memory, stack
    frame and spills; then ptxas's notes on serialized wgmma."""
    lines, notes, name, frame = [], [], None, ""
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.rsplit(" ", 1)[-1]
        elif "stack frame" in ln:
            frame = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            used = ln.split("Used", 1)[1].strip()
            lines.append(f"{name}: {used}; {frame}")
            name, frame = None, ""
        elif "C7514" in ln or "C7517" in ln:
            notes.append(ln.split("ptxas info    : ", 1)[-1].strip())
    return lines + notes


# The tensor-core kernels' warpgroup products (bf16 into float32 among
# them) and TMA loads in SASS, and the kernels that must hold them
SASS_OPS = ("HGMMA", "HGMMA.F32.BF16", "IGMMA", "UTMALDG")
TENSOR_CORE_KERNELS = ("tc_kernel", "split_gemm_kernel", "probe_kernel")
# GEMMs that the split wgmma core replaced, which must not come back
RETIRED_GEMMS = ("ffma_gemm_kernel", "mma_gemm_kernel")


def sass_summary(lib_path):
    """Per tensor-core kernel instance of the built library (tc_kernel,
    split_gemm_kernel, probe_kernel), the count of its warpgroup MMA (HGMMA bf16, those
    into float32, IGMMA int8) and TMA load (UTMALDG) instructions in the
    SASS (cuobjdump), one such line of each, and the (mangled) names of
    every kernel in the library."""
    import shutil

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, lines, names, name = {}, {}, [], None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :", 1)[1].strip()
            names.append(name)
        elif name and any(k in name for k in TENSOR_CORE_KERNELS):
            for op in SASS_OPS:
                head, _, tail = op.partition(".")
                if head in ln and (not tail or f".{tail}" in ln):
                    counts.setdefault(name, dict.fromkeys(SASS_OPS, 0))
                    counts[name][op] += 1
                    lines.setdefault(op, ln.strip())
    return counts, lines, names


def tolerance(torch, ref, kernel, tier, dtype):
    """The CPU tests' tolerances, in the working dtype; none at int8, whose
    kernels keep integer sums and the plain version's float order."""
    if tier == "int8":
        return 0.0
    peak = float(ref.float().abs().max())
    if dtype == torch.bfloat16:
        return 2.0 * 2.0 ** (math.floor(math.log2(peak)) - 7)  # 2 bf16 ulp
    if tier == "highest":
        if kernel == "radix_fold_matmul":  # the CPU tests' bound at N>=512
            return 2e-6
        return 1e-6 if kernel == "fold_matmul" else 1e-4
    return 1e-5 * peak


# The other direction's kernel, which a VJP runs
VJP_RUNS = {"fold_matmul": "matmul_scatter", "matmul_scatter": "fold_matmul",
            "radix_fold_matmul": "radix_matmul_scatter",
            "radix_matmul_scatter": "radix_fold_matmul"}


def device_functions(name, tier):
    """The device functions (csrc/) the wrapper ``name`` launches at
    ``tier``, in order: the route of that tier."""
    if name.endswith("_vjp"):
        return device_functions(VJP_RUNS[name.removesuffix("_vjp")], tier)
    if name == "add_masked_noise":
        return "noise_kernel"
    if name.startswith("probe_"):
        return f"probe_kernel<{PROBE_VARIANTS[name.removeprefix('probe_')]}>"
    if name.startswith("radix"):
        passes = 1 if tier == "default" else split_passes(tier)
        gemm = f"split_gemm_kernel<{passes}>"
        if name == "radix_fold_matmul":
            return f"fold_rotate_kernel + {gemm} + butterfly_out_kernel"
        return f"butterfly_in_kernel + {gemm} + scatter_kernel"
    if tier in ("highest", "high"):
        route = f"split_kernel + split_gemm_kernel<{split_passes(tier)}>"
        return route if name == "fold_matmul" else f"{route} + scatter_kernel"
    return "tc_kernel"


def entry(name, tier, dtype, config, n, route_tier=None, **numbers):
    """One kernel's line of the kernels JSON (``tier`` None for the noise
    kernel, which has one; ``route_tier`` the tier whose device functions
    it runs, if not ``tier``); ``launches`` is filled in by the run of the
    path ``config`` names."""
    label = dtype if tier is None else f"{tier},{dtype}"
    source = {"add_masked_noise": NOISE_SOURCE}.get(
        name, PROBE_SOURCE if name.startswith("probe_") else SOURCE)
    return dict(name=f"{name}[{label}]", config=config, n=n,
                route="cuda",
                device_functions=device_functions(name, route_tier or tier),
                source=source, replaces=REPLACES[name], launches=None,
                **numbers)


def nbytes(*tensors):
    """Bytes of the tensors among the arguments, each counted once."""
    return sum(t.numel() * t.element_size() for t in tensors
               if hasattr(t, "element_size"))


def read_args(mdct, args):
    """The arguments a kernel of ``mdct`` (or its VJP) reads: the matrix's
    (mono) or the factors' (radix) operand form and not the float32 matrix
    or factors, which its plain version reads."""
    skip = 4 if mdct.kernel_design == "mono" else 5
    return args[:skip] + args[skip + 1:]


def split_passes(tier):
    """The bf16 passes a split tier's kernels run: one per pair (i, j) of
    its operands' planes with i + j < planes (ops/cuda_mdct.py
    SPLIT_PLANES)."""
    from audiocodec_tpu_torch.ops import cuda_mdct

    planes = cuda_mdct.SPLIT_PLANES[tier]
    return planes * (planes + 1) // 2


def bound(flops, n_bytes, tier):
    """(bound_ms, bound_by, ffma_bound_ms): the larger of the operations
    over the tier's peak and the bytes over the memory rate. ``flops`` are
    the products'; at ``highest`` and ``high`` the operations are the split
    tiers' bf16 passes (:func:`split_passes` times ``flops``) at the bf16
    rate, the least work that gives those tiers' error on the card, for
    every kernel of the tier (radix and VJPs too), and ``ffma_bound_ms`` is
    the same bound with ``flops`` at the float32 FFMA rate (None at the
    other tiers). Tier "float32" counts float32 operations (the noise
    kernel)."""
    bytes_ms = n_bytes / (MEMORY_TB_S * 1e9)

    def larger(ops_ms):
        return (ops_ms, "operations") if ops_ms >= bytes_ms else (
            bytes_ms, "bytes")

    if tier in ("highest", "high"):
        ffma_ms = larger(flops / (PEAK["float32"] * 1e9))[0]
        return (*larger(split_passes(tier) * flops / (PEAK["default"] * 1e9)),
                ffma_ms)
    return (*larger(flops / (PEAK[tier] * 1e9)), None)


def gemm_flops(spectrum_frames, n, radix):
    """The products' operations: one [N, N] product (two [N/2, N/2] ones in
    the radix design) per spectrum frame and row."""
    return 2.0 * BATCH * spectrum_frames * (n * n // 2 if radix else n * n)


def library_call(torch, mdct, direction, adjoint=False):
    """One PyTorch call computing the same function as the kernel of
    ``direction`` (or, with ``adjoint``, as its VJP), taking and giving the
    kernels' [rows, frames, N] layout: the analysis is a conv1d of stride N
    whose [N, 1, 2N] weight is its response to unit frames, the synthesis a
    conv_transpose1d likewise, and the VJP of each the other on the same
    weight (built in float64 on the card from the plain versions). cuDNN's
    TF32 is off at ``highest`` and on at ``default``; the int8 tiers have
    no such call (None). Timed for ``library_ms`` only."""
    from audiocodec_tpu_torch.ops import cuda_mdct, dct, folding

    tier = mdct.kernel_precision
    if tier == "int8":
        return None
    n, dev = mdct.filters_n, mdct.wa_r.device
    coeffs = folding.make_fold_coefficients(n, mdct.window_type)
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64,  # noqa: E731
                                    device=dev)
    m64, s = dct.dct4_matrix(n), math.sqrt(4.0 * n)
    eye = torch.eye(n, dtype=torch.float64, device=dev)[:, None, :]
    analysis = direction == "forward"
    if analysis:  # frame 1 answers x[0] through taps 0..N-1, frame 0 N..2N-1
        out = cuda_mdct.fold_matmul_reference(
            eye, *(f64(getattr(coeffs, k)) for k in ("wa_r", "wb", "wc",
                                                      "ffr")), f64(m64 / s))
        w = torch.cat([out[:, 1], out[:, 0]]).T
    else:
        out = cuda_mdct.matmul_scatter_reference(
            eye, *(f64(getattr(coeffs, k)) for k in ("p", "q", "r", "s_r")),
            f64(m64 * s))
        w = out.reshape(n, 2 * n)
    weight = w[:, None, :].contiguous().to(mdct.kernel_dtype)
    pad = n if analysis else 0
    conv = analysis != adjoint
    fn = torch.nn.functional

    def call(inp):
        torch.backends.cudnn.allow_tf32 = tier == "default"
        rows = inp.shape[0]
        if conv:
            out = fn.conv1d(inp.reshape(rows, 1, -1), weight, stride=n,
                            padding=pad)
            return out.transpose(1, 2)
        out = fn.conv_transpose1d(inp.transpose(1, 2), weight, stride=n,
                                  padding=pad)
        return out.reshape(rows, -1, n)

    return call


def function_ms(torch, fn, calls=5):
    """Device time per call of ``fn`` by device function (the MDCT
    kernels' names, csrc/; others by the start of theirs), from a
    torch.profiler trace of ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((f for f in MDCT_DEVICE_FUNCTIONS if f in e.name),
                    e.name[:40])
        span = (e.time_range.end - e.time_range.start) / 1e3 / calls
        out[name] = out.get(name, 0.0) + span
    return out


def compare_kernels(torch, mdct, label, entries):
    """Both kernels of ``mdct``'s design against their plain versions on
    the card, on the test signal cut into [BATCH, blocks, N] rows: error,
    tolerance, CUDA-event times, the rate of the products, the bound and
    the library call's time."""
    from audiocodec_tpu_torch.ops import cuda_mdct

    n = mdct.filters_n
    x = make_signal(torch, mdct.wa_r.device, mdct.kernel_dtype)
    rows = x.reshape(BATCH, SAMPLES // n, n)
    fwd_args = mdct.kernel_args("forward")
    inv_args = mdct.kernel_args("inverse")
    with torch.no_grad():
        spectrum = mdct.kernel("forward")(rows, *fwd_args)
    tier = mdct.kernel_precision
    radix = mdct.kernel_design == "radix"
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
        by_function = function_ms(torch, lambda: kernel(inp, *args))
        plain_ms = cuda_ms(torch, lambda: plain(inp, *args))
        spectrum_frames = got.shape[1] if direction == "forward" else (
            inp.shape[1])
        flops = gemm_flops(spectrum_frames, n, radix)
        read = nbytes(inp, got, *read_args(mdct, args))
        bound_ms, bound_by, ffma_bound_ms = bound(flops, read, tier)
        library = library_call(torch, mdct, direction)
        library_ms = library_err = None
        if library is not None:
            library_err = float((library(inp).float() - want.float())
                                .abs().max())
            library_ms = cuda_ms(torch, lambda: library(inp), iters=5)
        tflops = flops / (ms * 1e-3) / 1e12
        dtype = str(inp.dtype).removeprefix("torch.")
        ffma = ("" if ffma_bound_ms is None
                else f", at the FFMA rate {ffma_bound_ms:.4f} ms")
        print(f"kernel {name} {tier} {dtype} {tuple(inp.shape)}: "
              f"max_abs_err {err:.3e} (tol {tol:.3e}), {ms:.4f} ms vs "
              f"plain {plain_ms:.4f} ms, library {library_ms} ms (max_abs_err "
              f"{library_err}), bound {bound_ms:.4f} ms ({bound_by}{ffma}) = "
              f"{100 * bound_ms / ms:.1f}% of the time, {tflops:.1f} TF/s of "
              f"products; device ms " + ", ".join(
                  f"{f} {t:.4f}" for f, t in by_function.items()))
        check(err <= tol, f"{name} {tier} {dtype}: error {err} > {tol}")
        entries.append(entry(name, tier, dtype, label, n, max_abs_err=err,
                             tol=tol, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             ffma_bound_ms=ffma_bound_ms,
                             library_ms=library_ms, tflops=tflops,
                             function_ms=by_function))


def tensor_core_phase(torch, mdcts):
    """3, continued. The mono kernels of the MDCTs ``mdcts`` (those of
    configurations (a), (b), (c), ``highest`` and ``high``) at 5 rows of 1,
    127 and 129 frames (around their tiles of 64 or 128 frames; no full
    wave of the card) against their plain versions, each tensor-core
    kernel's dynamic shared memory, and the bare [13792 x 1024] x [1024 x
    1024] product through torch.matmul (bf16) and torch._int_mm (int8):
    yardsticks of the product alone, which the port never calls."""
    from audiocodec_tpu_torch.ops import _build, cuda_mdct

    lib = _build.library()
    out = dict(ragged_max_abs_err={}, shared_bytes={}, yardsticks={})
    for tier, code in (("default", 1), ("int8", 2)):
        for fold, name in ((1, "fold_matmul"), (0, "matmul_scatter")):
            for n in (FILTERS_N, RADIX_N):
                b = lib.acx_tc_shared_bytes(code, fold, n)
                out["shared_bytes"][f"{name} {tier} N={n}"] = b
                print(f"build: tc_kernel {name} {tier} N={n}: {b} bytes "
                      "of dynamic shared memory")
    for tier, code in (("highest", 0), ("high", 3)):  # either direction, N
        b = lib.acx_tc_shared_bytes(code, 1, FILTERS_N)
        out["shared_bytes"][f"split_gemm_kernel {tier}"] = b
        print(f"build: split_gemm_kernel<{split_passes(tier)}> {tier}: {b} "
              "bytes of dynamic shared memory")
    for k, mdct in mdcts.items():
        tier = mdct.kernel_precision
        for blocks in (1, 127, 129):
            gen = torch.Generator(device="cpu").manual_seed(blocks)
            x = (torch.rand(5, blocks, FILTERS_N, generator=gen) * 2 - 1).to(
                mdct.wa_r.device, mdct.kernel_dtype)
            for direction in ("forward", "inverse"):
                kernel = mdct.kernel(direction)
                name = kernel.__name__
                plain = getattr(cuda_mdct, f"{name}_reference")
                args = mdct.kernel_args(direction)
                if direction == "inverse" and tier in ("highest", "high"):
                    # a spectrum of the path's scale, the forward's (as
                    # tests/test_torch_cuda.py feeds it): these tiers'
                    # synthesis tolerance is an absolute 1e-4, ~3 float32
                    # ulps of the ~300 that uniform spectra give
                    x = cuda_mdct.fold_matmul_reference(
                        x, *mdct.kernel_args("forward"))[:, :blocks]
                    x = x.contiguous()
                got, want = kernel(x, *args), plain(x, *args)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                tol = tolerance(torch, want, name, tier, x.dtype)
                out["ragged_max_abs_err"][f"{name} ({k}) T={blocks}"] = err
                check(got.shape == want.shape == (5, blocks + 1, FILTERS_N),
                      f"{name} ({k}) T={blocks}: shape {tuple(got.shape)}")
                check(err <= tol, f"{name} ({k}) T={blocks}: error {err} > "
                      f"{tol}")
    print("ragged frame counts, max_abs_err: "
          + ", ".join(f"{c} {e:.3e}"
                      for c, e in out["ragged_max_abs_err"].items()))
    dev = mdcts["b"].wa_r.device
    m, n = BATCH * (SAMPLES // FILTERS_N + 1), FILTERS_N
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    a = torch.randn(m, n, generator=gen).to(dev, torch.bfloat16)
    b = torch.randn(n, n, generator=gen).to(dev, torch.bfloat16)
    qa = torch.randint(-127, 128, (m, n), generator=gen,
                       dtype=torch.int8).to(dev)
    qb = torch.randint(-127, 128, (n, n), generator=gen,
                       dtype=torch.int8).to(dev)
    for label, fn, peak in (
            ("torch.matmul bf16", lambda: torch.matmul(a, b), PEAK["default"]),
            ("torch._int_mm int8", lambda: torch._int_mm(qa, qb),
             PEAK["int8"])):
        ms = cuda_ms(torch, fn)
        tflops = 2.0 * m * n * n / (ms * 1e-3) / 1e12
        out["yardsticks"][label] = dict(ms=ms, tflops=tflops)
        print(f"yardstick {label} [{m} x {n}] x [{n} x {n}]: {ms:.4f} ms = "
              f"{tflops:.1f} TF/s = {100 * tflops / peak:.1f}% of {peak:.0f}")
    return out


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
        bound_ms, bound_by, _ = bound(
            NOISE_OPS_PER_ELEMENT * spec.numel(), nbytes(spec, thr, got),
            "float32")
        entries.append(entry("add_masked_noise", None, dtype,
                             f"noise ({label})", codec.mdct.filters_n,
                             max_abs_err=err, tol=tol, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=None,
                             gb_per_s=gbs))
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
        mdct_once = {codec.mdct.kernel_name(d): 1
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
    mono kernels there for comparison."""
    from audiocodec_tpu_torch import MDCT

    for k in ("highest-radix", "default-radix", "highest-mono",
              "high-mono", "default-mono", "int8-mono"):
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


def vjp_tolerance(torch, want, tier, dtype):
    """A VJP's tolerance against autograd through the plain forward
    version, relative to the peak since a VJP's scale follows its
    cotangent. ``highest``/``high``: 2e-5 of the peak (the forward
    analysis's 1e-6 at its outputs' peak of ~0.05). The one-pass tiers
    (``default``, and ``int8``, whose backward is ``default``): four bf16
    ulps of the peak: the VJP rounds its cotangent (and, in bf16, its fold,
    rotation and butterfly) before each product where autograd rounds each
    product's gradient after it (up to 1.5 ulps apart, measured on the
    plain versions at these shapes), on top of the kernel's two ulps
    against its plain version."""
    peak = float(want.float().abs().max())
    if tier in ("highest", "high") and dtype == torch.float32:
        return 2e-5 * peak
    return 4.0 * 2.0 ** (math.floor(math.log2(peak)) - 7)


def vjp_phase(torch, dev, entries):
    """11. Each VJP against torch.autograd through its plain forward
    version on the same cotangent (numpy seed) at the main path's shapes,
    timed against its plain version, with the time of its block flips and
    lane-half swaps (torch passes) alone."""
    import numpy as np

    from audiocodec_tpu_torch import MDCT
    from audiocodec_tpu_torch.ops import cuda_mdct

    rng = np.random.default_rng(SEED)
    for k, cfg in VJP_CASES.items():
        mdct = MDCT(use_kernel=True, device=dev, **cfg)
        n, tier = mdct.filters_n, mdct.kernel_precision
        radix = mdct.kernel_design == "radix"
        rows = make_signal(torch, dev, mdct.kernel_dtype).reshape(
            BATCH, SAMPLES // n, n)
        with torch.no_grad():
            spectrum = mdct.kernel("forward")(rows,
                                              *mdct.kernel_args("forward"))
        for direction, inp in (("forward", rows), ("inverse", spectrum)):
            name = mdct.kernel_name(direction)
            args, vjp_args = (mdct.kernel_args(direction),
                              mdct.vjp_args(direction))
            cot = torch.from_numpy(rng.uniform(
                -1.0, 1.0, (BATCH, inp.shape[1] + 1, n)).astype(np.float32)
            ).to(dev, inp.dtype)
            vjp = getattr(cuda_mdct, f"{name}_vjp")
            plain_vjp = getattr(cuda_mdct, f"{name}_vjp_reference")
            plain = getattr(cuda_mdct, f"{name}_reference")
            plain_args = args
            if tier == "int8":  # straight-through: default, dequantized
                d = "fwd" if direction == "forward" else "inv"
                deq = cuda_mdct.dequantized(getattr(mdct, f"kernel_q_{d}"),
                                            args[6])
                plain_args = (*args[:4], deq, "default", 1.0)
            got = vjp(cot, *vjp_args)
            xg = inp.detach().requires_grad_()
            want, = torch.autograd.grad(plain(xg, *plain_args), xg, cot)
            torch.cuda.synchronize()
            del xg
            check(got.shape == want.shape == inp.shape,
                  f"{name}_vjp {tier}: shape {tuple(got.shape)}")
            err = float((got.float() - want.float()).abs().max())
            plain_err = float((got.float() - plain_vjp(cot, *vjp_args)
                               .float()).abs().max())
            tol = vjp_tolerance(torch, want, tier, inp.dtype)
            ms = cuda_ms(torch, lambda: vjp(cot, *vjp_args))
            plain_ms = cuda_ms(torch, lambda: plain_vjp(cot, *vjp_args),
                               iters=10)
            analysis = direction == "forward"
            full = torch.empty(BATCH, cot.shape[1] + 1, n, dtype=inp.dtype,
                               device=dev)
            glue_ms = cuda_ms(torch, lambda: cuda_mdct._vjp(
                cot, lambda *_: full, (), analysis))
            spectrum_frames = cot.shape[1] if analysis else got.shape[1]
            bound_ms, bound_by, ffma_bound_ms = bound(
                gemm_flops(spectrum_frames, n, radix),
                nbytes(cot, got, *read_args(mdct, vjp_args)),
                mdct.vjp_precision)
            library = library_call(torch, mdct, direction, adjoint=True)
            library_ms = library_err = None
            if library is not None:
                library_err = float((library(cot).float() - want.float())
                                    .abs().max())
                library_ms = cuda_ms(torch, lambda: library(cot), iters=5)
            dtype = str(inp.dtype).removeprefix("torch.")
            print(f"vjp {name}_vjp {tier} {dtype} {tuple(cot.shape)} -> "
                  f"{tuple(got.shape)}: max_abs_err {err:.3e} (tol "
                  f"{tol:.3e}; against the VJP's plain version "
                  f"{plain_err:.3e}), {ms:.4f} ms vs plain {plain_ms:.4f} ms, "
                  f"flips/swaps {glue_ms:.4f} ms, library {library_ms} ms "
                  f"(max_abs_err {library_err}), bound {bound_ms:.4f} ms "
                  f"({bound_by})")
            check(err <= tol, f"{name}_vjp {tier} {dtype}: error {err} > "
                  f"{tol}")
            config = (f"train ({k})" if not analysis and k in TRAIN_CONFIGS
                      else f"waveform grad ({k})")
            entries.append(entry(f"{name}_vjp", tier, dtype, config, n,
                                 route_tier=mdct.vjp_precision,
                                 max_abs_err=err, tol=tol,
                                 plain_version_err=plain_err, ms=ms,
                                 plain_ms=plain_ms, glue_ms=glue_ms,
                                 bound_ms=bound_ms, bound_by=bound_by,
                                 ffma_bound_ms=ffma_bound_ms,
                                 library_ms=library_ms))
            del cot, got, want, full
        del mdct, rows, spectrum


def trainer(torch, codec, model, x):
    """(params, loss_fn(params, generator), step()) of phase 12's trainer
    ``model`` on ``codec`` at full width, Adam 1e-3, from seeded weights."""
    from audiocodec_tpu_torch.models import post_filter, spectral_ae
    from audiocodec_tpu_torch.parallel import train

    n, dtype = codec.mdct.filters_n, codec.mdct.compute_dtype
    init = torch.Generator(device="cpu").manual_seed(SEED)
    if model == "gains":
        state = train.init_state(codec)
        step, _ = train.make_train_step(codec)
        return ({"gains": state.gains},
                lambda p, gen: train.perceptual_loss(codec, p["gains"], x),
                lambda gen: step(state, x))
    if model == "spectral_ae":
        cfg = spectral_ae.SpectralAE(filters_n=n, hidden_n=512, latent_n=64,
                                     latent_step=1 / 32)
        params = spectral_ae.init_params(init, cfg, dtype, device=x.device)
        loss = lambda p, gen: spectral_ae.perceptual_loss(  # noqa: E731
            codec, cfg, p, x, gen)
        step, make_opt = spectral_ae.make_train_step(codec, cfg)
    else:
        cfg = post_filter.PostFilter(n, 512)
        params = post_filter.init_params(init, cfg, dtype, device=x.device)
        loss = lambda p, gen: post_filter.enhancement_loss(  # noqa: E731
            codec, cfg, p, x)
        step, make_opt = post_filter.make_train_step(codec, cfg)
    opt = make_opt(list(params.values()))
    return params, loss, lambda gen: step(params, opt, x, gen)


# The MDCT kernels' device functions (csrc/mdct_kernels.cu), for the trace
MDCT_DEVICE_FUNCTIONS = ("tc_kernel", "split_kernel", "split_gemm_kernel",
                         "scatter_kernel", "fold_rotate_kernel",
                         "butterfly_in_kernel", "butterfly_out_kernel")


def trace_steps(torch, step, steps=5):
    """Device time of ``steps`` calls of ``step`` under torch.profiler, per
    step: the MDCT kernels, cuBLAS's GEMMs, every other kernel, and the
    share of the device's span (first kernel start to last kernel end)
    with no kernel running."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    spans, split = [], dict(mdct_kernels=0.0, library_gemms=0.0, other=0.0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        if any(f in e.name for f in MDCT_DEVICE_FUNCTIONS):
            key = "mdct_kernels"
        elif "gemm" in e.name.lower() or "cutlass" in e.name.lower():
            key = "library_gemms"
        else:
            key = "other"
        split[key] += (end - start) / 1e3 / steps
    spans.sort()
    busy, reach = 0.0, None
    for start, end in spans:
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    span = max(end for _, end in spans) - spans[0][0]
    return dict(device_ms_per_step=split, idle_share=1.0 - busy / span)


def training_phase(torch, dev, entries):
    """12. The trainers at full width: each step launches the analysis,
    the synthesis and the synthesis VJP once and no other kernel; the
    first step's loss and gradients agree with the all-plain step's; five
    steps stay finite; ms per step, training audio-s/s and peak memory."""
    from audiocodec_tpu_torch import Codec

    results = {}
    for k, model in TRAIN_CONFIGS.items():
        codec = Codec.create(SAMPLE_RATE, bark_bands_n=64, device=dev,
                             **VJP_CASES[k])
        mdct = codec.mdct
        dtype = str(mdct.compute_dtype).removeprefix("torch.")
        x = make_signal(torch, dev, mdct.compute_dtype)
        params, loss_fn, step = trainer(torch, codec, model, x)
        gen = lambda: torch.Generator(device=dev).manual_seed(SEED)  # noqa

        def value_and_grads():
            loss = loss_fn(params, gen())
            grads = torch.autograd.grad(loss, list(params.values()))
            return float(loss.detach()), grads

        loss, grads = value_and_grads()
        with plain_kernels():
            plain_loss, plain_grads = value_and_grads()
        loss_rtol, grad_share = TRAIN_TOL[dtype]
        grad_errs = {}
        for name, g, pg in zip(params, grads, plain_grads):
            err = float((g.float() - pg.float()).abs().max())
            tol = grad_share * float(pg.float().abs().max())
            grad_errs[name] = (err, tol)
            check(err <= tol, f"train ({k}): gradient of {name} {err} > "
                  f"{tol} from the all-plain step's")
        loss_err = abs(loss - plain_loss) / abs(plain_loss)
        check(loss_err <= loss_rtol, f"train ({k}): loss {loss} vs "
              f"all-plain {plain_loss}")
        del grads, plain_grads

        names = [mdct.kernel_name(d) for d in ("forward", "inverse")]
        reset_all_launch_counts()
        losses = [float(step(gen()))]
        torch.cuda.synchronize()
        counts = all_launch_counts()
        want = expected_counts(**{names[0]: 1, names[1]: 1,
                                  f"{names[1]}_vjp": 1})
        check(counts == want, f"train ({k}): launch counts {counts}")
        set_launches(entries, f"train ({k})", counts)
        losses += [float(step(gen())) for _ in range(4)]
        check(all(math.isfinite(v) for v in losses),
              f"train ({k}): losses {losses}")
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(torch, lambda: step(gen()), iters=10)
        peak_bytes = torch.cuda.max_memory_allocated()
        forward_ms = cuda_ms(torch, lambda: loss_fn(params, gen()), iters=10)
        trace = trace_steps(torch, lambda: step(gen()))
        rate = BATCH * SAMPLES / SAMPLE_RATE / (ms * 1e-3)
        results[k] = dict(
            model=model, loss=loss, plain_loss=plain_loss, loss_rel_err=
            loss_err, grad_err_tol=grad_errs, losses=losses, ms=ms,
            forward_ms=forward_ms, audio_s_per_s=rate,
            max_memory_allocated=peak_bytes, trace=trace)
        print(f"train ({k}) {model} {VJP_CASES[k]}: launches {counts}; "
              f"loss {loss:.7g} vs all-plain {plain_loss:.7g} (rel "
              f"{loss_err:.2e}); gradient err/tol "
              + ", ".join(f"{nm} {e:.2e}/{t:.2e}"
                          for nm, (e, t) in grad_errs.items())
              + f"; 5 losses {losses}; {ms:.3f} ms/step (forward "
              f"{forward_ms:.3f}) = {rate:.1f} training audio-s/s; peak "
              f"memory {peak_bytes / 2**30:.2f} GiB; traced device ms a step "
              f"{trace['device_ms_per_step']}, idle {trace['idle_share']:.3f}")
        del codec, x, params, loss_fn, step
    return results


def waveform_grad_phase(torch, dev, entries):
    """13. The gradient of inverse_transform(transform(x)) with respect to
    the waveform (a seeded cotangent), through all four kernels of the
    design, against the same gradient through their plain versions."""
    import numpy as np

    from audiocodec_tpu_torch import MDCT

    rng = np.random.default_rng(SEED + 1)
    results = {}
    for k, cfg in VJP_CASES.items():
        mdct = MDCT(use_kernel=True, device=dev, **cfg)
        n = mdct.filters_n
        x = make_signal(torch, dev, mdct.compute_dtype).requires_grad_()
        cot = torch.from_numpy(rng.uniform(
            -1.0, 1.0, (BATCH, SAMPLES + 2 * n, 1)).astype(np.float32)
        ).to(dev, mdct.compute_dtype)

        def grad():
            out = mdct.inverse_transform(mdct.transform(x))
            return torch.autograd.grad(out, x, cot)[0]

        reset_all_launch_counts()
        got = grad()
        torch.cuda.synchronize()
        counts = all_launch_counts()
        names = [mdct.kernel_name(d) for d in ("forward", "inverse")]
        check(counts == expected_counts(**{m: 1 for m in names},
                                        **{f"{m}_vjp": 1 for m in names}),
              f"waveform grad ({k}): launch counts {counts}")
        set_launches(entries, f"waveform grad ({k})", counts)
        with plain_kernels():
            want = grad()
        err = float((got.float() - want.float()).abs().max())
        # two VJPs chained: twice the one VJP's tolerance
        tol = 2.0 * vjp_tolerance(torch, want, mdct.kernel_precision,
                                  mdct.kernel_dtype)
        finite = bool(torch.isfinite(got).all())
        results[k] = dict(max_abs_err=err, tol=tol,
                          peak=float(want.float().abs().max()))
        print(f"waveform grad ({k}) {cfg}: launches {counts}; max_abs_err "
              f"{err:.3e} (tol {tol:.3e}) against the all-plain gradient")
        check(finite and err <= tol,
              f"waveform grad ({k}): error {err} > {tol} (finite {finite})")
        del mdct, x, cot, got, want
    return results


def probe_phase(torch, dev, entries):
    """14. The int8 probe through its entry point (its launches), then each
    of its kernels against its plain version at the probe's shape and at
    ragged row counts, its SNR against its plain version's, and the
    library call of the same product."""
    from audiocodec_tpu_torch.ops import _build, cuda_probe
    from audiocodec_tpu_torch.ops import dct as _dct
    from audiocodec_tpu_torch.probes import int8_probe

    m, x_np, y_ref = probe_inputs = int8_probe.inputs()
    reset_all_launch_counts()
    res = int8_probe.run(dev, probe_inputs=probe_inputs)
    torch.cuda.synchronize()
    counts = all_launch_counts()
    names = [k.__name__ for k in cuda_probe.KERNELS]
    check(all(counts[k] for k in names)
          and not any(v for k, v in counts.items() if k not in names),
          f"probe: launch counts {counts}")
    print(f"probe: {json.dumps(res)}; launches {counts}")

    x = torch.from_numpy(x_np).to(dev)
    rows, n = x.shape
    mats = {"bf16": m["bf16"].to(dev), "int8": m["int8"].to(dev)}
    ops = {k: cuda_probe.operand(v) for k, v in mats.items()}
    xb, (q, _) = x.to(torch.bfloat16), _dct.int8_rowquant(x)
    library = {"bf16": lambda: torch.matmul(xb, mats["bf16"]),
               "int8": lambda: torch._int_mm(q, mats["int8"])}
    # the library path from the kernel's own float32 x: a cast, then the
    # product (bf16 out); and the bytes each library call moves, each
    # input read once and each output written once
    cast_matmul = lambda: torch.matmul(x.to(torch.bfloat16),  # noqa: E731
                                       mats["bf16"])
    cast_matmul_ms = cuda_ms(torch, cast_matmul)
    out_bf16 = rows * n * 2
    library_bytes = {
        "torch.matmul bf16 x": nbytes(xb, mats["bf16"]) + out_bf16,
        "x.to(bfloat16) + torch.matmul": nbytes(x, xb) + nbytes(
            xb, mats["bf16"]) + out_bf16,
        "torch._int_mm": nbytes(q, mats["int8"]) + rows * n * 4,
    }
    print(f"probe library calls: x.to(bfloat16) + torch.matmul "
          f"{cast_matmul_ms:.4f} ms; bytes moved {library_bytes}")
    results = {"library_bytes": library_bytes,
               "cast_matmul_ms": cast_matmul_ms}
    for code, (variant, label) in enumerate(PROBE_VARIANTS.items()):
        name = f"probe_{variant}"
        shared = _build.library().acx_probe_shared_bytes(code)
        print(f"build: probe_kernel<{label}>: {shared} bytes of dynamic "
              "shared memory")
        check(shared == cuda_probe.shared_bytes(variant),
              f"probe_kernel<{label}>: {shared} bytes of shared memory, "
              f"cuda_probe.shared_bytes says {cuda_probe.shared_bytes(variant)}")
        key, tier = ("bf16", "default") if variant == "bf16" else (
            "int8", "int8")
        args = (mats[key],) if key == "bf16" else (mats[key], m["rescale"])
        kernel = getattr(cuda_probe, name)
        plain = getattr(cuda_probe, f"{name}_reference")
        errs = {}
        for r in (*PROBE_RAGGED_ROWS, rows):  # the full shape last
            got, want = kernel(x[:r], *args, ops[key]), plain(x[:r], *args)
            torch.cuda.synchronize()
            check(got.shape == want.shape == (r, n),
                  f"{name}: shape {tuple(got.shape)} at {r} rows")
            err = float((got - want).abs().max())
            tol = 0.0 if key == "int8" else tolerance(
                torch, want, name, "default", torch.float32)
            check(err <= tol, f"{name} at {r} rows: error {err} > {tol}")
            errs[r] = err
        snr = res[f"cuda_{variant}_snr_db"]
        plain_snr = int8_probe.snr_db(want.cpu().numpy(), y_ref)
        check(abs(snr - plain_snr) <= SNR_MARGIN_DB,
              f"{name}: SNR {snr} vs plain {plain_snr}")
        plain_ms = cuda_ms(torch, lambda: plain(x, *args), iters=5)
        library_ms = cuda_ms(torch, library[key])
        bound_ms, bound_by, _ = bound(2.0 * rows * n * n,
                                      nbytes(x, ops[key], got), tier)
        ms = res[f"cuda_{variant}_ms"]
        results[variant] = dict(snr_db=snr, plain_snr_db=plain_snr,
                                max_abs_err=errs, shared_bytes=shared)
        from_f32_ms = cast_matmul_ms if key == "bf16" else None
        print(f"kernel {name} [{rows} x {n}] x [{n} x {n}]: max_abs_err "
              f"{errs} (tol {tol:.3e}), SNR {snr:.4f} dB (plain "
              f"{plain_snr:.4f}), {ms:.4f} ms vs plain {plain_ms:.4f} ms, "
              f"library {library_ms:.4f} ms (from float32 x "
              f"{from_f32_ms} ms), bound {bound_ms:.4f} ms "
              f"({bound_by}) = {100 * bound_ms / ms:.1f}% of the time, "
              f"{res[f'cuda_{variant}_tf_s']:.1f} TF/s")
        entries.append(entry(name, tier, "float32", "probe", n,
                             max_abs_err=errs[rows], tol=tol, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=library_ms,
                             library_from_f32_ms=from_f32_ms,
                             snr_db=snr, plain_snr_db=plain_snr,
                             ragged_max_abs_err=errs))
        del got, want
    set_launches(entries, "probe", counts)
    return dict(run=res, kernels=results)


def rvq_phase(torch, dev):
    """15. The discrete RVQ codec at full width in (r): serving and three
    training steps, each through the kernels and against the all-plain
    run."""
    import numpy as np

    from audiocodec_tpu_torch import Codec
    from audiocodec_tpu_torch.models import rvq, spectral_ae

    codec = Codec.create(SAMPLE_RATE, bark_bands_n=64, device=dev,
                         **NOISE_CONFIGS["r"])
    ae, cfg = spectral_ae.SpectralAE(**RVQ_AE), rvq.RVQ(**RVQ_CFG)
    init = torch.Generator(device="cpu").manual_seed(SEED)
    params = spectral_ae.init_params(init, ae, torch.float32, device=dev)
    state = rvq.init_state(init, cfg, torch.float32, device=dev)
    x = make_signal(torch, dev, torch.float32)
    audio_s = BATCH * SAMPLES / SAMPLE_RATE

    def encode():
        return rvq.encode_discrete(codec, ae, cfg, params, state, x)

    def decode(codes):
        return rvq.decode_discrete(codec, ae, cfg, params, state, codes)

    reset_all_launch_counts()
    codes = encode()
    data = rvq.pack_codes(cfg, codes)
    back = rvq.unpack_codes(cfg, data, tuple(codes.shape))
    y = decode(back)
    torch.cuda.synchronize()
    counts = all_launch_counts()
    check(counts == expected_counts(fold_matmul=1, matmul_scatter=1),
          f"rvq serving: launch counts {counts}")
    check(codes.shape == (BATCH, SAMPLES // FILTERS_N + 1, 1, cfg.stages)
          and codes.dtype == torch.int32,
          f"rvq: codes {tuple(codes.shape)} {codes.dtype}")
    check(np.array_equal(back, codes.cpu().numpy())
          and len(data) * 8 == codes.numel() * cfg.bits_per_index,
          "rvq: the codes did not survive pack_codes/unpack_codes")
    check(y.shape == (BATCH, SAMPLES + 2 * FILTERS_N, 1)
          and bool(torch.isfinite(y).all()),
          f"rvq: decode {tuple(y.shape)}, finite "
          f"{bool(torch.isfinite(y).all())}")
    with plain_kernels():
        plain_codes, plain_y = encode(), decode(back)
    same = float((codes == plain_codes).float().mean())
    peak = float(plain_y.abs().max())
    err = float((y - plain_y).abs().max())
    # the synthesis's absolute 1e-4 (tolerance()), at the decode's scale
    tol = 1e-4 * max(1.0, peak)
    check(same >= RVQ_CODES_EQUAL, f"rvq: {same} of the codes equal the "
          "all-plain encode's")
    check(err <= tol, f"rvq: decode {err} > {tol} from the all-plain decode")
    encode_ms = cuda_ms(torch, encode, iters=10)
    decode_ms = cuda_ms(torch, lambda: decode(codes), iters=10)
    traces = {"encode": trace_steps(torch, encode),
              "decode": trace_steps(torch, lambda: decode(codes))}
    t0 = time.perf_counter()
    rvq.unpack_codes(cfg, rvq.pack_codes(cfg, codes), tuple(codes.shape))
    pack_ms = (time.perf_counter() - t0) * 1e3
    serving = dict(codes_equal=same, decode_max_abs_err=err, decode_tol=tol,
                   payload_bytes=len(data), encode_ms=encode_ms,
                   decode_ms=decode_ms, pack_unpack_wall_ms=pack_ms,
                   encode_audio_s_per_s=audio_s / (encode_ms * 1e-3),
                   decode_audio_s_per_s=audio_s / (decode_ms * 1e-3),
                   traces=traces)
    print(f"rvq serving {NOISE_CONFIGS['r']} {RVQ_AE} {RVQ_CFG}: launches "
          f"{counts}; codes equal to plain {100 * same:.4f}%, {len(data)} "
          f"bytes packed and unpacked bit for bit ({pack_ms:.1f} ms on the "
          f"host); decode max_abs_err {err:.3e} (tol {tol:.3e}); encode "
          f"{encode_ms:.3f} ms = {serving['encode_audio_s_per_s']:.1f} "
          f"audio-s/s, decode {decode_ms:.3f} ms = "
          f"{serving['decode_audio_s_per_s']:.1f} audio-s/s; traced "
          + ", ".join(f"{k} {t['device_ms_per_step']}, idle "
                      f"{t['idle_share']:.3f}" for k, t in traces.items()))
    del y, plain_y, plain_codes, back

    loss_rtol, grad_share = TRAIN_TOL["float32"]

    def within(label, got, want):
        """max |got - want| against grad_share of want's peak."""
        err = (float((got - want).abs().max()),
               grad_share * float(want.abs().max()))
        check(err[0] <= err[1], f"rvq train: {label} {err}")
        return err

    def held(label, gate, st):
        """Loss and gradients at one gate from the same params and RVQ
        state through the kernels and all plain; the latents of both."""
        def value_and_grads():
            loss, z = rvq.perceptual_loss(codec, ae, cfg, params, st, x,
                                          quantizer_gate=gate)
            grads = torch.autograd.grad(loss, list(params.values()))
            return float(loss.detach()), grads, z.detach()

        loss, grads, z = value_and_grads()
        with plain_kernels():
            plain_loss, plain_grads, plain_z = value_and_grads()
        loss_err = abs(loss - plain_loss) / abs(plain_loss)
        check(loss_err <= loss_rtol, f"rvq train ({label}): loss {loss} vs "
              f"all-plain {plain_loss}")
        grad_errs = {name: within(f"({label}) gradient of {name}", g, pg)
                     for name, g, pg in zip(params, grads, plain_grads)}
        print(f"rvq train ({label}, gate {gate}): loss {loss:.7g} vs "
              f"all-plain {plain_loss:.7g} (rel {loss_err:.2e}); gradient "
              "err/tol " + ", ".join(f"{nm} {e:.2e}/{t:.2e}"
                                     for nm, (e, t) in grad_errs.items()))
        return dict(loss=loss, plain_loss=plain_loss, loss_rel_err=loss_err,
                    grad_err_tol=grad_errs), z, plain_z

    # the first step's loss: the quantizer is off
    warmup, z, plain_z = held("warmup", 0.0, state)
    loss, plain_loss = warmup["loss"], warmup["plain_loss"]
    # its EMA step on the card, from each side's latents, with no reseed
    # (a draw is the only thing the two sides could not share); codewords
    # that a frame whose codes differ touches are left out of the compare
    ema_cfg = dataclasses.replace(cfg, reseed_threshold=0.0)
    ema, plain_ema = (rvq.ema_update(ema_cfg, state, v) for v in (z, plain_z))
    ema_codes, plain_ema_codes = (
        rvq.quantize(ema_cfg, state, v)[1].reshape(-1, cfg.stages)
        for v in (z, plain_z))
    moved = (ema_codes != plain_ema_codes).any(dim=-1)
    ema_same = 1.0 - float(moved.float().mean())
    check(ema_same >= RVQ_CODES_EQUAL, f"rvq train: {ema_same} of the EMA "
          "step's frames have the all-plain codes")
    keep = torch.ones(cfg.stages, cfg.codebook_size, dtype=torch.bool,
                      device=dev)
    for side in (ema_codes, plain_ema_codes):
        for s in range(cfg.stages):
            keep[s, side[moved, s].long()] = False
    ema_errs = {k: within(f"EMA {k}", ema[k][keep], plain_ema[k][keep])
                for k in ema}
    print(f"rvq train EMA step (reseed_threshold 0): frames with the "
          f"all-plain codes {100 * ema_same:.4f}%, codewords compared "
          f"{int(keep.sum())}/{keep.numel()}; err/tol "
          + ", ".join(f"{k} {e:.2e}/{t:.2e}" for k, (e, t) in
                      ema_errs.items()))
    # the engaged quantizer (STE, commitment) on the EMA-fitted codebooks
    engaged, _, _ = held("engaged", 1.0, ema)
    del z, plain_z, ema, plain_ema

    step, make_opt = rvq.make_train_step(codec, ae, cfg, warmup_steps=1)
    opt = make_opt(list(params.values()))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    losses = []
    once = expected_counts(fold_matmul=1, matmul_scatter=1,
                           matmul_scatter_vjp=1)
    for i in range(RVQ_TRAIN_STEPS):
        reset_all_launch_counts()
        losses.append(float(step(params, state, opt, x, gen, i)))
        counts = all_launch_counts()
        check(counts == once, f"rvq train step {i}: launch counts {counts}")
    check(all(math.isfinite(v) for v in losses), f"rvq train: {losses}")
    check(all(bool(torch.isfinite(t).all()) for t in state.values()),
          "rvq train: non-finite RVQ state")
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(torch, lambda: step(params, state, opt, x, gen,
                                     RVQ_TRAIN_STEPS), iters=10)
    peak_bytes = torch.cuda.max_memory_allocated()
    trace = trace_steps(torch, lambda: step(params, state, opt, x, gen,
                                            RVQ_TRAIN_STEPS))
    training = dict(warmup=warmup, engaged=engaged,
                    ema=dict(frames_equal=ema_same, err_tol=ema_errs),
                    losses=losses, ms=ms,
                    audio_s_per_s=audio_s / (ms * 1e-3),
                    max_memory_allocated=peak_bytes, trace=trace)
    print(f"rvq train: launches a step {counts}; first loss {loss:.7g} vs "
          f"all-plain {plain_loss:.7g}; {RVQ_TRAIN_STEPS} losses {losses}; "
          f"{ms:.3f} ms/step = "
          f"{training['audio_s_per_s']:.1f} training audio-s/s; peak memory "
          f"{peak_bytes / 2**30:.2f} GiB; traced device ms a step "
          f"{trace['device_ms_per_step']}, idle {trace['idle_share']:.3f}")
    return dict(serving=serving, training=training)


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
    sass, sass_lines, kernel_names = sass_summary(lib_path)
    for name, ops in sass.items():
        print(f"sass: {name}: " + ", ".join(f"{n} {op}" for op, n in
                                             ops.items()))
    for line in sass_lines.values():
        print(f"sass: e.g. {line}")
    tc = {k: ops for k, ops in sass.items() if "tc_kernel" in k}
    split = {k: ops for k, ops in sass.items() if "split_gemm_kernel" in k}
    check(len(tc) == 8 and all(
        (ops["HGMMA"] or ops["IGMMA"]) and ops["UTMALDG"]
        for ops in tc.values()),
        f"tc_kernel: not 8 instances with wgmma and TMA in SASS: {tc}")
    check(split and all(
        ops["HGMMA.F32.BF16"] and ops["UTMALDG"] for ops in split.values()),
        "split_gemm_kernel: an instance without bf16 wgmma into float32 or "
        f"TMA in SASS: {split}")
    probe = {k: ops for k, ops in sass.items() if "probe_kernel" in k}
    check(len(probe) == len(PROBE_VARIANTS) and all(
        (ops["HGMMA"] or ops["IGMMA"]) and ops["UTMALDG"]
        for ops in probe.values()),
        f"probe_kernel: not {len(PROBE_VARIANTS)} instances with wgmma and "
        f"TMA in SASS: {probe}")
    # every GEMM of the library runs on the tensor cores' wgmma
    retired = [k for k in kernel_names if any(g in k for g in RETIRED_GEMMS)]
    check(not retired, f"FFMA or WMMA GEMMs left in the library: {retired}")

    codecs = {k: Codec.create(SAMPLE_RATE, filters_n=FILTERS_N,
                              bark_bands_n=64, device=dev, **cfg)
              for k, cfg in CONFIGS.items()}
    for k, codec in codecs.items():
        check(codec.mdct.use_kernel is True,
              f"config ({k}): use_kernel='auto' did not resolve to the kernels")
    fidelity = {tier: MDCT(FILTERS_N, use_kernel=True, dct_precision=tier,
                           device=dev) for tier in ("highest", "high")}

    # 3. every kernel against its plain version, at the main path's shapes
    entries = []
    cases = {**{k: codecs[k].mdct for k in "abc"}, **fidelity}
    for label, mdct in cases.items():
        compare_kernels(torch, mdct, label, entries)
    tensor_core = tensor_core_phase(torch, cases)

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

    # 5. fidelity: f32 highest (and high) MDCT round trips through the
    # kernels
    x = make_signal(torch, dev, torch.float32)
    fid = {}
    for tier, mdct in fidelity.items():
        with torch.no_grad():
            reset_all_launch_counts()
            rt = mdct.inverse_transform(mdct.transform(x))
            torch.cuda.synchronize()
            counts = all_launch_counts()
        check(counts == expected_counts(fold_matmul=1, matmul_scatter=1),
              f"fidelity {tier}: launch counts {counts}")
        fid[tier] = snr_db(x, rt)
        print(f"fidelity: f32 {tier} MDCT round trip SNR {fid[tier]:.2f} dB")
        set_launches(entries, tier, counts)
    check(fid["highest"] >= FIDELITY_SNR_DB,
          f"fidelity SNR {fid['highest']} < {FIDELITY_SNR_DB}")

    # 7-10. the noise-injection codec and its kernels
    noise = noise_phases(torch, dev, entries)

    # 11-13. the VJPs and the training paths
    t11 = time.monotonic()
    vjp_phase(torch, dev, entries)
    t12 = time.monotonic()
    training = training_phase(torch, dev, entries)
    t13 = time.monotonic()
    waveform_grads = waveform_grad_phase(torch, dev, entries)

    # 14-15. the int8 probe and the discrete RVQ codec
    t14 = time.monotonic()
    probe = probe_phase(torch, dev, entries)
    t15 = time.monotonic()
    rvq = rvq_phase(torch, dev)
    print(f"wall: phases 1-10 {t11 - t0:.1f} s, 11 {t12 - t11:.1f} s, 12 "
          f"{t13 - t12:.1f} s, 13 {t14 - t13:.1f} s, 14 {t15 - t14:.1f} s, "
          f"15 {time.monotonic() - t15:.1f} s")

    # 6. the numbers
    print(json.dumps({"configs": results, "fidelity_snr_db": fid,
                      "tensor_core": tensor_core, **noise,
                      "training": training,
                      "waveform_grads": waveform_grads, "probe": probe,
                      "rvq": rvq}))
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
