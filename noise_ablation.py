#!/usr/bin/env python3
"""Time the noise kernel with one part of it switched off, on one NVIDIA
GPU, to see what bounds it.

    python3 noise_ablation.py

Builds audiocodec_tpu_torch/csrc/noise_kernel.cu three times with plain
nvcc (sm_90a, in parallel, into build/noise_ablation/): as it is, without
its loads (the generator, Box-Muller and the stores on zeros: the
instructions alone) and without its generator (the loads, the masked
add and the stores on z = 0: the bytes alone). Each variant runs on seeded
spectra and thresholds of the main path's shape [32, 431, 1024, 1] in
float32 and bfloat16, timed with CUDA events (50 launches after 5
warm-ups, three times), beside ``torch.add`` of the same two operands,
which moves the same bytes. Only the full kernel computes the noise: its
error against the plain version is printed; the others' results are
meaningless. Prints the card's name and power limit and, as the last line,
a JSON object of the times. Exits non-zero without a CUDA device or if the
source no longer holds a switched-off part's text.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "audiocodec_tpu_torch" / "csrc"
OUT = ROOT / "build" / "noise_ablation"
SHAPE = (32, 431, 1024, 1)
SEED = 1234
# (text of the kernel, its replacement) of each variant
LOADS = ("    const uint4 sv = __ldcs(reinterpret_cast<const uint4*>(spectrum) + v);\n"
         "    const uint4 tv = __ldcs(reinterpret_cast<const uint4*>(threshold) + v);\n")
VARIANTS = {
    "full": [],
    "no loads": [(LOADS, "    const uint4 sv = make_uint4(0, 0, 0, 0), tv = sv;\n")],
    "no generator": [(
        "    for (int c = 0; c < V / 4; ++c) normals4(v * (V / 4) + c, seed, "
        "z + 4 * c);\n",
        "    for (int e = 0; e < V; ++e) z[e] = 0.f;\n")],
}


def build(nvcc: str) -> dict:
    """Each variant's library path, built in parallel."""
    source = (CSRC / "noise_kernel.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"noise_ablation: {name}: the kernel no "
                                 f"longer holds {old!r}")
            text = text.replace(old, new)
        d = OUT / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        (d / "noise_kernel.cu").write_text(text)
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-shared", "-o",
               str(d / "lib.so"), str(d / "noise_kernel.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"noise_ablation: {name}: nvcc failed\n{log}")
        libs[name] = d / "lib.so"
    return libs


def event_ms(torch, fn, iters=50, warmup=5):
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


def main() -> int:
    import shutil

    import torch

    if not torch.cuda.is_available():
        print("noise_ablation: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from audiocodec_tpu_torch.ops import cuda_noise

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    libs = build(nvcc)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    times = {}
    for code, dtype in enumerate((torch.float32, torch.bfloat16)):
        label = str(dtype).removeprefix("torch.")
        spec = (torch.rand(SHAPE, generator=gen, device="cuda") - 0.5).to(dtype)
        thr = (torch.rand(SHAPE, generator=gen, device="cuda") * 0.1).to(dtype)
        out = torch.empty_like(spec)
        plain = cuda_noise.add_masked_noise_reference(spec, thr, SEED)
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            lib.acx_add_masked_noise.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_longlong, ctypes.c_uint, ctypes.c_int, ctypes.c_float,
                ctypes.c_void_p]

            def call():
                rc = lib.acx_add_masked_noise(
                    spec.data_ptr(), thr.data_ptr(), out.data_ptr(),
                    spec.numel(), SEED, code, cuda_noise.SIGMA_SCALE, stream)
                if rc:
                    raise RuntimeError(f"{name} {label}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            err = float((out.float() - plain.float()).abs().max())
            ms = [event_ms(torch, call) for _ in range(3)]
            times[f"{name} {label}"] = ms
            note = f", max_abs_err {err:.3e}" if name == "full" else ""
            print(f"{name}: add_masked_noise {label} {ms} ms{note}")
        ms = [event_ms(torch, lambda: torch.add(spec, thr)) for _ in range(3)]
        times[f"torch.add {label}"] = ms
        print(f"torch.add {label} (the same bytes): {ms} ms")
    print(json.dumps({"card": smi, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
