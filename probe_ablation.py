#!/usr/bin/env python3
"""Time the int8 probe's kernel with one part of it switched off, on one
NVIDIA GPU, to see what holds it back.

    python3 probe_ablation.py

Builds audiocodec_tpu_torch/csrc/probe_kernels.cu four times with plain
nvcc (sm_90a, in parallel, into build/probe_ablation/): as it is, without
the A build (A keeps whatever shared memory held), without the products
(no wgmma: the operand's stream, the build and the stores remain) and
without the output stores. Each variant's three kernels (bf16, int8, int8g)
run on the probe's x [14336, 1024] float32 (``probes/int8_probe.py``) and
are timed with CUDA events (50 launches after 5 warm-ups). Only the full
kernel computes the product: its error against the plain version is
printed; the others' results are meaningless. Prints the card's name and
power limit, each variant's registers and spills (ptxas) and, as the last
line, a JSON object of the times. Exits non-zero without a CUDA device or
if the source no longer holds a switched-off part's text.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "audiocodec_tpu_torch" / "csrc"
OUT = ROOT / "build" / "probe_ablation"
# (text of the kernel, its replacement) of each variant
VARIANTS = {
    "full": [],
    "no A build": [(
        "        build_a<V>(smem, scales, x, row0, rows, tile_rows, "
        "rank * L::KC,\n                   tid >> 5, tid & 31);\n", "")],
    "no products": [(
        "      for (int kk = 0; kk < 4; ++kk)\n        hopper::wgmma(",
        "      for (int kk = 0; kk < 0; ++kk)\n        hopper::wgmma(")],
    "no stores": [(
        "        if (r >= tile_rows || row >= rows) continue;",
        "        if (r >= 0) continue;")],
}
VARIANT_CODES = {"bf16": 0, "int8": 1, "int8_grouped": 2}


def build(nvcc: str) -> dict:
    """Each variant's library path, built in parallel; ptxas's register
    and spill lines of its probe kernels printed."""
    source = (CSRC / "probe_kernels.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"probe_ablation: {name}: the kernel no "
                                 f"longer holds {old!r}")
            text = text.replace(old, new)
        d = OUT / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        (d / "probe_kernels.cu").write_text(text)
        (d / "hopper.cuh").write_text((CSRC / "hopper.cuh").read_text())
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-shared", "-o",
               str(d / "lib.so"), str(d / "probe_kernels.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"probe_ablation: {name}: nvcc failed\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Function properties" in line and "probe_kernel" in line:
                instance = line.split("probe_kernelILi", 1)[1][0]
                print(f"build {name}: probe_kernel variant {instance}: "
                      f"{lines[i + 1].split(':', 1)[-1].strip()}; "
                      f"{lines[i + 2].split(':', 1)[-1].strip()}")
        libs[name] = d / "lib.so"
    return libs


def main() -> int:
    import shutil

    import torch

    if not torch.cuda.is_available():
        print("probe_ablation: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from audiocodec_tpu_torch.ops import cuda_probe
    from audiocodec_tpu_torch.probes import int8_probe

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    libs = build(nvcc)
    m = cuda_probe.probe_matrices()
    x = torch.from_numpy(int8_probe.make_input()).cuda()
    mats = {"bf16": m["bf16"].cuda(), "int8": m["int8"].cuda()}
    ops = {k: cuda_probe.operand(v) for k, v in mats.items()}
    plain = {
        "bf16": cuda_probe.probe_bf16_reference(x, mats["bf16"]),
        "int8": cuda_probe.probe_int8_reference(x, mats["int8"],
                                                m["rescale"]),
        "int8_grouped": cuda_probe.probe_int8_grouped_reference(
            x, mats["int8"], m["rescale"]),
    }
    out = torch.empty_like(plain["bf16"])
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.acx_probe_gemm.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        for variant, code in VARIANT_CODES.items():
            op = ops["bf16" if variant == "bf16" else "int8"]

            def call():
                rc = lib.acx_probe_gemm(x.data_ptr(), op.data_ptr(),
                                        out.data_ptr(), x.shape[0], code,
                                        float(m["rescale"]), stream)
                if rc:
                    raise RuntimeError(f"{name} {variant}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            err = float((out - plain[variant]).abs().max())
            for _ in range(5):
                call()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(50):
                call()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 50
            times[f"{name} {variant}"] = ms
            note = f", max_abs_err {err:.3e}" if name == "full" else ""
            print(f"{name}: probe_{variant} {ms:.4f} ms{note}")
    print(json.dumps({"card": smi, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
