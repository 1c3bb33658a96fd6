"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each source is compiled with plain ``nvcc`` into an object, all of them at
once in parallel processes, and the objects are linked into one shared
library with a C interface, cached under ``build/audiocodec_tpu_torch/`` of
the checkout by a hash of the sources and flags, and loaded with
``ctypes``. Nothing here runs when the package is imported: the first kernel
launch builds. A missing ``nvcc`` or a failed compile raises; nothing falls
back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("mdct_kernels.cu", "noise_kernel.cu", "probe_kernels.cu")
HEADERS = ("hopper.cuh",)  # included by the sources; part of the hash
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "audiocodec_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def _run_all(commands):
    """Run the commands in parallel; returns (return codes, outputs), after
    every process has ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in commands]
    outs = [p.communicate()[0] for p in procs]
    return [p.returncode for p in procs], outs


def build(nvcc: str | None = None, build_dir: Path = BUILD_DIR):
    """Compile the kernels unless a library of the same sources and flags
    exists. Returns (library path, compiler output; empty when cached).
    ``nvcc`` defaults to the one on the PATH, else the one under
    ``$CUDA_HOME`` (default ``/usr/local/cuda``).

    :raises RuntimeError: if ``nvcc`` is missing or a compile fails.
    """
    nvcc = nvcc or shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if not (os.path.isfile(nvcc) and os.access(nvcc, os.X_OK)):
        raise RuntimeError(f"nvcc not found at {nvcc!r}: cannot build the "
                           "CUDA kernels of audiocodec_tpu_torch")
    sources = [CSRC / s for s in SOURCES]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + [CSRC / h for h in HEADERS]:
        digest.update(src.read_bytes())
    lib = Path(build_dir) / f"libacx_kernels-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [lib.with_name(f"{lib.stem}.{s.stem}.{tag}.o") for s in sources]
    tmp = lib.with_name(f"{lib.name}.{tag}")
    try:
        rcs, logs = _run_all(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
            for s, o in zip(sources, objs)
        )
        if not any(rcs):
            link_rcs, link_logs = _run_all(
                [[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]]
            )
            rcs, logs = rcs + link_rcs, logs + link_logs
        if any(rcs):
            raise RuntimeError(f"nvcc failed ({rcs}):\n" + "".join(logs))
        os.replace(tmp, lib)  # atomic: concurrent builds agree on one file
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return lib, "".join(logs)


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with every entry point's signature set."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    signatures = {
        "acx_fold_matmul": [ptr] * 8 + [i32] * 5 + [f32, ptr],
        "acx_fold_matmul_t": [ptr] * 8 + [i32] * 5 + [ptr],
        "acx_matmul_scatter": [ptr] * 9 + [i32] * 5 + [f32, ptr],
        "acx_matmul_scatter_t": [ptr] * 9 + [i32] * 5 + [ptr],
        "acx_tc_shared_bytes": [i32] * 3,
        "acx_radix_fold_matmul": [ptr] * 10 + [i32] * 5 + [ptr],
        "acx_radix_fold_matmul_t": [ptr] * 10 + [i32] * 5 + [ptr],
        "acx_radix_matmul_scatter": [ptr] * 10 + [i32] * 5 + [ptr],
        "acx_radix_matmul_scatter_t": [ptr] * 10 + [i32] * 5 + [ptr],
        "acx_add_masked_noise": [ptr] * 3 + [
            ctypes.c_longlong, ctypes.c_uint, i32, f32, ptr,
        ],
        "acx_philox_uniforms": [ptr] * 2 + [
            ctypes.c_longlong, ctypes.c_uint, ptr,
        ],
        "acx_probe_gemm": [ptr] * 3 + [i32, i32, f32, ptr],
        "acx_probe_shared_bytes": [i32],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i32
    return lib
