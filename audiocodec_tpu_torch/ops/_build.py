"""Build and bind the hand-written CUDA kernels of ``csrc/``.

The sources are compiled with plain ``nvcc`` into a shared library with a C
interface, cached under ``build/audiocodec_tpu_torch/`` of the checkout by a
hash of the sources and flags, and loaded with ``ctypes``. Nothing here runs
when the package is imported: the first kernel launch builds. A missing
``nvcc`` or a failed compile raises; nothing falls back.
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
SOURCES = ("mdct_kernels.cu",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "audiocodec_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def build(nvcc: str | None = None, build_dir: Path = BUILD_DIR):
    """Compile the kernels unless a library of the same sources and flags
    exists. Returns (library path, compiler output; empty when cached).
    ``nvcc`` defaults to the one on the PATH, else the one under
    ``$CUDA_HOME`` (default ``/usr/local/cuda``).

    :raises RuntimeError: if ``nvcc`` is missing or the compile fails.
    """
    nvcc = nvcc or shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
    )
    if not (os.path.isfile(nvcc) and os.access(nvcc, os.X_OK)):
        raise RuntimeError(f"nvcc not found at {nvcc!r}: cannot build the "
                           "CUDA kernels of audiocodec_tpu_torch")
    sources = [CSRC / s for s in SOURCES]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.read_bytes())
    lib = Path(build_dir) / f"libmdct_kernels-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: concurrent builds agree on one file
    return lib, proc.stdout + proc.stderr


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with every entry point's signature set."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.acx_fold_matmul.argtypes = [ptr] * 8 + [i32] * 5 + [
        ctypes.c_float, ptr,
    ]
    lib.acx_fold_matmul.restype = i32
    lib.acx_matmul_scatter.argtypes = [ptr] * 9 + [i32] * 5 + [
        ctypes.c_float, ptr,
    ]
    lib.acx_matmul_scatter.restype = i32
    return lib
