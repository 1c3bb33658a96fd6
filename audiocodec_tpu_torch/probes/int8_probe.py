"""The int8 probe on the card: the three GEMM bodies of the JAX package's
Pallas probe (``benchmarks/pallas_int8_probe.py``) as the port's kernels,
with ``torch._int_mm`` beside them.

    python -m audiocodec_tpu_torch.probes.int8_probe [--quick] [--device cpu]

x [14336, 1024] float32 (uniform in [-0.8, 0.8), numpy seed 0, the probe's
own) times the probe's DCT-IV matrix (``ops/cuda_probe.py::probe_matrices``)
through ``cuda_bf16``, ``cuda_int8`` and ``cuda_int8_grouped`` (the kernels of
``csrc/probe_kernels.cu``) and ``torch_int8`` (the counterpart of the JAX
probe's ``xla_int8``: the same per-row quantization, ``torch._int_mm``, the
rescale; a yardstick the port never calls). Each variant's SNR is taken
against a float64 product with the float32 matrix. Prints a JSON line with
``rows``, ``n``, ``tb`` (the kernels' rows a block) and ``<variant>_snr_db``,
``<variant>_ms`` and ``<variant>_tf_s`` (CUDA events after warm-ups). With
``--device cpu`` every variant runs its plain version (``torch._int_mm`` on
the CPU) and only the SNRs print. Asking for the card without one fails.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from audiocodec_tpu_torch.ops import cuda_probe
from audiocodec_tpu_torch.ops import dct as _dct

ROWS = 14336  # 28 of the JAX probe's tiles of 512 rows


def make_input(rows: int = ROWS) -> np.ndarray:
    """The probe's x: [rows, 1024] float32, uniform in [-0.8, 0.8)."""
    return np.random.default_rng(0).uniform(
        -0.8, 0.8, (rows, cuda_probe.N)).astype(np.float32)


def torch_int8(x, mat, rescale):
    """Per-row dynamic int8 quantization, ``torch._int_mm``, the rescale:
    the probe's ``xla_int8``."""
    q, s = _dct.int8_rowquant(x)
    scale = s * torch.tensor(rescale, dtype=torch.float32)
    return torch._int_mm(q, mat).to(torch.float32) * scale


def variants(matrices: dict, device) -> dict:
    """name -> fn(x) of each variant, the matrices moved to ``device`` once."""
    bf16, int8 = matrices["bf16"].to(device), matrices["int8"].to(device)
    ob, oi = cuda_probe.operand(bf16), cuda_probe.operand(int8)
    rescale = matrices["rescale"]
    return {
        "cuda_bf16": lambda x: cuda_probe.probe_bf16(x, bf16, ob),
        "cuda_int8": lambda x: cuda_probe.probe_int8(x, int8, rescale, oi),
        "cuda_int8_grouped": lambda x: cuda_probe.probe_int8_grouped(
            x, int8, rescale, oi),
        "torch_int8": lambda x: torch_int8(x, int8, rescale),
    }


def snr_db(y: np.ndarray, y_ref: np.ndarray) -> float:
    err = y.astype(np.float64) - y_ref
    return 10.0 * math.log10(float(np.sum(y_ref**2))
                             / max(float(np.sum(err**2)), 1e-30))


def cuda_ms(fn, iters: int, warmup: int) -> float:
    """Milliseconds a call of ``fn`` on the card, by CUDA events."""
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


def inputs() -> tuple:
    """(the probe's matrices, its x as numpy, the float64 reference
    product y_ref)."""
    matrices = cuda_probe.probe_matrices()
    x = make_input()
    y_ref = x.astype(np.float64) @ matrices["f32"].numpy().astype(np.float64)
    return matrices, x, y_ref


def run(device="cuda", quick: bool = False, probe_inputs=None) -> dict:
    """The probe's numbers (see the module's doc) on ``device``: the card
    unless the caller asks for the CPU.

    :param probe_inputs: :func:`inputs`' result, made here when None.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the int8 probe asks for the card and there is "
                           "none (pass --device cpu for the plain versions)")
    matrices, x_np, y_ref = probe_inputs or inputs()
    x = torch.from_numpy(x_np).to(device)
    fns = variants(matrices, device)
    out = {"rows": ROWS, "n": cuda_probe.N, "tb": dict(cuda_probe.TILE_ROWS)}
    for name, fn in fns.items():
        out[f"{name}_snr_db"] = snr_db(fn(x).cpu().numpy(), y_ref)
    if device.type == "cpu":
        return out
    gflop = 2.0 * ROWS * cuda_probe.N**2 / 1e9
    iters, warmup = (5, 2) if quick else (50, 5)
    for name, fn in fns.items():
        ms = cuda_ms(lambda: fn(x), iters, warmup)
        out[f"{name}_ms"] = ms
        out[f"{name}_tf_s"] = gflop / ms
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="fewer timed calls")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu: the plain versions, "
                         "SNRs only")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and torch.cuda.is_available():
        print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    print(json.dumps(run(args.device, args.quick)))


if __name__ == "__main__":
    main()
