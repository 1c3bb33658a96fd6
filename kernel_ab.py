#!/usr/bin/env python3
"""Time the MDCT kernels of two checkouts on one NVIDIA GPU, in turns.

    python3 kernel_ab.py OTHER_TREE [--rounds 2]

OTHER_TREE is another checkout of this repository, for instance the parent
commit unpacked with ``git archive`` into ``build/parent``. The script runs
itself as a worker, one fresh process per turn, in the order other, this,
this, other (``--rounds 2``: twice that), so that both trees meet the same
card at the same power limit and temperature. Each worker builds its
tree's kernels into that tree's ``build/`` and times, with CUDA events
(50 launches after 5 warm-ups), each MDCT kernel of the port at the main
path's shapes (chip_smoke.py's signal, 32 clips of 10 s at 44.1 kHz:
[32, 430, 1024] and [32, 215, 2048]) in chip_smoke.py's configurations,
the VJPs of the N=1024 mono ones, and three paths: ``Codec.
round_trip_quantized`` in the three configurations of bench.py,
``round_trip_fast`` in (r) (float32 ``highest``, N=1024) and a training
step of chip_smoke.py's (r) trainer (``SpectralAE``): the wall time per
call (CUDA events around 20 calls, 10 steps, issued back to back) and,
from a torch.profiler trace of 10 calls, the device's busy time per call
(the union of its kernels' spans), which does not depend on how fast the
host issues the call's kernels. A case one tree has no kernel for is left
out. The last line is a JSON object with every turn's times and, per
case, the mean of each tree and their ratio.

Exits non-zero without a CUDA device. Imports torch, chip_smoke.py (its
configurations and timer) and the trees' ``audiocodec_tpu_torch`` only.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs

# (label, Codec.create arguments) of the codecs whose MDCT kernels are
# timed: chip_smoke.py's configurations at the main path's shapes
KERNEL_CASES = {
    **{f"{k} N=1024": cs.CONFIGS[k] for k in "abc"},
    "highest f32 N=1024": cs.NOISE_CONFIGS["r"],
    "high f32 N=1024": cs.VJP_CASES["h"],
    **{f"{k} N=2048": cfg for k, cfg in cs.DESIGN_CONFIGS.items()},
}


def busy_ms(torch, fn, calls=10):
    """Device busy time per call of ``fn``: the union of the spans of its
    kernels in a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, reach = 0.0, None
    for start, end in spans:
        if reach is None or start >= reach:
            busy, reach = busy + end - start, end
        elif end > reach:
            busy, reach = busy + end - reach, end
    return busy / 1e3 / calls


def worker(tree: Path) -> dict:
    import torch

    sys.path.insert(0, str(tree))
    import audiocodec_tpu_torch
    from audiocodec_tpu_torch import Codec
    from audiocodec_tpu_torch.ops import _build, cuda_mdct

    if Path(audiocodec_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported {audiocodec_tpu_torch.__file__}, not "
                           f"the package of {tree}")
    _build.library()
    times = {}
    with torch.no_grad():
        for label, cfg in KERNEL_CASES.items():
            try:
                mdct = Codec.create(cs.SAMPLE_RATE, bark_bands_n=64,
                                    device="cuda", use_kernel=True,
                                    **{"filters_n": cs.FILTERS_N, **cfg}).mdct
                n = mdct.filters_n
                rows = cs.make_signal(torch, "cuda", mdct.kernel_dtype)
                rows = rows.reshape(cs.BATCH, -1, n)
                fwd, inv = mdct.kernel("forward"), mdct.kernel("inverse")
                fargs = mdct.kernel_args("forward")
                iargs = mdct.kernel_args("inverse")
                spec = fwd(rows, *fargs)
            except ValueError:  # a tree without this kernel
                continue
            times[f"{fwd.__name__} {label}"] = cs.cuda_ms(
                torch, lambda: fwd(rows, *fargs), iters=50, warmup=5)
            times[f"{inv.__name__} {label}"] = cs.cuda_ms(
                torch, lambda: inv(spec, *iargs), iters=50, warmup=5)
            if n == cs.FILTERS_N and mdct.kernel_design == "mono":
                gen = torch.Generator(device="cpu").manual_seed(cs.SEED)
                for direction, inp in (("forward", rows), ("inverse", spec)):
                    vjp = getattr(cuda_mdct,
                                  f"{mdct.kernel_name(direction)}_vjp")
                    vargs = mdct.vjp_args(direction)
                    cot = (torch.rand(cs.BATCH, inp.shape[1] + 1, n,
                                      generator=gen) * 2 - 1).to(
                        "cuda", inp.dtype)
                    times[f"{vjp.__name__} {label}"] = cs.cuda_ms(
                        torch, lambda: vjp(cot, *vargs), iters=50, warmup=5)
            del mdct, rows, spec
        for label, cfg in cs.CONFIGS.items():
            codec = Codec.create(cs.SAMPLE_RATE, filters_n=cs.FILTERS_N,
                                 bark_bands_n=64, device="cuda", **cfg)
            x = cs.make_signal(torch, "cuda", codec.mdct.compute_dtype)
            call = lambda: codec.round_trip_quantized(x)  # noqa: E731
            times[f"round_trip_quantized ({label}) wall"] = cs.cuda_ms(
                torch, call, iters=20)
            times[f"round_trip_quantized ({label}) device busy"] = busy_ms(
                torch, call)
            del codec, x
        codec = Codec.create(cs.SAMPLE_RATE, bark_bands_n=64, device="cuda",
                             **cs.NOISE_CONFIGS["r"])
        x = cs.make_signal(torch, "cuda", codec.mdct.compute_dtype)
        call = lambda: codec.round_trip_fast(x, cs.SEED)  # noqa: E731
        times["round_trip_fast (r) wall"] = cs.cuda_ms(torch, call, iters=20)
        times["round_trip_fast (r) device busy"] = busy_ms(torch, call)
    _, _, step = cs.trainer(torch, codec, "spectral_ae", x)
    gen = torch.Generator(device="cuda")
    call = lambda: step(gen.manual_seed(cs.SEED))  # noqa: E731
    times["train (r) spectral_ae step wall"] = cs.cuda_ms(torch, call,
                                                          iters=10)
    times["train (r) spectral_ae step device busy"] = busy_ms(torch, call)
    return times


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--worker"]:
        print(json.dumps(worker(Path(args[1]).resolve())))
        return 0
    import torch

    if not torch.cuda.is_available() or not args:
        print("kernel_ab: needs a CUDA device and another tree",
              file=sys.stderr)
        return 1
    this = Path(__file__).resolve().parent
    other = Path(args[0]).resolve()
    rounds = int(args[args.index("--rounds") + 1]) if "--rounds" in args else 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    order = [("other", other), ("this", this), ("this", this),
             ("other", other)] * rounds
    turns = []
    for name, tree in order:
        out = subprocess.run([sys.executable, __file__, "--worker", str(tree)],
                             capture_output=True, text=True)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        times = json.loads(out.stdout.strip().splitlines()[-1])
        turns.append(dict(tree=name, times=times))
        print(f"turn {len(turns)} ({name}): " + ", ".join(
            f"{k} {v:.4f}" for k, v in times.items()))
    summary = {}
    for case in turns[0]["times"]:
        if any(case not in x["times"] for x in turns):
            continue  # one tree has no such kernel
        mean = {t: sum(x["times"][case] for x in turns if x["tree"] == t)
                / sum(1 for x in turns if x["tree"] == t)
                for t in ("other", "this")}
        spread = {t: [x["times"][case] for x in turns if x["tree"] == t]
                  for t in ("other", "this")}
        summary[case] = dict(other_ms=spread["other"], this_ms=spread["this"],
                             ratio=mean["this"] / mean["other"])
        print(f"{case}: other {mean['other']:.4f} ms, this "
              f"{mean['this']:.4f} ms, ratio {mean['this'] / mean['other']:.3f}"
              f" (other {spread['other']}, this {spread['this']})")
    print(json.dumps({"card": smi, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
