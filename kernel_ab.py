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
the VJPs of the N=1024 mono ones and of the radix ones, the int8 probe's
three kernels at its shape ([14336, 1024] x [1024, 1024]), the noise kernel
on the spectra and thresholds of (r) (float32) and (b) (bfloat16), [32,
431, 1024, 1], and four paths: ``Codec.round_trip_quantized`` in the
three configurations of bench.py, ``round_trip_fast`` in chip_smoke.py's
noise configurations (r) (float32 ``highest``, N=1024), (r2) (float32
``highest``, N=2048 radix) and (b) (bfloat16 ``default``), and a
training step of chip_smoke.py's (r) and (r2) trainers (``SpectralAE``;
the gains at N=2048 through the radix kernels): the wall time per
call (CUDA events around 20 calls, 10 steps, issued back to back) and,
from a torch.profiler trace of 10 calls, the device's busy time per call
(the union of its kernels' spans), which does not depend on how fast the
host issues the call's kernels; a training step also gives the peak of
allocated device memory over one step (MB, after a first step). A case
one tree has no kernel for is left out. Then, for each kernel instance of
this tree's library, the other tree's instance with the same SASS
(cuobjdump), if any. The last line is a JSON object with every turn's
numbers (ms, or MB), per case each tree's and their ratio of means, and
those SASS twins.

Exits non-zero without a CUDA device. Imports torch, chip_smoke.py (its
configurations and timer) and the trees' ``audiocodec_tpu_torch`` only.
"""

from __future__ import annotations

import json
import re
import shutil
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


def sass_bodies(tree: Path) -> dict:
    """{kernel instance: its SASS instructions} of the library the tree's
    workers built (cuobjdump), with the anonymous namespaces' hashes, the
    addresses and the branch labels left out."""
    lib = subprocess.run(
        [sys.executable, "-c", "from audiocodec_tpu_torch.ops import _build; "
         "print(_build.build()[0])"], cwd=tree, capture_output=True,
        text=True, check=True).stdout.split()[-1]
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    bodies, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = re.sub(r"_ZN\d+_GLOBAL__N__\w{8}_\d+_\w+?_cu_\w{8}", "",
                          ln.split("Function :", 1)[1].strip())
            bodies[name] = []
        elif name and (m := re.match(r"\s*/\*[0-9a-f]+\*/\s*(.*?);", ln)):
            bodies[name].append(re.sub(r"\.L_x_\d+", ".L", m.group(1)))
    return bodies


def sass_twins(this: Path, other: Path) -> dict:
    """Per kernel instance of this tree, the other tree's instance whose
    SASS is the same instruction for instruction (None if there is none):
    a kernel the change did not touch keeps its twin."""
    twins = {tuple(body): name
             for name, body in sass_bodies(other).items()}
    return {name: twins.get(tuple(body))
            for name, body in sass_bodies(this).items()}


def worker(tree: Path) -> dict:
    import torch

    sys.path.insert(0, str(tree))
    import audiocodec_tpu_torch
    from audiocodec_tpu_torch import Codec
    from audiocodec_tpu_torch.ops import _build, cuda_mdct, cuda_noise, cuda_probe
    from audiocodec_tpu_torch.probes import int8_probe

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
            radix = mdct.kernel_design == "radix"
            if radix or n == cs.FILTERS_N:
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
        probe = cuda_probe.probe_matrices()
        x = torch.from_numpy(int8_probe.make_input()).cuda()
        for variant in ("bf16", "int8", "int8_grouped"):
            key = "bf16" if variant == "bf16" else "int8"
            mat = probe[key].cuda()
            args = (mat,) if key == "bf16" else (mat, probe["rescale"])
            kernel = getattr(cuda_probe, f"probe_{variant}")
            op = cuda_probe.operand(mat)
            times[f"probe_{variant}"] = cs.cuda_ms(
                torch, lambda: kernel(x, *args, op), iters=50, warmup=5)
        del x
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
        for label in ("r", "r2", "b"):
            codec = Codec.create(cs.SAMPLE_RATE, bark_bands_n=64,
                                 device="cuda", **cs.NOISE_CONFIGS[label])
            x = cs.make_signal(torch, "cuda", codec.mdct.compute_dtype)
            if label != "r2":  # the noise kernel on the path's own operands
                spec, thr = codec._analyze(x)
                dtype = str(spec.dtype).removeprefix("torch.")
                times[f"add_masked_noise {dtype}"] = cs.cuda_ms(
                    torch, lambda: cuda_noise.add_masked_noise(spec, thr,
                                                               cs.SEED),
                    iters=50, warmup=5)
                del spec, thr
            call = lambda: codec.round_trip_fast(x, cs.SEED)  # noqa: E731
            times[f"round_trip_fast ({label}) wall"] = cs.cuda_ms(
                torch, call, iters=20)
            times[f"round_trip_fast ({label}) device busy"] = busy_ms(
                torch, call)
        codec = Codec.create(cs.SAMPLE_RATE, bark_bands_n=64, device="cuda",
                             **cs.NOISE_CONFIGS["r"])
        x = cs.make_signal(torch, "cuda", codec.mdct.compute_dtype)
    gen = torch.Generator(device="cuda")
    for label, model in (("r", "spectral_ae"), ("r2", "gains")):
        if label != "r":
            codec = Codec.create(cs.SAMPLE_RATE, bark_bands_n=64,
                                 device="cuda", **cs.VJP_CASES[label])
        _, _, step = cs.trainer(torch, codec, model, x)
        call = lambda: step(gen.manual_seed(cs.SEED))  # noqa: E731
        call()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        call()
        torch.cuda.synchronize()
        times[f"train ({label}) {model} step peak MB"] = (
            torch.cuda.max_memory_allocated() / 2**20)
        times[f"train ({label}) {model} step wall"] = cs.cuda_ms(
            torch, call, iters=10)
        times[f"train ({label}) {model} step device busy"] = busy_ms(
            torch, call)
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
        summary[case] = dict(other=spread["other"], this=spread["this"],
                             ratio=mean["this"] / mean["other"])
        unit = "MB" if case.endswith(" MB") else "ms"
        print(f"{case}: other {mean['other']:.4f} {unit}, this "
              f"{mean['this']:.4f} {unit}, ratio "
              f"{mean['this'] / mean['other']:.3f} (other {spread['other']}, "
              f"this {spread['this']})")
    twins = sass_twins(this, other)
    for name, twin in twins.items():
        print(f"sass: {name}: " + (f"identical to the other tree's {twin}"
                                   if twin else "no identical instance"))
    print(json.dumps({"card": smi, "summary": summary, "sass_twins": twins}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
