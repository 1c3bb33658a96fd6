"""Traffic kind ``corpus``: bulk encode with the ``corpus`` command.

``__main__.main(["corpus", indir, outdir, "--sample-rate", <rate>])`` at
the command's defaults over ``clips`` PCM16 WAVs of ``clip_samples``
samples, written to the run's scratch directory during set-up, called
again and again; the calls write to two output directories in turn.
Parameters: ``clips``, ``clip_samples``, ``batch`` (the clips made on the
device at a time), ``check`` (files compared a checked call, drawn from the
seed) and ``args`` (more command-line arguments; none at the defaults).
"""

from __future__ import annotations

import contextlib
import io
import os
import random

import numpy as np
import torch

from portbench.lib import audio, harness
from portbench.reference import containers
from portbench.reference.codec import Err, Reference


def name(i: int) -> str:
    return f"clip{i:05d}"


def write_inputs(run, indir) -> None:
    cfg, p = run.config, run.params
    os.makedirs(indir)
    for lo in range(0, p["clips"], p["batch"]):
        count = min(p["batch"], p["clips"] - lo)
        x = audio.pcm16(audio.music(
            harness.sub_seed(run.seed, "corpus", lo), count,
            p["clip_samples"], cfg["channels"], cfg["sample_rate"],
            run.device)).cpu().numpy()
        for j in range(count):
            with open(os.path.join(indir, name(lo + j) + ".wav"), "wb") as f:
                f.write(audio.wav_bytes(x[j], cfg["sample_rate"]))


def corpus(indir, outdir, run) -> int:
    from audiocodec_tpu_torch.__main__ import main

    argv = ["corpus", indir, outdir, "--sample-rate",
            str(run.config["sample_rate"]), *run.params["args"]]
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv, device=run.device)


def run(run):
    p = run.params
    indir = os.path.join(run.scratch, "in")
    write_inputs(run, indir)
    # the shapes of a call: one whole batch of the command's size
    warm_in = os.path.join(run.scratch, "warm")
    os.makedirs(warm_in)
    for i in range(min(p["clips"], 64)):
        os.symlink(os.path.join(indir, name(i) + ".wav"),
                   os.path.join(warm_in, name(i) + ".wav"))
    if corpus(warm_in, os.path.join(run.scratch, "warm-out"), run) != 0:
        raise harness.Failure("the warm-up corpus call failed")
    outs = [os.path.join(run.scratch, f"out{k}") for k in range(2)]
    calls = failed = 0
    with run.window() as w:
        while not w.done():
            if corpus(indir, outs[calls % 2], run) != 0:
                failed += 1
            calls += 1
    memory = run.memory_peak()
    last = [(k, outs[k % 2]) for k in range(max(0, calls - 2), calls)]
    bad, err = check(run, indir, last)
    rate = calls * p["clips"] * p["clip_samples"] / run.config[
        "sample_rate"] / w.seconds
    return harness.Outcome(
        attempted=calls, failed=failed, end_to_end={"audio_s_per_s": rate},
        checks=[("bad", bad), ("err", err)], summary=w.summary, ops=calls,
        memory_peak=memory, device=harness.device_info(run.device))


def read_wav(path) -> np.ndarray:
    """Our own PCM16 WAV (audio.wav_bytes) -> int16 [S, C]."""
    with open(path, "rb") as f:
        data = f.read()
    ch = int.from_bytes(data[22:24], "little")
    return np.frombuffer(data[44:], dtype="<i2").reshape(-1, ch)


def frames_of(run, samples: np.ndarray) -> torch.Tensor:
    """What the command encodes of a clip: the whole blocks of it."""
    n = run.config["filters_n"]
    usable = samples.shape[0] - samples.shape[0] % n
    return torch.from_numpy(samples[:usable].copy()).to(
        torch.float64)[None] / 32768.0


def chosen(run, call: int) -> list:
    rng = random.Random(harness.sub_seed(run.seed, "check", call))
    return rng.sample(range(run.params["clips"]),
                      min(run.params["check"], run.params["clips"]))


def check(run, indir, calls):
    """(files missing or failing to parse or frame as the configuration
    says, the compared files' error energy of their dequantized frames over
    the reference's). Every file of the last call is parsed; files drawn
    from the seed of the last two are compared."""
    cfg = run.config
    ref = Reference(cfg, run.device)
    blocks = run.params["clip_samples"] // cfg["filters_n"]
    bad, err = 0, Err()
    for k, outdir in calls:
        compare = set(chosen(run, k))
        full = k == calls[-1][0]
        for i in range(run.params["clips"]):
            if not (full or i in compare):
                continue
            try:
                path = os.path.join(outdir, name(i) + ".acz")
                if not os.path.exists(path):
                    raise ValueError("missing")
                with open(path, "rb") as f:
                    got = containers.read_acz(f.read(), cfg,
                                              decode=i in compare)
                if got["shape"][:2] != (1, blocks + 1):
                    raise ValueError(f"frames {got['shape']}")
                if i in compare:
                    x = frames_of(run, read_wav(os.path.join(
                        indir, name(i) + ".wav")))
                    _, _, expect = ref.encode(ref.analysis(x))
                    err.add(ref.dequantize(got["codes"], got["levels"]),
                            expect)
            except ValueError as e:
                run.log(f"call {k} file {name(i)}: {e}")
                bad += 1
    return bad, err.value


def control(run, ref) -> float:
    """The check's error with ``ref`` (the reference at a lower precision)
    in the program's place, on the files a run would compare."""
    cfg, p = run.config, run.params
    exact = Reference(cfg, run.device)
    err = Err()
    for i in sorted(set(chosen(run, 0))):
        lo = i - i % p["batch"]
        count = min(p["batch"], p["clips"] - lo)
        x = audio.pcm16(audio.music(
            harness.sub_seed(run.seed, "corpus", lo), count,
            p["clip_samples"], cfg["channels"], cfg["sample_rate"],
            run.device))[i - lo].cpu().numpy()
        x = frames_of(run, x)
        codes, levels, _ = ref.encode(ref.analysis(x))
        _, _, expect = exact.encode(exact.analysis(x))
        err.add(exact.dequantize(codes.cpu(), levels.cpu()), expect)
    return err.value
