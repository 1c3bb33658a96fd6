"""The port's training examples (examples/torch/) run as subprocesses with
``--cpu`` for two steps at the smallest widths, print their JAX twins'
lines and refuse to run without a GPU unless asked for the CPU."""

import re

import pytest

from tests.test_torch_examples_demos import run

TRAIN = {
    "train_spectral_gains.py": (
        ["--filters-n", "64"], "final mean gain: "),
    "train_neural_codec.py": (
        ["--filters-n", "64", "--latent-n", "8", "--batch", "2", "--clips",
         "2"], "quantized-latent reconstruction SNR: "),
    "train_rvq_codec.py": (
        ["--warmup", "1", "--filters-n", "64", "--latent-n", "8",
         "--stages", "2", "--codebook-size", "16", "--batch", "2",
         "--clips", "2"], "packed-code reconstruction SNR: "),
    "post_filter_demo.py": (
        [], "held-out decode SNR at 8.0x threshold scale: "),
}


@pytest.mark.parametrize("script", sorted(TRAIN))
def test_training_example(script):
    args, last = TRAIN[script]
    r = run(script, "--cpu", "--steps", "2", *args)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert lines[-1].startswith(last), r.stdout
    losses = [float(m.group(1)) for m in
              re.finditer(r"^step +\d+  loss (\S+)", r.stdout, re.M)]
    assert len(losses) == 2 and all(v == v for v in losses), r.stdout


@pytest.mark.parametrize("script", sorted(TRAIN))
def test_no_quiet_cpu_run(script):
    r = run(script, timeout=60)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
