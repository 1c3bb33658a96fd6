"""The port's example demos (examples/torch/) run as subprocesses with
``--cpu`` at tests/test_examples.py's arguments, print their key lines,
refuse to run without a GPU unless asked for the CPU, and import nothing
of JAX."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples" / "torch"
DEMOS = ("codec_demo.py", "adaptive_streaming_demo.py",
         "lossy_transport_demo.py", "archival_demo.py")


def run(script, *args, timeout=120):
    """``script`` in a subprocess on one CPU thread."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, str(EXAMPLES / script), *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT,
    )


def test_adaptive_streaming_demo():
    r = run("adaptive_streaming_demo.py", "--cpu", "--seconds", "3")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "plays in ANY .acs decoder" in r.stdout
    assert "0/4 chunks over budget" in r.stdout


def test_lossy_transport_demo():
    r = run("lossy_transport_demo.py", "--cpu", "--seconds", "4",
            "--chunk-blocks", "16", "--lose", "1")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "transport drops chunks [1]" in r.stdout
    assert "finite everywhere: True; stream length preserved: True" in (
        r.stdout)


def test_codec_demo(tmp_path):
    r = run("codec_demo.py", "--cpu", "--bitrates", "96",
            "--out-dir", str(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    for label in ("VBR", "96k plain", "96k ladder"):
        assert label in r.stdout
    assert sorted(p.name for p in tmp_path.glob("*.acz")) == [
        "96kbps_ladder.acz", "96kbps_plain.acz"]


def test_archival_demo():
    r = run("archival_demo.py", "--cpu", "--seconds", "4")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "bit-exact" in r.stdout
    assert "seekable=True" in r.stdout


@pytest.mark.parametrize("script", DEMOS)
def test_no_quiet_cpu_run(script):
    """Without --cpu a script runs on the GPU or fails; this machine's
    torch has no CUDA."""
    r = run(script, timeout=60)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(EXAMPLES.glob("*.py")),
                         ids=lambda p: p.name)
def test_examples_import_no_jax(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "optax", "audiocodec_tpu")]
    assert not bad, bad
    assert any(m.startswith("audiocodec_tpu_torch") for m in _imports(path))
