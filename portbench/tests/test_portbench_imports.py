"""Nothing under portbench/ imports JAX, the JAX package or the JAX
package's benchmarks, compared by whole top-level module names (the port's
name begins with the JAX package's); the reference imports nothing of the
program either."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

PORTBENCH = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "audiocodec_tpu", "benchmarks"}
FILES = sorted(p for p in PORTBENCH.rglob("*.py")
               if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args
                and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(PORTBENCH).as_posix()
                              for p in FILES])
def test_no_jax_import(path):
    found = top_level_imports(path)
    assert not found & BANNED, found & BANNED
    if "reference" in path.relative_to(PORTBENCH).parts:
        assert "audiocodec_tpu_torch" not in found


def test_whole_name_comparison(tmp_path):
    path = tmp_path / "names.py"
    path.write_text("import audiocodec_tpu_torch.serve\n"
                    "from audiocodec_tpu import x\n")
    assert top_level_imports(path) == {"audiocodec_tpu_torch",
                                       "audiocodec_tpu"}


def test_a_run_loads_no_jax():
    """The harness, every traffic kind and reader, and the program they
    drive, imported in a fresh process: sys.modules holds none of them."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "from portbench.lib import harness;"
        "import json;"
        "bench = json.load(open(harness.ROOT / 'BENCHMARK.json'));"
        "[harness.Cell(w['name']).traffic() for w in bench['workloads']];"
        "[harness.Cell(m['workloads'][0]).reader(m['name'])"
        " for m in bench['per_layer']];"
        "import audiocodec_tpu_torch.serve, audiocodec_tpu_torch.__main__;"
        "import audiocodec_tpu_torch.io.stream_container;"
        "print(harness.banned_modules())")
    out = subprocess.run([sys.executable, "-c", code,
                          str(PORTBENCH.parent)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
