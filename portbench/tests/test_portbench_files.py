"""BENCHMARK.json and the files it names: each loads, and every name, unit
and length is inside the benchmark's contract."""

import ast
import json
import re
from pathlib import Path

import pytest

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head"
                   r"|_dim$|_rank$|expansion|per_tok)")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    assert BENCH["paths"] == ["portbench"]
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert (ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(TEXT.match(w) for w in cmd)
    for word in cmd:
        assert not word.startswith("/") and ".." not in word.split("/")
        if "/" in word:
            assert word.split("/")[0] in BENCH["paths"]
            assert (ROOT / word).is_file()


def test_run_seconds_fit_the_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and TEXT.match(entry["why"])
    assert entry["source"].startswith("https://")
    path = ROOT / entry["file"]
    assert path.parent == PORTBENCH / "configs"
    assert path.stem == entry["name"]
    cfg = json.loads(path.read_text())
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key) and not WIDTH.search(key)
        assert key in cfg["assumed"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda e: e["name"])
def test_workload(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        assert NAME.match(cell[key])
    assert TEXT.match(cell["why"]) and cell["chips"] in (1, 4)
    data = json.loads((PORTBENCH / "workloads" / f"{cell['name']}.json")
                      .read_text())
    assert data["name"] == cell["name"] and data["config"] == cell["config"]
    assert data["chips"] == cell["chips"]
    assert (PORTBENCH / "traffic" / f"{data['kind']}.py").is_file()
    assert cell["name"] == f"{cell['config']}.{cell['traffic']}"
    assert set(data["limits"]) >= {"err"}
    # every cell reports set-up, another end-to-end metric and a layer
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell["name"] in m["workloads"] for m in BENCH["per_layer"])


def test_unique_names_and_pairs():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    cells = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(cells) == len(set(cells))
    assert len({w["name"] for w in BENCH["workloads"]}) == len(cells)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(cells) // 4)


@pytest.mark.parametrize("metric", BENCH["end_to_end"],
                         ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source",
                           "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader(metric):
    assert set(metric) == {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert TEXT.match(metric["layer"])
    moves = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in moves.get("workloads", [cell])
    path = PORTBENCH / "metrics" / f"{metric['name']}.py"
    tree = ast.parse(path.read_text())
    assert any(isinstance(n, ast.FunctionDef) and n.name == "read"
               for n in tree.body)
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_every_file_under_paths_is_named_from_name_characters():
    for path in PORTBENCH.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
