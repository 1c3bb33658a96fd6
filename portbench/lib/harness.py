"""Run one cell of BENCHMARK.json and print its result line.

Everything that belongs to one cell is found by name: the cell's entry in
BENCHMARK.json, ``workloads/<cell>.json`` (its configuration, traffic kind,
the kind's parameters and the limits of its checks),
``configs/<config>.json``, ``traffic/<kind>.py`` (which sets up, runs the
window and checks the outputs) and ``metrics/<metric>.py`` for each
per-layer metric that BENCHMARK.json gives the cell.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import random
import sys
import tempfile
import time
from pathlib import Path

import torch

from portbench.lib import trace as _trace

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent
PROGRAM = "audiocodec_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "audiocodec_tpu")


class Failure(Exception):
    """The run cannot give a result: it exits non-zero and prints none."""


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise Failure(f"no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise Failure(f"no file {path}")
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell's files, found by its name."""

    def __init__(self, name: str):
        bench = load_json(ROOT / "BENCHMARK.json")
        self.name = name
        self.workload = load_json(PORTBENCH / "workloads" / f"{name}.json")
        self.kind = self.workload["kind"]
        self.config = load_json(
            PORTBENCH / "configs" / f"{self.workload['config']}.json")
        self.chips = int(self.workload["chips"])
        if any(w["name"] == name for w in bench["workloads"]):
            self.end_to_end = [m for m in bench["end_to_end"]
                               if name in m.get("workloads", [name])]
        else:
            # a cell whose files are ready but that BENCHMARK.json does not
            # hold (README.md): the end-to-end metrics its file names
            self.end_to_end = [
                {"name": n, "unit": u} for n, u in
                self.workload.get("end_to_end", {}).items()] + [
                m for m in bench["end_to_end"] if "workloads" not in m]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"] if name in m.get(
            "workloads", [name] if m["moves"] in reported else [])]

    def traffic(self):
        return load_module(PORTBENCH / "traffic" / f"{self.kind}.py",
                           f"portbench_traffic_{self.kind}")

    def reader(self, metric: str):
        return load_module(PORTBENCH / "metrics" / f"{metric}.py",
                           "portbench_metric_" + metric.replace(".", "_"))


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from a seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items = []  # (index, value)
        self.offered = 0

    def offer(self, value):
        """-> the slot the value took, or None."""
        i = self.offered
        self.offered += 1
        if len(self.items) < self.k:
            self.items.append((i, value))
            return len(self.items) - 1
        j = self.rng.randrange(i + 1)
        if j < self.k:
            self.items[j] = (i, value)
            return j
        return None


def sub_seed(seed: int, *path) -> int:
    """A seed for one input of a run, drawn from the run's seed."""
    rng = random.Random(f"{seed}/" + "/".join(map(str, path)))
    return rng.getrandbits(62)


class Run:
    """What a traffic kind gets: the cell, the seed, the window's length,
    whether to trace, the device, a scratch directory under TMPDIR and
    the process's start on the host clock."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, scratch: str, t0: float):
        self.cell = cell
        self.config = cell.config
        self.workload = cell.workload
        self.params = cell.workload["params"]
        self.seed = seed
        self.trace = trace
        # a traced run traces a steady slice of the cell's traffic
        self.seconds = (min(seconds, cell.workload["trace_seconds"])
                        if trace else seconds)
        self.device = torch.device(device)
        self.scratch = scratch
        self.t0 = t0
        self.window_start = None

    def log(self, msg: str) -> None:
        print(f"[{self.cell.name}] {msg}", file=sys.stderr, flush=True)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def window(self):
        """The measured window: yields a Window; its ``summary`` holds the
        trace when the run traces."""
        w = Window(self)
        self.sync()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        cm = (_trace.traced(self.device) if self.trace
              else contextlib.nullcontext({}))
        with cm as summary:
            w.start = self.window_start = time.perf_counter()
            yield w
            self.sync()
            w.end = time.perf_counter()
        w.summary = summary or None

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))


class Window:
    def __init__(self, run: Run):
        self.run = run
        self.start = self.end = None
        self.summary = None

    def done(self) -> bool:
        return time.perf_counter() - self.start >= self.run.seconds

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Outcome:
    """What a traffic kind hands back."""

    def __init__(self, attempted, failed, end_to_end, checks, summary=None,
                 ops=0, counters=None, memory_peak=0, device=None,
                 setup_s=None):
        self.attempted = attempted
        self.failed = failed
        self.end_to_end = end_to_end  # {metric: value}
        self.checks = checks  # [(name, value)]
        self.summary = summary  # trace summary, or None
        self.ops = ops  # operations inside the traced window
        self.counters = counters or {}
        self.memory_peak = memory_peak
        self.device = device  # (name, count)
        self.setup_s = setup_s


class TraceView:
    """What a per-layer reader reads."""

    def __init__(self, cell: Cell, outcome: Outcome):
        self.cell = cell
        self.summary = outcome.summary
        self.ops = outcome.ops
        self.counters = outcome.counters
        self.workload = cell.workload
        self.params = cell.workload["params"]
        self.config = cell.config

    def metric(self, name: str):
        """Another metric's reader module (to share its definitions)."""
        return self.cell.reader(name)

    def device_ms(self, names=None, exclude=None) -> float:
        """Device ms in the window of the events whose names match."""
        total = 0.0
        for name, s, e in self.summary["device"]:
            if names is not None and not names(name):
                continue
            if exclude is not None and exclude(name):
                continue
            total += e - s
        return total / 1e3


def device_info(device) -> tuple:
    """(the card's name, cards used) of a one-card run."""
    device = torch.device(device)
    if device.type != "cuda":
        return (str(device), 1)
    return (torch.cuda.get_device_name(device), 1)


def devices(chips: int):
    """Fail unless the card is there: no CPU fallback."""
    if not torch.cuda.is_available():
        raise Failure("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise Failure(f"the cell needs {chips} cards, "
                      f"{torch.cuda.device_count()} found")


def check_program() -> None:
    import importlib
    try:
        mod = importlib.import_module(PROGRAM)
    except ImportError as e:
        raise Failure(f"the program is not in this checkout: {e}") from e
    where = Path(mod.__file__).resolve()
    if ROOT not in where.parents:
        raise Failure(f"{PROGRAM} imported from {where}, outside the "
                      f"checkout {ROOT}")


def banned_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules} & set(BANNED))


def judge(cell: Cell, outcome: Outcome):
    """-> (correct, [(name, value, limit)])."""
    limits = cell.workload["limits"]
    rows = [("failed", outcome.failed, 0)]
    for name, value in outcome.checks:
        if name not in limits:
            raise Failure(f"no limit for check {name!r}")
        rows.append((name, value, limits[name]))
    ok = all(v is not None and math.isfinite(v) and v <= lim
             for _, v, lim in rows)
    return ok, rows


def result(cell: Cell, outcome: Outcome, trace: bool):
    """The result line's object, and the checks' lines for stderr."""
    correct, rows = judge(cell, outcome)
    metrics = {}
    if not trace:
        values = dict(outcome.end_to_end, setup_s=outcome.setup_s)
        for m in cell.end_to_end:
            # "<quantity>.<class>" is the kind's <quantity> under a bound
            # of its own
            quantity = m["name"].split(".")[0]
            if quantity not in values:
                raise Failure(f"the run gave no {quantity}")
            metrics[m["name"]] = {"value": values[quantity],
                                  "unit": m["unit"]}
    else:
        view = TraceView(cell, outcome)
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    name, count = outcome.device
    device = {"platform": "gpu", "kind": name, "count": count,
              "memory_peak_bytes": outcome.memory_peak}
    line = {"correct": correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = _trace.busy_us(outcome.summary) * 1e-6
        device["window_s"] = _trace.window_us(outcome.summary) * 1e-6
        line["breakdown"] = _trace.breakdown(outcome.summary)
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    lines = [f"check {n} = {v!r} (limit {lim!r})" for n, v, lim in rows]
    return line, lines


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t0: float, **kind_args) -> dict:
    """Set up, run and check one cell on ``device``; -> the result line's
    object (its check lines already on stderr). ``kind_args`` go to the
    traffic kind's ``run``."""
    base = os.environ.get("TMPDIR") or None
    with tempfile.TemporaryDirectory(prefix="portbench-", dir=base) as tmp:
        run = Run(cell, seed, seconds, trace, device, tmp, t0)
        outcome = cell.traffic().run(run, **kind_args)
    if outcome.setup_s is None:
        outcome.setup_s = run.window_start - t0
    line, lines = result(cell, outcome, trace)
    for text in lines:
        print(text, file=sys.stderr)
    return line


def main(argv, t0: float) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        cell = Cell(args.workload)
        devices(cell.chips)
        check_program()
        line = execute(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", t0)
        found = banned_modules()
        if found:
            raise Failure(f"modules loaded that the port must not use: "
                          f"{found}")
    except Failure as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0
