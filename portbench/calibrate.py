"""Readings that set a cell's limits: the control's number on seeds.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3

For each seed, the number a run compares (``err``) with the plain
reference in float32 in the program's place, once with TF32 products (the
control: the nearest precision below the configuration's float32, which
has to come out as not correct) and once without (the configuration's own
precision). The program's own readings are those of ``run.py``'s runs.
Runs on the card only.
"""

import json
import sys
import time
from pathlib import Path

T0 = time.perf_counter()


def main(argv) -> int:
    import argparse

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import torch

    from portbench.lib import harness
    from portbench.reference.codec import Reference

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = harness.Cell(args.workload)
    harness.devices(cell.chips)
    kind = cell.traffic()
    seconds = harness.load_json(harness.ROOT / "BENCHMARK.json")[
        "run_seconds"]
    for seed in args.seeds:
        row = {"workload": cell.name, "seed": seed}
        for label, tf32 in (("control_tf32", True), ("float32", False)):
            run = harness.Run(cell, seed, seconds, False, "cuda", "", T0)
            ref = Reference(cell.config, "cuda", torch.float32, tf32=tf32)
            t = time.perf_counter()
            row[label] = kind.control(run, ref)
            row[label + "_s"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
