"""The knee of a ``serve_open`` cell: offered rates against completions.

    python3 portbench/sweep.py --workload mono44k.serve_open \
        --seconds 15 --rates 100 150 200 250 300

One server for all rates (as the cell starts it), each rate's open loop
in turn. Prints a JSON line a rate: offered and completed rate, the p50
and p95 latency, and how much later the last fifth of the requests ran
than the first fifth (a backlog that grows through the window). The knee
is the highest rate that keeps up with no growing backlog; the cell runs
at 0.8 of it, written into its workload file as a number (README.md).
Runs on the card only.
"""

import json
import math
import statistics
import sys
import time
from pathlib import Path

T0 = time.perf_counter()


def main(argv) -> int:
    import argparse

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench.lib import audio, harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = harness.Cell(args.workload)
    harness.devices(cell.chips)
    kind = cell.traffic()
    run = harness.Run(cell, args.seed, args.seconds, False, "cuda", "", T0)
    lengths, _ = kind.plan(run)
    pcm = kind.clips(run, lengths)
    payloads = [audio.wav_bytes(c, cell.config["sample_rate"]) for c in pcm]
    server = kind.ChildServer(run)
    try:
        socks = kind.connect(server.port, run.params["connections"])
        for rate in args.rates:
            run.params["rate"] = rate
            _, schedule = kind.plan(run)
            start, lat, late, _ = kind.drive(socks, payloads, schedule, ())
            done = [x for x in lat if math.isfinite(x)]
            end = max(due + x for (due, _), x in zip(schedule, lat)
                      if math.isfinite(x))
            fifth = max(1, len(lat) // 5)
            row = {
                "rate": rate, "requests": len(lat),
                "completed_per_s": len(done) / end,
                "p50_ms": 1e3 * statistics.median(done),
                "p95_ms": 1e3 * kind.p95(lat),
                "first_fifth_p50_ms": 1e3 * statistics.median(lat[:fifth]),
                "last_fifth_p50_ms": 1e3 * statistics.median(lat[-fifth:]),
                "late_p95_ms": 1e3 * kind.p95(late),
                "failed": len(lat) - len(done),
            }
            print(json.dumps(row), flush=True)
        for s in socks:
            s.close()
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
