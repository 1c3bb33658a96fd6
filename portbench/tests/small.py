"""The cells at sizes a CPU test run holds, and an in-process server for
the serve kind (so that a test can break the program underneath it)."""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.lib import harness, program  # noqa: E402

SIZES = {
    "mono44k.batch32x10s": ({}, dict(clips=2, samples=1024 * 24, ring=2,
                                     keep=3)),
    "stereo48k.stream600s": (dict(chunk_blocks=8,
                                  stream_seconds=8 * 1024 * 3.5 / 48000),
                             dict(ring=2, keep=2, chunks=2)),
    "mono44k.serve_open": ({}, dict(rate=16.0, connections=4, pool=6,
                                    warm_rounds=1, check=8, median_s=0.5,
                                    min_s=0.1, max_s=1.0)),
    "mono44k.corpus1000x10s": ({}, dict(
        clips=6, clip_samples=22050, batch=3, check=3,
        args=["--clip-seconds", "0.5", "--batch", "4"])),
}


def cell(name: str) -> harness.Cell:
    c = harness.Cell(name)
    config, params = SIZES[name]
    c.config.update(config)
    c.workload["params"].update(params)
    return c


class InProcessServer:
    """The serve kind's server in this process, on the CPU."""

    def __init__(self, run):
        from audiocodec_tpu_torch import serve

        codec = program.codec(run.config, run.device)
        self.server = serve.CodecServer(codec,
                                        run.config["sample_rate"]).start()
        self.port = self.server.port
        self.device = harness.device_info(run.device)

    def peak(self) -> int:
        return 0

    def stop(self) -> None:
        self.server.stop()


def execute(name: str, seed: int = 2**31 + 11, seconds: float = 0.6,
            trace: bool = False) -> dict:
    """One run of the cell on the CPU -> its result line's object."""
    extra = ({"server_factory": InProcessServer}
             if name == "mono44k.serve_open" else {})
    return harness.execute(cell(name), seed, seconds, trace, "cpu",
                           time.perf_counter(), **extra)
