#!/usr/bin/env python3
"""Time the .acs stream encoder's one-deep pipeline against a synchronous
copy of each chunk, on one NVIDIA GPU.

    python3 stream_ablation.py

Encodes chip_smoke.py's phase-18 stream (BASELINE.md configuration 5: 48
kHz stereo, N=1024, 64 Bark bands, chunks of 256 blocks, configuration (r))
with ``encode_stream`` two ways: as it is ("pipeline": chunk k+1's device
step is queued before chunk k's pinned, non-blocking copy is waited for and
Rice-packed) and with each chunk's payload copied by ``.cpu()`` as soon as
its step is queued ("synchronous": the card's step and the host's pack in
series). Two rounds of pipeline, synchronous, synchronous, pipeline
follow a warm-up, and every file must equal the first byte for byte.
Prints the card's name and power limit, each run's seconds and audio-s/s,
and as the last line a JSON object of them. Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
ROUNDS = 2


def synchronous_to_host(tensors):
    """``stream_container._to_host`` without the overlap: every CUDA tensor
    copied to the host at once, no event to wait for."""
    return [t.cpu() if hasattr(t, "is_cuda") and t.is_cuda else t
            for t in tensors], None


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("stream_ablation: no CUDA device", file=sys.stderr)
        return 1
    from audiocodec_tpu_torch.io import stream_container as sc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    codec = cs.stream_codec(torch, "cuda", "r")
    x = cs.stream_signal(torch, "cpu", cs.STREAM_SECONDS)
    audio_s = x.shape[1] / cs.STREAM_SR
    pipelined = sc._to_host
    variants = {"pipeline": pipelined, "synchronous": synchronous_to_host}
    work = ROOT / "build" / "stream_ablation"
    work.mkdir(parents=True, exist_ok=True)
    runs = []
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        first = None
        warm = str(Path(tmp) / "warm.acs")
        sc.encode_stream(codec, x[:, :2 * cs.STREAM_CB * cs.FILTERS_N], warm,
                         chunk_blocks=cs.STREAM_CB)
        order = ["pipeline", "synchronous", "synchronous", "pipeline"]
        for name in order * ROUNDS:
            path = Path(tmp) / f"{len(runs)}.acs"
            sc._to_host = variants[name]
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sc.encode_stream(codec, x, str(path),
                                 chunk_blocks=cs.STREAM_CB)
                torch.cuda.synchronize()
                s = time.perf_counter() - t0
            finally:
                sc._to_host = pipelined
            data = path.read_bytes()
            first = first or data
            cs.check(data == first, f"stream_ablation: {name} run "
                     f"{len(runs) + 1} wrote other bytes")
            runs.append(dict(variant=name, seconds=s,
                             audio_s_per_s=audio_s / s))
            print(f"run {len(runs)} ({name}): {audio_s:.1f} s of stereo "
                  f"encoded in {s:.3f} s = {audio_s / s:.1f} audio-s/s "
                  f"[{smi}]")
    summary = {}
    for name in variants:
        rates = [r["audio_s_per_s"] for r in runs if r["variant"] == name]
        summary[name] = dict(audio_s_per_s=rates,
                             mean=sum(rates) / len(rates))
    ratio = summary["pipeline"]["mean"] / summary["synchronous"]["mean"]
    print(f"pipeline / synchronous encode audio-s/s: {ratio:.4f} [{smi}]")
    print(json.dumps({"card": smi, "audio_seconds": audio_s, "runs": runs,
                      "summary": summary, "ratio": ratio}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.PhaseError as e:
        print(f"stream_ablation: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
