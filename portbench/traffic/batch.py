"""Traffic kind ``batch``: the library path of neural pipelines.

``Codec.round_trip_quantized`` on batches already on the device, issued
back to back from a ring of seeded batches. Parameters: ``clips`` and
``samples`` (a batch is [clips, samples, channels]), ``ring`` (distinct
batches), ``keep`` (calls whose outputs are checked, drawn from the seed).
"""

from __future__ import annotations

import torch

from portbench.lib import audio, harness, program
from portbench.reference.codec import Err, Reference


def inputs(run):
    cfg, p = run.config, run.params
    return [audio.music(harness.sub_seed(run.seed, "batch", j), p["clips"],
                        p["samples"], cfg["channels"], cfg["sample_rate"],
                        run.device)
            for j in range(p["ring"])]


def run(run):
    cfg, p = run.config, run.params
    ring = inputs(run)
    codec = program.codec(cfg, run.device)
    with torch.no_grad():
        for x in ring:  # every input, so no first touch lands in the window
            codec.round_trip_quantized(x)
        keep = harness.Reservoir(p["keep"], harness.sub_seed(run.seed, "keep"))
        calls = 0
        with run.window() as w:
            while not w.done():
                keep.offer(codec.round_trip_quantized(ring[calls % len(ring)]))
                calls += 1
    memory = run.memory_peak()
    del codec
    clip_s = p["samples"] / cfg["sample_rate"]
    rate = calls * p["clips"] * clip_s / w.seconds
    return harness.Outcome(
        attempted=calls, failed=0, end_to_end={"audio_s_per_s": rate},
        checks=[("err", check(run, ring, keep.items))], summary=w.summary,
        ops=calls, memory_peak=memory, device=harness.device_info(run.device))


def check(run, ring, kept) -> float:
    """The kept calls' error energy over the reference's."""
    ref = Reference(run.config, run.device)
    expect, err = {}, Err()
    for i, out in kept:
        slot = i % len(ring)
        if slot not in expect:
            expect[slot] = ref.round_trip(ring[slot])
        try:
            err.add(out, expect[slot])
        except ValueError as e:
            run.log(f"call {i}: {e}")
            return float("inf")
    return err.value


def control(run, ref) -> float:
    """The check's number with ``ref`` (the reference at a lower
    precision) in the program's place."""
    ring = inputs(run)
    kept = [(j, ref.round_trip(x)) for j, x in enumerate(ring)]
    return check(run, ring, kept)

