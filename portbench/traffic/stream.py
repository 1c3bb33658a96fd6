"""Traffic kind ``stream``: long streams into ``.acs``.

``io.stream_container.encode_stream`` of whole streams of the
configuration's ``stream_seconds``, one after another, each from a
[1, samples, channels] float32 tensor in host memory, padded to whole
chunks of ``chunk_blocks`` blocks as the command line pads it, written to
a file in the run's scratch directory. Parameters: ``ring`` (distinct
streams), ``keep`` (streams whose files are checked, drawn from the seed),
``chunks`` (body chunks checked a kept stream, drawn from the seed; the
flush chunk of each is checked too).
"""

from __future__ import annotations

import os
import random

import torch

from portbench.lib import audio, harness, program
from portbench.reference import containers
from portbench.reference.codec import Err, Reference


def sizes(config):
    """(samples of audio, padded samples, samples a chunk)."""
    chunk = config["chunk_blocks"] * config["filters_n"]
    samples = int(round(config["stream_seconds"] * config["sample_rate"]))
    return samples, -(-samples // chunk) * chunk, chunk


def inputs(run):
    cfg = run.config
    samples, padded, _ = sizes(cfg)
    out = []
    for j in range(run.params["ring"]):
        x = audio.music(harness.sub_seed(run.seed, "stream", j), 1, samples,
                        cfg["channels"], cfg["sample_rate"], run.device)
        out.append(torch.nn.functional.pad(
            x.permute(0, 2, 1), (0, padded - samples)).permute(0, 2, 1)
            .contiguous().cpu())
    return out


def run(run):
    from audiocodec_tpu_torch.io.stream_container import encode_stream

    cfg, p = run.config, run.params
    samples, padded, chunk = sizes(cfg)
    ring = inputs(run)
    codec = program.codec(cfg, run.device)
    kb = cfg["chunk_blocks"]
    # every shape of a stream: two body chunks and the flush frame
    encode_stream(codec, ring[0][:, :2 * chunk],
                  os.path.join(run.scratch, "warm.acs"), chunk_blocks=kb,
                  orig_samples=2 * chunk)
    path = os.path.join(run.scratch, "stream.acs")
    keep = harness.Reservoir(p["keep"], harness.sub_seed(run.seed, "keep"))
    streams = failed = 0
    with run.window() as w:
        while not w.done():
            j = streams % len(ring)
            n_chunks = encode_stream(codec, ring[j], path, chunk_blocks=kb,
                                     orig_samples=samples)
            streams += 1
            if n_chunks != padded // chunk + 1:
                failed += 1
            slot = keep.offer(j)
            if slot is not None:
                os.replace(path, os.path.join(run.scratch, f"keep{slot}.acs"))
    memory = run.memory_peak()
    del codec
    kept = [(j, os.path.join(run.scratch, f"keep{slot}.acs"))
            for slot, (_, j) in enumerate(keep.items)]
    bad, err = check(run, ring, kept)
    rate = streams * samples / cfg["sample_rate"] / w.seconds
    return harness.Outcome(
        attempted=streams, failed=failed,
        end_to_end={"audio_s_per_s": rate},
        checks=[("bad", bad), ("err", err)], summary=w.summary, ops=streams,
        memory_peak=memory, device=harness.device_info(run.device))


def chosen_chunks(run, stream: int, body: int) -> list:
    rng = random.Random(harness.sub_seed(run.seed, "chunks", stream))
    return sorted(rng.sample(range(body), min(run.params["chunks"], body))
                  ) + [body]


def check(run, ring, kept):
    """(streams whose file does not parse or frame as the configuration
    says, the checked chunks' error energy of their dequantized frames over
    the reference's)."""
    cfg = run.config
    samples, padded, chunk = sizes(cfg)
    body = padded // chunk
    ref = Reference(cfg, run.device)
    bad, err = 0, Err()
    for k, (j, path) in enumerate(kept):
        try:
            s = containers.Stream(path, cfg)
            blocks = s.blocks()
            if blocks != [cfg["chunk_blocks"]] * body + [1] or s.meta.get(
                    "nsamp") != samples:
                raise ValueError(f"chunk blocks or nsamp: {s.meta}")
            for c in chosen_chunks(run, k, body):
                codes, levels = s.chunk(c)
                frames = ref.frames(ring[j], c * cfg["chunk_blocks"],
                                    blocks[c])
                _, _, expect = ref.encode(frames)
                err.add(ref.dequantize(codes[None], levels[None]), expect)
        except ValueError as e:
            run.log(f"stream {path}: {e}")
            bad += 1
    return bad, err.value


def control(run, ref) -> float:
    """The check's error with ``ref`` (the reference at a lower precision)
    in the program's place, on the chunks a run would check."""
    cfg = run.config
    samples, padded, chunk = sizes(cfg)
    body = padded // chunk
    exact = Reference(cfg, run.device)
    ring = inputs(run)
    err = Err()
    for k in range(run.params["keep"]):
        x = ring[k % len(ring)]
        for c in chosen_chunks(run, k, body):
            count = cfg["chunk_blocks"] if c < body else 1
            first = c * cfg["chunk_blocks"]
            codes, levels, _ = ref.encode(ref.frames(x, first, count))
            _, _, expect = exact.encode(exact.frames(x, first, count))
            err.add(exact.dequantize(codes.cpu(), levels.cpu()), expect)
    return err.value
