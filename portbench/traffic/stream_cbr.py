"""Traffic kind ``stream_cbr``: long streams into constant-bitrate ``.acs``
files with forward error correction, as a broadcast feed over a transport
runs them (``encode --kbps <k> --cbr --fec <s>``).

``io.stream_container.encode_stream_cbr`` of whole streams of the
configuration's ``stream_seconds``, one after another in a closed loop,
each from a [1, samples, 2] float32 tensor in host memory padded to whole
chunks (``orig_samples`` set), at the configuration's target, tolerance,
trials a round, dead zone, FEC scale and reservoir. Each stream is
``audio.music`` with its louder channel first (the same per-channel gains
for every seed), times a gain envelope that steps every ``step_s`` seconds
through ``envelope_db`` with ``ramp_ms`` linear ramps, the same for every
seed: a scale that suits one segment misses the others by far, so the
search has work in every chunk. Parameters besides: ``ring``, ``keep``,
``chunks`` as ``traffic/stream.py``.

Checks. Every stream of the window: ``rate``, the worst |file kbps -
target| / target (the file's bytes over the padded stream's seconds, as
the encoder reckons its tolerance), and ``chunk_rate``, the worst body
chunk's |wire bits - share| / share, where share is the target's bits a
chunk less the stream header's 350 B spread over the body chunks (the
framing as ``encode_stream_cbr`` reckons it). Each kept file, read by the
reference's own reader (``reference/cbr.py``): ``bad`` counts files that
do not parse or frame as configured (header, CRCs, index, trailer, scales
in (0, 2^32), blocks, ``nsamp``, the flush chunk at the last body chunk's
scale, the FEC chain); on the sampled chunks and the flush chunk, ``err``
is the error energy of their dequantized frames over the reference's
encode at their wire scales; ``fec_err`` the same of the copies their
successors carry against the reference's coarse copy.
"""

from __future__ import annotations

import math
import os
import statistics
import tempfile
import time

import torch

from portbench.lib import audio, harness, program
from portbench.reference import cbr as _cbr
from portbench.reference.codec import Err
from portbench.traffic import stream as _stream

sizes = _stream.sizes
chosen_chunks = _stream.chosen_chunks
HEADER_BYTES = 350  # the stream header, as encode_stream_cbr reckons it


def envelope(samples: int, sample_rate: int, p: dict, device):
    """[samples] float64 gains: ``envelope_db`` in turn, a level every
    ``step_s`` seconds, each step a linear ramp of ``ramp_ms`` from the
    level before."""
    levels = [10.0 ** (db / 20.0) for db in p["envelope_db"]]
    t = torch.arange(samples, device=device, dtype=torch.float64) / (
        sample_rate)
    seg = torch.div(t, p["step_s"], rounding_mode="floor").long()
    table = torch.tensor(levels, dtype=torch.float64, device=device)
    here = table[seg % len(levels)]
    before = table[(seg - 1) % len(levels)]
    ramp = torch.clamp((t - seg * p["step_s"]) / (p["ramp_ms"] * 1e-3),
                       max=1.0)
    return torch.where(seg > 0, before + (here - before) * ramp, here)


def signal(run, j: int) -> torch.Tensor:
    """Stream j of the ring, [1, samples, C] float32 on the run's device."""
    cfg = run.config
    samples = sizes(cfg)[0]
    sr, ch = cfg["sample_rate"], cfg["channels"]
    seed = harness.sub_seed(run.seed, "stream", j)
    x = audio.music(seed, 1, samples, ch, sr, run.device, torch.float64)
    # audio.music's gains in dB, drawn first from the same generator: the
    # louder channel first, so each channel has the same gain every seed
    gains = audio.gains_db(audio.generator(seed, run.device), ch, run.device)
    x = x[..., torch.argsort(gains, descending=True)]
    env = envelope(samples, sr, run.params, run.device)
    return (x * env[None, :, None]).to(torch.float32)


def inputs(run):
    samples, padded, _ = sizes(run.config)
    return [torch.nn.functional.pad(
        signal(run, j).permute(0, 2, 1), (0, padded - samples)).permute(
            0, 2, 1).contiguous().cpu() for j in range(run.params["ring"])]


def keywords(cfg) -> dict:
    """``encode_stream_cbr``'s keywords of the configuration."""
    return dict(chunk_blocks=cfg["chunk_blocks"],
                target_kbps=float(cfg["target_kbps"]),
                tolerance=float(cfg["tolerance"]),
                trials_per_round=int(cfg["trials_per_round"]),
                deadzone=cfg["deadzone"], fec=float(cfg["fec"]),
                reservoir_kbits=float(cfg["reservoir_kbits"]))


def rates(cfg, path) -> tuple:
    """(|file kbps - target| / target, the worst body chunk's |wire bits -
    share| / share) of a written stream."""
    samples, padded, chunk = sizes(cfg)
    body = padded // chunk
    target = float(cfg["target_kbps"])
    kbps = os.path.getsize(path) * 8 / (padded / cfg["sample_rate"]) / 1e3
    share = (target * 1e3 * chunk / cfg["sample_rate"]
             - HEADER_BYTES * 8 / body)
    bits = _cbr.wire_bits(path)[:body]
    return (abs(kbps - target) / target,
            max(abs(b - share) / share for b in bits))


def counts(rate):
    """The rate layer's counters, or None in a program without them."""
    return rate.counts() if hasattr(rate, "counts") else None


def run(run):
    from audiocodec_tpu_torch import rate
    from audiocodec_tpu_torch.io.stream_container import encode_stream_cbr

    cfg, p = run.config, run.params
    samples, padded, chunk = sizes(cfg)
    seconds = samples / cfg["sample_rate"]
    ring = inputs(run)
    codec = program.codec(cfg, run.device)
    kw = keywords(cfg)
    # one whole stream: every shape, the allocator's growth and the step's
    # graph capture
    encode_stream_cbr(codec, ring[0], os.path.join(run.scratch, "warm.acs"),
                      orig_samples=samples, **kw)
    path = os.path.join(run.scratch, "stream.acs")
    keep = harness.Reservoir(p["keep"], harness.sub_seed(run.seed, "keep"))
    streams = failed = 0
    worst_rate = worst_chunk = 0.0
    walls, per_stream = [], []
    before = counts(rate)
    with run.window() as w:
        while not w.done():
            j = streams % len(ring)
            c0 = counts(rate)
            t = time.perf_counter()
            n_chunks, _, _ = encode_stream_cbr(codec, ring[j], path,
                                               orig_samples=samples, **kw)
            walls.append(time.perf_counter() - t)
            streams += 1
            if n_chunks != padded // chunk + 1:
                failed += 1
            try:
                r, rc = rates(cfg, path)
            except ValueError as e:
                run.log(f"stream {streams}: {e}")
                r = rc = math.inf
            worst_rate, worst_chunk = max(worst_rate, r), max(worst_chunk,
                                                              rc)
            if c0 is not None:
                c1 = counts(rate)
                per_stream.append({k: c1[k] - c0[k] for k in c1})
            slot = keep.offer(j)
            if slot is not None:
                os.replace(path, os.path.join(run.scratch, f"keep{slot}.acs"))
    after = counts(rate)
    memory = run.memory_peak()
    del codec
    run.log(f"{streams} streams, seconds a stream "
            f"{[round(v, 3) for v in walls]}, median "
            f"{statistics.median(walls):.3f}")
    for name in ("passes", "searches", "rounds", "packs", "unconverged"):
        if per_stream:
            run.log(f"{name} a stream {[s[name] for s in per_stream]}")
    kept = [(j, os.path.join(run.scratch, f"keep{slot}.acs"))
            for slot, (_, j) in enumerate(keep.items)]
    bad, err, fec_err = check(run, ring, kept)
    return harness.Outcome(
        attempted=streams, failed=failed,
        end_to_end={"audio_s_per_s": streams * seconds / w.seconds},
        checks=[("bad", bad), ("err", err), ("fec_err", fec_err),
                ("rate", worst_rate), ("chunk_rate", worst_chunk)],
        summary=w.summary, ops=streams,
        counters={"before": before, "after": after, "streams": streams},
        memory_peak=memory, device=harness.device_info(run.device))


def check(run, ring, kept):
    """(files that do not parse or frame as configured, the checked
    chunks' error energy over the reference's, their FEC copies' error
    energy over the reference's coarse copies)."""
    cfg = run.config
    samples, padded, chunk = sizes(cfg)
    body = padded // chunk
    kb = cfg["chunk_blocks"]
    ref = _cbr.Cbr(cfg, run.device)
    bad, err, fec_err = 0, Err(), Err()
    for k, (j, path) in enumerate(kept):
        try:
            s = _cbr.CbrStream(path, cfg)
            blocks, scales = s.blocks(), s.scales()
            if blocks != [kb] * body + [1] or s.meta.get("nsamp") != samples:
                raise ValueError(f"chunk blocks or nsamp: {s.meta}")
            if scales[-1] != scales[-2]:
                raise ValueError("the flush chunk's scale is not the last "
                                 "body chunk's")
            s.check_chain(float(cfg["fec"]))
            for c in chosen_chunks(run, k, body):
                codes, levels, scale = s.chunk(c)
                _, _, expect = ref.encode(ring[j], c * kb, blocks[c], scale)
                err.add(ref.dequantize(codes, levels, scale), expect)
                if c < body:  # the flush chunk has no successor
                    m = s.member(c + 1)
                    _, _, expect = ref.coarse(ring[j], c * kb, blocks[c],
                                              scale * float(cfg["fec"]))
                    fec_err.add(ref.dequantize_member(m), expect)
        except ValueError as e:
            run.log(f"stream {path}: {e}")
            bad += 1
    return bad, err.value, fec_err.value


def control(run, ref) -> float:
    """The check's ``err`` with ``ref``'s precision (the plain reference in
    float32 with TF32 products) in the program's place, on the chunks a
    run would check, at the wire scales the program's encode of each kept
    stream chose; its ``fec_err`` goes to the log."""
    from audiocodec_tpu_torch.io.stream_container import encode_stream_cbr

    cfg = run.config
    samples, padded, chunk = sizes(cfg)
    body = padded // chunk
    kb = cfg["chunk_blocks"]
    exact = _cbr.Cbr(cfg, run.device)
    low = _cbr.Cbr(cfg, ref.device, ref.dtype, tf32=ref.tf32)
    ring = inputs(run)
    codec = program.codec(cfg, run.device)
    err, fec_err = Err(), Err()
    for k in range(run.params["keep"]):
        x = ring[k % len(ring)]
        with tempfile.TemporaryDirectory() as tmp:
            _, scales, _ = encode_stream_cbr(
                codec, x, os.path.join(tmp, "control.acs"),
                orig_samples=samples, **keywords(cfg))
        scales = list(scales) + [scales[-1]]  # the flush reuses the last
        for c in chosen_chunks(run, k, body):
            count = kb if c < body else 1
            codes, levels, _ = low.encode(x, c * kb, count, scales[c])
            _, _, want = exact.encode(x, c * kb, count, scales[c])
            err.add(exact.dequantize(codes.cpu(), levels.cpu(), scales[c]),
                    want)
            if c < body:
                fec = scales[c] * float(cfg["fec"])
                codes, levels, _ = low.coarse(x, c * kb, count, fec)
                _, _, want = exact.coarse(x, c * kb, count, fec)
                fec_err.add(exact.dequantize_coarse(
                    codes.cpu(), levels.cpu(), fec), want)
    run.log(f"control fec_err {fec_err.value!r}")
    return err.value
