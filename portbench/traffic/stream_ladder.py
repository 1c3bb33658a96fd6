"""Traffic kind ``stream_ladder``: long joint-stereo streams into ``.acs``
at the ``low`` preset (mid/side, dead zone, TNS, block switching, noise
fill, forward masking, bandwidth extension, intensity stereo).

``io.stream_container.encode_stream`` of whole streams of the
configuration's ``stream_seconds``, one after another, each from a
[1, samples, 2] float32 tensor in host memory padded to whole chunks, at
the configuration's fixed threshold scale, into a file in the run's scratch
directory. Each stream is a mix: ``sources`` music voices (``audio.music``)
panned across the image, loudest in the centre, and a percussion voice of
noise bursts (``hits`` a second drawn uniformly in its range, 1 ms attacks,
``decay_ms`` to -60 dB, ``percussion_db`` below the loudest voice's peak),
so that the channels are correlated as a mix is and block switching and
TNS fire on a share of frames. Every seed gets the same gains and pans.
Parameters besides: ``ring``, ``keep``, ``chunks`` as ``traffic/stream.py``.

The check reads each kept file with the ladder's own reader; ``bad``
counts files that do not parse, frame or declare the configuration; on the
sampled chunks and the flush chunk, ``err`` is the error energy of the
spectra the file's members decode to (the reference's decoder, without the
noise draw) over the reference encode's own, ``side`` the share of
side-information entries that differ from the reference's.
"""

from __future__ import annotations

import inspect
import math
import os
import statistics
import time

import torch

from portbench.lib import audio, harness, program
from portbench.reference.codec import Err
from portbench.reference.ladder import Ladder, LadderStream, differ
from portbench.traffic import stream as _stream

sizes = _stream.sizes
chosen_chunks = _stream.chosen_chunks


def pans(sources: int) -> list:
    """Constant-power pan positions in [0, 1] by loudness rank: the loudest
    source in the centre, the others spread to alternate sides."""
    out = [0.5]
    for r in range(1, sources):
        side = 0.5 + 0.4 * math.ceil(r / 2) / math.ceil((sources - 1) / 2)
        out.append(side if r % 2 else 1.0 - side)
    return out


def percussion(seed: int, samples: int, sample_rate: int, p: dict, device):
    """[samples] noise bursts: hit times with gaps uniform in 1/hits, each
    a 1 ms linear attack and an exponential decay to -60 dB in its decay
    time, peak 1 before the noise."""
    g = audio.generator(seed, device)
    lo, hi = p["hits"]
    n_hits = int(samples / sample_rate * hi) + 2
    gaps = 1.0 / (lo + (hi - lo) * torch.rand(n_hits, generator=g,
                                              device=device,
                                              dtype=torch.float64))
    starts = torch.cumsum(gaps, 0) * sample_rate
    d_lo, d_hi = p["decay_ms"]
    decay = (d_lo + (d_hi - d_lo) * torch.rand(
        n_hits, generator=g, device=device, dtype=torch.float64)) * 1e-3
    out = torch.empty(samples, dtype=torch.float64, device=device)
    for start in range(0, samples, audio.SPAN):
        t = torch.arange(start, min(start + audio.SPAN, samples),
                         device=device, dtype=torch.float64)
        i = (torch.searchsorted(starts, t, right=True) - 1).clamp_min(0)
        tau = (t - starts[i]) / sample_rate
        env = torch.clamp(tau / 1e-3, max=1.0) * torch.exp(
            -math.log(1000.0) * tau / decay[i])
        env = torch.where(tau >= 0, env, 0.0)
        out[start:start + t.numel()] = env * torch.randn(
            t.numel(), generator=g, device=device, dtype=torch.float64)
    return out / 3.0  # the noise's peaks near the envelope's


def mix(run, j: int) -> torch.Tensor:
    """Stream j of the ring, [1, samples, 2] float32 on the run's device."""
    cfg, p = run.config, run.params
    samples = sizes(cfg)[0]
    sr = cfg["sample_rate"]
    seed = harness.sub_seed(run.seed, "stream", j)
    k = p["sources"]
    voices = audio.music(seed, 1, samples, k, sr, run.device,
                         torch.float64)[0]  # [S, k]
    # audio.music's gains in dB, drawn first from the same generator
    gains = audio.gains_db(audio.generator(seed, run.device), k, run.device)
    rank = torch.argsort(gains, descending=True).tolist()
    angle = torch.zeros(k, dtype=torch.float64, device=run.device)
    for r, src in enumerate(rank):
        angle[src] = pans(k)[r] * math.pi / 2
    left = voices @ torch.cos(angle)
    right = voices @ torch.sin(angle)
    # audio.music scales each source to a peak bound of 0.9 at its gain
    peak = 0.9 * 10.0 ** (float(gains.max()) / 20.0)
    hit = peak * 10.0 ** (-p["percussion_db"] / 20.0) * percussion(
        harness.sub_seed(run.seed, "percussion", j), samples, sr, p,
        run.device)
    x = torch.stack([left + hit, right + hit], -1).clamp(-0.9, 0.9)
    return x[None].to(torch.float32)


def inputs(run):
    samples, padded, _ = sizes(run.config)
    return [torch.nn.functional.pad(
        mix(run, j).permute(0, 2, 1), (0, padded - samples)).permute(
            0, 2, 1).contiguous().cpu() for j in range(run.params["ring"])]


def features(cfg) -> dict:
    """``encode_stream``'s keywords of the configuration."""
    return dict(ms=cfg["ms"], deadzone=cfg["deadzone"], tns=cfg["tns"],
                bs=cfg["bs"], nf=cfg["nf"], nf_seed=cfg["nf_seed"],
                tmask=cfg["tmask"], bwe=cfg["bwe"],
                intensity=cfg["intensity"],
                threshold_scale=cfg["threshold_scale"])


def run(run):
    from audiocodec_tpu_torch.io.stream_container import encode_stream

    cfg, p = run.config, run.params
    samples, padded, chunk = sizes(cfg)
    seconds = samples / cfg["sample_rate"]
    ring = inputs(run)
    codec = program.codec(cfg, run.device)
    kb = cfg["chunk_blocks"]
    kw = features(cfg)
    # a program whose writer keeps no counters runs without them
    counting = "counters" in inspect.signature(encode_stream).parameters
    # every shape of a stream: two body chunks (the second with the
    # forward-masking context) and the flush frame
    encode_stream(codec, ring[0][:, :2 * chunk],
                  os.path.join(run.scratch, "warm.acs"), chunk_blocks=kb,
                  orig_samples=2 * chunk, **kw)
    path = os.path.join(run.scratch, "stream.acs")
    keep = harness.Reservoir(p["keep"], harness.sub_seed(run.seed, "keep"))
    streams = failed = 0
    kbps, walls, totals = [], [], {}
    with run.window() as w:
        while not w.done():
            j = streams % len(ring)
            counts = {}
            t = time.perf_counter()
            n_chunks = encode_stream(
                codec, ring[j], path, chunk_blocks=kb, orig_samples=samples,
                **kw, **({"counters": counts} if counting else {}))
            walls.append(time.perf_counter() - t)
            streams += 1
            if n_chunks != padded // chunk + 1:
                failed += 1
            kbps.append(os.path.getsize(path) * 8 / seconds / 1e3)
            for name, v in counts.items():
                totals[name] = totals.get(name, 0) + v
            slot = keep.offer(j)
            if slot is not None:
                os.replace(path, os.path.join(run.scratch, f"keep{slot}.acs"))
    memory = run.memory_peak()
    del codec
    frames = totals.get("frames", 0)
    shares = {name: v / frames for name, v in totals.items()
              if name in ("short_frames", "tns_frames") and frames}
    run.log(f"{streams} streams, kbps {[round(v, 3) for v in kbps]}, "
            f"median {statistics.median(kbps):.3f}; seconds a stream "
            f"{[round(v, 3) for v in walls]}; writer counters {totals}; "
            f"shares of frames {shares}")
    kept = [(j, os.path.join(run.scratch, f"keep{slot}.acs"))
            for slot, (_, j) in enumerate(keep.items)]
    bad, err, side = check(run, ring, kept)
    rate = streams * seconds / w.seconds
    return harness.Outcome(
        attempted=streams, failed=failed,
        end_to_end={"audio_s_per_s": rate},
        checks=[("bad", bad), ("err", err), ("side", side)],
        summary=w.summary, ops=streams, counters=totals,
        memory_peak=memory, device=harness.device_info(run.device))


def check(run, ring, kept):
    """(files that do not parse, frame or declare the configuration, the
    decoded spectra's error energy over the reference's, the share of
    side-information entries that differ)."""
    cfg = run.config
    samples, padded, chunk = sizes(cfg)
    body = padded // chunk
    ref = Ladder(cfg, run.device)
    bad, err, diff, total = 0, Err(), 0, 0
    for k, (j, path) in enumerate(kept):
        try:
            s = LadderStream(path, cfg)
            blocks = s.blocks()
            if blocks != [cfg["chunk_blocks"]] * body + [1] or s.meta.get(
                    "nsamp") != samples:
                raise ValueError(f"chunk blocks or nsamp: {s.meta}")
            for c in chosen_chunks(run, k, body):
                got = s.chunk(c)
                want = ref.encode(ring[j], c * cfg["chunk_blocks"],
                                  blocks[c])
                err.add(ref.decode(got), ref.decode(want))
                d, n = differ(got, want)
                diff, total = diff + d, total + n
        except ValueError as e:
            run.log(f"stream {path}: {e}")
            bad += 1
    return bad, err.value, diff / total if total else 0.0


def control(run, ref) -> float:
    """The check's ``err`` with ``ref``'s precision (the plain reference
    in float32 with TF32 products) in the program's place, on the chunks a
    run would check; its ``side`` goes to the log."""
    cfg = run.config
    samples, padded, chunk = sizes(cfg)
    body = padded // chunk
    exact = Ladder(cfg, run.device)
    low = Ladder(cfg, ref.device, ref.dtype, tf32=ref.tf32)
    ring = inputs(run)
    err, diff, total = Err(), 0, 0
    for k in range(run.params["keep"]):
        x = ring[k % len(ring)]
        for c in chosen_chunks(run, k, body):
            count = cfg["chunk_blocks"] if c < body else 1
            first = c * cfg["chunk_blocks"]
            got = low.encode(x, first, count)
            want = exact.encode(x, first, count)
            err.add(exact.decode(got), exact.decode(want))
            d, n = differ(got, want)
            diff, total = diff + d, total + n
    run.log(f"control side {diff / total if total else 0.0!r}")
    return err.value
