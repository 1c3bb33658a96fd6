"""Music-like test audio made from a seed, on any device.

Each channel of each clip is two voices of harmonic notes (a lead in
160-1000 Hz, a bass in 55-220 Hz). A voice changes note every 0.25-1 s;
a note has six harmonics at 1/h amplitudes scaled by a random factor, a
10 ms attack and an exponential decay of 1-6 per second. White noise about
30 dB below the voices' level and a gain on a peak bound of 0.9 complete
it. The gains are spread evenly over -12..0 dB across the channels of the
call, in an order drawn from the seed: every seed gets the same set of
gains, so a seed changes which channel is loud but not how much there is
to code. The Rice packs' cost depends on how the codes are
distributed, so the signal is built to quantize like music (sparse tonal
spectra over a noise floor), not like two tones over white noise.
"""

from __future__ import annotations

import math
import struct

import torch

HARMONICS = 6
VOICES = ((160.0, 1000.0, 1.0), (55.0, 220.0, 0.5))  # (low Hz, high Hz, gain)
NOISE_DB = -30.0
SPAN = 1 << 18  # samples synthesised at a time


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device,
                                       dtype=torch.float64)


def gains_db(g, rows: int, device) -> torch.Tensor:
    """[rows] gains in dB, evenly spread over -12..0: the same set for
    every seed, in an order drawn from ``g``."""
    order = torch.randperm(rows, generator=g, device=device).to(
        torch.float64)
    return -12.0 + 12.0 * (order + 0.5) / rows


def music(seed: int, clips: int, samples: int, channels: int,
          sample_rate: int, device, dtype=torch.float32) -> torch.Tensor:
    """[clips, samples, channels] in [-0.9, 0.9], the same for the same
    seed, sizes and device."""
    device = torch.device(device)
    g = generator(seed, device)
    rows = clips * channels
    notes = int(math.ceil(samples / (0.25 * sample_rate))) + 1
    out = torch.empty(rows, samples, dtype=dtype, device=device)
    peak = sum(v[2] for v in VOICES) * sum(1.0 / h for h in
                                           range(1, HARMONICS + 1))
    gain = 0.9 / peak * 10.0 ** (gains_db(g, rows, device)[:, None] / 20.0)
    hs = torch.arange(1, HARMONICS + 1, device=device, dtype=torch.float64)
    params = []
    for lo_hz, hi_hz, vgain in VOICES:
        dur = _uniform(g, (rows, notes), 0.25, 1.0, device) * sample_rate
        ends = torch.cumsum(dur, dim=1)
        f0 = torch.exp(_uniform(g, (rows, notes), math.log(lo_hz),
                                math.log(hi_hz), device))
        amp = _uniform(g, (rows, notes, HARMONICS), 0.3, 1.0, device) / hs
        # harmonics above 0.45 of the rate are left out
        amp = amp * (f0[..., None] * hs < 0.45 * sample_rate) * vgain
        decay = _uniform(g, (rows, notes), 1.0, 6.0, device)
        params.append((ends, ends - dur, f0, amp, decay))
    noise_amp = 10.0 ** (NOISE_DB / 20.0) * math.sqrt(0.5) * 0.5
    for start in range(0, samples, SPAN):
        t = torch.arange(start, min(start + SPAN, samples), device=device,
                         dtype=torch.float64)
        acc = torch.zeros(rows, t.numel(), dtype=torch.float64,
                          device=device)
        for ends, begins, f0, amp, decay in params:
            idx = torch.searchsorted(ends, t.expand(rows, -1).contiguous(),
                                     right=True).clamp_max(notes - 1)
            tau = (t - torch.gather(begins, 1, idx)) / sample_rate
            env = torch.clamp(tau / 0.01, max=1.0) * torch.exp(
                -torch.gather(decay, 1, idx) * tau)
            phase = 2.0 * math.pi * torch.gather(f0, 1, idx) * tau
            a = amp[torch.arange(rows, device=device)[:, None], idx]
            acc += env * (a * torch.sin(phase[..., None] * hs)).sum(-1)
        acc += noise_amp * torch.randn(acc.shape, generator=g, device=device,
                                       dtype=torch.float64)
        out[:, start:start + t.numel()] = (acc * gain).clamp(-0.9, 0.9)
    return out.reshape(clips, channels, samples).permute(0, 2, 1).contiguous()


def pcm16(x: torch.Tensor) -> torch.Tensor:
    """Float samples in [-1, 1) -> int16, as a 16-bit WAV holds them."""
    return torch.clamp(torch.round(x * 32768.0), -32768, 32767).to(
        torch.int16)


def wav_bytes(samples, sample_rate: int) -> bytes:
    """A PCM16 WAV of int16 ``samples`` [S, C] (numpy)."""
    data = samples.astype("<i2").tobytes()
    ch = samples.shape[1]
    return (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, ch, sample_rate,
                          sample_rate * 2 * ch, 2 * ch, 16)
            + b"data" + struct.pack("<I", len(data)) + data)
