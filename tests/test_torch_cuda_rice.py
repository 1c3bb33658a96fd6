"""The run-length Rice coder of ``ops/cuda_rice.py`` against the host coder,
``native.rrice_encode``: byte for byte.

The tests marked ``cuda`` need an NVIDIA GPU with nvcc: run ``python -m
pytest --noconftest -m cuda tests/test_torch_cuda_rice.py`` there. Without a
card they skip; the skip condition is a string, evaluated when each test is
set up and never while the module is imported. The others run on the CPU:
they hold ``bound``, the plain version, and ``_emulate``, a step-by-step
copy of ``csrc/rice_kernel.cu`` (its lanes, the zero runs across them, the
group scan, the edge words it zeroes, the staged words and which of them a
group stores or ORs), to the host coder's bytes.
"""

import math

import numpy as np
import pytest
import torch

from audiocodec_tpu_torch import Codec, native, serve
from audiocodec_tpu_torch.io import stream_container as sc
from audiocodec_tpu_torch.ops import cuda_rice
from audiocodec_tpu_torch.utils import graphs


def card(test):
    """Marks a test that needs the card."""
    test = pytest.mark.skipif("not torch.cuda.is_available()",
                              reason="needs an NVIDIA GPU")(test)
    return pytest.mark.cuda(test)


I32_MIN, I32_MAX = -2**31, 2**31 - 1


def _laplace(rng, scale, shape, zeros=0.0):
    v = np.round(rng.laplace(scale=scale, size=shape))
    v[rng.random(shape) < zeros] = 0
    return v.astype(np.int32)


def _case(name):
    """The codes of a case: int32, seeded."""
    rng = np.random.default_rng(sum(map(ord, name)))
    g = cuda_rice.GROUP
    if name.startswith("laplace"):
        return _laplace(rng, float(name[7:]), (9, g))
    if name == "zeros90":
        return _laplace(rng, 4.0, (9, g), zeros=0.9)
    if name == "zeros99.9":
        return _laplace(rng, 4.0, (40, g), zeros=0.999)
    if name == "all_zeros":
        return np.zeros((4, g), np.int32)
    if name == "ends_nonzero":  # every group ends on a nonzero after zeros
        v = _laplace(rng, 2.0, (6, g), zeros=0.95)
        v[:, -1] = rng.choice([-3, -1, 1, 5], 6)
        v[:, -9:-1] = 0
        return v
    if name == "ends_zeros":  # trailing runs of every length class
        v = _laplace(rng, 2.0, (6, g), zeros=0.5)
        for i, run in enumerate((1, 2, 7, 8, 9, 200)):
            v[i, -run:] = 0
        return v
    if name == "escapes":  # raw escapes in both modes, the int32 extremes
        v = _laplace(rng, 1.0, (6, g), zeros=0.6)
        v[0, ::7] = I32_MIN
        v[0, 3::7] = I32_MAX
        v[1] = rng.integers(I32_MIN, I32_MAX, g, endpoint=True)
        v[2, [5, 100, 255]] = [I32_MAX, I32_MIN, 1 << 20]
        v[3, :] = 0
        v[3, [0, 255]] = [I32_MIN, -(1 << 30)]
        v[4] = rng.integers(I32_MIN, I32_MAX, g, endpoint=True)
        v[4, -1] = 0  # plain mode's escapes, then a zero
        v[5, 17] = I32_MIN
        return v
    if name == "partial":  # the last group 77 values long
        return _laplace(rng, 3.0, (3 * g + 77,), zeros=0.7)
    if name == "short":  # shorter than one lane, one group, several lanes
        return _laplace(rng, 3.0, (5,), zeros=0.3)
    if name == "body":  # a body chunk of the stream cells
        return _laplace(rng, 1.5, (1, 256, 1024, 2), zeros=0.6)
    if name == "flush":  # the flush chunk
        return _laplace(rng, 1.5, (1, 1, 1024, 2), zeros=0.6)
    raise KeyError(name)


CASES = ("laplace0.5", "laplace1", "laplace4", "laplace64", "zeros90",
         "zeros99.9", "all_zeros", "ends_nonzero", "ends_zeros", "escapes",
         "partial", "short", "body", "flush")
# the body chunk's 2,048 groups take the emulation ~a minute; its groups'
# kinds are the other cases'
EMULATED = tuple(c for c in CASES if c != "body")


# -- a copy of csrc/rice_kernel.cu's steps ------------------------------------

LANES, PER_LANE, MAXQ, HEADER = 32, 8, 47, 5


def _zigzag(v):
    return ((v << 1) ^ (v >> 31)) & 0xFFFFFFFF


def _est(total, count, k):
    return count * (k + 1) + (total >> k)


def _best_k(total, count):
    costs = [_est(total, count, k) for k in range(16)]
    return costs.index(min(costs))


def _gamma_bits(x):
    return 2 * (x.bit_length() - 1) + 1


def _plan(u, length):
    """The kernel's ``plan`` for every lane of one group: (lanes, k, rle);
    a lane is (its values, run0, trail)."""
    lanes = [u[PER_LANE * i:PER_LANE * (i + 1)] for i in range(LANES)]
    tz, nonzero = [], []
    for vals in lanes:
        t = 0
        for x in vals:
            t = 0 if x else t + 1
        tz.append(t)
        nonzero.append(any(vals))
    out, plain_sum, nz_sum, run_cost, nz = [], 0, 0, 0, 0
    for i, vals in enumerate(lanes):
        before = [j for j in range(i) if nonzero[j]]  # the ballot
        r = (tz[before[-1]] + PER_LANE * (i - 1 - before[-1]) if before
             else PER_LANE * i)
        run0 = r
        for x in vals:
            plain_sum += x
            if x == 0:
                r += 1
                continue
            run_cost += _gamma_bits(r + 1)
            r = 0
            nz += 1
            nz_sum += x - 1
        last = bool(vals) and PER_LANE * i + len(vals) == length
        trail = r if last else 0
        if trail:
            run_cost += _gamma_bits(trail + 1)
        out.append((vals, run0, trail))
    plain_k = _best_k(plain_sum, length)
    rle_k = _best_k(nz_sum, nz) if nz else 0
    rle = run_cost + (_est(nz_sum, nz, rle_k) if nz else 0) < _est(
        plain_sum, length, plain_k)
    return out, (rle_k if rle else plain_k), rle


def _tokens(lane, k, rle):
    """The lane's symbols as (value, bits), in order."""
    vals, r, trail = lane
    out = []

    def rice(x):
        if x >> k >= MAXQ:
            out.extend([((1 << 48) - 1, 48), (x, 33)])
        else:
            q = x >> k
            out.append(((((1 << q) - 1) << (k + 1)) | (x & ((1 << k) - 1)),
                        q + 1 + k))

    def gamma(x):
        out.append((x, _gamma_bits(x)))

    for x in vals:
        if not rle:
            rice(x)
        elif x == 0:
            r += 1
        else:
            gamma(r + 1)
            rice(x - 1)
            r = 0
    if rle and trail:
        gamma(trail + 1)
    return out


def _put(stage, pos, v, n):
    """``put``: the n low bits of v, MSB first, ORed into 32-bit words
    (held here as big-endian integers) -> the next bit."""
    while n > 0:
        s = pos & 31
        take = min(n, 32 - s)
        piece = (v >> (n - take)) & ((1 << take) - 1)
        stage[pos >> 5] |= piece << (32 - s - take)
        pos += take
        n -= take
    return pos


def _emulate(codes, order=1):
    """The kernel's bytes for ``codes``, its groups' writes in ``order``
    (1: first to last; -1: last to first, so that a group that stored a
    word it shares would wipe its successor's bits)."""
    u = [_zigzag(int(v)) for v in np.asarray(codes).ravel()]
    groups = -(-len(u) // 256)
    plans = [_plan(u[256 * g:256 * (g + 1)], len(u[256 * g:256 * (g + 1)]))
             for g in range(groups)]
    lens = [HEADER + sum(n for lane in lanes
                         for _, n in _tokens(lane, k, rle))
            for lanes, k, rle in plans]
    first = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    total = int(first[-1])
    # a buffer used before: only the words at the groups' edges are zeroed
    words = [0xA5C3F00F] * (-(-total // 32))
    for g in range(groups):
        words[int(first[g]) >> 5] = 0
        words[(int(first[g]) + lens[g] - 1) >> 5] = 0
    for g in range(groups)[::order]:
        lanes, k, rle = plans[g]
        bits = [sum(n for _, n in _tokens(lane, k, rle)) for lane in lanes]
        below = np.concatenate([[0], np.cumsum(bits)[:-1]])
        s0 = int(first[g]) & 31
        n_words = (s0 + lens[g] + 31) >> 5
        stage = [0] * n_words
        _put(stage, s0, (k << 1) | int(rle), HEADER)
        for lane, b in zip(lanes, below):
            pos = s0 + HEADER + int(b)
            for v, n in _tokens(lane, k, rle):
                pos = _put(stage, pos, v, n)
        w0, open_end = int(first[g]) >> 5, (s0 + lens[g]) & 31
        for w, word in enumerate(stage):
            if (w == 0 and s0) or (w == n_words - 1 and open_end):
                words[w0 + w] |= word
            else:
                words[w0 + w] = word
    return np.array(words, dtype=">u4").tobytes()[:(total + 7) // 8]


@pytest.mark.parametrize("order", [1, -1], ids=["forward", "reverse"])
@pytest.mark.parametrize("case", EMULATED)
def test_kernel_steps_give_the_host_coders_bytes(case, order):
    codes = _case(case)
    assert _emulate(codes, order) == native.rrice_encode(codes)


def test_cases_cover_both_modes_and_the_escapes():
    """The cases reach every branch of the coder: plain and run-length
    groups, escapes in each, groups that end on a zero and on a nonzero."""
    modes = set()
    for case in EMULATED:
        u = [_zigzag(int(v)) for v in _case(case).ravel()]
        for g in range(0, len(u), 256):
            lanes, k, rle = _plan(u[g:g + 256], len(u[g:g + 256]))
            escaped = any(n == 48 for lane in lanes
                          for _, n in _tokens(lane, k, rle))
            modes.add((rle, escaped, u[min(g + 255, len(u) - 1)] == 0))
    assert modes == {(a, b, c) for a in (False, True) for b in (False, True)
                     for c in (False, True)}


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 524288, 2048])
def test_bound_is_the_host_coders(n):
    assert cuda_rice.bound(n) == native._load().acx_rrice_bound(n, 256)


@pytest.mark.parametrize("case", ["laplace1", "all_zeros", "partial"])
def test_plain_version_is_the_host_coder(case):
    codes = _case(case)
    buf, nbytes = cuda_rice.rrice_encode(torch.from_numpy(codes))
    want = native.rrice_encode(codes)
    assert nbytes.dtype == torch.int64 and int(nbytes) == len(want)
    assert buf.numpy().tobytes() == want
    assert cuda_rice.launch_counts() == {"rrice_encode": 0}


# -- on the card ---------------------------------------------------------------


@card
@pytest.mark.parametrize("case", CASES)
def test_card_bytes_equal_the_host_coders(case):
    codes = _case(case)
    want = native.rrice_encode(codes)
    cuda_rice.reset_launch_counts()
    on_card = torch.from_numpy(codes).cuda()
    buf, nbytes = cuda_rice.rrice_encode(on_card)
    torch.cuda.synchronize()
    assert cuda_rice.launch_counts() == {"rrice_encode": 1}
    # the plain version answers on the codes' device too
    plain, plain_n = cuda_rice.rrice_encode_reference(on_card)
    assert plain.is_cuda and plain_n.is_cuda and int(plain_n) == len(want)
    assert plain.cpu().numpy().tobytes() == want
    assert buf.is_cuda and nbytes.is_cuda and nbytes.shape == (1,)
    # whole words (the kernel writes words) up to the host coder's bound
    assert buf.numel() % 4 == 0
    assert buf.numel() >= cuda_rice.bound(codes.size)
    assert int(nbytes) == len(want)
    assert buf[:len(want)].cpu().numpy().tobytes() == want


@card
def test_card_buffer_reused_holds_no_stale_bits(monkeypatch):
    """A buffer the allocator hands back, still holding an earlier coding
    or ones in every bit, holds the new coding alone: the coder zeroes the
    words it ORs into."""
    dense, sparse = _case("laplace64"), _case("zeros99.9")[:9]
    assert dense.shape == sparse.shape
    want = native.rrice_encode(sparse)
    buf, _ = cuda_rice.rrice_encode(torch.from_numpy(dense).cuda())
    torch.cuda.synchronize()
    stale = buf.clone()
    del buf
    empty = torch.empty

    def stale_empty(*args, **kwargs):
        t = empty(*args, **kwargs)
        if t.is_cuda and t.dtype == torch.uint8 and t.shape == stale.shape:
            t.copy_(stale)  # the dense coding
        elif t.is_cuda:
            t.view(torch.uint8).fill_(0xFF)
        return t

    codes = torch.from_numpy(sparse).cuda()
    for fill in ("dense", "ones"):
        if fill == "ones":
            stale.fill_(0xFF)
        with monkeypatch.context() as m:
            m.setattr(torch, "empty", stale_empty)
            got, nbytes = cuda_rice.rrice_encode(codes)
        assert int(nbytes) == len(want), fill
        assert got[:len(want)].cpu().numpy().tobytes() == want, fill


@card
def test_card_refuses_what_the_kernel_does_not_take():
    codes = torch.zeros(4, 256, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="int32"):
        cuda_rice.rrice_encode(codes.to(torch.int64))
    with pytest.raises(ValueError, match="int32"):
        cuda_rice.rrice_encode(codes.t())


def _music(samples, seed):
    """Two panned tones, noise and clicks after gaps: [1, samples, 2]."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 48000
    x = np.stack([0.3 * np.sin(2 * math.pi * 440 * t),
                  0.2 * np.sin(2 * math.pi * 660 * t + 1.0)], axis=1)
    x += 0.02 * rng.standard_normal((samples, 2))
    for at in range(20000, samples, 37000):
        x[at - 3000:at] *= 0.01
        x[at:at + 40] += 0.8
    return torch.from_numpy(np.clip(x, -1, 1).astype(np.float32))[None]


STREAMS = {
    "archive": {},
    "low": dict(ms=True, deadzone=1.0, tns=True, bs=True, nf=True,
                tmask=130.0, bwe=True, intensity=True,
                threshold_scale=5.71875),
}


@card
@pytest.mark.parametrize("preset", list(STREAMS))
def test_card_stream_is_the_host_coded_stream(preset, tmp_path, monkeypatch):
    """``encode_stream`` on the card (every chunk coded there, the flush
    included, the steps replayed from CUDA graphs) writes the bytes of the
    same encode with the codes coded on the host (its steps op by op), and
    so does the server's stream session fed the same chunks,
    with one coder launch a chunk; ``decode_stream`` reads them back."""
    kb = 32
    codec = Codec.create(48000, filters_n=1024, bark_bands_n=64,
                         sidecar_grid=4, device="cuda")
    x = _music(3 * kb * 1024, seed=len(preset))
    kw = STREAMS[preset]
    card_path, host_path = tmp_path / "card.acs", tmp_path / "host.acs"
    card_counts, host_counts = {}, {}
    cuda_rice.reset_launch_counts()
    n = sc.encode_stream(codec, x, str(card_path), chunk_blocks=kb,
                         counters=card_counts, **kw)
    assert n == 4 and cuda_rice.launch_counts() == {"rrice_encode": n}
    encode_frames = codec.encode_frames

    def host_codes(*args, **kwargs):
        enc = encode_frames(*args, **kwargs)
        return enc._replace(codes=enc.codes.cpu())

    monkeypatch.setattr(codec, "encode_frames", host_codes)
    # op by op: a step's graph would replay the card's encode_frames
    monkeypatch.setattr(graphs, "ENABLED", False)
    assert sc.encode_stream(codec, x, str(host_path), chunk_blocks=kb,
                            counters=host_counts, **kw) == n
    assert {k: v for k, v in card_counts.items()
            if not k.startswith("graph_")} == {
        k: v for k, v in host_counts.items() if not k.startswith("graph_")}
    assert card_path.read_bytes() == host_path.read_bytes()
    monkeypatch.undo()
    cuda_rice.reset_launch_counts()
    step = kb * 1024
    with serve.CodecServer(codec, 48000, port=0) as server, \
            serve.Client(port=server.port) as client:
        parts = [client.begin_stream(channels=2, chunk_blocks=kb, **kw)]
        for k in range(0, x.shape[1], step):
            parts.append(client.feed(x[0, k:k + step].numpy()))
        parts.append(client.finish_stream())
    assert cuda_rice.launch_counts() == {"rrice_encode": n}
    assert b"".join(parts) == card_path.read_bytes()
    y = torch.cat(list(sc.decode_stream(codec, str(card_path))), dim=1)
    assert y.shape == (1, x.shape[1] + 2 * 1024, 2)
    assert bool(torch.isfinite(y).all()) and float(y.abs().max()) > 0.05
