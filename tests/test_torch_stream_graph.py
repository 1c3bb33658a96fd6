"""The chunk step's CUDA graph (``io/stream_container._StepGraph``): an
``.acs`` encode whose steps replay writes the bytes of the same encode run
op by op.

The tests marked ``cuda`` need an NVIDIA GPU: run ``python -m pytest
--noconftest -m cuda tests/test_torch_stream_graph.py`` there. Each encodes
with the graphs and again with them turned off (``utils.graphs.ENABLED``),
byte for byte, and counts the replays. Without a card they skip; the skip
condition is a string, evaluated when each test is set up. The others run
on the CPU, where a stand-in for the graph (``_Replayer``: a replay runs the
step on the static inputs and writes the static outputs) takes the
encoder's loads and copies as a card's replay would: the key and when a
step runs op by op, the table's bound, the order of the state's loads and
copies, sessions on threads, the cached 0-d constants and the 0-d tensor
scale's product.
"""

import io
import sys
import threading
import time

import numpy as np
import pytest
import torch

from audiocodec_tpu_torch import Codec, tns
from audiocodec_tpu_torch.io import stream_container as sc
from audiocodec_tpu_torch.utils import dtypes as _dtypes
from audiocodec_tpu_torch.utils import graphs

SR, N, BARK, CB = 16000, 256, 16, 4


def card(test):
    """Marks a test that needs the card."""
    test = pytest.mark.skipif("not torch.cuda.is_available()",
                              reason="needs an NVIDIA GPU")(test)
    return pytest.mark.cuda(test)


def signal(ch, blocks, seed=0, silent=(), n=N, rate=SR):
    """[1, blocks * n, ch] float32 tones over noise with an impulse after a
    quiet span in every 8 blocks (TNS and block switching fire), the
    blocks of ``silent`` digital zero."""
    rng = np.random.default_rng(seed)
    t = np.arange(blocks * n) / rate
    x = (0.3 * np.sin(2 * np.pi * 440 * t)[:, None]
         + 0.02 * np.sin(2 * np.pi * 6000 * t)[:, None]
         + 0.03 * rng.normal(size=(blocks * n, ch)))
    for b in range(1, blocks, 8):
        x[b * n:b * n + n // 2] *= 0.01
        x[b * n + n // 2 + 40] += 0.9
    if ch == 2:
        x[:, 1] = 0.8 * x[:, 0] + 0.01 * rng.normal(size=blocks * n)
    for b in silent:
        x[b * n:(b + 1) * n] = 0.0
    return torch.from_numpy(np.clip(x, -1, 1).astype(np.float32)[None])


LADDER = dict(ms=True, deadzone=1.0, tns=True, bs=True, nf=True,
              tmask=130.0, bwe=True, intensity=True)
# name -> (channels, blocks, silent blocks, encode_stream keywords,
# (eager, captured, replayed) on the CPU's stand-in). The ladder's
# forward-masking context grows by a chunk's 4 frames up to its 15: 5 keys
CASES = {
    "plain": (1, 16, (), {}, (1, 1, 3)),
    "ladder": (2, 64, (), dict(LADDER, threshold_scale=5.71875),
               (5, 5, 11)),
    "fec": (2, 16, (), dict(ms=True, fec=4.0), (1, 1, 3)),
    "cbr": (1, 16, (), dict(threshold_scale=[1.0, 4.0, 2.0, 8.0], bs=True),
            (1, 1, 3)),
    # chunks 3-4 silent: chunk 3 coded (the gate's hangover), chunk 4 a
    # silent record, chunk 5 coded from a zero carry: the first key again
    "dtx": (2, 32, range(12, 20), dict(dtx=-60.0), (1, 1, 6)),
}


def _codec(dtype="float32"):
    return Codec.create(SR, filters_n=N, bark_bands_n=BARK,
                        compute_dtype=dtype, device="cpu")


def _tensors(out):
    enc, fecq, carry, ctx = out
    return [t for t in (*enc, *(fecq or ()), carry, ctx) if t is not None]


class _Replayer:
    """The CPU's stand-in for a CUDA graph: a replay runs the captured step
    on the static inputs and writes what it returns into the static
    outputs; ``seen`` keeps the inputs of each replay."""

    def __init__(self, step, inputs):
        self.step, self.inputs, self.seen = step, inputs, []
        self.outputs = step(*inputs)

    def replay(self):
        self.seen.append([None if t is None else t.clone()
                          for t in self.inputs])
        for dst, src in zip(_tensors(self.outputs),
                            _tensors(self.step(*self.inputs))):
            dst.copy_(src)


def _capture(step, x, carry, ctx):
    inputs = (x.clone(), carry.clone(), None if ctx is None else ctx.clone(),
              x.new_ones(()), x.new_ones(()))
    graph = _Replayer(step, inputs)
    return sc._StepGraph(graph, inputs, graph.outputs)


def _copied(tensors):
    """``_to_host`` on the card: the outputs copied before the next replay
    (on the CPU it hands over the tensors themselves), a while after the
    replay, as a card's queue takes its time."""
    time.sleep(0.02)
    return [t.clone() if isinstance(t, torch.Tensor) else t
            for t in tensors], None


@pytest.fixture
def stand_in(monkeypatch):
    """The CPU's steps replay from the stand-in; the counts start at 0."""
    monkeypatch.setattr(graphs, "DEVICE", "cpu")
    monkeypatch.setattr(sc._StepGraph, "capture", staticmethod(_capture))
    monkeypatch.setattr(sc, "_to_host", _copied)
    sc.reset_graph_counts()
    yield
    sc.reset_graph_counts()


class op_by_op:
    """The graphs off while the block runs (``utils.graphs.ENABLED``)."""

    def __enter__(self):
        self.enabled, graphs.ENABLED = graphs.ENABLED, False

    def __exit__(self, *exc):
        graphs.ENABLED = self.enabled


def _encode(codec, x, **kw):
    buf = io.BytesIO()
    sc.encode_stream(codec, x, buf, chunk_blocks=CB, **kw)
    return buf.getvalue()


def _counts(eager, captured, replayed):
    return dict(eager=eager, captured=captured, replayed=replayed)


@pytest.mark.parametrize("case", list(CASES))
def test_replayed_stream_is_the_stream_run_op_by_op(case, stand_in):
    """Each preset's stream replayed from the stand-in is the stream run
    op by op, with a capture and an op-by-op step a key."""
    ch, blocks, silent, kw, counts = CASES[case]
    codec = _codec()
    x = signal(ch, blocks, seed=len(case), silent=silent)
    with op_by_op():
        want = _encode(codec, x, **kw)
    sc.reset_graph_counts()
    writer = {}
    buf = io.BytesIO()
    sc.encode_stream(codec, x, buf, chunk_blocks=CB, counters=writer, **kw)
    assert buf.getvalue() == want
    assert sc.graph_counts() == _counts(*counts)
    assert {k: v for k, v in writer.items() if k.startswith("graph_")} == {
        f"graph_{k}": v for k, v in _counts(*counts).items() if v}
    # a second stream on the codec replays every step of the keys it saw
    sc.reset_graph_counts()
    assert _encode(codec, x, **kw) == want
    assert sc.graph_counts() == _counts(0, 0, sum(counts[::2]))


def _encoder(codec, ch, **kw):
    return sc._ChunkEncoder(codec, io.BytesIO(), ch, **kw)


@pytest.mark.parametrize("why", ["cpu", "grad", "drown", "off"])
def test_steps_without_a_key_run_op_by_op(why, stand_in, monkeypatch):
    """Off the card, with grad on, with a tensor ``drown`` or with the
    graphs off, a step has no key; on the card's stand-in it is counted as
    run op by op."""
    codec = _codec()
    kw = dict(drown=torch.tensor(0.0)) if why == "drown" else {}
    if why == "cpu":
        monkeypatch.setattr(graphs, "DEVICE", "cuda")
    if why == "off":
        monkeypatch.setattr(graphs, "ENABLED", False)
    enc = _encoder(codec, 1, **kw)
    x = signal(1, 3 * CB)
    with torch.set_grad_enabled(why == "grad"):
        for k in range(3):
            chunk = x[:, k * CB * N:(k + 1) * CB * N]
            assert enc._graph_key(chunk) is None
            enc.push(chunk, 1.0)
        enc.finish()
    eager = 0 if why == "cpu" else 3
    assert sc.graph_counts() == _counts(eager, 0, 0)
    assert codec not in sc._graphs


@torch.no_grad()
def test_key_follows_the_chunk_and_the_context(stand_in):
    """A chunk's shape and the context's presence and shape each make
    another key; the flush frame runs op by op, uncounted."""
    codec = _codec()
    enc = _encoder(codec, 2, **LADDER)
    x = signal(2, 8 * CB)
    chunk = x[:, :CB * N]
    first = enc._graph_key(chunk)
    assert first == enc._graph_key(chunk.clone())
    assert first != enc._graph_key(x[:, :2 * CB * N])
    enc.push(chunk, 1.0)
    assert enc._tctx is not None
    second = enc._graph_key(chunk)
    assert second != first and second[2] == tuple(enc._tctx.shape)
    assert _encoder(codec, 2, **dict(LADDER, fec=4.0))._graph_key(
        chunk) != first
    before = sc.graph_counts()
    enc.finish()
    assert sc.graph_counts() == before == _counts(1, 1, 0)


@torch.no_grad()
def test_graphs_of_a_codec_are_bounded(stand_in, monkeypatch):
    """A session whose chunks change size captures a graph a new size, the
    least recently used leaving the codec's table past its bound, and
    writes the bytes of its steps run op by op."""
    monkeypatch.setattr(sc, "_GRAPH_SLOTS", 2)
    codec = _codec()
    x = signal(1, 40)
    sizes = (4, 8, 4, 12, 8, 4)

    def encode():
        enc = _encoder(codec, 1)
        at = 0
        for blocks in sizes:
            enc.push(x[:, at * N:(at + blocks) * N], 2.0)
            at += blocks
        enc.finish()
        return enc._writer._f.getvalue()

    got = encode()
    keys = [k[0][1] // N for k in sc._graphs[codec]]
    assert keys == [8, 4]  # 12 blocks left before 8 and 4 came again
    assert sc.graph_counts() == _counts(5, 5, 1)
    monkeypatch.setattr(graphs, "ENABLED", False)
    assert encode() == got


@torch.no_grad()
def test_state_is_loaded_before_and_copied_after_each_replay(stand_in):
    """Each replay sees the encoder's carry and context of the chunk before
    and the scale of its chunk; the encoder keeps copies of the new state,
    which later replays leave alone."""
    codec = _codec()
    enc = _encoder(codec, 2, **LADDER)
    x = signal(2, 32)
    states = []
    for k in range(8):
        chunk = x[:, k * CB * N:(k + 1) * CB * N]
        before = (enc._carry.clone(),
                  None if enc._tctx is None else enc._tctx.clone())
        enc.push(chunk, 1.0 + k)
        after = (enc._carry, enc._tctx)
        states.append((before, after, [t.clone() for t in after]))
    last = list(sc._graphs[codec].values())[-1]
    replays = last.graph.seen
    # the context grows to its 15 frames by chunk 4: chunks 5-7 replay
    assert len(replays) == sc.graph_counts()["replayed"] == 3
    for seen, ((carry, ctx), _, _) in zip(replays, states[5:]):
        assert torch.equal(seen[1], carry) and torch.equal(seen[2], ctx)
    assert [float(s[3]) for s in replays] == [6.0, 7.0, 8.0]
    static = last.outputs[2:]
    for _, after, then in states[5:]:
        for kept, out, value in zip(after, static, then):
            assert kept.data_ptr() != out.data_ptr()
            assert torch.equal(kept, value)  # no later replay wrote it
    assert torch.equal(states[7][1][0], x[:, -N:].transpose(1, 2))
    enc.finish()


def test_sessions_on_threads_share_a_codec_graphs(stand_in):
    """More sessions than cores, each on its thread, push chunk after chunk
    on one codec with a short switch interval: each writes the bytes of
    its stream run alone op by op, and no count is lost."""
    codec = _codec()
    sessions = 12
    chunks = 4
    xs = [signal(2, chunks * CB, seed=s) for s in range(sessions)]

    @torch.no_grad()
    def session(x, out, k):
        enc = _encoder(codec, 2, ms=True, tns=True)
        for c in range(chunks):
            enc.push(x[:, c * CB * N:(c + 1) * CB * N], 2.0)
            enc.drain()
        enc.finish()
        out[k] = enc._writer._f.getvalue()

    got = [None] * sessions
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=session, args=(x, got, k))
                   for k, x in enumerate(xs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    counts = sc.graph_counts()
    assert counts["captured"] == counts["eager"] == 1
    assert counts["replayed"] == sessions * chunks - 1
    for k, x in enumerate(xs):
        want = [None]
        with op_by_op():
            session(x, want, 0)
        assert got[k] == want[0], k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("value", [tns._QSTEP, 3.0])
def test_divisor_is_made_once_with_its_exact_value(dtype, value):
    dt = getattr(torch, dtype)
    a = _dtypes.divisor(value, dt, torch.device("cpu"))
    assert _dtypes.divisor(value, dt, torch.device("cpu")) is a
    assert a.dtype == dt and a.dim() == 0
    assert float(a) == _dtypes.rounded(value, dt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_tensor_scale_multiplies_as_the_float_scale(dtype):
    """A 0-d scale filled with the scale rounded to the compute dtype, as a
    graph's input, gives ``Codec._scaled``'s float product bit for bit."""
    codec = _codec(dtype)
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(5)
    thr = torch.from_numpy(10.0 ** rng.uniform(-7, 0, (3, 8, N, 2))).to(dt)
    scales = [5.71875, 5.71875 * 4.0, 1 / 3, 1e-3, 123.456, 2.0 ** -20,
              *10.0 ** rng.uniform(-4, 4, 16)]
    for s in scales:
        t = torch.empty((), dtype=dt)
        t.fill_(_dtypes.rounded(s, dt))
        a, b = codec._scaled(thr, s), codec._scaled(thr, t)
        assert a.dtype == b.dtype == dt
        assert torch.equal(a.view(-1).view(torch.uint8),
                           b.view(-1).view(torch.uint8)), s


# -- on the card ------------------------------------------------------------

CARD_CB = 32
CARD_SR = 48000
CARD_CASES = {
    "archive": ({}, 6, (1, 1, 5)),
    "low": (dict(LADDER, threshold_scale=5.71875), 6, (2, 2, 4)),
    "low_fec": (dict(LADDER, threshold_scale=5.71875, fec=4.0), 6,
                (2, 2, 4)),
    "cbr": (dict(threshold_scale=[1.0, 4.0, 2.0, 8.0, 0.5, 3.0], bs=True),
            6, (1, 1, 5)),
    # chunks 3-5 silent: 3 coded (hangover), 4-5 silent records, 6 coded
    # from a zero carry replays the first key
    "dtx": (dict(dtx=-60.0), 8, (1, 1, 5)),
}


def _card_codec(device="cuda"):
    return Codec.create(CARD_SR, filters_n=1024, bark_bands_n=64,
                        sidecar_grid=4, device=device)


def _card_signal(seed, chunks, silent=()):
    return signal(2, chunks * CARD_CB, seed=seed, silent=silent, n=1024,
                  rate=CARD_SR)


def _card_encode(codec, x, **kw):
    buf = io.BytesIO()
    sc.encode_stream(codec, x, buf, chunk_blocks=CARD_CB, **kw)
    return buf.getvalue()


@card
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_card_replayed_stream_is_the_stream_run_op_by_op(case, monkeypatch):
    kw, chunks, counts = CARD_CASES[case]
    codec = _card_codec()
    silent = range(3 * CARD_CB, 6 * CARD_CB) if case == "dtx" else ()
    x = _card_signal(len(case), chunks, silent)
    sc.reset_graph_counts()
    got = _card_encode(codec, x, **kw)
    assert sc.graph_counts() == _counts(*counts)
    sc.reset_graph_counts()
    assert _card_encode(codec, x, **kw) == got
    assert sc.graph_counts() == _counts(0, 0, sum(counts[::2]))
    monkeypatch.setattr(graphs, "ENABLED", False)
    sc.reset_graph_counts()
    assert _card_encode(codec, x, **kw) == got
    assert sc.graph_counts() == _counts(sum(counts[::2]), 0, 0)


@card
@pytest.mark.parametrize("how", ["alternate", "threads"])
def test_card_sessions_interleaved_on_one_codec(how, monkeypatch):
    """Two chunk encoders on one codec, as the server's sessions run them
    (a chunk pushed, then drained), in turns on one thread or each on its
    thread: each writes the bytes of its stream run op by op."""
    codec = _card_codec()
    chunks = 6
    xs = [_card_signal(seed, chunks) for seed in (1, 2)]
    kw = dict(LADDER, threshold_scale=5.71875)

    def sessions(turns):
        encs = [sc._ChunkEncoder(codec, io.BytesIO(), 2, **kw) for _ in xs]
        steps = [(i, c) for c in range(chunks) for i in range(len(xs))]

        def run(mine):
            with torch.no_grad():
                for i, c in mine:
                    step = CARD_CB * 1024
                    encs[i].push(xs[i][:, c * step:(c + 1) * step], 5.71875)
                    encs[i].drain()

        if turns:
            run(steps)
        else:
            threads = [threading.Thread(target=run, args=(
                [s for s in steps if s[0] == i],)) for i in range(len(xs))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads)
        with torch.no_grad():
            for e in encs:
                e.finish()
        return [e._writer._f.getvalue() for e in encs]

    sc.reset_graph_counts()
    got = sessions(how == "alternate")
    assert sc.graph_counts() == _counts(2, 2, 2 * chunks - 2)
    monkeypatch.setattr(graphs, "ENABLED", False)
    assert sessions(True) == got


@card
def test_card_codec_on_the_cpu_runs_op_by_op():
    """A CPU codec beside the card: no graph, nothing counted."""
    codec = _card_codec("cpu")
    x = _card_signal(0, 2)
    sc.reset_graph_counts()
    a = _card_encode(codec, x)
    assert sc.graph_counts() == _counts(0, 0, 0)
    assert codec not in sc._graphs
    assert _card_encode(codec, x) == a


# the MDCT's other routes and dtypes (chip_smoke.py's (r2), (b)), its int8
# tier and a float64 pipeline, each at the low preset
TIERS = {
    "radix2048": dict(filters_n=2048, kernel_design="radix"),
    "bf16": dict(compute_dtype="bfloat16", fast_bf16=True,
                 dct_precision="default"),
    "int8": dict(dct_precision="int8"),
    "float64": dict(compute_dtype="float64"),
}


@card
@pytest.mark.parametrize("tier", list(TIERS))
def test_card_tiers_replay_as_they_run_op_by_op(tier):
    cfg = TIERS[tier]
    codec = Codec.create(CARD_SR, bark_bands_n=64, sidecar_grid=4,
                         device="cuda", **cfg)
    x = signal(2, 4 * CARD_CB, seed=3, n=cfg.get("filters_n", 1024),
               rate=CARD_SR).to(codec.mdct.compute_dtype)
    kw = dict(LADDER, threshold_scale=5.71875)
    sc.reset_graph_counts()
    got = _card_encode(codec, x, **kw)
    assert sc.graph_counts() == _counts(2, 2, 2)
    with op_by_op():
        assert _card_encode(codec, x, **kw) == got
