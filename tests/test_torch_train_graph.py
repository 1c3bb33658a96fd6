"""The RVQ codec's train step replayed as one CUDA graph
(``parallel.train.LossGraph``, engaged by ``rvq.make_train_step``) at
``tests/test_torch_train_step.py``'s small sizes.

Each replayed step is held bit for bit to the same step run op by op from
the same seeded state (``utils.graphs.ENABLED`` False turns the graphs
off): the losses, the gradients, the parameters, Adam's state, the
codebooks and EMA statistics and the reseed generator's state. The tests
run twice: on the CPU, where a stand-in for the graph (``_Replayer``: a
replay runs the loss and its backward op by op on the static inputs and
writes the static outputs) takes the step's loads, gradients and copies as
a card's replay would, and on the card (marked ``cuda``: run ``python -m
pytest --noconftest -m cuda tests/test_torch_train_graph.py`` there; it
skips without one), under deterministic algorithms, since the EMA sums'
``index_add_`` adds its float32 rows by atomics in any order otherwise.
The CPU alone checks the EMA counts against ``bincount``, a failed
capture's gradients and the ``train.graph_ms`` reader; the card alone, that
parameters on the host beside a batch on the card run op by op.
"""

import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from audiocodec_tpu_torch import Codec  # noqa: E402
from audiocodec_tpu_torch.models import rvq, spectral_ae  # noqa: E402
from audiocodec_tpu_torch.parallel import train  # noqa: E402
from audiocodec_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from audiocodec_tpu_torch.utils import graphs  # noqa: E402
from portbench.lib import audio, harness  # noqa: E402

SR, N, BANDS, BLOCKS = 16000, 256, 32, 12
AE = spectral_ae.SpectralAE(N, 64, 16, 1 / 32)
CFG = rvq.RVQ(2, 64, 16)


class _Replayer:
    """The CPU's stand-in for a CUDA graph of the loss: a replay runs the
    loss and its backward op by op on the static inputs and writes the
    loss, the aux and the gradients into the static outputs. Its stage
    searches go uncounted, as a card's replay runs none on the host."""

    def __init__(self, params, forward, inputs):
        self.params, self.forward, self.inputs = params, forward, inputs
        self.outputs = None

    def run(self) -> list:
        held = [p.grad for p in self.params]
        for p in self.params:
            p.grad = None
        loss, aux = self.forward(*self.inputs)
        loss.backward()
        grads = [p.grad for p in self.params]
        for p, g in zip(self.params, held):
            p.grad = g
        return [loss.detach(), aux.detach(), *grads]

    def replay(self) -> None:
        counted = dict(rvq._counts)
        for dst, src in zip(self.outputs, self.run()):
            dst.copy_(src)
        rvq._counts.update(counted)


def _capture(params, forward, inputs):
    """``LossGraph.capture`` over the stand-in: the forward runs once, its
    searches counted, as a capture's are."""
    params, inputs = list(params), [t.clone() for t in inputs]
    graph = _Replayer(params, forward, inputs)
    graph.outputs = graph.run()
    loss, aux, *grads = graph.outputs
    return train.LossGraph(graph, params, inputs, loss, aux, grads)


@pytest.fixture(params=["stand_in", pytest.param("card",
                                                  marks=pytest.mark.cuda)])
def device(request, monkeypatch):
    """The device whose steps replay, the counts at 0: the CPU with the
    stand-in graph, or the card under deterministic algorithms."""
    rvq.reset_counts()
    if request.param == "stand_in":
        monkeypatch.setattr(graphs, "DEVICE", "cpu")
        monkeypatch.setattr(train.LossGraph, "capture",
                            staticmethod(_capture))
        yield "cpu"
        return
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield "cuda"
    finally:
        torch.use_deterministic_algorithms(False)


def setup(device, seed=3, blocks=BLOCKS, **kw):
    """(params, state, optimizer, step, generator, a ring of 2 batches),
    the step's first (bypassed) step taken."""
    codec = Codec.create(SR, filters_n=N, bark_bands_n=BANDS, device=device)
    init = audio.generator(seed, device)
    params = spectral_ae.init_params(init, AE, torch.float32, device)
    state = rvq.init_state(init, CFG, torch.float32, device)
    step, factory = rvq.make_train_step(codec, AE, CFG, warmup_steps=1, **kw)
    opt = factory(list(params.values()))
    ring = [audio.music(seed + j, 2, N * blocks, 1, SR, device)
            for j in range(2)]
    gen = audio.generator(seed + 1, device)
    step(params, state, opt, ring[0], gen, 0)
    return params, state, opt, step, gen, ring


def snapshot(loss, params, state, opt, gen) -> dict:
    """Copies of what a step gave and what the next starts from."""
    adam = {}
    for k, p in params.items():
        s = opt.state[p]
        adam[k] = (s["step"].clone(), s["exp_avg"].clone(),
                   s["exp_avg_sq"].clone())
    return {"loss": loss.clone(),
            "grads": {k: p.grad.clone() for k, p in params.items()},
            "params": {k: p.detach().clone() for k, p in params.items()},
            "adam": adam, "rvq": {k: v.clone() for k, v in state.items()},
            "generator": gen.get_state()}


def assert_equal(a: dict, b: dict, where=()):
    """Every tensor of two snapshots equal, bit for bit."""
    assert a.keys() == b.keys(), where
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, dict):
            assert_equal(x, y, (*where, k))
        elif isinstance(x, tuple):
            for j, (u, v) in enumerate(zip(x, y)):
                assert torch.equal(u, v), (*where, k, j)
        else:
            assert torch.equal(x, y), (*where, k)


def steps(monkeypatch, device, graphed: bool, n=3, replace=None):
    """Snapshots of ``n`` engaged steps after the first, with the graphs
    on or off; ``replace(state)`` runs before the last of them."""
    monkeypatch.setattr(graphs, "ENABLED", graphed)
    params, state, opt, step, gen, ring = setup(device)
    step(params, state, opt, ring[1], gen, 1)
    out = []
    for i in range(2, 2 + n):
        if replace is not None and i == 1 + n:
            state["codebooks"] = replace(state["codebooks"])
        loss = step(params, state, opt, ring[i % 2], gen, i)
        out.append(snapshot(loss, params, state, opt, gen))
    return out


def test_replayed_steps_equal_op_by_op_steps(monkeypatch, device):
    plain = steps(monkeypatch, device, False)
    counts = rvq.counts()
    assert [counts[k] for k in ("direct", "captured", "replayed")] == [
        5, 0, 0]
    rvq.reset_counts()
    replayed = steps(monkeypatch, device, True)
    for i, (a, b) in enumerate(zip(plain, replayed)):
        assert_equal(a, b, (f"step {i + 2}",))
    counts = rvq.counts()
    # the bypassed step and the first engaged one run op by op and capture
    # their gate's graph; every later step replays, and the forward's
    # searches count for each
    assert {k: counts[k] for k in ("steps", "replayed", "captured",
                                   "direct")} == {
        "steps": 5, "replayed": 3, "captured": 2, "direct": 2}
    assert counts["searches"] == 5 * 2 * CFG.stages
    assert counts["reseeded"] > 0  # 26 rows a stage for 64 codewords


def test_replaced_codebooks_are_the_ones_the_next_replay_reads(
        monkeypatch, device):
    def replace(codebooks):
        return torch.flip(codebooks, dims=[1]) * 0.5

    plain = steps(monkeypatch, device, False, n=2, replace=replace)
    replayed = steps(monkeypatch, device, True, n=2, replace=replace)
    assert_equal(plain[-1], replayed[-1])
    assert rvq.counts()["replayed"] == 2


def test_a_key_captures_once_and_a_new_gate_or_shape_anew(device):
    params, state, opt, step, gen, ring = setup(device)  # gate 0: captured
    counts = lambda: [rvq.counts()[k] for k in (  # noqa: E731
        "direct", "captured", "replayed")]
    assert counts() == [1, 1, 0]
    step(params, state, opt, ring[1], gen, 0)  # the same key
    assert counts() == [1, 1, 1]
    for i in (1, 2, 3):  # gate 1: a new key
        step(params, state, opt, ring[i % 2], gen, i)
    assert counts() == [2, 2, 3]
    longer = audio.music(9, 2, N * (BLOCKS + 1), 1, SR, device)
    for i in (4, 5):  # a new shape
        step(params, state, opt, longer, gen, i)
    assert counts() == [3, 3, 4]
    step(params, state, opt, ring[0], gen, 6)  # the first shape again
    assert counts() == [3, 3, 5]


def test_the_step_keeps_its_last_few_graphs(device):
    params, state, opt, step, gen, _ = setup(device)
    batches = [audio.music(9, 2, N * b, 1, SR, device)
               for b in range(BLOCKS + 1, BLOCKS + 2 + rvq._GRAPH_SLOTS)]
    for i, x in enumerate(batches, start=1):
        step(params, state, opt, x, gen, i)
    assert rvq.counts()["captured"] == 1 + len(batches)
    # the least recently used keys went: the bypassed step's, then the
    # first shape's
    step(params, state, opt, batches[-1], gen, 10)
    step(params, state, opt, batches[0], gen, 11)
    assert rvq.counts()["replayed"] == 1
    assert rvq.counts()["captured"] == 2 + len(batches)


@pytest.mark.parametrize("kind", ["mesh", "remat"])
def test_mesh_and_remat_steps_run_op_by_op(device, kind):
    kw = ({"mesh": Mesh(((torch.device(device),),))} if kind == "mesh"
          else {"remat": True})
    params, state, opt, step, gen, ring = setup(device, **kw)
    for i in (1, 2, 3):
        step(params, state, opt, ring[i % 2], gen, i)
    counts = rvq.counts()
    assert [counts[k] for k in ("direct", "captured", "replayed")] == [
        4, 0, 0]


@pytest.mark.cuda
def test_host_parameters_beside_a_card_batch_run_op_by_op():
    """The loss copies them to the card, which a capture refuses."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rvq.reset_counts()
    codec = Codec.create(SR, filters_n=N, bark_bands_n=BANDS, device="cuda")
    params = spectral_ae.init_params(audio.generator(3, "cpu"), AE,
                                     torch.float32, "cpu")
    state = rvq.init_state(audio.generator(3, "cuda"), CFG, torch.float32,
                           "cuda")
    step, factory = rvq.make_train_step(codec, AE, CFG, warmup_steps=1)
    opt = factory(list(params.values()))
    x = audio.music(3, 2, N * BLOCKS, 1, SR, "cuda")
    gen = audio.generator(4, "cuda")
    for i in (0, 1, 2):
        assert bool(torch.isfinite(step(params, state, opt, x, gen, i)))
    counts = rvq.counts()
    assert [counts[k] for k in ("steps", "direct", "captured",
                                "replayed")] == [3, 3, 0, 0]


def test_a_failed_capture_leaves_the_grads_as_they_were():
    """On the CPU a capture fails as it starts, after the parameters'
    ``.grad`` were set aside for the graph's own."""
    params = [torch.ones(3, requires_grad=True) for _ in range(2)]
    params[0].grad = held = torch.full((3,), 2.0)

    def forward(x):
        loss = (params[0] * params[1] * x).sum()
        return loss, loss

    with pytest.raises(RuntimeError):
        train.LossGraph.capture(params, forward, (torch.ones(3),))
    assert params[0].grad is held and params[1].grad is None


def test_host_tensors_run_op_by_op():
    rvq.reset_counts()
    params, state, opt, step, gen, ring = setup("cpu")
    for i in (1, 2):
        step(params, state, opt, ring[i % 2], gen, i)
    counts = rvq.counts()
    assert [counts[k] for k in ("steps", "direct", "captured",
                                "replayed")] == [3, 0, 0, 0]


def test_a_loss_keeps_its_value_after_the_next_step(device):
    params, state, opt, step, gen, ring = setup(device)
    step(params, state, opt, ring[1], gen, 1)
    first = step(params, state, opt, ring[0], gen, 2)
    held = first.clone()
    second = step(params, state, opt, ring[1], gen, 3)
    assert rvq.counts()["replayed"] == 2
    assert torch.equal(first, held)
    assert not torch.equal(first, second)


def test_a_replayed_step_runs_the_graph_span(device):
    params, state, opt, step, gen, ring = setup(device)
    step(params, state, opt, ring[1], gen, 1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, state, opt, ring[0], gen, 2)
    spans = sorted(((e.name, e.time_range.start) for e in prof.events()
                    if e.is_user_annotation), key=lambda s: s[1])
    names = [n for n, _ in spans if n.startswith("train.") or n == "rvq.ema"]
    # the forward's and backward's spans ran at the capture alone
    assert names == ["train.graph", "train.optimizer", "rvq.ema"]


def _counts_and_bincounts(codebooks, flat):
    """(``_ema_stats``' counts, each stage's ``bincount`` of the same
    picks)."""
    counts, _ = rvq._ema_stats(CFG, codebooks, flat)
    want, residual = [], flat
    for codebook in codebooks:
        idx, q = rvq._nearest(residual, codebook)
        want.append(torch.bincount(idx, minlength=CFG.codebook_size).float())
        residual = residual - q
    return counts, torch.stack(want)


@pytest.mark.parametrize("case", ["spread", "top_unpicked", "one_codeword"])
def test_ema_counts_are_the_bincounts(case):
    g = torch.Generator().manual_seed(7)
    k, d = CFG.codebook_size, CFG.dim
    codebooks = torch.randn(CFG.stages, k, d, generator=g) * 0.1
    flat = torch.randn(300, d, generator=g) * 0.1
    if case == "top_unpicked":
        codebooks[:, k // 2:] += 100.0  # no row comes near the upper half
    elif case == "one_codeword":
        flat = codebooks[0, 5].expand(40, d).clone()
    counts, want = _counts_and_bincounts(codebooks, flat)
    assert counts.dtype == torch.float32
    assert torch.equal(counts, want)
    assert (counts == 0).any()  # codewords no row picks
    if case == "top_unpicked":
        assert (counts[:, k // 2:] == 0).all()
    if case == "one_codeword":
        assert counts[0, 5] == 40


def _view(keys):
    summary = {"device": [("split_gemm_kernel<6>", 0, 100)], "host": [],
               "keys": keys, "window": (0, 2_000_000)}
    outcome = harness.Outcome(1, 0, {}, [], summary=summary, ops=4)
    return harness.TraceView(harness.Cell("mono44k_rvq.train32x10s"),
                             outcome)


def test_the_graph_ms_reader():
    read = harness.Cell("mono44k_rvq.train32x10s").reader(
        "train.graph_ms").read
    # (count, self us, total us): 4 replays, 1 ms in all
    keys = {"train.graph": [4, 100.0, 1_000.0],
            "train.optimizer": [4, 0.0, 9_000.0]}
    assert read(_view(keys)) == pytest.approx(0.25)
    # the parent's step replays no graph: nothing to read
    assert read(_view({"train.forward": [4, 0.0, 9_000.0]})) is None
