"""The RVQ codec's training step on the CPU at a small size: one engaged
step against the plain reference of ``portbench/reference/rvq_train.py``,
the spans that split a step (``train.forward``, ``train.backward``,
``train.optimizer``; ``rvq.search`` inside the forward, ``rvq.ema`` after
the optimizer), the results bit for bit with and without a profiler
recording, and the RVQ's counters."""

import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from audiocodec_tpu_torch import Codec  # noqa: E402
from audiocodec_tpu_torch.models import (  # noqa: E402
    post_filter, rvq, spectral_ae)
from audiocodec_tpu_torch.parallel import train  # noqa: E402
from portbench.lib import audio  # noqa: E402
from portbench.reference.rvq_train import PARAMS, TrainReference  # noqa: E402

SR, N, BANDS, BLOCKS = 16000, 256, 32, 12
AE = spectral_ae.SpectralAE(N, 64, 16, 1 / 32)
CFG = rvq.RVQ(2, 64, 16)
CONFIG = {
    "sample_rate": SR, "filters_n": N, "bark_bands_n": BANDS, "alpha": 0.6,
    "window_type": "vorbis", "sidecar_grid": 4,
    "rvq": {"stages": CFG.stages, "codebook_size": CFG.codebook_size,
            "dim": CFG.dim, "ema_decay": CFG.ema_decay,
            "reseed_threshold": CFG.reseed_threshold,
            "commitment_weight": CFG.commitment_weight},
    "optimizer": {"name": "adam", "lr": 1e-3, "betas": [0.9, 0.999],
                  "eps": 1e-8},
    "nmr_weight": 0.1, "nmr_floor": 1e-3}
SPANS = ("train.forward", "train.backward", "train.optimizer", "rvq.search",
         "rvq.ema")

# (reason, value) of each tolerance, by the port's compute dtype. float32:
# the loss sums ~1e4 float32 terms (a few 1e-7 relative); the gradients
# come back through float32 products over K <= 256 (~1e-6 of their peak);
# the parameters move by lr-sized Adam steps computed in float32 (a few
# ulps of weights ~0.1); the codebooks are float32 means and batch rows,
# whose error energy over their own is a few float32 ulps squared (~4e-15).
# float64: the port's float64 path is the reference's arithmetic but for
# the order of sums, except that its EMA statistics are float32
# (``rvq._ema_stats``).
TOL = {
    torch.float32: {"loss": 1e-5, "grad": 1e-4, "params": 1e-6,
                    "codebooks": 1e-12},
    torch.float64: {"loss": 1e-12, "grad": 1e-9, "params": 1e-12,
                    "codebooks": 1e-12},
}


def setup(dtype=torch.float32, seed=3):
    """(codec, params, state, optimizer, step, generator, batch): the
    step's first (bypassed) step taken, so Adam's moments are set."""
    codec = Codec.create(SR, filters_n=N, bark_bands_n=BANDS,
                         compute_dtype=dtype, device="cpu")
    init = torch.Generator().manual_seed(seed)
    params = spectral_ae.init_params(init, AE, dtype, "cpu")
    state = rvq.init_state(init, CFG, dtype, "cpu")
    step, factory = rvq.make_train_step(codec, AE, CFG, warmup_steps=1)
    opt = factory(list(params.values()))
    x = audio.music(seed, 2, N * BLOCKS, 1, SR, "cpu", dtype)
    gen = torch.Generator().manual_seed(seed + 1)
    step(params, state, opt, x, gen, 0)
    return codec, params, state, opt, step, gen, x


def snapshot(params, state, opt, gen) -> dict:
    adam = {}
    for k, p in params.items():
        s = opt.state[p]
        adam[k] = (float(s["step"]), s["exp_avg"].clone(),
                   s["exp_avg_sq"].clone())
    return {"params": {k: v.detach().clone() for k, v in params.items()},
            "adam": adam, "rvq": {k: v.clone() for k, v in state.items()},
            "generator": (gen.get_state(), gen.device)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_an_engaged_step_equals_the_reference(dtype):
    torch.set_num_threads(1)
    _, params, state, opt, step, gen, x = setup(dtype)
    before = snapshot(params, state, opt, gen)
    loss = step(params, state, opt, x, gen, 1)
    ref = TrainReference(CONFIG, "cpu").step(before, x)
    tol = TOL[dtype]
    assert abs(loss.item() - ref["loss"]) <= tol["loss"] * ref["loss"]
    for k in PARAMS:
        g, want = params[k].grad.double(), ref["grads"][k]
        assert (g - want).abs().max() <= tol["grad"] * want.abs().max(), k
        assert (params[k].detach().double() - ref["params"][k]).abs().max() \
            <= tol["params"], k
    # every pick of the step: the batch's counts out of the EMA counts
    counts = torch.round((state["ema_count"].double()
                          - CFG.ema_decay * before["rvq"]["ema_count"])
                         / (1 - CFG.ema_decay))
    assert torch.equal(counts, ref["counts"])
    assert counts.sum() == CFG.stages * 2 * (BLOCKS + 1)
    err = ((state["codebooks"].double() - ref["codebooks"]) ** 2).sum()
    assert err <= tol["codebooks"] * (ref["codebooks"] ** 2).sum()


def recorded(fn):
    """fn() under a CPU profiler -> (its result, the user spans' (name,
    start, end) in order)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.is_user_annotation),
                   key=lambda s: s[1])
    return out, spans


def test_a_recorded_step_emits_its_spans_once_each_nested():
    _, params, state, opt, step, gen, x = setup()
    _, spans = recorded(lambda: step(params, state, opt, x, gen, 1))
    at = {}
    for name, s, e in spans:
        if name in SPANS:
            assert name not in at, name
            at[name] = (s, e)
    assert set(at) == set(SPANS)
    fwd, bwd, opt_, search, ema = (at[n] for n in SPANS)
    # the three are disjoint, in order; the search inside the forward, the
    # EMA step after the optimizer's
    assert fwd[1] <= bwd[0] and bwd[1] <= opt_[0]
    assert fwd[0] <= search[0] and search[1] <= fwd[1]
    assert opt_[1] <= ema[0]


@pytest.mark.parametrize("trainer", ["spectral_ae", "gains", "post_filter"])
def test_every_trainer_steps_through_the_three_spans(trainer):
    codec = Codec.create(SR, filters_n=N, bark_bands_n=BANDS, device="cpu")
    x = audio.music(5, 2, N * BLOCKS, 1, SR, "cpu")
    init = torch.Generator().manual_seed(5)
    if trainer == "gains":
        st = train.init_state(codec)
        step, _ = train.make_train_step(codec)
        run = lambda: step(st, x)  # noqa: E731
    else:
        mod, cfg = ((spectral_ae, AE) if trainer == "spectral_ae"
                    else (post_filter, post_filter.PostFilter(N, 32)))
        params = mod.init_params(init, cfg, device="cpu")
        step, factory = mod.make_train_step(codec, cfg)
        opt = factory(list(params.values()))
        run = lambda: step(params, opt, x)  # noqa: E731
    _, spans = recorded(run)
    names = [n for n, _, _ in spans if n.startswith("train.")]
    assert names == ["train.forward", "train.backward", "train.optimizer"]


def test_a_recording_changes_no_bit_of_the_step():
    def two_steps(record):
        _, params, state, opt, step, gen, x = setup()
        run = lambda: step(params, state, opt, x, gen, 1)  # noqa: E731
        loss = recorded(run)[0] if record else run()
        return (loss, {k: p.grad for k, p in params.items()},
                {k: p.detach() for k, p in params.items()}, state,
                {k: dict(opt.state[p]) for k, p in params.items()})

    plain, traced = two_steps(False), two_steps(True)
    assert torch.equal(plain[0], traced[0])
    for a, b in zip(plain[1:], traced[1:]):
        for k in a:
            if isinstance(a[k], dict):
                for j in a[k]:
                    assert torch.equal(a[k][j], b[k][j]), (k, j)
            else:
                assert torch.equal(a[k], b[k]), k


def test_counts_steps_searches_and_reseeds():
    _, params, state, opt, step, gen, x = setup()
    rvq.reset_counts()
    dead = 0
    for i in (1, 2):
        step(params, state, opt, x, gen, i)
        dead += int((state["ema_count"] < CFG.reseed_threshold).sum())
    assert rvq.counts() == {"steps": 2, "searches": 2 * 2 * CFG.stages,
                            "reseeded": dead}
    assert dead > 0  # 26 rows a stage for 64 codewords: most starve
    rvq.reset_counts()
    assert rvq.counts() == {"steps": 0, "searches": 0, "reseeded": 0}
