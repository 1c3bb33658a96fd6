"""The training cell on the CPU at a small size: its run end to end,
traced and not, the faults planted under it, its readers on synthetic
trace summaries and the step's FLOP count; on the card (``-m cuda``), the
control at the small size."""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from audiocodec_tpu_torch.mdct import MDCT  # noqa: E402
from audiocodec_tpu_torch.models import rvq  # noqa: E402
from audiocodec_tpu_torch.ops import dct as _dct  # noqa: E402
from portbench.lib import harness, roofline, roofline_train  # noqa: E402

NAME = "mono44k_rvq.train32x10s"
PORTBENCH = Path(__file__).resolve().parents[1]
# the cell at a size a CPU test run holds: 16 kHz, N=256, 32 bands,
# SpectralAE(256, 64, 16), RVQ(2, 64, 16), 2 clips of 12 blocks, the
# checked steps among the window's first 8
SMALL = (dict(sample_rate=16000, filters_n=256, bark_bands_n=32,
              ae={"filters_n": 256, "hidden_n": 64, "latent_n": 16,
                  "latent_step": 1 / 32},
              rvq={"stages": 2, "codebook_size": 64, "dim": 16,
                   "ema_decay": 0.99, "reseed_threshold": 1.0,
                   "commitment_weight": 0.25},
              warmup_steps=2),
         dict(clips=2, samples=256 * 12, ring=2, keep=3, within=8))
PER_LAYER = ("train.forward_ms", "train.backward_ms", "rvq.ema_ms")


def small_cell() -> harness.Cell:
    c = harness.Cell(NAME)
    c.config.update(SMALL[0])
    c.workload["params"].update(SMALL[1])
    return c


def execute(seed: int = 2**31 + 11, trace: bool = False) -> dict:
    torch.set_num_threads(1)
    return harness.execute(small_cell(), seed, 0.3, trace, "cpu",
                           time.perf_counter())


def test_the_cell_runs_correct_on_the_cpu():
    line = execute()
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 8 and line["failed"] == 0
    assert set(line["metrics"]) == {"audio_s_per_s.host", "setup_s"}
    assert set(line["checks"]) == {"failed", "loss", "grad", "update",
                                   "picks", "codebook", "err"}
    json.dumps(line)


def test_the_traced_line_reads_the_spans():
    line = execute(seed=2**33 + 5, trace=True)
    assert line["correct"] is True, line["checks"]
    # the program's spans are read; train.mfu finds no device on a CPU
    assert set(line["metrics"]) == set(PER_LAYER)
    assert all(m["value"] > 0 for m in line["metrics"].values())


def test_the_checked_steps_follow_the_seed():
    kind = small_cell().traffic()

    def kept(seed):
        return kind.kept_steps(harness.Run(small_cell(), seed, 1.0, False,
                                           "cpu", "", 0.0))

    assert kept(2**40 + 1) == kept(2**40 + 1)
    assert len(kept(2**40 + 1)) == 3 and max(kept(2**40 + 1)) < 8
    assert any(kept(2**40 + 1) != kept(s) for s in range(2, 9))


def test_the_reference_takes_the_programs_side_of_a_tie():
    """Row 0 lies a relative distance gap of ~1e-6 nearer codeword 0 than
    codeword 1, row 1 a gap of 0.75: where the program picked codeword 1,
    row 0 takes it and row 1 does not."""
    from portbench.reference.rvq_train import TIE, TrainReference

    ref = TrainReference(small_cell().config, "cpu")
    codebook = torch.tensor([[1.0, 0.0], [0.0, 1.0], [9.0, 9.0]],
                            dtype=torch.float64)
    rows = torch.tensor([[0.5 + 1e-7, 0.5], [1.0, 0.5]],
                        dtype=torch.float64)
    assert ref.nearest(rows, codebook)[0].tolist() == [0, 0]
    got, taken = ref.nearest(rows, codebook, torch.tensor([1, 1]))
    assert got.tolist() == [1, 0] and taken == 1
    assert 1e-6 < TIE < 0.75
    got, taken = ref.nearest(rows, codebook, torch.tensor([0, 2]))
    assert got.tolist() == [0, 0] and taken == 0


# -- faults planted under a run ---------------------------------------------

def argmax_search(monkeypatch):
    """Each stage picks the farthest codeword."""
    def nearest(residual, codebook):
        scores = residual.float() @ codebook.float().T
        sq = torch.sum(codebook.float() ** 2, dim=-1)
        idx = torch.argmax(sq[None, :] - 2.0 * scores, dim=-1)
        return idx, codebook[idx].to(residual.dtype)

    monkeypatch.setattr(rvq, "_nearest", nearest)


def no_commitment(monkeypatch):
    """The commitment term left out of the loss."""
    orig = rvq._quantize

    def quantize(cfg, codebooks, z):
        z_q, codes, sq = orig(cfg, codebooks, z)
        return z_q, codes, sq * 0.0

    monkeypatch.setattr(rvq, "_quantize", quantize)


class _Scaled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * 1.001


def scaled_synthesis_vjp(monkeypatch):
    """The synthesis's VJP scaled by 1.001."""
    orig = MDCT.inverse_transform
    monkeypatch.setattr(MDCT, "inverse_transform",
                        lambda self, f: orig(self, _Scaled.apply(f)))


def skipped_ema_stage(monkeypatch):
    """The last stage's EMA statistics left out."""
    orig = rvq._ema_stats

    def stats(cfg, codebooks, flat):
        counts, sums = orig(cfg, codebooks, flat)
        counts[-1], sums[-1] = 0.0, 0.0
        return counts, sums

    monkeypatch.setattr(rvq, "_ema_stats", stats)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """t rounded to TF32 (10 mantissa bits, to nearest even), with the
    identity's gradient."""
    m, e = torch.frexp(t.detach())
    r = torch.ldexp(torch.round(m * 2048.0) / 2048.0, e)
    return t + (r - t).detach()


def tf32_products(monkeypatch):
    """TF32 products in ``_dct.matmul``: the float32 operands rounded to
    TF32 as the tensor cores read them (float32 sums)."""
    orig = _dct.matmul

    def matmul(a, b, precision):
        if (a.dtype, b.dtype) == (torch.float32,) * 2 and precision in (
                "highest", "high"):
            a, b = _tf32(a), _tf32(b)
        return orig(a, b, precision)

    monkeypatch.setattr(_dct, "matmul", matmul)


FAULTS = {"argmax": argmax_search, "no-commitment": no_commitment,
          "synthesis-vjp-1.001": scaled_synthesis_vjp,
          "ema-stage-skipped": skipped_ema_stage,
          "tf32-products": tf32_products}


@pytest.mark.parametrize("plant", list(FAULTS.values()), ids=list(FAULTS))
def test_a_broken_step_is_not_correct(monkeypatch, plant):
    plant(monkeypatch)
    line = execute()
    assert line["correct"] is False, line["checks"]


# -- readers ------------------------------------------------------------------

def view(summary, ops=1):
    outcome = harness.Outcome(1, 0, {}, [], summary=summary, ops=ops)
    return harness.TraceView(harness.Cell(NAME), outcome)


def summary(keys=None, device=(("split_gemm_kernel<6>", 0, 100),)):
    return {"device": list(device), "host": [], "keys": keys or {},
            "window": (0, 2_000_000)}


@pytest.mark.parametrize("metric, span", [
    ("train.forward_ms", "train.forward"),
    ("train.backward_ms", "train.backward"),
    ("rvq.ema_ms", "rvq.ema")])
def test_span_readers(metric, span):
    read = harness.Cell(NAME).reader(metric).read
    # (count, self us, total us): 4 steps, 10 ms in all
    keys = {span: [4, 100.0, 10_000.0], "rvq.search": [4, 0.0, 99_000.0]}
    assert read(view(summary(keys))) == pytest.approx(2.5)
    assert read(view(summary({"rvq.search": [4, 0.0, 9.0]}))) is None


def test_the_step_is_183_gflop():
    """The count from shapes: the MDCT's analysis, synthesis and
    VJP 86.8, the dense layers 77.7, the searches 14.5, Bark ~3.7."""
    cell = harness.Cell(NAME)
    parts = roofline_train.step_flops(cell.config, cell.workload["params"])
    m, n, h, z = 32 * 431, 1024, 512, 64
    assert parts["mdct"] == pytest.approx(3 * 2.0 * 32 * 431 * n * n)
    forward = 2.0 * m * (2 * n * h + 2 * h * z)
    assert parts["dense"] == pytest.approx(3 * forward - 2.0 * m * n * h)
    assert parts["search"] == pytest.approx(8 * 2.0 * m * 1024 * 64)
    assert sum(parts.values()) / 1e9 == pytest.approx(182.7, abs=0.05)


def test_mfu():
    read = harness.Cell(NAME).reader("train.mfu").read
    cell = harness.Cell(NAME)
    flops = sum(roofline_train.step_flops(cell.config,
                                          cell.workload["params"]).values())
    # 160 steps in a 2 s window
    want = 100.0 * flops * 160 / (2.0 * roofline.PEAK_BF16_FLOPS)
    assert read(view(summary(), ops=160)) == pytest.approx(want)
    assert 1.0 < want < 2.0
    assert read(view(summary(device=()), ops=160)) is None


@pytest.mark.cuda
def test_the_control_fails_at_the_small_size():
    if not torch.cuda.is_available():
        pytest.skip("TF32 products need the card")
    from portbench.reference.codec import Reference

    cell = small_cell()
    limits = cell.workload["limits"]
    for seed in (1, 2, 3):
        run = harness.Run(cell, seed, 30.0, False, "cuda", "", 0.0)
        control = Reference(cell.config, "cuda", torch.float32, tf32=True)
        got = cell.traffic().control(run, control)
        assert any(got[k] > limits[k] for k in limits), got
