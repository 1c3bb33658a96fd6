"""Traffic kind ``train``: the RVQ neural codec's training step.

``rvq.make_train_step`` over ``Codec.create`` of the configuration, with
its ``ae``, ``rvq``, ``optimizer``, ``nmr_weight``, ``nmr_floor``,
``warmup_steps`` and ``remat``: engaged steps back to back, closed loop, on
batches already on the device, batch ``i % ring`` at step ``i`` of the
window. Set-up draws the parameters and codebooks from the seed and runs
the ``warmup_steps`` bypassed steps and two engaged ones. Parameters:
``clips`` and ``samples`` (a batch is [clips, samples, channels]),
``ring`` (distinct batches), ``keep`` (the steps checked, drawn from the
seed among the window's first ``within``; the window runs until they are
done). Only around those steps is the state copied: before, the
parameters, Adam's state, the RVQ state, the generator's and the program's
codes of the batch (``rvq.encode_discrete`` on that state: the side of a
tie the step's search takes); after, the loss, the gradients, the
parameters and the RVQ state. Each is held to the plain reference's step
from the same state (``reference/rvq_train.py``).
"""

from __future__ import annotations

import functools
import random

import torch

from portbench.lib import audio, harness, program
from portbench.reference.rvq_train import PARAMS, TrainReference

CHECKS = ("loss", "grad", "update", "picks", "codebook", "err")


def inputs(run):
    cfg, p = run.config, run.params
    return [audio.music(harness.sub_seed(run.seed, "train", j), p["clips"],
                        p["samples"], cfg["channels"], cfg["sample_rate"],
                        run.device)
            for j in range(p["ring"])]


class Trainer:
    """The program's model, optimizer and step, built from the seed."""

    def __init__(self, run):
        from audiocodec_tpu_torch.models import rvq, spectral_ae

        cfg = run.config
        self.rvq = rvq
        self.codec = program.codec(cfg, run.device)
        self.ae, self.cfg = spectral_ae.SpectralAE(**cfg["ae"]), rvq.RVQ(
            **cfg["rvq"])
        dtype = program.DTYPES[cfg["compute_dtype"]]
        init = audio.generator(harness.sub_seed(run.seed, "init"),
                               run.device)
        self.params = spectral_ae.init_params(init, self.ae, dtype,
                                              run.device)
        self.state = rvq.init_state(init, self.cfg, dtype, run.device)
        opt = cfg["optimizer"]
        if opt["name"] != "adam":
            raise harness.Failure(f"optimizer {opt['name']!r}")
        self.step_fn, factory = rvq.make_train_step(
            self.codec, self.ae, self.cfg, optimizer=functools.partial(
                torch.optim.Adam, lr=opt["lr"], betas=tuple(opt["betas"]),
                eps=opt["eps"]),
            remat=cfg["remat"], nmr_weight=cfg["nmr_weight"],
            nmr_floor=cfg["nmr_floor"], warmup_steps=cfg["warmup_steps"])
        self.opt = factory(list(self.params.values()))
        self.generator = audio.generator(
            harness.sub_seed(run.seed, "reseed"), run.device)
        self.steps = 0  # steps taken, set-up's included

    def reset_counts(self) -> None:
        if hasattr(self.rvq, "reset_counts"):
            self.rvq.reset_counts()

    def counts(self) -> dict:
        """The program's steps, searches and reseeded codewords, where it
        counts them."""
        return self.rvq.counts() if hasattr(self.rvq, "counts") else {}

    def step(self, x):
        loss = self.step_fn(self.params, self.state, self.opt, x,
                            self.generator, self.steps)
        self.steps += 1
        return loss

    def before(self, x) -> dict:
        """Copies of what a step on ``x`` starts from, and the program's
        picks of its rows [S, M]."""
        adam = {}
        for name, p in self.params.items():
            s = self.opt.state.get(p, {})
            adam[name] = (float(s["step"]) if "step" in s else 0.0,
                          _copy(s.get("exp_avg")),
                          _copy(s.get("exp_avg_sq")))
        codes = self.rvq.encode_discrete(self.codec, self.ae, self.cfg,
                                         self.params, self.state, x)
        return {"params": _copies(self.params), "adam": adam,
                "rvq": _copies(self.state),
                "codes": codes.reshape(-1, self.cfg.stages).T.long(),
                "generator": (self.generator.get_state(),
                              self.generator.device)}

    def after(self, loss) -> dict:
        """Copies of what a step gave."""
        return {"loss": loss.clone(),
                "grads": {k: _copy(p.grad) for k, p in self.params.items()},
                "params": _copies(self.params), "rvq": _copies(self.state)}


def _copy(t):
    return None if t is None else t.detach().clone()


def _copies(d: dict) -> dict:
    return {k: _copy(v) for k, v in d.items()}


def kept_steps(run) -> list:
    p = run.params
    rng = random.Random(harness.sub_seed(run.seed, "keep"))
    return sorted(rng.sample(range(p["within"]), p["keep"]))


def run(run):
    cfg, p = run.config, run.params
    ring = inputs(run)
    trainer = Trainer(run)
    trainer.reset_counts()
    for i in range(cfg["warmup_steps"] + 2):  # bypassed, then engaged
        trainer.step(ring[i % len(ring)])
    kept = kept_steps(run)
    records, losses = [], []
    steps = 0
    with run.window() as w:
        while steps <= kept[-1] or not w.done():
            x = ring[steps % len(ring)]
            before = trainer.before(x) if steps in kept else None
            loss = trainer.step(x)
            if before is not None:
                records.append((steps, before, trainer.after(loss)))
            if steps == 0:
                losses.append(loss)
            steps += 1
    losses.append(loss)
    memory = run.memory_peak()
    counts = trainer.counts()
    run.log(f"steps {steps} in the window; the program's counts since "
            f"set-up began {counts}; loss {losses[0].item():.6g} at the "
            f"window's start, {losses[-1].item():.6g} at its end")
    del trainer
    clip_s = p["samples"] / cfg["sample_rate"]
    rate = steps * p["clips"] * clip_s / w.seconds
    checks = check(run, ring, records)
    return harness.Outcome(
        attempted=steps, failed=0, end_to_end={"audio_s_per_s": rate},
        checks=list(checks.items()), summary=w.summary, ops=steps,
        counters=counts, memory_peak=memory,
        device=harness.device_info(run.device))


def picks(cfg: dict, before: dict, after: dict) -> torch.Tensor:
    """The program's assignment counts of the step [S, K] (float64), read
    from its EMA counts: (after - decay * before) / (1 - decay)."""
    decay = float(cfg["rvq"]["ema_decay"])
    count = [a["rvq"]["ema_count"].detach().to(torch.float64)
             for a in (before, after)]
    return torch.round((count[1] - decay * count[0]) / (1.0 - decay))


def compare(cfg: dict, before: dict, after: dict, ref: dict) -> dict:
    """One step's numbers: the program's ``after`` against the reference's
    step ``ref`` from the same ``before``.

    ``loss`` the relative loss error; ``grad`` the largest max-abs
    gradient error over that gradient's peak; ``update`` the error energy
    of the parameters' step over the reference's step; ``picks`` the share
    of the batch's codeword assignments that differ (:func:`picks`);
    ``codebook`` the updated codebooks' error energy over the reference's;
    ``err`` the updated parameters' error energy over the reference's."""
    f64 = torch.float64

    def t(a):
        return a.detach().to(ref["codebooks"].device, f64)

    loss = float(after["loss"])
    out = {"loss": abs(loss - ref["loss"]) / abs(ref["loss"])}
    out["grad"] = max(
        (t(after["grads"][k]) - ref["grads"][k]).abs().max().item()
        / ref["grads"][k].abs().max().item() for k in PARAMS)
    num = den = e_num = e_den = 0.0
    for k in PARAMS:
        p0 = t(before["params"][k])
        step_p, step_r = t(after["params"][k]) - p0, ref["params"][k] - p0
        num += ((step_p - step_r) ** 2).sum().item()
        den += (step_r ** 2).sum().item()
        e_num += ((t(after["params"][k]) - ref["params"][k]) ** 2).sum().item()
        e_den += (ref["params"][k] ** 2).sum().item()
    out["update"] = num / den
    counts = t(picks(cfg, before, after))
    stages, rows = ref["counts"].shape[0], ref["counts"][0].sum().item()
    out["picks"] = ((counts - ref["counts"]).abs().sum().item()
                    / (2.0 * rows * stages))
    cb_p, cb_r = t(after["rvq"]["codebooks"]), ref["codebooks"]
    out["codebook"] = ((cb_p - cb_r) ** 2).sum().item() / (
        cb_r ** 2).sum().item()
    out["err"] = e_num / e_den
    return out


def check(run, ring, records) -> dict:
    """The largest of each number over the checked steps."""
    ref = TrainReference(run.config, run.device)
    worst = dict.fromkeys(CHECKS, 0.0)
    for i, before, after in records:
        want = ref.step(before, ring[i % len(ring)], before["codes"])
        numbers = compare(run.config, before, after, want)
        run.log(f"step {i}: " + ", ".join(f"{k} {v:.3g}" for k, v in
                                          numbers.items())
                + f"; ties taken the program's way {want['ties_taken']}")
        for k, v in numbers.items():
            worst[k] = max(worst[k], v)
    if not records:
        return dict.fromkeys(CHECKS, float("nan"))
    return worst


def control(run, ref) -> dict:
    """The checks' numbers with the training reference at ``ref``'s
    precision (the plain reference at a lower precision) in the program's
    place: the program runs the steps up to each checked one, and the
    control takes that step from the program's state."""
    cfg = run.config
    ring = inputs(run)
    trainer = Trainer(run)
    for i in range(cfg["warmup_steps"] + 2):
        trainer.step(ring[i % len(ring)])
    lower = TrainReference(cfg, ref.device, ref.dtype, ref.tf32)
    kept, records = kept_steps(run), []
    for steps in range(kept[-1] + 1):
        x = ring[steps % len(ring)]
        before = trainer.before(x) if steps in kept else None
        trainer.step(x)
        if before is not None:
            got = lower.step(before, x)
            after = {"loss": torch.tensor(got["loss"]),
                     "grads": got["grads"], "params": got["params"],
                     "rvq": {k: got[k] for k in ("codebooks", "ema_count",
                                                 "ema_sum")}}
            records.append((steps, before, after))
    return check(run, ring, records)
