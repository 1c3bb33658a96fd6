"""Plain reference of one training step of the RVQ neural codec, in PyTorch.

Imports nothing of the program. Written from the models' published
description, over ``codec.py``'s analysis, masking threshold and synthesis
(used as they are):

* the spectral autoencoder: per-frame dense layers over the band axis of
  [B, T, N, C] frames (y = x W + b, W [fan_in, fan_out]); the encoder is
  dense, GELU (tanh approximation), dense, tanh; the decoder dense, GELU,
  dense;
* residual vector quantization (SoundStream, arXiv:2107.03312): the
  latent vectors of each frame and channel are the rows, in (clip, frame,
  channel) order; each of S stages picks the nearest of its K codewords to
  the residual by exact squared distances, sums of squared differences
  (ties to the lower index), and passes the residual less that codeword on;
  the quantized latent is the sum of the stages' codewords;
* the straight-through estimator (the quantized value forward, the
  identity backward) and the commitment term beta * mean((z - sg(q))^2)
  (VQ-VAE, arXiv:1711.00937);
* the loss: mean((synthesis(recon)[:, N:-N] - x)^2)
  + w_nmr * mean(((recon - spec) / max(threshold, floor))^2) + the
  commitment, the threshold that of the input's own spectrum;
* the gradients by autograd on those operations;
* Adam (Kingma & Ba, arXiv:1412.6980) with bias correction, written out:
  m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, p -= lr m^ / (sqrt(v^) +
  eps) with m^ = m / (1 - b1^t), v^ = v / (1 - b2^t);
* EMA k-means codebooks (VQ-VAE's appendix; SoundStream): each stage's
  assignment counts and residual sums decay into its EMA count and sum,
  the counts Laplace-smoothed by 1e-5 over the K codewords, the codeword
  the mean; a codeword whose EMA count falls below the reseed threshold
  takes the batch vector at a row drawn by ``torch.randint(0, M, (S, K))``.

Departures from the description, each to hold the program's step, not a
variant of it:

* the step starts from the program's own state (parameters, Adam's
  moments and step count, the codebooks and EMA statistics, the
  generator's state), so no error builds up across steps;
* the EMA step follows the Adam step and uses this step's forward latents
  and the codebooks the forward searched, as the program orders them;
* the reseed's rows come from a generator of the program's device set to
  the program's state: the same picks;
* at a tie the reference takes the program's side: where the codeword the
  program picked for a row (``follow``, its codes) lies within a relative
  distance gap of ``TIE`` of the nearest one, the row takes it. The
  program's latents are within ~1.1e-6 of their peak (float32; the
  control's TF32 products 3.2e-4), so its picks can differ only at such
  gaps; one pick taken the other way moves the loss by ~3e-6 and the
  gradients by ~1e-3 of their peak, and the check compares the
  arithmetic of the same picks.

Precision: ``dtype`` float64 is the reference; float32 with ``tf32`` on
is the control. Products run with TF32 off unless ``tf32``.
"""

from __future__ import annotations

import contextlib
import math

import torch

from portbench.reference.codec import Reference

PARAMS = ("enc_w1", "enc_b1", "enc_w2", "enc_b2", "dec_w1", "dec_b1",
          "dec_w2", "dec_b2")
LAPLACE = 1e-5
SEARCH_ROWS = 1024  # rows of one block of the exact distance search
# A tie: a runner-up within this relative distance gap of the nearest
# codeword. The program's latents are within 1.2e-6 of their peak, which
# moves a gap by up to ~4 |dz| / |z - c|: ~1e-4 for a codeword 0.1 away.
TIE = 1e-3


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 products on or off for the block, restored after it."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    before = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = on
    try:
        yield
    finally:
        for f, b in zip(flags, before):
            f.allow_tf32 = b


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU in its tanh approximation."""
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


class TrainReference:
    """One training step of a configuration (a ``configs/*.json`` dict with
    ``ae``, ``rvq``, ``optimizer``, ``nmr_weight`` and ``nmr_floor``) on
    ``device`` at ``dtype``."""

    def __init__(self, config: dict, device, dtype=torch.float64,
                 tf32: bool = False):
        self.codec = Reference(config, device, dtype, tf32)
        self.device, self.dtype, self.tf32 = self.codec.device, dtype, tf32
        self.n = int(config["filters_n"])
        rvq, opt = config["rvq"], config["optimizer"]
        self.stages = int(rvq["stages"])
        self.k = int(rvq["codebook_size"])
        self.dim = int(rvq["dim"])
        self.decay = float(rvq["ema_decay"])
        self.threshold = float(rvq["reseed_threshold"])
        self.beta = float(rvq["commitment_weight"])
        if opt["name"] != "adam":
            raise ValueError("the reference implements Adam")
        self.lr, self.eps = float(opt["lr"]), float(opt["eps"])
        self.b1, self.b2 = (float(b) for b in opt["betas"])
        self.nmr_weight = float(config["nmr_weight"])
        self.nmr_floor = float(config["nmr_floor"])

    def _t(self, a: torch.Tensor) -> torch.Tensor:
        return a.detach().to(self.device, self.dtype)

    # -- the autoencoder --------------------------------------------------

    def dense(self, x, w, b):
        """[B, T, K, C] frames -> [B, T, H, C]: x W + b on each frame."""
        return (self.codec._mm(x.transpose(2, 3), w).transpose(2, 3)
                + b[None, None, :, None])

    def encode(self, p, spec):
        h = gelu(self.dense(spec, p["enc_w1"], p["enc_b1"]))
        return torch.tanh(self.dense(h, p["enc_w2"], p["enc_b2"]))

    def decode(self, p, z):
        h = gelu(self.dense(z, p["dec_w1"], p["dec_b1"]))
        return self.dense(h, p["dec_w2"], p["dec_b2"])

    # -- the quantizer ----------------------------------------------------

    def nearest(self, r: torch.Tensor, codebook: torch.Tensor, follow=None):
        """(the index of each row's nearest codeword [M] by sums of squared
        differences (blocks of rows, so memory stays bounded), the rows
        taken the program's way): where ``follow`` [M] (the program's
        picks) names a codeword within a relative gap of ``TIE`` of the
        nearest, the row takes it."""
        out, taken = [], 0
        for i in range(0, r.shape[0], SEARCH_ROWS):
            d = ((r[i:i + SEARCH_ROWS, None, :] - codebook[None]) ** 2).sum(-1)
            best = torch.argmin(d, dim=1)
            if follow is not None:
                f = follow[i:i + SEARCH_ROWS].to(best.device)
                d1 = d.gather(1, best[:, None])[:, 0]
                df = d.gather(1, f[:, None])[:, 0]
                tie = (df - d1 <= TIE * df) & (f != best)
                best = torch.where(tie, f, best)
                taken += int(tie.sum())
            out.append(best)
        return torch.cat(out), taken

    def search(self, flat: torch.Tensor, codebooks: torch.Tensor,
               follow=None):
        """-> (indices [S, M], each stage's incoming residual [S, M, D],
        the quantized rows: the sum of the picked codewords [M, D], the
        rows taken the program's way at a tie); ``follow`` the program's
        picks [S, M] or None."""
        residual, picks, residuals = flat, [], []
        quant = torch.zeros_like(flat)
        taken = 0
        for s, codebook in enumerate(codebooks):
            idx, n = self.nearest(residual, codebook,
                                  None if follow is None else follow[s])
            taken += n
            picks.append(idx)
            residuals.append(residual)
            quant = quant + codebook[idx]
            residual = residual - codebook[idx]
        return torch.stack(picks), torch.stack(residuals), quant, taken

    # -- the step ---------------------------------------------------------

    def step(self, before: dict, x: torch.Tensor, follow=None) -> dict:
        """One engaged step from the program's state ``before`` (keys
        ``params``, ``adam`` {name: (step, exp_avg, exp_avg_sq)}, ``rvq``
        {codebooks, ema_count, ema_sum}, ``generator`` (its state and
        device)) on the batch ``x`` [B, S, C], taking the program's side
        of a tie where its picks ``follow`` [S, M] (rows in (clip, frame,
        channel) order) show it -> the loss (a float), the gradients, the
        parameters after Adam, the batch's assignment counts [S, K], the
        RVQ state after the EMA step and the rows taken at a tie."""
        with tf32(self.tf32):
            return self._step(before, x, follow)

    def _step(self, before, x, follow):
        n, d = self.n, self.dim
        p = {k: self._t(before["params"][k]).requires_grad_()
             for k in PARAMS}
        codebooks = self._t(before["rvq"]["codebooks"])
        x = self._t(x)
        spec = self.codec.analysis(x)
        thr = self.codec.threshold(self.codec.bark_intensity(spec))
        z = self.encode(p, spec)
        b, t, _, c = z.shape
        rows = z.movedim(-1, -2).reshape(-1, d)  # (clip, frame, channel)
        flat = rows.detach()
        picks, residuals, quant, taken = self.search(flat, codebooks,
                                                     follow)
        z_q = (rows + (quant - rows).detach()).reshape(b, t, c, d).movedim(
            -1, -2)
        recon = self.decode(p, z_q)
        wave = self.codec.synthesis(recon)[:, n:-n]
        loss = (torch.mean((wave - x) ** 2)
                + self.nmr_weight * torch.mean(
                    ((recon - spec) / torch.clamp_min(thr, self.nmr_floor))
                    ** 2)
                + self.beta * torch.mean((rows - quant) ** 2))
        grads = dict(zip(PARAMS, torch.autograd.grad(
            loss, [p[k] for k in PARAMS])))
        params = {k: self.adam(p[k].detach(), grads[k], before["adam"][k])
                  for k in PARAMS}
        out = self.ema(before, flat, picks, residuals)
        out.update(loss=loss.item(), grads=grads, params=params,
                   ties_taken=taken)
        return out

    def adam(self, p, g, state):
        step, m, v = state
        t = step + 1
        m = self.b1 * (0.0 if m is None else self._t(m)) + (1 - self.b1) * g
        v = (self.b2 * (0.0 if v is None else self._t(v))
             + (1 - self.b2) * g * g)
        m_hat = m / (1 - self.b1 ** t)
        v_hat = v / (1 - self.b2 ** t)
        return p - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)

    def ema(self, before, flat, picks, residuals) -> dict:
        rvq = before["rvq"]
        counts = torch.stack([torch.bincount(i, minlength=self.k)
                              for i in picks]).to(self.dtype)
        sums = torch.zeros(self.stages, self.k, self.dim, dtype=self.dtype,
                           device=self.device)
        for s in range(self.stages):
            sums[s].index_add_(0, picks[s], residuals[s])
        count = (self.decay * self._t(rvq["ema_count"])
                 + (1 - self.decay) * counts)
        total = (self.decay * self._t(rvq["ema_sum"])
                 + (1 - self.decay) * sums)
        n = count.sum(-1, keepdim=True)
        smoothed = (count + LAPLACE) / (n + self.k * LAPLACE) * n
        means = total / smoothed[..., None]
        state, device = before["generator"]
        g = torch.Generator(device=device)
        g.set_state(state)
        rows = torch.randint(0, flat.shape[0], (self.stages, self.k),
                             generator=g, device=device).to(self.device)
        dead = (count < self.threshold)[..., None]
        return {"counts": counts, "ema_count": count, "ema_sum": total,
                "codebooks": torch.where(dead, flat[rows], means)}
