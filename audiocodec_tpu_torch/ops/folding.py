"""Diamond fold / unfold of the MDCT polyphase filter bank.

The numpy float64 builders are copies of ``audiocodec_tpu/ops/folding.py``
(the port must not import the JAX package); :func:`fold` and :func:`unfold`
are its tensor functions in torch, :func:`fold_t` the transposed fold of the
synthesis VJP and :func:`unfold_t` the transposed unfold of the analysis
VJP. See that module for the derivation.

  analysis   folded[n, k]   = wa_r[k]*x[n-1, h-1-k] + wb[k]*x[n-1, h+k]   (k < h)
             folded[n, h+j] = wc[j]*x[n, j]        - ffr[j]*x[n, N-1-j]  (j < h)

  synthesis  out[n, k]   = p[h-1-k]*z[n, h-1-k] + r[k]*z[n-1, h+k]       (k < h)
             out[n, h+j] = q[j]*z[n, j]         + s_r[j]*z[n-1, N-1-j]   (j < h)

Each product and each sum rounds to the tensor's dtype on its own (torch
runs them as separate elementwise ops), which is the rounding the CUDA
kernels in ``csrc/mdct_kernels.cu`` reproduce.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from audiocodec_tpu_torch.ops import windows as _windows


@dataclasses.dataclass(frozen=True)
class FoldCoefficients:
    """Per-sample fold/unfold weights, each of shape [N/2], float64."""

    wa_r: np.ndarray
    wb: np.ndarray
    wc: np.ndarray
    ffr: np.ndarray
    p: np.ndarray
    q: np.ndarray
    r: np.ndarray
    s_r: np.ndarray


def make_fold_coefficients(filters_n: int, window_type) -> FoldCoefficients:
    """Build analysis + synthesis fold weights in float64 on the host."""
    w = _windows.window_coefficients(filters_n, window_type)
    ff = _windows.window_completion(w, filters_n)
    h = filters_n // 2
    i = np.arange(h)

    det = -w[i] * ff[h - 1 - i] - w[filters_n + i] * w[filters_n - 1 - i]
    a = np.arange(h)
    p = -ff[a] / det[h - 1 - a]
    q = -w[filters_n + h - 1 - a] / det[h - 1 - a]
    r = -w[filters_n - 1 - i] / det[i]
    s = w[i] / det[i]

    return FoldCoefficients(
        wa_r=w[:h][::-1].copy(),
        wb=w[h:filters_n].copy(),
        wc=w[filters_n : filters_n + h].copy(),
        ffr=ff[::-1].copy(),
        p=p,
        q=q,
        r=r,
        s_r=s[::-1].copy(),
    )


def fold(x_blocks: torch.Tensor, wa_r, wb, wc, ffr) -> torch.Tensor:
    """Analysis fold: [..., blocks, N] -> [..., blocks+1, N].

    Out-of-range input blocks are zero, which gives the blocks+1 framing.
    """
    h = x_blocks.shape[-1] // 2
    xl = x_blocks[..., :h]
    xu = x_blocks[..., h:]
    to_next = torch.flip(xl, (-1,)) * wa_r + xu * wb
    to_cur = xl * wc - torch.flip(xu, (-1,)) * ffr
    zeros = torch.zeros_like(to_next[..., :1, :])
    lower = torch.cat([zeros, to_next], dim=-2)
    upper = torch.cat([to_cur, zeros], dim=-2)
    return torch.cat([lower, upper], dim=-1)


def fold_t(g_blocks: torch.Tensor, wa_r, wb, wc, ffr) -> torch.Tensor:
    """Transposed fold: [..., blocks+1, N] -> [..., blocks, N], the fold of
    the synthesis VJP read from the cotangent in its natural order,

      gf[n, k]   = wa_r[k]*g[n+1, N-1-k] + wb[k]*g[n+1, k]   (k < h)
      gf[n, h+j] = wc[j]*g[n, h+j]       - ffr[j]*g[n, h-1-j] (j < h)

    with the weights of ``cuda_mdct.unfold_vjp_weights``. Each element has
    :func:`fold`'s products and sum, with the same weight on the same side:
    ``fold(swap(flipT(g)))`` reversed in its blocks and cut by its first and
    last block, bit for bit (flipT reverses the blocks, swap exchanges the
    halves of the last axis)."""
    h = g_blocks.shape[-1] // 2
    nxt, cur = g_blocks[..., 1:, :], g_blocks[..., :-1, :]
    lower = torch.flip(nxt[..., h:], (-1,)) * wa_r + nxt[..., :h] * wb
    upper = cur[..., h:] * wc - torch.flip(cur[..., :h], (-1,)) * ffr
    return torch.cat([lower, upper], dim=-1)


def unfold(z_blocks: torch.Tensor, p, q, r, s_r) -> torch.Tensor:
    """Synthesis unfold: [..., blocks, N] -> [..., blocks+1, N]; the inverse
    of :func:`fold` up to the one-block boundary padding."""
    h = z_blocks.shape[-1] // 2
    zl = z_blocks[..., :h]
    zu = z_blocks[..., h:]
    cur_low = torch.flip(zl * p, (-1,))
    prev_low = zu * r
    cur_up = zl * q
    prev_up = torch.flip(zu, (-1,)) * s_r
    zeros = torch.zeros_like(zl[..., :1, :])
    low = torch.cat([cur_low, zeros], dim=-2) + torch.cat(
        [zeros, prev_low], dim=-2
    )
    up = torch.cat([cur_up, zeros], dim=-2) + torch.cat(
        [zeros, prev_up], dim=-2
    )
    return torch.cat([low, up], dim=-1)


def unfold_t(z_blocks: torch.Tensor, p, q, r, s_r) -> torch.Tensor:
    """Transposed unfold: [..., blocks+1, N] -> [..., blocks, N], the
    overlap scatter of the analysis VJP read from its product zg in natural
    order,

      dx[n, k]   = q[k]*zg[n, k]             + s_r[k]*zg[n+1, N-1-k]   (k < h)
      dx[n, h+j] = p[h-1-j]*zg[n, h-1-j]     + r[j]*zg[n+1, h+j]       (j < h)

    with the weights of ``cuda_mdct.fold_vjp_weights``. Each element has
    :func:`unfold`'s two products and its sum "current + previous", the
    same weight on the same value: ``unfold(flipT(zg))`` reversed in its
    blocks, cut by its first and last block and its halves exchanged, bit
    for bit (flipT reverses the blocks)."""
    h = z_blocks.shape[-1] // 2
    cur, nxt = z_blocks[..., :-1, :], z_blocks[..., 1:, :]
    low = cur[..., :h] * q + torch.flip(nxt[..., h:], (-1,)) * s_r
    up = torch.flip(cur[..., :h] * p, (-1,)) + nxt[..., h:] * r
    return torch.cat([low, up], dim=-1)


def filter_window_matrix(filters_n: int, window_type) -> np.ndarray:
    """Dense diamond folding matrix F, [N, N] float64."""
    w = _windows.window_coefficients(filters_n, window_type)
    ff = _windows.window_completion(w, filters_n)
    h = filters_n // 2
    F = np.zeros((filters_n, filters_n), dtype=np.float64)
    i = np.arange(h)
    F[i, h - 1 - i] = w[i]
    F[h + i, i] = w[h + i]
    F[i, h + i] = w[filters_n + i]
    F[h + i, filters_n - 1 - i] = -ff[i]
    return F


def dense_fold_matrices(filters_n: int, window_type):
    """(H0, H1) with y[n] = x[n] @ H0 + x[n-1] @ H1, float64."""
    F = filter_window_matrix(filters_n, window_type)
    h = filters_n // 2
    H0 = F.copy()
    H0[:, :h] = 0.0
    H1 = F.copy()
    H1[:, h:] = 0.0
    return H0, H1


def dense_unfold_matrices(filters_n: int, window_type):
    """(G0, G1) with out[n] = z[n] @ G0 + z[n-1] @ G1, float64."""
    F = filter_window_matrix(filters_n, window_type)
    G = np.linalg.inv(F)
    h = filters_n // 2
    G0 = G.copy()
    G0[h:, :] = 0.0
    G1 = G.copy()
    G1[:h, :] = 0.0
    return G0, G1
