"""The VJPs of the port's MDCT kernels and ``quantize_ste``, on the CPU.

Each of the four ``torch.autograd.Function``s of ``ops/cuda_mdct.py`` (on a
CPU tensor: the other direction's plain version with the remapped
residents) is held to ``torch.autograd`` through its plain forward version
in float64, to ``gradcheck``, and to ``jax.grad`` through the JAX Pallas
kernels in interpret mode at the tolerances of
tests/test_pallas.py::TestPallasGradients (2e-5 analysis, 2e-3 synthesis).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from audiocodec_tpu import quantize as jax_quantize
from audiocodec_tpu.mdct import MDCT as JaxMDCT
from audiocodec_tpu_torch import MDCT, quantize
from audiocodec_tpu_torch.ops import cuda_mdct, dct, folding, radix

torch.set_num_threads(1)

KERNELS = ("fold_matmul", "matmul_scatter", "radix_fold_matmul",
           "radix_matmul_scatter")


def _residents(name, n, dtype=torch.float64):
    """(forward args after the signal, VJP args after the cotangent) of the
    kernel ``name`` at ``highest``, made on the host in float64."""
    c = folding.make_fold_coefficients(n, "vorbis")
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)  # noqa
    fold_w = tuple(t(getattr(c, k)) for k in ("wa_r", "wb", "wc", "ffr"))
    unfold_w = tuple(t(getattr(c, k)) for k in ("p", "q", "r", "s_r"))
    m64, s = dct.dct4_matrix(n), math.sqrt(4.0 * n)
    analysis = name.endswith("fold_matmul")
    w = fold_w if analysis else unfold_w
    vw = (cuda_mdct.fold_vjp_weights(*w) if analysis
          else cuda_mdct.unfold_vjp_weights(*w))
    if name.startswith("radix"):
        params = radix.forward_params if analysis else radix.inverse_params
        rot, mats = (t(a) for a in params(n))
        vjp = (cuda_mdct.radix_fold_vjp_residents if analysis
               else cuda_mdct.radix_unfold_vjp_residents)(rot, mats)
        return (*w, rot, mats, "highest"), (*vw, *vjp, "highest")
    mat = t(m64 / s if analysis else m64 * s)
    vmat = (cuda_mdct.fold_vjp_matrix if analysis
            else cuda_mdct.unfold_vjp_matrix)(mat)
    return (*w, mat, "highest"), (*vw, vmat, "highest")


def flip_route(g, forward, args):
    """The synthesis VJP through the analysis ``forward`` composed with
    torch flips: ``forward`` on the block-reversed cotangent with its lane
    halves exchanged, reversed back and cut by its first and last frame
    (T+2 frames out, T kept). The oracle of the transposed fold."""
    h = g.shape[-1] // 2
    gr = torch.flip(g, (1,))
    gr = torch.cat([gr[..., h:], gr[..., :h]], dim=-1).contiguous()
    return torch.flip(forward(gr, *args), (1,))[:, 1:-1]


def scatter_flip_route(g, synthesis, args):
    """The analysis VJP through the synthesis ``synthesis`` composed with
    torch flips: ``synthesis`` on the block-reversed cotangent (T+2 frames
    out), reversed back, cut by its first and last frame and its lane
    halves exchanged. The oracle of the transposed scatter."""
    h = g.shape[-1] // 2
    out = torch.flip(synthesis(torch.flip(g, (1,)).contiguous(), *args),
                     (1,))[:, 1:-1]
    return torch.cat([out[..., h:], out[..., :h]], dim=-1)


SYNTHESIS_VJP_TIERS = [  # (compute dtype, fast_bf16, precision)
    ("float32", False, "highest"),
    ("float32", False, "high"),
    ("float32", False, "int8"),  # straight-through: default, dequantized
    ("bfloat16", True, "default"),
]


def _cotangent(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("frames", [2, 9, 130])
@pytest.mark.parametrize("n", [256, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_t_is_the_flipped_fold(dtype, n, frames):
    """folding.fold_t of the cotangent (T+1 frames) equals the fold of its
    reversed, lane-swapped blocks, reversed back and cut to T frames, bit
    for bit, with the synthesis VJP's weights in the working dtype."""
    m = MDCT(n, compute_dtype=dtype, fast_bf16=dtype == "bfloat16",
             use_kernel=True, device="cpu")
    weights = m.vjp_args("inverse")[:4]
    assert {w.dtype for w in weights} == {getattr(torch, dtype)}
    g = _cotangent((3, frames, n), dtype, frames)
    got = folding.fold_t(g, *weights)
    assert got.shape == (3, frames - 1, n) and got.dtype == g.dtype
    assert torch.equal(got, flip_route(g, folding.fold, weights))


@pytest.mark.parametrize("frames", [2, 9, 130])
@pytest.mark.parametrize("n", [256, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unfold_t_is_the_flipped_unfold(dtype, n, frames):
    """folding.unfold_t of the cotangent's product (T+1 frames) equals the
    unfold of its reversed blocks, reversed back, cut to T frames and its
    lane halves exchanged, bit for bit, with the analysis VJP's weights in
    the working dtype."""
    m = MDCT(n, compute_dtype=dtype, fast_bf16=dtype == "bfloat16",
             use_kernel=True, device="cpu")
    weights = m.vjp_args("forward")[:4]
    assert {w.dtype for w in weights} == {getattr(torch, dtype)}
    z = _cotangent((3, frames, n), dtype, frames)
    got = folding.unfold_t(z, *weights)
    assert got.shape == (3, frames - 1, n) and got.dtype == z.dtype
    assert torch.equal(got, scatter_flip_route(z, folding.unfold, weights))


@pytest.mark.parametrize("frames", [2, 9, 130])
@pytest.mark.parametrize("n", [256, 512])
@pytest.mark.parametrize("dtype,fast,precision", SYNTHESIS_VJP_TIERS)
def test_fold_matmul_vjp_is_the_flip_route(dtype, fast, precision, n,
                                           frames):
    """The mono analysis VJP's plain version (the product, then the
    transposed scatter), and the wrapper on a CPU tensor, equal the flip
    route through the synthesis's plain version bit for bit."""
    m = MDCT(n, compute_dtype=dtype, fast_bf16=fast, use_kernel=True,
             dct_precision=precision, device="cpu")
    vjp_args = m.vjp_args("forward")
    g = _cotangent((3, frames, n), dtype, 2 * n + frames)
    want = scatter_flip_route(g, cuda_mdct.matmul_scatter_reference,
                              vjp_args[:-1])
    got = cuda_mdct.fold_matmul_vjp_reference(g, *vjp_args)
    assert got.shape == (3, frames - 1, n) and got.dtype == g.dtype
    assert torch.equal(got, want)
    cuda_mdct.reset_launch_counts()
    assert torch.equal(cuda_mdct.fold_matmul_vjp(g, *vjp_args), want)
    assert set(cuda_mdct.launch_counts().values()) == {0}


@pytest.mark.parametrize("frames", [2, 9, 130])
@pytest.mark.parametrize("n", [256, 512])
@pytest.mark.parametrize("dtype,fast,precision", SYNTHESIS_VJP_TIERS)
def test_matmul_scatter_vjp_is_the_flip_route(dtype, fast, precision, n,
                                              frames):
    """The mono synthesis VJP's plain version (the transposed fold, then
    the product), and the wrapper on a CPU tensor, equal the flip route
    through the analysis's plain version bit for bit."""
    m = MDCT(n, compute_dtype=dtype, fast_bf16=fast, use_kernel=True,
             dct_precision=precision, device="cpu")
    vjp_args = m.vjp_args("inverse")
    g = _cotangent((3, frames, n), dtype, n + frames)
    want = flip_route(g, cuda_mdct.fold_matmul_reference, vjp_args[:-1])
    got = cuda_mdct.matmul_scatter_vjp_reference(g, *vjp_args)
    assert got.shape == (3, frames - 1, n) and got.dtype == g.dtype
    assert torch.equal(got, want)
    cuda_mdct.reset_launch_counts()
    assert torch.equal(cuda_mdct.matmul_scatter_vjp(g, *vjp_args), want)
    assert set(cuda_mdct.launch_counts().values()) == {0}


@pytest.mark.parametrize("n", [256, 512])
@pytest.mark.parametrize("name", KERNELS)
def test_function_matches_autograd_through_the_plain_version(name, n):
    args, vjp_args = _residents(name, n)
    rng = np.random.default_rng(n)
    x = torch.tensor(rng.uniform(-1, 1, (2, 5, n)), requires_grad=True)
    g = torch.tensor(rng.uniform(-1, 1, (2, 6, n)))
    cuda_mdct.reset_launch_counts()
    y = cuda_mdct.FUNCTIONS[name].apply(x, args, vjp_args)
    plain = getattr(cuda_mdct, f"{name}_reference")
    assert torch.equal(y, plain(x.detach(), *args))
    got, = torch.autograd.grad(y, x, g)
    want, = torch.autograd.grad(plain(x, *args), x, g)
    assert got.shape == x.shape
    assert float((got - want).abs().max()) <= 1e-10 * float(want.abs().max())
    assert set(cuda_mdct.launch_counts().values()) == {0}


@pytest.mark.parametrize("name", KERNELS)
def test_function_passes_gradcheck(name):
    args, vjp_args = _residents(name, 16)
    x = torch.rand(1, 3, 16, dtype=torch.float64, requires_grad=True)
    fn = lambda x: cuda_mdct.FUNCTIONS[name].apply(x, args, vjp_args)  # noqa
    assert torch.autograd.gradcheck(fn, (x,))


def test_function_refuses_trained_constants():
    args, vjp_args = _residents("fold_matmul", 256)
    x = torch.rand(1, 2, 256, dtype=torch.float64, requires_grad=True)
    w = args[0].clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="no gradient"):
        cuda_mdct.FUNCTIONS["fold_matmul"].apply(x, (w, *args[1:]), vjp_args)
    counts = cuda_mdct.launch_counts()
    assert sorted(counts) == sorted(KERNELS + tuple(f"{k}_vjp"
                                                    for k in KERNELS))


def _jax_grads(jm, tm, direction, seed):
    """(JAX grad through its Pallas kernels in interpret mode, the port's
    grad through its Functions) of sum(out**2), in float64 numpy."""
    rng = np.random.default_rng(seed)
    n = tm.filters_n
    if direction == "forward":
        a = rng.uniform(-1, 1, (1, 5 * n, 1)).astype(np.float32)
        jf, tf = jm.transform, tm.transform
    else:
        a = rng.uniform(-0.5, 0.5, (1, 5, n, 1)).astype(np.float32)
        jf, tf = jm.inverse_transform, tm.inverse_transform
    with pltpu.force_tpu_interpret_mode():
        gj = jax.grad(lambda v: jnp.sum(jf(v) ** 2))(jnp.asarray(a))
    xt = torch.from_numpy(a).requires_grad_()
    gt, = torch.autograd.grad((tf(xt) ** 2).sum(), xt)
    return np.asarray(gj, dtype=np.float64), gt.double().numpy()


@pytest.mark.parametrize("direction,atol", [("forward", 2e-5),
                                            ("inverse", 2e-3)])
@pytest.mark.parametrize("design", ["mono", "radix"])
def test_vjp_matches_jax_pallas(design, direction, atol):
    n = 256
    jm = JaxMDCT.create(n, use_pallas=True, pallas_kernel=design)
    tm = MDCT(n, use_kernel=True, kernel_design=design, device="cpu")
    gj, gt = _jax_grads(jm, tm, direction, 9 if direction == "forward" else 10)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=atol)


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_int8_backward_is_straight_through(direction):
    """At int8 the VJP is the ``default`` tier's on the dequantized matrix:
    the residents are that matrix's, and the gradient is the autograd
    gradient through the ``default`` plain forward on it, to that tier's
    error (its operands rounded to bf16 once on each side)."""
    n = 256
    m = MDCT(n, use_kernel=True, dct_precision="int8", device="cpu")
    fwd = direction == "forward"
    d = "fwd" if fwd else "inv"
    deq = cuda_mdct.dequantized(getattr(m, f"kernel_q_{d}"),
                                m.int8_scale[0 if fwd else 1])
    assert torch.equal(deq, getattr(m, f"kernel_q_{d}").float()
                       * np.float32(m.int8_scale[0 if fwd else 1] * 127.0))
    args = m.kernel_args(direction)
    weights = args[:4]
    remap = cuda_mdct.fold_vjp_matrix if fwd else cuda_mdct.unfold_vjp_matrix
    vjp = m.vjp_args(direction)
    assert vjp[5] == "default" and torch.equal(vjp[4], remap(deq))
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.uniform(-0.5, 0.5, (2, 5, n)), dtype=torch.float32,
                     requires_grad=True)
    g = torch.tensor(rng.uniform(-1, 1, (2, 6, n)), dtype=torch.float32)
    name = "fold_matmul" if fwd else "matmul_scatter"
    got, = torch.autograd.grad(
        cuda_mdct.FUNCTIONS[name].apply(x, args, vjp), x, g)
    plain = getattr(cuda_mdct, f"{name}_reference")
    want, = torch.autograd.grad(plain(x, *weights, deq, "default"), x, g)
    # the cotangent rounded to bf16 before the product on one side, the
    # product's gradient after it on the other: two bf16 ulps of the peak
    peak = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2.0**-7 * peak


@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_int8_vjp_matches_jax_pallas(direction):
    n = 256
    jm = JaxMDCT.create(n, use_pallas=True, dct_precision="int8",
                        pallas_kernel="mono")
    tm = MDCT(n, use_kernel=True, dct_precision="int8", device="cpu")
    gj, gt = _jax_grads(jm, tm, direction, 4)
    # both run the default tier (bf16 operands, float32 sums) on the same
    # dequantized matrix: they differ by the sums' order
    np.testing.assert_allclose(gt, gj, rtol=0,
                               atol=1e-5 * np.abs(gj).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_ste_forward_matches_jax(dtype):
    rng = np.random.default_rng(4)
    x = rng.normal(scale=0.1, size=(2, 3, 64, 1)).astype(np.float32)
    thr = rng.uniform(1e-3, 0.1, size=x.shape).astype(np.float32)
    want = jax_quantize.quantize_ste(jnp.asarray(x, getattr(jnp, dtype)),
                                     jnp.asarray(thr, getattr(jnp, dtype)))
    got = quantize.quantize_ste(torch.from_numpy(x).to(getattr(torch, dtype)),
                                torch.from_numpy(thr).to(getattr(torch,
                                                                 dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.double().numpy(),
                                  np.asarray(want, dtype=np.float64))


def test_quantize_ste_gradient():
    """Straight-through: the amplitudes' gradient is the cotangent, the
    threshold's zero (tests/test_codec.py::test_ste_gradient)."""
    amps = torch.tensor([[0.5, -0.3]], requires_grad=True)
    thr = torch.tensor([[0.1, 0.1]], requires_grad=True)
    ga, gt = torch.autograd.grad(
        (quantize.quantize_ste(amps, thr) ** 2).sum(), (amps, thr))
    assert bool(torch.isfinite(ga).all()) and bool((gt == 0.0).all())
    coded = quantize.quantize_ste(amps.detach(), thr.detach())
    assert torch.equal(ga, 2 * coded)
