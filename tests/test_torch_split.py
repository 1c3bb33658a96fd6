"""The split tiers (``highest``, ``high``) of the mono MDCT kernels, on the
CPU: the three-way bf16 split of a float32 value, a plain torch emulation of
the kernels' six- and three-pass products held against float64 and against
the JAX package's Pallas kernels at ``precision="high"`` (interpret mode),
and the matrices' operand forms at these tiers."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from audiocodec_tpu.mdct import MDCT as JaxMDCT
from audiocodec_tpu_torch import MDCT
from audiocodec_tpu_torch.ops import cuda_mdct, dct, folding

torch.set_num_threads(1)

# (A plane, B plane) of each pass, small terms first, as split_gemm_kernel
# runs them (csrc/mdct_kernels.cu pass_plane); three passes are the JAX
# kernel's `high` recipe (pallas_mdct.py _mxu)
PASSES = {6: [(1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0)],
          3: [(0, 1), (1, 0), (0, 0)]}
K_BLOCK = 64  # K of a kernel stage: one fresh float32 sum, then the total


def _bf16_rne(a: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 (held in float32) by round-to-nearest-even on the
    bits, independent of torch's cast."""
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _values():
    """Random float32 values of either sign over every exponent the split
    holds exactly (2^-110 .. bf16's largest), and edge values."""
    rng = np.random.default_rng(0)
    mant = rng.uniform(1.0, 2.0, 20000)
    expo = rng.integers(-110, 127, 20000)
    sign = rng.choice([-1.0, 1.0], 20000)
    rand = (sign * mant * np.exp2(expo)).astype(np.float32)
    edges = np.array([0.0, -0.0, 1.0, -1.0, 1.0 + 2.0**-23, 1.0 - 2.0**-24,
                      2.0**-110, -(2.0**-110), 3.3e38, -3.3e38, 1.0 + 2.0**-8,
                      1.0 + 2.0**-9, 1.0 + 2.0**-9 + 2.0**-23, 1e-30, 65504.0,
                      np.float32(np.pi), np.float32(-np.e)], dtype=np.float32)
    return np.concatenate([rand, edges])


def test_three_way_split_is_exact():
    a = torch.from_numpy(_values())
    planes = cuda_mdct.split_planes(a, 3)
    assert planes.shape == (3, a.numel()) and planes.dtype == torch.bfloat16
    p = planes.double()
    assert torch.equal(p[0] + p[1] + p[2], a.double())  # exact, in float64
    assert torch.equal(torch.signbit(planes[0]), torch.signbit(a))
    # each plane holds the bits the one before left: |a_(i+1)| <= 2^-8 |a_i|
    assert bool((p[1].abs() <= 2.0**-8 * p[0].abs()).all())
    assert bool((p[2].abs() <= 2.0**-8 * p[1].abs()).all())
    # two planes leave at most 2^-16 |a| out
    assert bool(((a.double() - p[0] - p[1]).abs()
                 <= 2.0**-16 * a.double().abs()).all())


def test_split_is_round_to_nearest_even_of_each_residual():
    """The planes are RNE casts of the exact float32 residuals, which the
    kernels' split3 (__float2bfloat16_rn, __fsub_rn) computes too."""
    a = _values()
    planes = cuda_mdct.split_planes(torch.from_numpy(a), 3).float().numpy()
    r = a
    for i in range(3):
        h = _bf16_rne(r)
        np.testing.assert_array_equal(planes[i], h)
        r = (r - h).astype(np.float32)
    assert not np.any(r)  # nothing left after three planes


def split_product(a, mat, passes):
    """a [..., K] @ mat [K, M] as split_gemm_kernel computes it: both
    operands as three bf16 planes, each K block of K_BLOCK a fresh float32
    sum of the passes' plane products (small terms first), added to a
    float32 total."""
    ap = cuda_mdct.split_planes(a, 3).float()
    bp = cuda_mdct.split_planes(mat, 3).float()
    total = torch.zeros(*a.shape[:-1], mat.shape[1])
    for k0 in range(0, a.shape[-1], K_BLOCK):
        ks = slice(k0, k0 + K_BLOCK)
        part = None
        for i, j in PASSES[passes]:
            term = ap[i][..., ks] @ bp[j][ks]
            part = term if part is None else part + term
        total = total + part
    return total


# each tier's max forward-MDCT error against float64 (the JAX package's
# ops/dct.py: ~8e-9 at `highest`, ~7e-7 at `high`, at N=1024), with the
# room N=256's larger peak needs
TIER_ERROR = {6: 1.5e-8, 3: 1e-6}


@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("passes", [6, 3])
def test_split_products_meet_the_tier_error(n, passes):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 8, n)).astype(np.float32))
    m = MDCT(n, use_kernel=True, device="cpu")
    coeffs = folding.make_fold_coefficients(n, "vorbis")
    w64 = [torch.as_tensor(getattr(coeffs, k))
           for k in ("wa_r", "wb", "wc", "ffr")]
    want = folding.fold(x.double(), *w64) @ torch.as_tensor(
        dct.dct4_matrix(n) / math.sqrt(4.0 * n))
    got = split_product(folding.fold(x, m.wa_r, m.wb, m.wc, m.ffr),
                        m.dct_mat_fwd, passes)
    err = float((got.double() - want).abs().max())
    assert err <= TIER_ERROR[passes], err
    if passes == 6:  # as close as the float32 product itself, or closer
        plain = cuda_mdct.fold_matmul_reference(x, *m.kernel_args("forward"))
        assert err <= float((plain.double() - want).abs().max())


def test_three_passes_miss_the_high_synthesis_tolerance():
    """Why `high` runs six passes (csrc/mdct_kernels.cu HIGH_PASSES): at
    the card tests' shapes and inputs (tests/test_torch_cuda.py) three
    passes hold the analysis within 1e-5 of its peak (chip_smoke.py's
    `high` tolerance) but not the synthesis, whose outputs sum the products
    of the matrix's large entries; six passes hold both."""
    n, blocks = 1024, 130
    g = torch.Generator(device="cpu").manual_seed(blocks)
    x = torch.rand(3, blocks, n, generator=g) * 2 - 1
    m = MDCT(n, use_kernel=True, dct_precision="high", device="cpu")
    fwd, inv = m.kernel_args("forward"), m.kernel_args("inverse")
    y = cuda_mdct.fold_matmul_reference(x, *fwd)
    want = cuda_mdct.matmul_scatter_reference(y, *inv)
    folded = folding.fold(x, *fwd[:4])
    y_tol = 1e-5 * float(y.abs().max())
    tol = 1e-5 * float(want.abs().max())
    err = {}
    for passes in (3, 6):
        y_err = float((split_product(folded, m.dct_mat_fwd, passes)
                       - y).abs().max())
        assert y_err <= y_tol, (passes, y_err, y_tol)
        z = split_product(y, m.dct_mat_inv, passes)
        err[passes] = float((folding.unfold(z, *inv[:4]) - want).abs().max())
    assert err[6] <= tol < err[3], (err, tol)


@pytest.mark.parametrize("n", [256, 1024])
def test_three_pass_products_match_pallas_high(n):
    """At ``high`` the emulation's three passes are the JAX kernel's
    (``pallas_mdct.fold_matmul``/``matmul_scatter`` in interpret mode, its
    matrix pre-split into bf16 hi/lo); the two sum the same exact products
    in other orders in float32, so they agree to 1e-6 of the peak."""
    rng = np.random.default_rng(n + 1)
    x = rng.uniform(-1, 1, (2, 8 * n, 1)).astype(np.float32)
    spec = rng.uniform(-0.05, 0.05, (2, 8, n, 1)).astype(np.float32)
    jm = JaxMDCT.create(n, use_pallas=True, dct_precision="high",
                        pallas_kernel="mono")
    with pltpu.force_tpu_interpret_mode():
        yj = np.asarray(jm.transform(jnp.asarray(x)), dtype=np.float64)
        oj = np.asarray(jm.inverse_transform(jnp.asarray(spec)),
                        dtype=np.float64)
    m = MDCT(n, use_kernel=True, dct_precision="high", device="cpu")
    rows = torch.from_numpy(x[..., 0]).reshape(2, 8, n)
    y = split_product(folding.fold(rows, m.wa_r, m.wb, m.wc, m.ffr),
                      m.dct_mat_fwd, 3)
    z = split_product(torch.from_numpy(spec[..., 0]), m.dct_mat_inv, 3)
    out = folding.unfold(z, m.p, m.q, m.r, m.s_r).reshape(2, -1)
    for got, want in ((y.double().numpy()[..., None], yj),
                      (out.double().numpy()[..., None], oj)):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_split_operand_residents(n, precision):
    """The operand forms at the split tiers: three bf16 planes [3, N_out,
    K] of the transposed float32 matrix, plane 0 its bf16 rounding, the
    three summing to it exactly, the synthesis's columns in natural order
    (its product goes through a z scratch, not the pair-order epilogue);
    the VJP residents likewise of the VJP matrices."""
    m = MDCT(n, use_kernel=True, dct_precision=precision, device="cpu")
    assert cuda_mdct.SPLIT_PLANES[precision] == 3
    for d in ("fwd", "inv"):
        mat = getattr(m, f"dct_mat_{d}")
        op = getattr(m, f"kernel_op_{d}")
        assert op.shape == (3, n, n) and op.dtype == torch.bfloat16
        assert op.is_contiguous()
        assert torch.equal(op[0], mat.T.to(torch.bfloat16))
        assert torch.equal(op.double().sum(0), mat.T.double())
        vmat, vop = getattr(m, f"vjp_mat_{d}"), getattr(m, f"vjp_op_{d}")
        assert torch.equal(vop, cuda_mdct.split_planes(vmat.T, 3))
        assert torch.equal(vop.double().sum(0), vmat.T.double())
    assert m.kernel_args("forward")[-1] is m.kernel_op_fwd
    assert m.kernel_args("inverse")[-1] is m.kernel_op_inv
    assert m.vjp_args("inverse")[-1] is m.vjp_op_inv


def test_split_tiers_refuse_what_their_kernels_do_not_take():
    """The wrappers' operand check (run before a launch): bfloat16 input at
    a split tier, and an operand form of another tier."""
    m = MDCT(256, use_kernel=True, dct_precision="highest", device="cpu")
    x = torch.zeros(1, 4, 256)
    cuda_mdct._check_operand(x, m.kernel_op_fwd, "highest")  # accepted
    with pytest.raises(TypeError, match="float32 input"):
        cuda_mdct._check_operand(x.bfloat16(), m.kernel_op_fwd, "highest")
    with pytest.raises(ValueError, match="operand form"):
        cuda_mdct._check_operand(x, m.kernel_op_fwd[:2].contiguous(), "high")
    with pytest.raises(ValueError, match="operand form"):
        cuda_mdct._check_operand(x, m.kernel_op_fwd[0], "highest")
