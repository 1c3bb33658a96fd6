"""The radix kernel design held against the JAX package on the CPU: the
plain versions of the port's radix kernels (what a CPU tensor runs) against
the JAX radix Pallas kernels in interpret mode, the factorization itself in
float64 in the port's natural basis, the ``kernel_design`` option, and a JAX
radix codec carried across by ``convert.codec_from_arrays``.

Tolerances are those of tests/test_pallas.py::TestRadixKernels: forward
1e-6 (2e-6 at N >= 512), inverse 1e-4, bf16 ``default`` 1e-3 forward and
two bf16 ulps of the peak inverse (the port's kernel-tier bound)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from audiocodec_tpu.codec import Codec as JaxCodec
from audiocodec_tpu.mdct import MDCT as JaxMDCT
from audiocodec_tpu.ops import pallas_mdct as jax_pallas
from audiocodec_tpu_torch import MDCT, Codec
from audiocodec_tpu_torch.convert import codec_from_arrays
from audiocodec_tpu_torch.ops import cuda_mdct, dct, radix
from tests.test_torch_codec import _leaves_and_meta
from tests.test_torch_grad import flip_route, scatter_flip_route

torch.set_num_threads(1)


def _inputs(shape, dtype_name, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-scale, scale, shape).astype(np.float32)
    return (jnp.asarray(x, dtype=getattr(jnp, dtype_name)),
            torch.from_numpy(x).to(getattr(torch, dtype_name)))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float64).numpy()
    return np.asarray(jnp.asarray(a, dtype=jnp.float64))


def _pair(n, **kw):
    dtype = kw.pop("compute_dtype", "float32")
    jm = JaxMDCT.create(n, compute_dtype=getattr(jnp, dtype), use_pallas=True,
                        pallas_kernel="radix", **kw)
    tm = MDCT(n, compute_dtype=dtype, use_kernel=True, kernel_design="radix",
              device="cpu", **kw)
    return jm, tm


@pytest.mark.parametrize("n,blocks,window_type", [
    (256, 3, "vorbis"), (256, 7, "sine"), (256, 4, None), (256, 4, "rect"),
    (512, 5, "vorbis"), (1024, 3, "vorbis"),
])
def test_radix_plain_versions_match_pallas(n, blocks, window_type):
    jm, tm = _pair(n, window_type=window_type)
    assert tm.kernel_design == "radix" and tm.radix_mat_fwd.shape == (
        2, n // 2, n // 2)
    xj, xt = _inputs((2, blocks * n, 1), "float32", blocks)
    sj, st = _inputs((2, blocks, n, 1), "float32", blocks + 1, scale=0.5)
    with pltpu.force_tpu_interpret_mode():
        yj = _np(jm.transform(xj))
        oj = _np(jm.inverse_transform(sj))
    yt, ot = tm.transform(xt), tm.inverse_transform(st)
    assert yt.shape == (2, blocks + 1, n, 1) and ot.shape == (
        2, (blocks + 1) * n, 1)
    np.testing.assert_allclose(_np(yt), yj, rtol=0,
                               atol=1e-6 if n < 512 else 2e-6)
    np.testing.assert_allclose(_np(ot), oj, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n", [256, 1024])
def test_radix_bf16_default_tier_matches_pallas(n):
    """The fast path rotates and butterflies in bf16, as the JAX kernel
    does; the plain versions round where it rounds."""
    jm, tm = _pair(n, compute_dtype="bfloat16", fast_bf16=True,
                   dct_precision="default")
    assert tm.kernel_dtype == torch.bfloat16
    assert tm.radix_rot_fwd.dtype == torch.bfloat16
    xj, xt = _inputs((2, 5 * n, 1), "bfloat16", 0)
    sj, st = _inputs((2, 5, n, 1), "bfloat16", 1, scale=0.05)
    with pltpu.force_tpu_interpret_mode():
        yj = _np(jm.transform(xj))
        oj = _np(jm.inverse_transform(sj))
    np.testing.assert_allclose(_np(tm.transform(xt)), yj, rtol=0, atol=1e-3)
    peak = np.abs(oj).max()
    np.testing.assert_allclose(_np(tm.inverse_transform(st)), oj, rtol=0,
                               atol=2.0 * 2.0 ** (np.floor(np.log2(peak)) - 7))


@pytest.mark.parametrize("n", [64, 256, 1024])
def test_factorization_is_exact_in_the_natural_basis(n):
    """rotation + two [M, M] products + butterfly == the scaled DCT-IV the
    mono kernels use, as matrices in float64; and the transposed chain ==
    the synthesis matrix."""
    h = n // 2
    eye = torch.eye(n, dtype=torch.float64)
    rot, mats = map(torch.from_numpy, radix.forward_params(n))
    rt = radix.rotate(eye, rot)
    full = radix.butterfly(rt[:, :h] @ mats[0], rt[:, h:] @ mats[1])
    mono = dct.dct4_matrix(n) / math.sqrt(4.0 * n)
    np.testing.assert_allclose(full.numpy(), mono, rtol=0, atol=1e-13)
    rot, mats = map(torch.from_numpy, radix.inverse_params(n))
    us, vs = radix.butterfly_t(eye)
    z = radix.rotate_t(us @ mats[0], vs @ mats[1], rot)
    np.testing.assert_allclose(z.numpy(), dct.dct4_matrix(n) * math.sqrt(4.0 * n),
                               rtol=0, atol=1e-11)


def test_builders_carry_the_jax_factors_over_as_they_are():
    """The rotation vectors and [M, M] factors are defined on the pairs
    (f_n, f_{N-1-n}): the JAX package's, built for its swizzled lanes, are
    the port's."""
    n = 256
    _, _, r1, r2, p, q = jax_pallas.radix_forward_params(n, "vorbis")
    rot, mats = radix.forward_params(n)
    np.testing.assert_array_equal(rot, np.concatenate([r1, r2]))
    np.testing.assert_array_equal(mats, np.stack([p, q]))
    _, _, ra, rb, pi, qi = jax_pallas.radix_inverse_params(n, "vorbis")
    rot, mats = radix.inverse_params(n)
    np.testing.assert_array_equal(rot, np.concatenate([ra, rb]))
    np.testing.assert_array_equal(mats, np.stack([pi, qi]))
    assert mats.flags.c_contiguous


def test_radix_round_trip_reconstructs():
    n = 256
    tm = MDCT(n, use_kernel=True, kernel_design="radix", device="cpu")
    _, xt = _inputs((1, 10 * n, 1), "float32", 5)
    rt = tm.inverse_transform(tm.transform(xt))
    assert float((xt - rt[:, n:-n]).abs().max()) < 1e-5


def test_radix_cpu_tensor_takes_the_plain_version_and_counts_nothing():
    m = MDCT(256, use_kernel=True, kernel_design="radix", device="cpu")
    x = torch.rand(2, 5, 256) - 0.5
    cuda_mdct.reset_launch_counts()
    fwd = m.kernel_args("forward")
    got = cuda_mdct.radix_fold_matmul(x, *fwd)
    assert torch.equal(got, cuda_mdct.radix_fold_matmul_reference(x, *fwd))
    assert set(cuda_mdct.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="tiers"):
        cuda_mdct.radix_fold_matmul(x, *fwd[:-2], "int8", fwd[-1])
    meta = lambda t: t.to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="no kernel for a tensor on meta"):
        cuda_mdct.radix_matmul_scatter(meta(x), *map(meta, fwd[:-2]),
                                       "highest", meta(fwd[-1]))


class TestKernelDesign:
    def test_auto_is_mono(self):
        assert MDCT(2048, use_kernel=True,
                    device="cpu").kernel_design == "mono"
        assert Codec.create(44100, filters_n=2048,
                            device="cpu").mdct.kernel_design == "mono"

    def test_radix_buffers_only_where_a_kernel_runs(self):
        m = MDCT(256, use_kernel="forward", kernel_design="radix",
                 device="cpu")
        assert m.radix_rot_fwd.shape == (2, 256)
        assert m.radix_rot_inv is None and m.radix_mat_inv is None
        off = MDCT(256, kernel_design="radix", device="cpu")
        assert off.radix_mat_fwd is None and off.kernel_design == "radix"
        mono = MDCT(256, use_kernel=True, device="cpu")
        assert mono.radix_mat_fwd is None

    def test_codec_passes_it_through(self):
        c = Codec.create(44100, filters_n=256, bark_bands_n=32,
                         use_kernel=True, kernel_design="radix", device="cpu")
        assert c.mdct.kernel_design == "radix"
        assert c.mdct.kernel("forward") is cuda_mdct.radix_fold_matmul

    @pytest.mark.parametrize("kwargs,match", [
        (dict(kernel_design="fft"), "kernel_design must be"),
        (dict(kernel_design="radix", dct_precision="int8"), "no int8 tier"),
        (dict(kernel_design="radix", dct_precision="int8", use_kernel=True),
         "no int8 tier"),
    ])
    def test_rejected(self, kwargs, match):
        with pytest.raises(ValueError, match=match):
            MDCT(256, device="cpu", **kwargs)


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_convert_carries_a_jax_radix_codec(precision):
    n, sr = 256, 44100
    jc = JaxCodec.create(sr, filters_n=n, bark_bands_n=32, use_pallas=True,
                         pallas_kernel="radix", dct_precision=precision)
    tc = Codec.create(sr, filters_n=n, bark_bands_n=32, use_kernel=True,
                      kernel_design="radix", dct_precision=precision,
                      device="cpu")
    leaves, meta = _leaves_and_meta(jc)
    got = codec_from_arrays(leaves, meta, device="cpu")
    assert got.mdct.kernel_design == "radix"
    want = dict(tc.named_buffers())
    have = dict(got.named_buffers())
    assert sorted(have) == sorted(want)
    for name, buf in want.items():
        assert have[name].dtype == buf.dtype, name
        assert torch.equal(have[name], buf), name
    xj, xt = _inputs((1, 4 * n, 1), "float32", 3)
    out = got.round_trip_fast(xt, 2)
    assert torch.equal(out, tc.round_trip_fast(xt, 2))
    with pltpu.force_tpu_interpret_mode():
        spec_j = _np(jc.mdct.transform(xj))
    np.testing.assert_allclose(_np(got.mdct.transform(xt)), spec_j, rtol=0,
                               atol=1e-6)


def _split_product(a, mat, passes):
    from tests.test_torch_split import split_product
    return split_product(a.float(), mat.float(), passes)


def radix_emulation(m, x, direction, passes):
    """The radix kernels as the card runs them, in torch on the CPU: the
    fold and rotation (or the transposed butterfly) in x's dtype, the two
    [N/2, N/2] products as split_gemm_kernel sums them (``passes`` plane
    products a K block of 64, a fresh float32 sum each), the butterfly (or
    the transposed rotation, rounded to x's dtype, and the overlap
    scatter)."""
    from audiocodec_tpu_torch.ops import folding

    args = m.kernel_args(direction)
    h = x.shape[-1] // 2
    if direction == "forward":
        wa_r, wb, wc, ffr, rot, mats = args[:6]
        rt = radix.rotate(folding.fold(x, wa_r, wb, wc, ffr), rot)
        u = _split_product(rt[..., :h], mats[0], passes)
        v2 = _split_product(rt[..., h:], mats[1], passes)
        return radix.butterfly(u, v2).to(x.dtype)
    p, q, r, s_r, rot, mats = args[:6]
    us, vs = radix.butterfly_t(x)
    z = radix.rotate_t(_split_product(us, mats[0], passes),
                       _split_product(vs, mats[1], passes), rot).to(x.dtype)
    return folding.unfold(z, p, q, r, s_r).to(x.dtype)


@pytest.mark.parametrize("n", [512, 1024])
@pytest.mark.parametrize("tier", ["highest", "default-bf16"])
def test_split_radix_products_match_pallas(n, tier):
    """The radix route on the split GEMM core, emulated (six passes on three
    planes at `highest`, one pass on the bf16 planes at `default`), against
    the JAX radix Pallas kernels in interpret mode, at the tolerances of
    test_radix_plain_versions_match_pallas and
    test_radix_bf16_default_tier_matches_pallas."""
    bf16 = tier == "default-bf16"
    kw = dict(compute_dtype="bfloat16", fast_bf16=True,
              dct_precision="default") if bf16 else {}
    jm, tm = _pair(n, **kw)
    passes = 1 if bf16 else 6
    assert cuda_mdct.RADIX_PLANES[tm.kernel_precision] == (1 if bf16 else 3)
    dtype = "bfloat16" if bf16 else "float32"
    xj, xt = _inputs((2, 5 * n, 1), dtype, n)
    sj, st = _inputs((2, 5, n, 1), dtype, n + 1, scale=0.05 if bf16 else 0.5)
    with pltpu.force_tpu_interpret_mode():
        yj = _np(jm.transform(xj))
        oj = _np(jm.inverse_transform(sj))
    y = radix_emulation(tm, xt[..., 0].reshape(2, 5, n), "forward", passes)
    out = radix_emulation(tm, st[..., 0], "inverse", passes)
    yt = _np(y)[..., None]
    ot = _np(out.reshape(2, -1))[..., None]
    if bf16:
        np.testing.assert_allclose(yt, yj, rtol=0, atol=1e-3)
        peak = np.abs(oj).max()
        np.testing.assert_allclose(
            ot, oj, rtol=0, atol=2.0 * 2.0 ** (np.floor(np.log2(peak)) - 7))
    else:
        np.testing.assert_allclose(yt, yj, rtol=0, atol=2e-6)
        np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-4)


@pytest.mark.parametrize("frames", [2, 9, 130])
@pytest.mark.parametrize("n", [256, 512])
@pytest.mark.parametrize("dtype,fast,precision", [
    ("float32", False, "highest"), ("bfloat16", True, "default")])
def test_radix_matmul_scatter_vjp_is_the_flip_route(dtype, fast, precision,
                                                    n, frames):
    """The radix synthesis VJP's plain version (the transposed fold, the
    rotation, the two products, the butterfly), and the wrapper on a CPU
    tensor, equal the flip route through the radix analysis's plain
    version bit for bit."""
    m = MDCT(n, compute_dtype=dtype, fast_bf16=fast, use_kernel=True,
             dct_precision=precision, kernel_design="radix", device="cpu")
    vjp_args = m.vjp_args("inverse")
    _, g = _inputs((3, frames, n), dtype, n + frames)
    want = flip_route(g, cuda_mdct.radix_fold_matmul_reference,
                      vjp_args[:-1])
    got = cuda_mdct.radix_matmul_scatter_vjp_reference(g, *vjp_args)
    assert got.shape == (3, frames - 1, n) and got.dtype == g.dtype
    assert torch.equal(got, want)
    cuda_mdct.reset_launch_counts()
    assert torch.equal(cuda_mdct.radix_matmul_scatter_vjp(g, *vjp_args), want)
    assert set(cuda_mdct.launch_counts().values()) == {0}


@pytest.mark.parametrize("frames", [2, 9, 130])
@pytest.mark.parametrize("n", [256, 512])
@pytest.mark.parametrize("dtype,fast,precision", [
    ("float32", False, "highest"), ("bfloat16", True, "default")])
def test_radix_fold_matmul_vjp_is_the_flip_route(dtype, fast, precision, n,
                                                 frames):
    """The radix analysis VJP's plain version (the radix synthesis's
    products on the cotangent, then the transposed scatter), and the
    wrapper on a CPU tensor, equal the flip route through the radix
    synthesis's plain version bit for bit."""
    m = MDCT(n, compute_dtype=dtype, fast_bf16=fast, use_kernel=True,
             dct_precision=precision, kernel_design="radix", device="cpu")
    vjp_args = m.vjp_args("forward")
    _, g = _inputs((3, frames, n), dtype, 2 * n + frames)
    want = scatter_flip_route(g, cuda_mdct.radix_matmul_scatter_reference,
                              vjp_args[:-1])
    got = cuda_mdct.radix_fold_matmul_vjp_reference(g, *vjp_args)
    assert got.shape == (3, frames - 1, n) and got.dtype == g.dtype
    assert torch.equal(got, want)
    cuda_mdct.reset_launch_counts()
    assert torch.equal(cuda_mdct.radix_fold_matmul_vjp(g, *vjp_args), want)
    assert set(cuda_mdct.launch_counts().values()) == {0}


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_radix_operand_residents(precision):
    """The radix kernels' operand form: each factor transposed, as bf16
    planes [2, P, N/2, N/2] (three at the split tiers, summing back to the
    float32 factor exactly; at `default` one, its bf16 rounding); the VJP
    operands are the planes of the remapped factors; both are the last
    argument of the kernel's and of the VJP's arguments."""
    n = 256
    m = MDCT(n, use_kernel=True, kernel_design="radix",
             dct_precision=precision, device="cpu")
    planes = cuda_mdct.RADIX_PLANES[precision]
    for d in ("fwd", "inv"):
        mats, op = getattr(m, f"radix_mat_{d}"), getattr(m, f"kernel_op_{d}")
        assert op.shape == (2, planes, n // 2, n // 2)
        assert op.dtype == torch.bfloat16 and op.is_contiguous()
        for h in range(2):
            assert torch.equal(op[h, 0], mats[h].T.to(torch.bfloat16))
            if planes == 3:
                assert torch.equal(op[h].double().sum(0), mats[h].T.double())
        vmats, vop = getattr(m, f"vjp_mat_{d}"), getattr(m, f"vjp_op_{d}")
        remap = (cuda_mdct.radix_fold_vjp_residents if d == "fwd"
                 else cuda_mdct.radix_unfold_vjp_residents)
        assert torch.equal(vmats, remap(getattr(m, f"radix_rot_{d}"),
                                        mats)[1])
        assert torch.equal(vop, torch.stack([
            cuda_mdct.split_planes(v.T, planes) for v in vmats]))
    assert m.kernel_args("forward")[-1] is m.kernel_op_fwd
    assert m.kernel_args("inverse")[-1] is m.kernel_op_inv
    assert m.vjp_args("forward")[-1] is m.vjp_op_fwd
    assert m.vjp_args("inverse")[-1] is m.vjp_op_inv


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_convert_rebuilds_the_radix_operands(precision):
    """A JAX radix codec carried across: the kernels' operand forms and the
    VJP operands are rebuilt from the converted factors, equal to those of
    a port codec built the same way."""
    n, sr = 256, 44100
    jc = JaxCodec.create(sr, filters_n=n, bark_bands_n=32, use_pallas=True,
                         pallas_kernel="radix", dct_precision=precision)
    got = codec_from_arrays(*_leaves_and_meta(jc), device="cpu").mdct
    for d in ("fwd", "inv"):
        want = cuda_mdct.radix_operand(getattr(got, f"radix_mat_{d}"),
                                       precision)
        assert torch.equal(getattr(got, f"kernel_op_{d}"), want)
        assert torch.equal(getattr(got, f"vjp_op_{d}"),
                           cuda_mdct.radix_operand(
                               getattr(got, f"vjp_mat_{d}"), precision))
        assert getattr(got, f"kernel_op_{d}").shape[1] == (
            cuda_mdct.RADIX_PLANES[precision])


def test_radix_wrappers_check_the_operand_form():
    """The radix wrappers' operand check (before a launch): the planes of
    another tier, a mono operand and bfloat16 input at a split tier."""
    m = MDCT(256, use_kernel=True, kernel_design="radix", device="cpu")
    x = torch.zeros(1, 4, 256)
    op = m.kernel_op_fwd
    cuda_mdct._check_operand(x, op, "highest", radix=True)  # accepted
    with pytest.raises(ValueError, match="radix_operand"):
        cuda_mdct._check_operand(x, op[:, :1].contiguous(), "highest",
                                 radix=True)
    with pytest.raises(ValueError, match="radix_operand"):
        cuda_mdct._check_operand(x, op, "default", radix=True)
    with pytest.raises(TypeError, match="float32 input"):
        cuda_mdct._check_operand(x.bfloat16(), op, "highest", radix=True)
