"""The host-side pieces around the mono MDCT kernels' tensor-core tiers, in
plain torch on the CPU: the synthesis operand's pair order with the
kernel's chunked overlap-scatter epilogue, the frame tiles of its launch
grid, the operand residents and their rebuild after a conversion, and the
tiers at N=2048, where the kernels run K in two passes."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from audiocodec_tpu.codec import Codec as JaxCodec
from audiocodec_tpu.mdct import MDCT as JaxMDCT
from audiocodec_tpu_torch import MDCT, Codec
from audiocodec_tpu_torch.convert import codec_from_arrays
from audiocodec_tpu_torch.ops import cuda_mdct, dct, folding

torch.set_num_threads(1)


def _chunked_scatter(z_perm, p, q, r, s_r, dtype):
    """The synthesis kernel's epilogue in torch: z in pair order [rows, T,
    N] (rounded to ``dtype``), one pair block at a time, each output frame n
    from z[n] and z[n-1] (the one-frame shift), two output columns per pair
    (c, N-1-c), each product and sum rounded to ``dtype``."""
    rows, t, n = z_perm.shape
    h, half = n // 2, cuda_mdct.PAIR_BLOCK // 2
    zero = torch.zeros(rows, 1, n, dtype=dtype)
    cur = torch.cat([z_perm, zero], dim=1)   # z[n], zero at n = T
    prev = torch.cat([zero, z_perm], dim=1)  # z[n-1], zero at n = 0
    out = torch.empty(rows, t + 1, n, dtype=dtype)
    for b in range(n // cuda_mdct.PAIR_BLOCK):
        cols = slice(b * cuda_mdct.PAIR_BLOCK, (b + 1) * cuda_mdct.PAIR_BLOCK)
        zc = cur[..., cols][..., :half]   # z[n, c]
        zp = prev[..., cols][..., half:]  # z[n-1, N-1-c]
        c = torch.arange(b * half, (b + 1) * half)
        out[..., h - 1 - c] = zc * p[c] + zp * r[h - 1 - c]
        out[..., h + c] = zc * q[c] + zp * s_r[c]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [256, 512])
def test_pair_order_and_chunked_epilogue_equal_unfold(n, dtype):
    rng = np.random.default_rng(n)
    coeffs = folding.make_fold_coefficients(n, "vorbis")
    p, q, r, s_r = (torch.as_tensor(getattr(coeffs, k)).to(dtype)
                    for k in ("p", "q", "r", "s_r"))
    mat = torch.as_tensor(dct.dct4_matrix(n) * math.sqrt(4.0 * n),
                          dtype=torch.float32)
    y = torch.as_tensor(rng.uniform(-1, 1, (3, 7, n)), dtype=dtype)
    perm = cuda_mdct.pair_permutation(n)
    assert sorted(perm.tolist()) == list(range(n))
    z = (y.float() @ mat).to(dtype)
    z_perm = (y.float() @ mat[:, perm]).to(dtype)
    assert torch.equal(z_perm, z[..., perm])
    got = _chunked_scatter(z_perm, p, q, r, s_r, dtype)
    assert torch.equal(got, folding.unfold(z, p, q, r, s_r))


# frames a tensor-core block holds (csrc/mdct_kernels.cu TcCfg::BM)
BLOCK_FRAMES = {"default": 64, "int8": 128}


def _frame_tiles(t_in, bm, analysis):
    """The tensor-core kernel's blocks along a row, as its launch grid cuts
    the T+1 output frames: (first output frame, output frames, first input
    frame) for each. The analysis folds its own frames; a synthesis block
    holds input frames [first - 1, first - 1 + bm) and writes the bm-1
    output frames that need only those."""
    tile = bm if analysis else bm - 1
    t_out = t_in + 1
    return [(f, min(tile, t_out - f), f if analysis else f - 1)
            for f in range(0, t_out, tile)]


@pytest.mark.parametrize("t_in", [1, 2, 127, 128, 129, 431])
@pytest.mark.parametrize("precision", ["default", "int8"])
@pytest.mark.parametrize("analysis", [True, False])
def test_frame_tiles_write_every_output_frame_once(t_in, precision,
                                                   analysis):
    bm = BLOCK_FRAMES[precision]
    written = np.zeros(t_in + 1, dtype=int)
    for first, count, first_in in _frame_tiles(t_in, bm, analysis):
        assert 1 <= count <= (bm if analysis else bm - 1)
        written[first:first + count] += 1
        if not analysis:
            # output frames [first, first + count) read z frames
            # [first - 1, first + count), all inside the block's A rows
            assert first_in == first - 1
            assert first + count <= first_in + bm
        else:
            assert first_in == first
    assert (written == 1).all()


@pytest.mark.parametrize("n", [256, 1024, 2048])
def test_operand_residents(n):
    s = math.sqrt(4.0 * n)
    m64 = dct.dct4_matrix(n)
    perm = cuda_mdct.pair_permutation(n)
    bf = MDCT(n, use_kernel=True, dct_precision="default", device="cpu")
    assert bf.kernel_op_fwd.dtype == torch.bfloat16
    assert torch.equal(bf.kernel_op_fwd,
                       bf.dct_mat_fwd.to(torch.bfloat16).T.contiguous())
    assert torch.equal(bf.kernel_op_inv,
                       bf.dct_mat_inv[:, perm].to(torch.bfloat16).T)
    assert bf.kernel_op_fwd.is_contiguous() and bf.kernel_op_inv.is_contiguous()
    q8 = MDCT(n, use_kernel=True, dct_precision="int8", device="cpu")
    q_fwd, _ = cuda_mdct.host_int8(m64 / s)
    q_inv, _ = cuda_mdct.host_int8(m64 * s)
    assert torch.equal(q8.kernel_op_fwd, torch.from_numpy(q_fwd).T)
    assert torch.equal(q8.kernel_op_inv, torch.from_numpy(q_inv)[:, perm].T)
    # the VJPs run the other direction's kernel at default
    assert torch.equal(q8.vjp_op_fwd, cuda_mdct.synthesis_operand(
        q8.vjp_mat_fwd, "default"))
    assert torch.equal(q8.vjp_op_inv, cuda_mdct.analysis_operand(
        q8.vjp_mat_inv, "default"))
    # the split tiers: bf16 planes of the float32 matrices, natural order
    hi = MDCT(n, use_kernel=True, dct_precision="highest", device="cpu")
    assert torch.equal(hi.kernel_op_fwd,
                       cuda_mdct.split_planes(hi.dct_mat_fwd.T, 3))
    assert torch.equal(hi.kernel_op_inv,
                       cuda_mdct.split_planes(hi.dct_mat_inv.T, 3))
    assert torch.equal(hi.vjp_op_inv, cuda_mdct.split_planes(
        hi.vjp_mat_inv.T, 3))
    assert hi.kernel_args("forward")[-1] is hi.kernel_op_fwd
    assert bf.kernel_args("inverse")[-1] is bf.kernel_op_inv
    assert bf.vjp_args("forward")[-1] is bf.vjp_op_fwd


@pytest.mark.parametrize("precision", ["default", "int8"])
def test_kernel_residents_rebuilt_after_conversion(precision):
    """The operand forms and VJP residents follow the leaves a conversion
    sets: here the JAX codec's matrices scaled by 2."""
    n = 256
    jc = JaxCodec.create(44100, filters_n=n, bark_bands_n=32,
                         compute_dtype=jnp.float32, use_pallas=True,
                         dct_precision=precision)
    leaves = {}
    for part in ("mdct", "psycho"):
        obj = getattr(jc, part)
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if hasattr(v, "shape"):
                leaves[f"{part}.{f.name}"] = np.asarray(v)
    for k in ("mdct.dct_mat_fwd", "mdct.dct_mat_inv"):
        leaves[k] = leaves[k] * 2
    m, p = jc.mdct, jc.psycho
    meta = dict(
        sample_rate=p.sample_rate, filters_n=n, bark_bands_n=32,
        alpha=p.alpha, window_type=m.window_type,
        compute_dtype=str(m.compute_dtype), fast_bf16=m.fast_bf16,
        use_pallas=m.use_pallas, pallas_kernel=m.pallas_kernel,
        dct_precision=precision, bark_precision=p.bark_precision,
        pallas_int8_scale=m.pallas_int8_scale,
    )
    got = codec_from_arrays(leaves, meta, device="cpu").mdct
    own = Codec.create(44100, filters_n=n, bark_bands_n=32,
                       use_kernel=True, dct_precision=precision,
                       device="cpu").mdct
    for d, build in (("fwd", cuda_mdct.analysis_operand),
                     ("inv", cuda_mdct.synthesis_operand)):
        src = getattr(got, f"kernel_q_{d}" if precision == "int8"
                      else f"dct_mat_{d}")
        assert torch.equal(getattr(got, f"kernel_op_{d}"),
                           build(src, precision))
    vjp_build = {"fwd": cuda_mdct.synthesis_operand,
                 "inv": cuda_mdct.analysis_operand}
    for d in ("fwd", "inv"):
        assert torch.equal(getattr(got, f"vjp_op_{d}"), vjp_build[d](
            getattr(got, f"vjp_mat_{d}"), "default"))
    if precision == "default":  # the scaled leaves reached the residents
        assert torch.equal(got.kernel_op_fwd.float(),
                           (own.dct_mat_fwd * 2).to(torch.bfloat16).T.float())
        assert not torch.equal(got.vjp_op_inv, own.vjp_op_inv)


@pytest.mark.parametrize("dtype,fast,precision", [
    ("float32", False, "highest"), ("float32", False, "default"),
    ("bfloat16", True, "default"), ("bfloat16", True, "int8"),
])
def test_auto_design_is_mono_at_n2048(dtype, fast, precision):
    """The mono kernels take N=2048 at every tier (the one-pass tiers in
    two K passes of their A tile, the split tiers streaming K), so "auto"
    stays mono and builds the operand forms there."""
    m = MDCT(2048, compute_dtype=dtype, fast_bf16=fast, use_kernel=True,
             dct_precision=precision, device="cpu")
    assert m.kernel_design == "mono" and m.use_kernel is True
    op = m.kernel_args("forward")[-1]
    if precision == "highest":  # three bf16 planes
        assert op.shape == (3, 2048, 2048) and op.dtype == torch.bfloat16
    else:
        assert op.shape == (2048, 2048)
    assert op.is_contiguous()


@pytest.mark.parametrize("dtype,precision,fast", [
    ("float32", "default", False), ("bfloat16", "default", True),
    ("float32", "int8", False), ("bfloat16", "int8", True),
])
def test_wide_one_pass_tiers_match_pallas(dtype, precision, fast):
    """At N=2048 what a CPU tensor runs for the mono kernels (their plain
    versions) agrees with the JAX package's Pallas mono kernels in
    interpret mode, at the tolerances of tests/test_torch_mdct.py."""
    n, blocks = 2048, 3
    jm = JaxMDCT.create(n, compute_dtype=getattr(jnp, dtype), fast_bf16=fast,
                        use_pallas=True, dct_precision=precision,
                        pallas_kernel="mono")
    tm = MDCT(n, compute_dtype=dtype, fast_bf16=fast, use_kernel=True,
              dct_precision=precision, device="cpu")
    rng = np.random.default_rng(blocks)
    x = rng.uniform(-1, 1, (2, blocks * n, 1)).astype(np.float32)
    spec = rng.uniform(-0.05, 0.05, (2, blocks, n, 1)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        yj = np.asarray(jm.transform(jnp.asarray(x, getattr(jnp, dtype))),
                        dtype=np.float64)
        oj = np.asarray(jm.inverse_transform(
            jnp.asarray(spec, getattr(jnp, dtype))), dtype=np.float64)
    tdt = getattr(torch, dtype)
    yt = tm.transform(torch.from_numpy(x).to(tdt)).double().numpy()
    ot = tm.inverse_transform(torch.from_numpy(spec).to(tdt)).double().numpy()
    for got, want, direction in ((yt, yj, "fwd"), (ot, oj, "inv")):
        peak = np.abs(want).max()
        if dtype == "bfloat16":  # two bf16 ulps of the largest value
            atol = 2.0 * 2.0 ** (np.floor(np.log2(peak)) - 7)
        else:
            atol = (1e-5 if precision == "default" else 1e-6) * peak
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
