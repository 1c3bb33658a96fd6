"""The hand-written CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc: run ``python -m pytest --noconftest -m
cuda tests/test_torch_cuda.py`` there (``--noconftest``: tests/conftest.py
imports jax, which the port does not need). Without a card they skip; the skip
condition is a string, so it is evaluated when each test is set up and
never while the module is imported."""

import math

import numpy as np
import pytest
import torch

from audiocodec_tpu_torch import MDCT, Codec
from audiocodec_tpu_torch.ops import cuda_mdct, cuda_noise

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs an NVIDIA GPU"),
]

def _once(*names):
    """Every MDCT kernel's and VJP's count 0, except the named ones at 1."""
    return {k: int(k in names) for k in cuda_mdct.launch_counts()}


MONO_ONCE = _once("fold_matmul", "matmul_scatter")
RADIX_ONCE = _once("radix_fold_matmul", "radix_matmul_scatter")

TIERS = [  # (compute dtype, fast_bf16, precision)
    ("float32", False, "highest"),
    ("float32", False, "high"),
    ("float32", False, "default"),
    ("float32", False, "int8"),
    ("bfloat16", True, "default"),
    ("bfloat16", True, "int8"),
]


def _tol(want, tier, dtype, direction):
    peak = float(want.float().abs().max())
    if dtype == torch.bfloat16:
        return 2.0 * 2.0 ** (math.floor(math.log2(peak)) - 7)
    if tier in ("highest", "high"):
        return 1e-6 if direction == "fwd" else 1e-4
    return (1e-6 if tier == "int8" else 1e-5) * peak


@pytest.mark.parametrize("n,blocks", [(256, 3), (256, 37), (1024, 8),
                                      (1024, 130)])
@pytest.mark.parametrize("dtype,fast,precision", TIERS)
def test_kernels_match_plain_versions(n, blocks, dtype, fast, precision):
    m = MDCT(n, compute_dtype=dtype, fast_bf16=fast, use_kernel=True,
             dct_precision=precision, device="cuda")
    g = torch.Generator(device="cpu").manual_seed(blocks)
    x = (torch.rand(3, blocks, n, generator=g) * 2 - 1).to("cuda",
                                                           m.kernel_dtype)
    fwd, inv = m.kernel_args("forward"), m.kernel_args("inverse")
    cuda_mdct.reset_launch_counts()
    y = cuda_mdct.fold_matmul(x, *fwd)
    y_ref = cuda_mdct.fold_matmul_reference(x, *fwd)
    out = cuda_mdct.matmul_scatter(y, *inv)
    out_ref = cuda_mdct.matmul_scatter_reference(y, *inv)
    torch.cuda.synchronize()
    assert cuda_mdct.launch_counts() == MONO_ONCE
    assert y.shape == (3, blocks + 1, n) and out.shape == (3, blocks + 2, n)
    tier = m.kernel_precision
    assert float((y.float() - y_ref.float()).abs().max()) <= _tol(
        y_ref, tier, x.dtype, "fwd")
    assert float((out.float() - out_ref.float()).abs().max()) <= _tol(
        out_ref, tier, x.dtype, "inv")


@pytest.mark.parametrize("n,blocks", [(1024, 1), (1024, 127), (1024, 129),
                                      (2048, 1), (2048, 64), (2048, 129)])
@pytest.mark.parametrize("dtype,fast,precision", TIERS)
def test_tensor_core_kernels_at_ragged_frame_counts(n, blocks, dtype, fast,
                                                    precision):
    """Frame counts around the tiles (64 frames at default, 128 at int8;
    the synthesis's tiles overlap by one; 128 rows of the flattened
    [rows x frames] A at the split tiers, across rows) and five rows, which
    fill no wave of the card. At N=2048 the one-pass tiers' A tile holds
    half of K: every chunk runs two K passes and rebuilds A between them,
    int8 takes each frame's scale over both passes first, and int8g keeps
    its group order; the split tiers stream 32 K tiles."""
    m = MDCT(n, compute_dtype=dtype, fast_bf16=fast, use_kernel=True,
             dct_precision=precision, device="cuda")
    g = torch.Generator(device="cpu").manual_seed(blocks)
    x = (torch.rand(5, blocks, n, generator=g) * 2 - 1).to("cuda",
                                                           m.kernel_dtype)
    fwd, inv = m.kernel_args("forward"), m.kernel_args("inverse")
    cuda_mdct.reset_launch_counts()
    y = cuda_mdct.fold_matmul(x, *fwd)
    out = cuda_mdct.matmul_scatter(y, *inv)
    torch.cuda.synchronize()
    assert cuda_mdct.launch_counts() == MONO_ONCE
    y_ref = cuda_mdct.fold_matmul_reference(x, *fwd)
    out_ref = cuda_mdct.matmul_scatter_reference(y, *inv)
    tier = m.kernel_precision
    assert float((y.float() - y_ref.float()).abs().max()) <= _tol(
        y_ref, tier, x.dtype, "fwd")
    assert float((out.float() - out_ref.float()).abs().max()) <= _tol(
        out_ref, tier, x.dtype, "inv")
    if precision == "int8":  # integer sums, the plain version's float order
        assert torch.equal(y, y_ref) and torch.equal(out, out_ref)


@pytest.mark.parametrize("precision", ["default", "int8", "highest", "high"])
def test_operand_residents_on_the_card(precision):
    split = precision in cuda_mdct.SPLIT_PLANES  # float32 only
    dtype = torch.float32 if split else torch.bfloat16
    m = MDCT(1024, compute_dtype=dtype, fast_bf16=not split, use_kernel=True,
             dct_precision=precision, device="cuda")
    src = "kernel_q" if precision == "int8" else "dct_mat"
    for d, build in (("fwd", cuda_mdct.analysis_operand),
                     ("inv", cuda_mdct.synthesis_operand)):
        op = getattr(m, f"kernel_op_{d}")
        assert op.is_cuda and op.is_contiguous()
        assert torch.equal(op, build(getattr(m, f"{src}_{d}"), precision))
        assert getattr(m, f"vjp_op_{d}").dtype == torch.bfloat16
    fwd = m.kernel_args("forward")
    x = torch.zeros(2, 4, 1024, dtype=dtype, device="cuda")
    with pytest.raises(ValueError, match="operand form"):
        cuda_mdct.fold_matmul(x, *fwd[:-1], None)
    with pytest.raises(ValueError, match="operand form"):
        cuda_mdct.matmul_scatter(x, *m.kernel_args("inverse")[:-1],
                                 fwd[-1].mT)  # not contiguous


def test_auto_resolves_to_the_kernels_on_the_card():
    assert MDCT(1024, device="cuda").use_kernel is True
    assert MDCT(1024, compute_dtype="float32", dct_precision="default",
                device="cuda").use_kernel is True
    assert MDCT(192, device="cuda").use_kernel is False


def test_highest_round_trip_through_the_kernels():
    n = 1024
    m = MDCT(n, use_kernel=True, device="cuda")
    t = torch.arange(64 * n, dtype=torch.float64) / 44100
    x = (0.4 * torch.sin(2 * np.pi * 440 * t))[None, :, None].float().cuda()
    rt = m.inverse_transform(m.transform(x))[:, n:-n].double()
    snr = 10 * torch.log10((x.double() ** 2).sum() / ((x - rt) ** 2).sum())
    assert float(snr) >= 130.0


def test_round_trip_quantized_launches_each_kernel_once():
    c = Codec.create(44100, compute_dtype="bfloat16", fast_bf16=True,
                     dct_precision="int8", device="cuda")
    x = torch.zeros(2, 8 * 1024, 1, dtype=torch.bfloat16, device="cuda")
    cuda_mdct.reset_launch_counts()
    out = c.round_trip_quantized(x)
    torch.cuda.synchronize()
    assert out.shape == (2, 10 * 1024, 1)
    assert cuda_mdct.launch_counts() == MONO_ONCE


def test_round_trip_quantized_copies_nothing_to_the_card():
    """A 0-d constant made on the card in each call is a pageable
    host-to-device copy in each call, which held the call back on the host
    (device idle 20-49% of it)."""
    from torch.profiler import ProfilerActivity, profile

    c = Codec.create(44100, compute_dtype="bfloat16", fast_bf16=True,
                     dct_precision="int8", device="cuda")
    x = torch.zeros(2, 8 * 1024, 1, dtype=torch.bfloat16, device="cuda")
    c.round_trip_quantized(x)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        c.round_trip_quantized(x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("tc_kernel" in n for n in names)
    assert not [n for n in names if "HtoD" in n]


def test_kernel_events_hold_no_stage_label():
    """Each stage span also gets a row on the device's timeline (its
    first kernel to its last); ``kernel_events`` gives the kernels and
    copies alone."""
    from torch.profiler import ProfilerActivity, profile

    from audiocodec_tpu_torch.utils import profiling

    c = Codec.create(44100, device="cuda")
    x = torch.zeros(2, 8 * 1024, 1, device="cuda")
    c.round_trip_quantized(x)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        c.round_trip_quantized(x)
        torch.cuda.synchronize()
    labels = {e.name for e in prof.events()
              if e.device_type != torch.autograd.DeviceType.CUDA
              and e.is_user_annotation}
    names = {e.name for e in profiling.kernel_events(prof)}
    assert "psycho.fused" in labels
    assert any("split_gemm_kernel" in n for n in names)
    assert not labels & names


def test_wrappers_refuse_what_the_kernels_do_not_take():
    m = MDCT(256, use_kernel=True, device="cuda")
    fwd = m.kernel_args("forward")
    x = torch.zeros(1, 4, 256, device="cuda")
    with pytest.raises(NotImplementedError, match="backward"):
        cuda_mdct.fold_matmul(x.clone().requires_grad_(), *fwd)
    with pytest.raises(NotImplementedError, match="no gradient"):
        cuda_mdct.fold_matmul(x, fwd[0].clone().requires_grad_(), *fwd[1:])
    with pytest.raises(ValueError, match="contiguous"):
        cuda_mdct.fold_matmul(torch.zeros(1, 256, 4, device="cuda").mT, *fwd)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cuda_mdct.fold_matmul(x.double(), *fwd)
    with pytest.raises(ValueError, match="matrix must be"):
        cuda_mdct.fold_matmul(x, *fwd[:4], fwd[4].half(), "highest", 1.0)
    # the split tiers' kernels take float32 only
    bf = tuple(w.bfloat16() for w in fwd[:4])
    with pytest.raises(TypeError, match="float32 input"):
        cuda_mdct.fold_matmul(x.bfloat16(), *bf, *fwd[4:])


def test_misaligned_views_are_copied_by_the_mdct_and_refused_by_the_wrapper():
    n = 256
    m = MDCT(n, use_kernel=True, device="cuda")
    flat = torch.rand(2 * 4 * n + 1, device="cuda") - 0.5
    x = flat[1:].view(2, 4 * n, 1)  # 4 bytes past an aligned allocation
    assert x.data_ptr() % 16
    want = m.transform(x.clone())
    assert torch.equal(m.transform(x), want)
    fwd = m.kernel_args("forward")
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_mdct.fold_matmul(flat[1:].view(2, 4, n), *fwd)


RADIX_TIERS = [t for t in TIERS if t[2] != "int8"]


@pytest.mark.parametrize("n,blocks", [(256, 3), (256, 37), (2048, 8),
                                      (2048, 130)])
@pytest.mark.parametrize("dtype,fast,precision", RADIX_TIERS)
def test_radix_kernels_match_plain_versions(n, blocks, dtype, fast,
                                            precision):
    m = MDCT(n, compute_dtype=dtype, fast_bf16=fast, use_kernel=True,
             dct_precision=precision, kernel_design="radix", device="cuda")
    g = torch.Generator(device="cpu").manual_seed(blocks)
    x = (torch.rand(3, blocks, n, generator=g) * 2 - 1).to("cuda",
                                                           m.kernel_dtype)
    fwd, inv = m.kernel_args("forward"), m.kernel_args("inverse")
    cuda_mdct.reset_launch_counts()
    y = cuda_mdct.radix_fold_matmul(x, *fwd)
    y_ref = cuda_mdct.radix_fold_matmul_reference(x, *fwd)
    out = cuda_mdct.radix_matmul_scatter(y, *inv)
    out_ref = cuda_mdct.radix_matmul_scatter_reference(y, *inv)
    torch.cuda.synchronize()
    assert cuda_mdct.launch_counts() == RADIX_ONCE
    assert y.shape == (3, blocks + 1, n) and out.shape == (3, blocks + 2, n)
    tier = m.kernel_precision
    assert float((y.float() - y_ref.float()).abs().max()) <= _tol(
        y_ref, tier, x.dtype, "fwd")
    assert float((out.float() - out_ref.float()).abs().max()) <= _tol(
        out_ref, tier, x.dtype, "inv")


def test_radix_highest_round_trip_through_the_kernels():
    n = 2048
    m = MDCT(n, use_kernel=True, kernel_design="radix", device="cuda")
    t = torch.arange(32 * n, dtype=torch.float64) / 44100
    x = (0.4 * torch.sin(2 * np.pi * 440 * t))[None, :, None].float().cuda()
    rt = m.inverse_transform(m.transform(x))[:, n:-n].double()
    snr = 10 * torch.log10((x.double() ** 2).sum() / ((x - rt) ** 2).sum())
    assert float(snr) >= 125.0


def test_radix_wrappers_refuse_what_the_kernels_do_not_take():
    m = MDCT(256, use_kernel=True, kernel_design="radix", device="cuda")
    fwd = m.kernel_args("forward")
    x = torch.zeros(1, 4, 256, device="cuda")
    with pytest.raises(ValueError, match="tiers"):
        cuda_mdct.radix_fold_matmul(x, *fwd[:-2], "int8", fwd[-1])
    with pytest.raises(NotImplementedError, match="backward"):
        cuda_mdct.radix_fold_matmul(x.clone().requires_grad_(), *fwd)
    with pytest.raises(ValueError, match="rotation"):
        cuda_mdct.radix_fold_matmul(x, *fwd[:4], fwd[4][:1], *fwd[5:])
    with pytest.raises(ValueError, match="operand form"):
        cuda_mdct.radix_fold_matmul(x, *fwd[:-1], None)
    with pytest.raises(TypeError, match="float32 input"):
        cuda_mdct.radix_fold_matmul(x.bfloat16(),
                                    *(w.bfloat16() for w in fwd[:5]),
                                    *fwd[5:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_noise_kernel_matches_plain_version(dtype):
    g = torch.Generator(device="cpu").manual_seed(0)
    shape = (3, 37, 256, 1)
    spec = (torch.rand(shape, generator=g) - 0.5).to("cuda", dtype)
    thr = (torch.rand(shape, generator=g) * 0.1).to("cuda", dtype)
    cuda_noise.reset_launch_counts()
    got = cuda_noise.add_masked_noise(spec, thr, 11)
    want = cuda_noise.add_masked_noise_reference(spec, thr, 11)
    torch.cuda.synchronize()
    assert cuda_noise.launch_counts() == {"add_masked_noise": 1}
    err = float((got.float() - want.float()).abs().max())
    if dtype == torch.float32:
        assert err <= 1e-5 * float(thr.max())
    else:
        peak = float(want.float().abs().max())
        assert err <= 2.0 * 2.0 ** (math.floor(math.log2(peak)) - 7)
    for dev_u, cpu_u in zip(cuda_noise.uniforms(11, spec.numel(), "cuda"),
                            cuda_noise.uniforms(11, spec.numel(), "cpu")):
        assert torch.equal(dev_u.cpu(), cpu_u)


@pytest.mark.parametrize("offset,count", [(0, 1), (0, 7), (0, 9), (0, 4099),
                                          (1, 9), (1, 4099), (3, 40001)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_noise_kernel_at_ragged_counts_and_offsets(dtype, offset, count):
    """Counts that are not a multiple of 8 (the tail after the 16-byte
    vectors) and operands that start one or three elements into their
    buffers (the scalar path of a launch whose pointers are not 16-byte
    aligned): one launch, within the plain version's tolerance, and the
    uniforms bit for bit at that count."""
    g = torch.Generator(device="cpu").manual_seed(count)
    spec = (torch.rand(offset + count, generator=g) - 0.5).to("cuda", dtype)
    thr = (torch.rand(offset + count, generator=g) * 0.1).to("cuda", dtype)
    spec, thr = spec[offset:], thr[offset:]
    cuda_noise.reset_launch_counts()
    got = cuda_noise.add_masked_noise(spec, thr, 5)
    want = cuda_noise.add_masked_noise_reference(spec, thr, 5)
    torch.cuda.synchronize()
    assert cuda_noise.launch_counts() == {"add_masked_noise": 1}
    err = float((got.float() - want.float()).abs().max())
    if dtype == torch.float32:
        assert err <= 1e-5 * float(thr.max())
    else:
        peak = float(want.float().abs().max())
        assert err <= 2.0 * 2.0 ** (math.floor(math.log2(peak)) - 7)
    for dev_u, cpu_u in zip(cuda_noise.uniforms(5, count, "cuda"),
                            cuda_noise.uniforms(5, count, "cpu")):
        assert torch.equal(dev_u.cpu(), cpu_u)


def test_noise_kernel_moments():
    shape = (8, 64, 1024, 1)
    zero = torch.zeros(shape, device="cuda")
    z = cuda_noise.add_masked_noise(zero, torch.ones_like(zero), 0)
    z = z.double().flatten()
    n, sigma = z.numel(), 1.0 / 6.0
    assert abs(float(z.mean())) < 5 * sigma / math.sqrt(n)
    assert abs(float(z.std()) / sigma - 1.0) < 0.01
    assert 0.0020 < float((z.abs() > 3 * sigma).double().mean()) < 0.0035
    assert abs(float(((z / z.std()) ** 4).mean()) - 3.0) < 0.1
    again = cuda_noise.add_masked_noise(zero, torch.ones_like(zero), 0)
    other = cuda_noise.add_masked_noise(zero, torch.ones_like(zero), 1)
    assert torch.equal(again.double().flatten(), z)
    assert float((other.double().flatten() - z).abs().max()) > 1e-3


@pytest.mark.parametrize("design", ["mono", "radix"])
def test_round_trip_fast_launches_each_kernel_once(design):
    c = Codec.create(44100, filters_n=2048, kernel_design=design,
                     device="cuda")
    x = torch.zeros(2, 8 * 2048, 1, device="cuda")
    cuda_mdct.reset_launch_counts()
    cuda_noise.reset_launch_counts()
    out = c.round_trip_fast(x, 5)
    torch.cuda.synchronize()
    assert out.shape == (2, 10 * 2048, 1)
    assert cuda_mdct.launch_counts() == (
        MONO_ONCE if design == "mono" else RADIX_ONCE)
    assert cuda_noise.launch_counts() == {"add_masked_noise": 1}


def test_round_trip_fast_copies_nothing_to_the_card():
    from torch.profiler import ProfilerActivity, profile

    c = Codec.create(44100, compute_dtype="bfloat16", fast_bf16=True,
                     dct_precision="default", device="cuda")
    x = torch.zeros(2, 8 * 1024, 1, dtype=torch.bfloat16, device="cuda")
    c.round_trip_fast(x, 1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        c.round_trip_fast(x, 1)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("noise_kernel" in n for n in names)
    assert not [n for n in names if "HtoD" in n]


VJP_TIERS = [  # (design, compute dtype, fast_bf16, precision)
    ("mono", "float32", False, "highest"),
    ("mono", "float32", False, "high"),
    ("mono", "float32", False, "default"),
    ("mono", "bfloat16", True, "default"),
    ("mono", "float32", False, "int8"),
    ("radix", "float32", False, "highest"),
    ("radix", "bfloat16", True, "default"),
]


@pytest.mark.parametrize("n,blocks", [(256, 37), (1024, 130)])
@pytest.mark.parametrize("design,dtype,fast,precision", VJP_TIERS)
def test_vjps_match_autograd_through_the_plain_versions(design, dtype, fast,
                                                        precision, n, blocks):
    """Each Function's backward launches the other direction's kernel once
    and agrees with autograd through the plain forward version (at int8:
    the plain ``default`` forward on the dequantized matrix), at the
    forward kernels' tolerances."""
    m = MDCT(n, compute_dtype=dtype, fast_bf16=fast, use_kernel=True,
             dct_precision=precision, kernel_design=design, device="cuda")
    g = torch.Generator(device="cpu").manual_seed(blocks)
    for direction in ("forward", "inverse"):
        name = m.kernel_name(direction)
        x = (torch.rand(3, blocks, n, generator=g) * 2 - 1).to(
            "cuda", m.kernel_dtype).requires_grad_()
        cot = (torch.rand(3, blocks + 1, n, generator=g) * 2 - 1).to(
            "cuda", m.kernel_dtype)
        args = m.kernel_args(direction)
        cuda_mdct.reset_launch_counts()
        y = cuda_mdct.FUNCTIONS[name].apply(x, args, m.vjp_args(direction))
        got, = torch.autograd.grad(y, x, cot)
        torch.cuda.synchronize()
        assert cuda_mdct.launch_counts() == _once(name, f"{name}_vjp")
        plain_args = args
        if precision == "int8":
            d = "fwd" if direction == "forward" else "inv"
            deq = cuda_mdct.dequantized(getattr(m, f"kernel_q_{d}"),
                                        args[6])
            plain_args = (*args[:4], deq, "default", 1.0)
        plain = getattr(cuda_mdct, f"{name}_reference")
        want, = torch.autograd.grad(plain(x, *plain_args), x, cot)
        err = float((got.float() - want.float()).abs().max())
        assert got.shape == x.shape
        assert err <= _vjp_tol(want, m.kernel_precision, x.dtype), err


@pytest.mark.parametrize("n,blocks", [(1024, 1), (1024, 129), (2048, 64)])
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_split_tier_vjps_at_ragged_frame_counts(precision, n, blocks):
    """The split tiers' VJPs (the other direction's split kernel) around
    the 128-row tiles and at N=2048."""
    test_vjps_match_autograd_through_the_plain_versions(
        "mono", "float32", False, precision, n, blocks)


# The device functions of the analysis routes, the synthesis VJPs' own
ANALYSIS_ROUTES = ("tc_kernel", "split_kernel", "split_gemm_kernel",
                   "fold_rotate_kernel", "butterfly_out_kernel")


def _flip_route(m, g):
    """The synthesis VJP composed from the analysis kernel (the public
    wrapper) and torch flips: the kernel on the block-reversed cotangent
    with its lane halves exchanged, reversed back and cut to T frames."""
    vjp_args = m.vjp_args("inverse")
    h = g.shape[-1] // 2
    gr = torch.flip(g, (1,))
    gr = torch.cat([gr[..., h:], gr[..., :h]], dim=-1).contiguous()
    if m.kernel_design == "radix":
        out = cuda_mdct.radix_fold_matmul(gr, *vjp_args)
    else:  # the analysis wrapper takes mat_scale before the operand
        out = cuda_mdct.fold_matmul(gr, *vjp_args[:-1], 1.0, vjp_args[-1])
    return torch.flip(out, (1,))[:, 1:-1]


@pytest.mark.parametrize("n,blocks", [(1024, 1), (1024, 129), (2048, 64)])
@pytest.mark.parametrize("design,dtype,fast,precision", VJP_TIERS)
def test_synthesis_vjp_is_one_transposed_fold_launch(design, dtype, fast,
                                                     precision, n, blocks):
    """The synthesis VJP (one call of the analysis route in its
    transposed-fold mode) equals the flip route bit for bit, and a
    torch.profiler trace of one call holds the route's kernels and nothing
    else: no flip, cat, copy or slice."""
    from torch.profiler import ProfilerActivity, profile

    m = MDCT(n, compute_dtype=dtype, fast_bf16=fast, use_kernel=True,
             dct_precision=precision, kernel_design=design, device="cuda")
    vjp = getattr(cuda_mdct, f"{m.kernel_name('inverse')}_vjp")
    vjp_args = m.vjp_args("inverse")
    gen = torch.Generator(device="cpu").manual_seed(blocks)
    g = (torch.rand(3, blocks + 1, n, generator=gen) * 2 - 1).to(
        "cuda", m.kernel_dtype)
    cuda_mdct.reset_launch_counts()
    got = vjp(g, *vjp_args)
    torch.cuda.synchronize()
    assert cuda_mdct.launch_counts() == _once(vjp.__name__)
    assert got.shape == (3, blocks, n) and got.dtype == g.dtype
    assert torch.equal(got, _flip_route(m, g))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        vjp(g, *vjp_args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and all(any(f in nm for f in ANALYSIS_ROUTES)
                         for nm in names), names


def test_synthesis_vjps_refuse_a_one_frame_cotangent():
    """A cotangent of one frame has no VJP frame: refused before a launch,
    by the synthesis VJPs and the analysis ones."""
    for design in ("mono", "radix"):
        m = MDCT(256, use_kernel=True, kernel_design=design, device="cuda")
        for direction in ("inverse", "forward"):
            vjp = getattr(cuda_mdct, f"{m.kernel_name(direction)}_vjp")
            with pytest.raises(ValueError, match="T>=2"):
                vjp(torch.zeros(2, 1, 256, device="cuda"),
                    *m.vjp_args(direction))


# The device functions of the synthesis routes, the analysis VJPs' own
SYNTHESIS_ROUTES = ("tc_kernel", "split_kernel", "split_gemm_kernel",
                    "scatter_kernel", "butterfly_in_kernel")


def _scatter_flip_route(m, g):
    """The analysis VJP composed from the synthesis kernel (the public
    wrapper) and torch flips: the kernel on the block-reversed cotangent,
    reversed back, cut to T frames and its lane halves exchanged."""
    vjp_args = m.vjp_args("forward")
    gr = torch.flip(g, (1,)).contiguous()
    if m.kernel_design == "radix":
        out = cuda_mdct.radix_matmul_scatter(gr, *vjp_args)
    else:  # the synthesis wrapper takes mat_scale before the operand
        out = cuda_mdct.matmul_scatter(gr, *vjp_args[:-1], 1.0, vjp_args[-1])
    out = torch.flip(out, (1,))[:, 1:-1]
    h = g.shape[-1] // 2
    return torch.cat([out[..., h:], out[..., :h]], dim=-1)


@pytest.mark.parametrize("n,blocks", [(1024, 1), (1024, 129), (2048, 64)])
@pytest.mark.parametrize("design,dtype,fast,precision", VJP_TIERS)
def test_analysis_vjp_is_one_transposed_scatter_launch(design, dtype, fast,
                                                       precision, n, blocks):
    """The analysis VJP (one call of the synthesis route in its
    transposed-scatter mode) equals the flip route bit for bit, and a
    torch.profiler trace of one call holds the route's kernels and nothing
    else: no flip, cat, copy or slice."""
    from torch.profiler import ProfilerActivity, profile

    m = MDCT(n, compute_dtype=dtype, fast_bf16=fast, use_kernel=True,
             dct_precision=precision, kernel_design=design, device="cuda")
    vjp = getattr(cuda_mdct, f"{m.kernel_name('forward')}_vjp")
    vjp_args = m.vjp_args("forward")
    gen = torch.Generator(device="cpu").manual_seed(blocks)
    g = (torch.rand(3, blocks + 1, n, generator=gen) * 2 - 1).to(
        "cuda", m.kernel_dtype)
    cuda_mdct.reset_launch_counts()
    got = vjp(g, *vjp_args)
    torch.cuda.synchronize()
    assert cuda_mdct.launch_counts() == _once(vjp.__name__)
    assert got.shape == (3, blocks, n) and got.dtype == g.dtype
    assert torch.equal(got, _scatter_flip_route(m, g))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):  # one call of 2 frames may leave no event
            vjp(g, *vjp_args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and all(any(f in nm for f in SYNTHESIS_ROUTES)
                         for nm in names), names


def _vjp_tol(want, tier, dtype):
    """chip_smoke.py's ``vjp_tolerance``: 2e-5 of the peak at float32
    ``highest``; four bf16 ulps of the peak at the one-pass tiers, whose
    VJP rounds its operands to bf16 before each product where autograd
    through the plain forward rounds each product's gradient after it."""
    peak = float(want.float().abs().max())
    if tier in ("highest", "high") and dtype == torch.float32:
        return 2e-5 * peak
    return 4.0 * 2.0 ** (math.floor(math.log2(peak)) - 7)


@pytest.mark.parametrize("design", ["mono", "radix"])
def test_training_step_launches_each_kernel_once(design):
    from audiocodec_tpu_torch.models import spectral_ae as sae

    c = Codec.create(44100, filters_n=1024, kernel_design=design,
                     device="cuda")
    cfg = sae.SpectralAE(1024, 64, 16)
    params = sae.init_params(torch.Generator().manual_seed(0), cfg)
    step, make_opt = sae.make_train_step(c, cfg)
    opt = make_opt(list(params.values()))
    x = torch.rand(2, 8 * 1024, 1, device="cuda") - 0.5
    cuda_mdct.reset_launch_counts()
    loss = step(params, opt, x)
    torch.cuda.synchronize()
    names = [c.mdct.kernel_name(d) for d in ("forward", "inverse")]
    assert cuda_mdct.launch_counts() == _once(*names, f"{names[1]}_vjp")
    assert bool(torch.isfinite(loss))


def test_rvq_serves_and_trains_through_the_kernels():
    """The discrete codec on the card: encode_discrete launches the
    analysis once, decode_discrete the synthesis once, the codes survive
    the pack, and each training step launches the analysis, the synthesis
    and the synthesis VJP once a run op by op: the warmup's and the
    quantizer's first steps run op by op and then capture their CUDA graph
    (the wrappers run again inside the capture: twice each), and a later
    step replays the graph (none from the host)."""
    from audiocodec_tpu_torch.models import rvq
    from audiocodec_tpu_torch.models import spectral_ae as sae

    c = Codec.create(44100, filters_n=1024, device="cuda")
    cfg, rcfg = sae.SpectralAE(1024, 64, 16), rvq.RVQ(2, 64, 16)
    params = sae.init_params(torch.Generator().manual_seed(0), cfg)
    state = rvq.init_state(torch.Generator().manual_seed(1), rcfg)
    x = torch.rand(2, 8 * 1024, 1, device="cuda") - 0.5
    cuda_mdct.reset_launch_counts()
    codes = rvq.encode_discrete(c, cfg, rcfg, params, state, x)
    assert cuda_mdct.launch_counts() == _once("fold_matmul")
    back = rvq.unpack_codes(rcfg, rvq.pack_codes(rcfg, codes),
                            tuple(codes.shape))
    assert np.array_equal(back, codes.cpu().numpy())
    cuda_mdct.reset_launch_counts()
    y = rvq.decode_discrete(c, cfg, rcfg, params, state, back)
    assert cuda_mdct.launch_counts() == _once("matmul_scatter")
    assert y.shape == (2, 10 * 1024, 1) and bool(torch.isfinite(y).all())
    step, make_opt = rvq.make_train_step(c, cfg, rcfg, warmup_steps=1)
    opt = make_opt(list(params.values()))
    gen = torch.Generator(device="cuda").manual_seed(2)
    once = _once("fold_matmul", "matmul_scatter", "matmul_scatter_vjp")
    for i in range(3):
        cuda_mdct.reset_launch_counts()
        rvq.reset_counts()
        loss = step(params, state, opt, x, gen, i)
        torch.cuda.synchronize()
        counts = rvq.counts()
        runs = counts["direct"] + counts["captured"]
        assert [counts[k] for k in ("direct", "captured", "replayed")] == (
            [1, 1, 0] if i < 2 else [0, 0, 1])
        assert cuda_mdct.launch_counts() == {k: runs * v
                                             for k, v in once.items()}
        assert bool(torch.isfinite(loss))


@pytest.fixture(scope="module")
def probe_matrices():
    from audiocodec_tpu_torch.ops import cuda_probe

    m = cuda_probe.probe_matrices()
    mats = {"bf16": m["bf16"].cuda(), "int8": m["int8"].cuda()}
    return dict(m, **mats, ops={k: cuda_probe.operand(v)
                                for k, v in mats.items()})


@pytest.mark.parametrize("rows", [14336, 1, 127, 1000])
@pytest.mark.parametrize("variant", ["bf16", "int8", "int8_grouped"])
def test_probe_kernels_match_plain_versions(variant, rows, probe_matrices):
    """The int8 probe's kernels at its shape and at ragged row counts
    (around the 64- and 128-row tiles): int8 and int8g bit for bit, bf16
    within the ``default`` tier's 1e-5 of the peak (float32 sums in another
    order)."""
    from audiocodec_tpu_torch.ops import cuda_probe
    from audiocodec_tpu_torch.probes import int8_probe

    m = probe_matrices
    mat = m["bf16" if variant == "bf16" else "int8"]
    op = m["ops"]["bf16" if variant == "bf16" else "int8"]
    args = () if variant == "bf16" else (m["rescale"],)
    x = torch.from_numpy(int8_probe.make_input(rows)).cuda()
    kernel = getattr(cuda_probe, f"probe_{variant}")
    plain = getattr(cuda_probe, f"probe_{variant}_reference")
    cuda_probe.reset_launch_counts()
    got = kernel(x, mat, *args, op)
    torch.cuda.synchronize()
    assert cuda_probe.launch_counts()[f"probe_{variant}"] == 1
    want = plain(x, mat, *args)
    assert got.shape == want.shape == (rows, 1024)
    if variant == "bf16":
        peak = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * peak
    else:
        assert torch.equal(got, want)


def test_probe_kernels_refuse_what_they_do_not_take(probe_matrices):
    from audiocodec_tpu_torch.ops import cuda_probe

    m = probe_matrices
    x = torch.zeros(4, 1024, device="cuda")
    with pytest.raises(ValueError, match="operand"):
        cuda_probe.probe_bf16(x, m["bf16"])  # no operand form
    with pytest.raises(ValueError, match="operand"):
        cuda_probe.probe_int8(x, m["int8"], m["rescale"], m["ops"]["bf16"])
    with pytest.raises(ValueError, match="float32"):
        cuda_probe.probe_bf16(x[:, :512].contiguous(), m["bf16"],
                              m["ops"]["bf16"])
