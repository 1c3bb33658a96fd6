"""The port's MDCT held against the JAX package's on the CPU.

The kernel tiers compare the plain versions of the port's kernels (what a
CPU tensor runs) with the JAX Pallas kernels in interpret mode. That matters
most at int8, where the JAX package's XLA path is a different computation
(dense fold-into-matmul, synthesis at ``default``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from audiocodec_tpu.mdct import MDCT as JaxMDCT
from audiocodec_tpu_torch import MDCT

torch.set_num_threads(1)


def _inputs(shape, dtype_name, seed, scale=1.0):
    """The same values for both frameworks: numpy float32 (or float64),
    rounded to bf16 by each side's own round-to-nearest-even cast."""
    rng = np.random.default_rng(seed)
    np_dtype = np.float64 if dtype_name == "float64" else np.float32
    x = rng.uniform(-scale, scale, shape).astype(np_dtype)
    xj = jnp.asarray(x, dtype=getattr(jnp, dtype_name))
    xt = torch.from_numpy(x).to(getattr(torch, dtype_name))
    return xj, xt


def _np(a):
    return np.asarray(jnp.asarray(a, dtype=jnp.float64)) if not isinstance(
        a, torch.Tensor) else a.to(torch.float64).numpy()


@pytest.mark.parametrize("dtype,fwd_atol,inv_atol", [
    ("float64", 1e-12, 1e-10),
    ("float32", 1e-6, 1e-4),
])
@pytest.mark.parametrize("window_type", ["vorbis", "sine", None])
def test_mdct_highest_matches_jax(dtype, fwd_atol, inv_atol, window_type):
    n = 256
    jm = JaxMDCT.create(n, window_type=window_type,
                        compute_dtype=getattr(jnp, dtype), use_pallas=False)
    tm = MDCT(n, window_type=window_type, compute_dtype=dtype, device="cpu")
    xj, xt = _inputs((2, 6 * n, 2), dtype, 0)
    yj, yt = jm.transform(xj), tm.transform(xt)
    assert yt.shape == (2, 7, n, 2) and yt.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=0, atol=fwd_atol)
    sj, st = _inputs((2, 5, n, 2), dtype, 1, scale=0.5)
    oj, ot = jm.inverse_transform(sj), tm.inverse_transform(st)
    assert ot.shape == (2, 6 * n, 2)
    np.testing.assert_allclose(_np(ot), _np(oj), rtol=0, atol=inv_atol)


@pytest.mark.parametrize("precision", ["default", "int8"])
def test_dense_formulation_matches_jax(precision):
    """The one-pass tiers off the kernels run the dense two-matmul form.
    JAX's CPU matmul keeps full float32 where the port rounds operands to
    bf16 at ``default`` (the tier's definition), so they agree to that
    tier's error."""
    n = 256
    jm = JaxMDCT.create(n, dct_precision=precision, use_pallas=False)
    tm = MDCT(n, dct_precision=precision, device="cpu")
    assert tm.dense_fwd_cur is not None and not tm.kernel_fwd
    np.testing.assert_array_equal(tm.dense_fwd_cur.numpy(),
                                  np.asarray(jm.dense_fwd_cur))
    xj, xt = _inputs((1, 5 * n, 1), "float32", 2)
    yj, yt = _np(jm.transform(xj)), _np(tm.transform(xt))
    np.testing.assert_allclose(yt, yj, rtol=0, atol=2e-2 * np.abs(yj).max())


# (dtype, precision, fast_bf16, tolerance kind)
KERNEL_TIERS = [
    ("float32", "highest", False, "highest"),
    ("float32", "default", False, "f32_default"),
    ("bfloat16", "default", True, "bf16"),
    ("float32", "int8", False, "int8"),
    ("bfloat16", "int8", True, "bf16"),
]


def _assert_tier(got, want, kind, direction):
    peak = np.abs(want).max()
    atol = {
        "highest": 1e-6 if direction == "fwd" else 1e-4,
        "f32_default": 1e-5 * peak,
        "int8": 1e-6 * peak,
        # two bf16 ulps of the largest value
        "bf16": 2.0 * 2.0 ** (np.floor(np.log2(peak)) - 7),
    }[kind]
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("blocks", [3, 8, 37])
@pytest.mark.parametrize("dtype,precision,fast,kind", KERNEL_TIERS)
def test_kernel_plain_versions_match_pallas(n, blocks, dtype, precision, fast,
                                            kind):
    jm = JaxMDCT.create(n, compute_dtype=getattr(jnp, dtype), fast_bf16=fast,
                        use_pallas=True, dct_precision=precision,
                        pallas_kernel="mono")
    tm = MDCT(n, compute_dtype=dtype, fast_bf16=fast, use_kernel=True,
              dct_precision=precision, device="cpu")
    xj, xt = _inputs((2, blocks * n, 1), dtype, blocks)
    sj, st = _inputs((2, blocks, n, 1), dtype, blocks + 1, scale=0.05)
    with pltpu.force_tpu_interpret_mode():
        yj = _np(jm.transform(xj))
        oj = _np(jm.inverse_transform(sj))
    _assert_tier(_np(tm.transform(xt)), yj, kind, "fwd")
    _assert_tier(_np(tm.inverse_transform(st)), oj, kind, "inv")


def test_kernel_round_trip_reconstructs():
    n = 256
    tm = MDCT(n, use_kernel=True, device="cpu")
    _, xt = _inputs((1, 10 * n, 1), "float32", 5)
    rt = tm.inverse_transform(tm.transform(xt))
    assert float((xt - rt[:, n:-n]).abs().max()) < 1e-5


class TestUseKernel:
    def test_auto_is_off_on_the_cpu(self):
        m = MDCT(1024, device="cpu")
        assert m.use_kernel is False
        assert m.kernel_q_fwd is None and m.kernel_q_inv is None

    @pytest.mark.parametrize("mode,fwd,inv", [
        ("forward", True, False), ("inverse", False, True), (True, True, True),
    ])
    def test_directions(self, mode, fwd, inv):
        m = MDCT(256, use_kernel=mode, dct_precision="int8", device="cpu")
        assert (m.kernel_fwd, m.kernel_inv) == (fwd, inv)
        assert (m.kernel_q_fwd is not None) == fwd
        assert (m.dense_inv_cur is not None) == (not inv)

    @pytest.mark.parametrize("kwargs,match", [
        (dict(filters_n=192, use_kernel=True), "multiple of 256"),
        (dict(filters_n=256, use_kernel=True, compute_dtype="float64"),
         "non-float64"),
        (dict(filters_n=256, use_kernel="both"), "use_kernel must be"),
        (dict(filters_n=256, dct_precision="int8", compute_dtype="float64"),
         "float64"),
        (dict(filters_n=255), "even"),
    ])
    def test_rejected(self, kwargs, match):
        with pytest.raises(ValueError, match=match):
            MDCT(device="cpu", **kwargs)

    def test_bf16_kernel_runs_one_pass(self):
        m = MDCT(256, compute_dtype="bfloat16", fast_bf16=True,
                 use_kernel=True, device="cpu")
        assert m.kernel_dtype == torch.bfloat16
        assert m.kernel_precision == "default"
        slow = MDCT(256, compute_dtype="bfloat16", use_kernel=True,
                    device="cpu")
        assert slow.kernel_dtype == torch.float32
        assert slow.kernel_precision == "highest"

    def test_input_dtype_enforced(self):
        with pytest.raises(TypeError, match="never casts"):
            MDCT(256, device="cpu").transform(
                torch.zeros(1, 256, 1, dtype=torch.float64))
