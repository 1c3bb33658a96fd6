"""The PyTorch port's building blocks held against the JAX package on the CPU:
host builders (exactly equal), the dtype policy, the int8 recipe, the kernel
wrappers' CPU behaviour and the build's refusal to fall back."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocodec_tpu import psycho as jax_psycho
from audiocodec_tpu.ops import dct as jax_dct
from audiocodec_tpu.ops import folding as jax_folding
from audiocodec_tpu.ops import windows as jax_windows
from audiocodec_tpu_torch import psycho as t_psycho
from audiocodec_tpu_torch.ops import _build
from audiocodec_tpu_torch.ops import cuda_mdct
from audiocodec_tpu_torch.ops import dct as t_dct
from audiocodec_tpu_torch.ops import folding as t_folding
from audiocodec_tpu_torch.ops import windows as t_windows
from audiocodec_tpu_torch.utils import dtypes as t_dtypes

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


# -- numpy builders: exactly equal --------------------------------------------


@pytest.mark.parametrize("window_type", ["vorbis", "sine", None])
@pytest.mark.parametrize("n", [64, 1024])
def test_window_and_fold_builders_equal(window_type, n):
    w = t_windows.window_coefficients(n, window_type)
    np.testing.assert_array_equal(
        w, jax_windows.window_coefficients(n, window_type)
    )
    np.testing.assert_array_equal(
        t_windows.window_completion(w, n), jax_windows.window_completion(w, n)
    )
    got = t_folding.make_fold_coefficients(n, window_type)
    want = jax_folding.make_fold_coefficients(n, window_type)
    for field in ("wa_r", "wb", "wc", "ffr", "p", "q", "r", "s_r"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    for mine, theirs in (
        (t_folding.dense_fold_matrices, jax_folding.dense_fold_matrices),
        (t_folding.dense_unfold_matrices, jax_folding.dense_unfold_matrices),
    ):
        for a, b in zip(mine(n, window_type), theirs(n, window_type)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [256, 1024])
def test_dct_matrix_equal(n):
    np.testing.assert_array_equal(t_dct.dct4_matrix(n), jax_dct.dct4_matrix(n))


@pytest.mark.parametrize("sr,filters,bands", [(44100, 1024, 64),
                                              (16000, 256, 48)])
def test_psycho_builders_equal(sr, filters, bands):
    for a, b in zip(t_psycho._bark_freq_mapping(sr, filters, bands),
                    jax_psycho._bark_freq_mapping(sr, filters, bands)):
        np.testing.assert_array_equal(a, b)
    max_bark = float(jax_psycho.freq2bark(sr / 2.0))
    np.testing.assert_array_equal(
        t_psycho._spreading_matrix(bands, max_bark, 0.6),
        jax_psycho._spreading_matrix(bands, max_bark, 0.6),
    )
    np.testing.assert_array_equal(
        t_psycho._quiet_threshold_intensity(bands, max_bark, -20.0),
        jax_psycho._quiet_threshold_intensity(bands, max_bark, -20.0),
    )


# -- dtype policy --------------------------------------------------------------


@pytest.mark.parametrize("bad", [torch.float16, "float16", torch.int32])
def test_float16_and_non_floats_rejected(bad):
    with pytest.raises(TypeError, match="float16 lacks"):
        t_dtypes.canonicalize_compute_dtype(bad)


@pytest.mark.parametrize("name,want", [("float32", torch.float32),
                                       (torch.bfloat16, torch.bfloat16),
                                       ("torch.float64", torch.float64)])
def test_compute_dtype_canonicalized(name, want):
    assert t_dtypes.canonicalize_compute_dtype(name) is want


def test_no_implicit_cast():
    with pytest.raises(TypeError, match="never casts implicitly"):
        t_dtypes.check_input_dtype(torch.zeros(2, dtype=torch.float64),
                                   torch.float32)
    assert t_dtypes.scalar(0.6, torch.bfloat16).item() == float(
        jnp.asarray(0.6, jnp.bfloat16)
    )


# -- the int8 recipe: same codes and scales as the JAX package -----------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_rowquant_matches_jax(dtype):
    rng = np.random.default_rng(1)
    u = rng.normal(scale=0.1, size=(6, 256)).astype(np.float32)
    u[0, :3] = [0.5, -0.5, 0.25]  # ties at 127 * x / s: round half to even
    uj = jnp.asarray(u, dtype=getattr(jnp, dtype))
    qj, sj = jax_dct.int8_rowquant(uj)
    qt, st = t_dct.int8_rowquant(
        torch.from_numpy(u).to(getattr(torch, dtype))
    )
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_int8_matmul_matches_jax():
    """The XLA-side int8 tier (dynamic matrix scale): 1e-6 x max|ref|."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (5, 256)).astype(np.float32)
    m = (t_dct.dct4_matrix(256) / 32.0).astype(np.float32)
    want = np.asarray(jax_dct._int8_matmul(jnp.asarray(x), jnp.asarray(m)))
    got = t_dct._int8_matmul(torch.from_numpy(x), torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_int_matmul_is_exact():
    q = torch.full((2, 1024), 127, dtype=torch.int8)
    qm = torch.full((1024, 3), -127, dtype=torch.int8)
    assert (t_dct.int_matmul(q, qm) == -127 * 127 * 1024).all()


# -- wrappers on the CPU, and no fallback off it -------------------------------


def _fold_args(n=256, t=5, tier="int8"):
    rng = np.random.default_rng(3)
    c = t_folding.make_fold_coefficients(n, "vorbis")
    x = torch.from_numpy(rng.uniform(-1, 1, (2, t, n)).astype(np.float32))
    w = [torch.tensor(getattr(c, f), dtype=torch.float32)
         for f in ("wa_r", "wb", "wc", "ffr")]
    q, scale = cuda_mdct.host_int8(t_dct.dct4_matrix(n) / np.sqrt(4.0 * n))
    return x, w, torch.from_numpy(q), scale


def test_cpu_tensor_takes_the_plain_version_and_counts_nothing():
    x, w, q, scale = _fold_args()
    cuda_mdct.reset_launch_counts()
    got = cuda_mdct.fold_matmul(x, *w, q, "int8", scale)
    want = cuda_mdct.fold_matmul_reference(x, *w, q, "int8", scale)
    assert torch.equal(got, want) and got.shape == (2, 6, 256)
    assert set(cuda_mdct.launch_counts().values()) == {0}


def test_other_devices_raise():
    x, w, q, scale = _fold_args()
    meta = lambda t: t.to("meta")  # noqa: E731
    with pytest.raises(ValueError, match="no kernel for a tensor on meta"):
        cuda_mdct.fold_matmul(meta(x), *map(meta, w), meta(q), "int8", scale)
    with pytest.raises(ValueError, match="no kernel for a tensor on meta"):
        cuda_mdct.matmul_scatter(meta(x), *map(meta, w), meta(q), "int8",
                                 scale)


def test_build_without_nvcc_raises(tmp_path):
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(nvcc=str(tmp_path / "no-such-dir" / "nvcc"),
                     build_dir=tmp_path)
    assert not any(tmp_path.iterdir())


def test_import_loads_no_jax():
    code = ("import sys, audiocodec_tpu_torch, audiocodec_tpu_torch.convert, "
            "audiocodec_tpu_torch.models, audiocodec_tpu_torch.parallel, "
            "audiocodec_tpu_torch.ops.threefry, audiocodec_tpu_torch.scq, "
            "audiocodec_tpu_torch.tns, audiocodec_tpu_torch.blockswitch, "
            "audiocodec_tpu_torch.nf, audiocodec_tpu_torch.bwe, "
            "audiocodec_tpu_torch.intensity, audiocodec_tpu_torch.io.wav, "
            "audiocodec_tpu_torch.io.bitstream, audiocodec_tpu_torch.native, "
            "audiocodec_tpu_torch.rate, audiocodec_tpu_torch.streaming, "
            "audiocodec_tpu_torch.io.stream_container, "
            "audiocodec_tpu_torch.lossless, audiocodec_tpu_torch.metrics, "
            "audiocodec_tpu_torch.resample, audiocodec_tpu_torch.__main__, "
            "audiocodec_tpu_torch.serve, audiocodec_tpu_torch.parallel.mesh, "
            "audiocodec_tpu_torch.parallel.corpus, "
            "audiocodec_tpu_torch.parallel.pipeline, "
            "audiocodec_tpu_torch.parallel.multihost, "
            "audiocodec_tpu_torch.parallel.sequence, "
            "audiocodec_tpu_torch.utils.device, "
            "audiocodec_tpu_torch.utils.serialization; "
            "bad = [m for m in sys.modules if m in ('jax', 'ml_dtypes') or "
            "m.startswith(('jax.', 'ml_dtypes.', 'audiocodec_tpu.')) or "
            "m == 'audiocodec_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
