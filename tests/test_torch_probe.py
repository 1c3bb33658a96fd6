"""The port's int8 probe held against the JAX package's on the CPU.

``benchmarks/pallas_int8_probe.py --interpret`` runs the Pallas probe's three
bodies in interpret mode at its full shape; the port's probe on ``--device
cpu`` runs its kernels' plain versions on the same x. The SNRs must agree
within 0.02 dB (the JAX probe prints them rounded to 0.01), the int8 codes
and scales bit for bit, and the matrices must be the probe's own."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocodec_tpu.ops import dct as jax_dct
from audiocodec_tpu_torch.ops import cuda_probe
from audiocodec_tpu_torch.ops import dct as _dct
from audiocodec_tpu_torch.probes import int8_probe

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "benchmarks" / "pallas_int8_probe.py"
SNR_DB = 0.02
PAIRS = {"cuda_bf16": "pallas_bf16", "cuda_int8": "pallas_int8",
         "cuda_int8_grouped": "pallas_int8_grouped",
         "torch_int8": "xla_int8"}


@pytest.fixture(scope="module")
def jax_probe():
    """The JAX probe's printed result, and whether its process had the
    persistent compilation cache on. The script names a fixed cache
    directory, not one inside the checkout that runs it; the run turns the
    cache off, as the CPU lane runs JAX (tests/conftest.py)."""
    code = (
        "import json, runpy, sys, jax; "
        f"sys.argv = [{str(SCRIPT)!r}, '--interpret']; "
        f"runpy.run_path({str(SCRIPT)!r}, run_name='__main__'); "
        "print(json.dumps({'compilation_cache': "
        "jax.config.jax_enable_compilation_cache}))"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=600, check=True,
        env={**os.environ, "JAX_ENABLE_COMPILATION_CACHE": "false"},
    ).stdout.strip().splitlines()
    return json.loads(out[-2]), json.loads(out[-1])


@pytest.fixture(scope="module")
def port_probe():
    return int8_probe.run("cpu")


@pytest.mark.parametrize("variant", sorted(PAIRS))
def test_snr_matches_the_jax_probe(variant, port_probe, jax_probe):
    jax_probe, _ = jax_probe
    got, want = port_probe[f"{variant}_snr_db"], jax_probe[
        f"{PAIRS[variant]}_snr_db"]
    assert abs(got - want) <= SNR_DB, (variant, got, want)
    assert (port_probe["rows"], port_probe["n"]) == (jax_probe["rows"],
                                                       jax_probe["n"])


def test_jax_probe_runs_without_a_compilation_cache(jax_probe):
    assert jax_probe[1] == {"compilation_cache": False}


def test_cpu_run_prints_snrs_only(port_probe):
    assert set(port_probe) == {"rows", "n", "tb"} | {
        f"{v}_snr_db" for v in PAIRS}
    assert port_probe["tb"] == {"bf16": 128, "int8": 128, "int8_grouped": 128}


@pytest.mark.parametrize("grouped", [False, True])
def test_codes_and_scales_bit_equal_to_int8_rowquant(grouped):
    """The port's quantization (each row, or each row's 128-column
    groups) of the probe's x against the JAX package's recipe."""
    x = int8_probe.make_input()
    if grouped:
        x = x.reshape(x.shape[0], -1, 128)
    qj, sj = jax_dct.int8_rowquant(jnp.asarray(x))
    qt, st = _dct.int8_rowquant(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_matrices_are_the_probes():
    """pallas_int8_probe.py:52-66, written out."""
    n = 1024
    k = np.arange(n)
    mat = np.sqrt(2.0 / n) * np.cos(
        np.pi / n * (k[:, None] + 0.5) * (k[None, :] + 0.5))
    s_m = float(np.max(np.abs(mat)))
    mat_bf16 = jnp.asarray(mat.astype(np.float32), dtype=jnp.bfloat16)
    mat_i8 = np.clip(np.round(mat / s_m * 127.0), -127, 127).astype(np.int8)
    m = cuda_probe.probe_matrices(n)
    np.testing.assert_array_equal(m["mat"], mat)
    np.testing.assert_array_equal(m["f32"].numpy(), mat.astype(np.float32))
    np.testing.assert_array_equal(
        m["bf16"].view(torch.int16).numpy(),
        np.asarray(mat_bf16).view(np.int16))
    np.testing.assert_array_equal(m["int8"].numpy(), mat_i8)
    assert m["rescale"] == s_m / (127.0 * 127.0)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """On a CPU tensor a wrapper is its plain version and counts no launch;
    ragged row counts need nothing of the kernels' tiles."""
    m = cuda_probe.probe_matrices()
    cuda_probe.reset_launch_counts()
    for rows in (1, 127, 1000):
        x = torch.from_numpy(int8_probe.make_input(rows))
        assert torch.equal(cuda_probe.probe_bf16(x, m["bf16"]),
                           cuda_probe.probe_bf16_reference(x, m["bf16"]))
        for fn in ("probe_int8", "probe_int8_grouped"):
            got = getattr(cuda_probe, fn)(x, m["int8"], m["rescale"])
            want = getattr(cuda_probe, f"{fn}_reference")(
                x, m["int8"], m["rescale"])
            assert got.shape == (rows, 1024) and torch.equal(got, want)
    assert cuda_probe.launch_counts() == {
        "probe_bf16": 0, "probe_int8": 0, "probe_int8_grouped": 0}


def test_int8_reference_is_the_probes_arithmetic():
    """The plain int8 versions against the Pallas bodies' arithmetic written
    in numpy (float32 scale, true division, round half to even, integer
    sums, float32 epilogue in the bodies' order), on a few rows."""
    m = cuda_probe.probe_matrices()
    x = int8_probe.make_input(16)
    q8 = m["int8"].numpy().astype(np.int64)
    f32 = np.float32
    rescale = f32(m["rescale"])

    def quant(u):
        s = np.abs(u).max(axis=1, keepdims=True) + f32(1e-12)
        q = np.clip(np.round(u * (f32(127.0) / s)), -127, 127)
        return q.astype(np.int64), s

    q, s = quant(x)
    want = (q @ q8).astype(f32) * (s * rescale)
    got = cuda_probe.probe_int8_reference(torch.from_numpy(x), m["int8"],
                                          m["rescale"])
    np.testing.assert_array_equal(got.numpy(), want)
    acc = np.zeros((16, 1024), f32)
    for j in range(8):
        q, s = quant(x[:, j * 128:(j + 1) * 128])
        acc = acc + (q @ q8[j * 128:(j + 1) * 128]).astype(f32) * s
    got = cuda_probe.probe_int8_grouped_reference(
        torch.from_numpy(x), m["int8"], m["rescale"])
    np.testing.assert_array_equal(got.numpy(), acc * rescale)


def test_card_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="card"):
        int8_probe.run()


@pytest.mark.parametrize("variant", ["bf16", "int8", "int8_grouped"])
def test_wrapper_refuses_an_operand_of_the_wrong_form(variant):
    """The kernels' checks (run before a launch, here on CPU tensors): the
    operand form of the other tier, a missing, transposed-view, misshapen
    or misaligned operand, and x of another shape or dtype."""
    m = cuda_probe.probe_matrices()
    key = "bf16" if variant == "bf16" else "int8"
    op = cuda_probe.operand(m[key])
    other = cuda_probe.operand(m["int8" if key == "bf16" else "bf16"])
    x = torch.zeros(4, 1024)
    cuda_probe._check(variant, x, op)  # accepted
    flat = torch.zeros(1024 * 1024 + 16, dtype=op.dtype)
    for bad in (None, other, op.T, op[:512].contiguous(),
                flat[1:1024 * 1024 + 1].view(1024, 1024)):
        with pytest.raises(ValueError):
            cuda_probe._check(variant, x, bad)
    for xb in (torch.zeros(4, 512), torch.zeros(0, 1024),
               torch.zeros(4, 1024, dtype=torch.float64)):
        with pytest.raises(ValueError, match="float32"):
            cuda_probe._check(variant, xb, op)
    with pytest.raises(ValueError, match="no kernel for a tensor on cpu"):
        cuda_probe._launch(variant, x, op)


H100_SHARED_BYTES = 232448  # the dynamic shared memory a CTA may opt into


@pytest.mark.parametrize("variant", ["bf16", "int8", "int8_grouped"])
def test_tile_constants_agree_with_the_kernel_geometry(variant):
    """The kernels' geometry as the Python constants state it
    (csrc/probe_kernels.cu BM, IC, Cfg/Layout; chip_smoke.py holds
    ``shared_bytes`` to ``acx_probe_shared_bytes`` on the card): a 128 KB
    A tile of TILE_ROWS rows of the CTA's share of K, whose 128-byte K
    tiles are the wgmma groups of int8g, a CTA that fits the card with
    its ring as deep as the room allows, and the launch's row tiles
    (csrc launch) at the probe's 14336 rows on the H100's 132 SMs: at int8
    one whole tile of at most 128 rows for each CTA, at bf16 tiles of 128
    rows over 66 clusters of two."""
    esize = 2 if variant == "bf16" else 1
    rows, cols = cuda_probe.TILE_ROWS[variant], cuda_probe.TILE_COLUMNS[variant]
    kc = cuda_probe.N // cuda_probe.KSPLIT[variant]  # K of a CTA
    assert rows * kc * esize == 128 * 1024
    assert kc * esize // 128 == 8  # K tiles of 128 bytes: int8g's groups
    assert rows == 2 * 64 and cols % 128 == 0 and cuda_probe.N % cols == 0
    stage = cols * 128
    smem = cuda_probe.shared_bytes(variant)
    # the int8 tiers' scales, or the partial sums a bf16 warpgroup receives
    extra = 4 * 64 * cols if variant == "bf16" else 4 * rows * 8
    assert smem == (1024 + 128 * 1024 + cuda_probe.STAGES[variant] * stage
                    + 128 + extra)
    assert smem <= H100_SHARED_BYTES < smem + stage  # the ring fills the CTA
    assert smem == {"bf16": 230528, "int8": 218240,
                    "int8_grouped": 218240}[variant]
    rows_n, groups = int8_probe.ROWS, 132 // cuda_probe.KSPLIT[variant]
    tile_rows = rows
    if variant != "bf16":  # whole tiles, `per` a CTA
        per = -(-(-(-rows_n // rows)) // groups)
        tile_rows = -(-rows_n // (groups * per))
        assert per == 1 and groups * tile_rows >= rows_n
    items = -(-rows_n // tile_rows) * (cuda_probe.N // cols)
    assert (tile_rows, items) == ((128, 896) if variant == "bf16"
                                  else (109, 1056))
    assert (2 * cuda_probe.STAGES[variant] + 2) * 8 <= 128  # barriers
