"""The port's training path held against the JAX package on the CPU: the
spectral autoencoder, the post-filter and the per-band-gain trainer.

Both packages start from the same weights (``convert.params_from_arrays``)
and the same codec (``convert.codec_from_arrays``): the JAX codec runs its
Pallas kernels in interpret mode, the port its kernels' plain versions
(``use_kernel=True`` on the CPU), so the gradients reach the synthesis
kernel's VJP on both sides. There is no latent noise in the comparisons
(``key=None`` in JAX, no generator in the port). The JAX tests' own checks
(tests/test_models.py, tests/test_parallel.py) are ported beside them.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from audiocodec_tpu.codec import Codec as JaxCodec
from audiocodec_tpu.models import post_filter as jax_pf
from audiocodec_tpu.models import spectral_ae as jax_sae
from audiocodec_tpu.parallel import make_mesh
from audiocodec_tpu.parallel import train as jax_train
from audiocodec_tpu_torch import MDCT, Codec, PsychoacousticModel, convert
from audiocodec_tpu_torch.models import post_filter as pf
from audiocodec_tpu_torch.models import rvq
from audiocodec_tpu_torch.models import spectral_ae as sae
from audiocodec_tpu_torch.parallel import train
from audiocodec_tpu_torch.probes import int8_probe
from tests.test_torch_codec import _leaves_and_meta

torch.set_num_threads(1)

SR, N = 16000, 256
LOSS_RTOL, GRAD_RTOL, STEP_ATOL = 1e-5, 1e-4, 1e-4


@pytest.fixture(scope="module")
def codecs():
    jc = JaxCodec.create(SR, filters_n=N, bark_bands_n=16, use_pallas=True)
    tc = convert.codec_from_arrays(*_leaves_and_meta(jc), device="cpu")
    assert tc.mdct.kernel_fwd and tc.mdct.kernel_inv
    return jc, tc


def _wave(batch=2, blocks=8, seed=0):
    """A tone plus noise, [batch, blocks*N, 1], the same for both."""
    rng = np.random.default_rng(seed)
    t = np.arange(blocks * N)
    x = 0.5 * np.sin(2 * np.pi * 880 / SR * t)[None, :, None] \
        + 0.05 * rng.normal(size=(batch, blocks * N, 1))
    x = x.astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _to_port(params_j):
    return convert.params_from_arrays(
        {k: np.asarray(v) for k, v in params_j.items()}, device="cpu")


def _assert_grads(grads_t, grads_j):
    for name, g in grads_t.items():
        want = np.asarray(grads_j[name], dtype=np.float64)
        np.testing.assert_allclose(
            g.double().numpy(), want, rtol=0,
            atol=GRAD_RTOL * max(np.abs(want).max(), 1e-30), err_msg=name)


def _assert_params(params_t, params_j):
    for name, p in params_t.items():
        np.testing.assert_allclose(
            p.detach().double().numpy(),
            np.asarray(params_j[name], dtype=np.float64), rtol=0,
            atol=STEP_ATOL, err_msg=name)


def _value_and_grad(loss, params):
    value = loss(params)
    grads = torch.autograd.grad(value, list(params.values()))
    return value.detach(), dict(zip(params, grads))


def test_entry_points_default_to_the_card():
    """Every entry point builds on the card unless the caller asks for the
    CPU; without a card, building with the default raises and does not
    land on the CPU."""
    for fn in (MDCT, Codec.create, PsychoacousticModel,
               convert.codec_from_arrays, convert.params_from_arrays,
               convert.rvq_state_from_arrays, sae.init_params, pf.init_params,
               rvq.init_state, int8_probe.run):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            MDCT(256)
        with pytest.raises((AssertionError, RuntimeError)):
            Codec.create(SR, filters_n=256, bark_bands_n=16)
        with pytest.raises((AssertionError, RuntimeError)):
            rvq.init_state(torch.Generator(), rvq.RVQ(2, 16, 8))


class TestSpectralAE:
    @pytest.fixture(scope="class")
    def cfgs(self):
        kw = dict(filters_n=N, hidden_n=32, latent_n=8, latent_step=1 / 16)
        return jax_sae.SpectralAE(**kw), sae.SpectralAE(**kw)

    @pytest.fixture(scope="class")
    def params_j(self, cfgs):
        return jax_sae.init_params(jax.random.key(0), cfgs[0])

    def test_loss_and_grads_match_jax(self, codecs, cfgs, params_j):
        (jc, tc), (cj, ct) = codecs, cfgs
        xj, xt = _wave()
        with pltpu.force_tpu_interpret_mode():
            lj, gj = jax.value_and_grad(
                lambda p: jax_sae.perceptual_loss(jc, cj, p, xj, None)
            )(params_j)
        lt, gt = _value_and_grad(
            lambda p: sae.perceptual_loss(tc, ct, p, xt), _to_port(params_j))
        np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_RTOL)
        _assert_grads(gt, gj)

    def test_three_adam_steps_match_jax(self, codecs, cfgs, params_j):
        (jc, tc), (cj, ct) = codecs, cfgs
        xj, xt = _wave(seed=1)
        step_j, opt_j = jax_sae.make_train_step(jc, cj, make_mesh(n_devices=1))
        pj = jax.tree.map(jnp.copy, params_j)
        state_j = opt_j.init(pj)
        step_t, opt_t = sae.make_train_step(tc, ct)
        pt = _to_port(params_j)
        opt = opt_t(list(pt.values()))
        with pltpu.force_tpu_interpret_mode():
            for _ in range(3):
                pj, state_j, lj = step_j(pj, state_j, xj, None)
                lt = step_t(pt, opt, xt)
                np.testing.assert_allclose(float(lt), float(lj),
                                           rtol=LOSS_RTOL)
        _assert_params(pt, pj)

    def test_shapes(self, cfgs):
        params = sae.init_params(torch.Generator().manual_seed(0), cfgs[1],
                                 device="cpu")
        assert sorted(params) == sorted(jax_sae.init_params(
            jax.random.key(0), cfgs[0]))
        assert params["enc_w1"].shape == (N, 32)  # [fan_in, fan_out]
        frames = torch.zeros(2, 5, N, 2)
        z = sae.encode_frames(params, frames)
        assert z.shape == (2, 5, 8, 2)
        assert sae.decode_frames(params, z).shape == frames.shape

    def test_latent_bounded_and_quantizable(self, cfgs):
        cfg = cfgs[1]
        params = sae.init_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
        frames = torch.from_numpy(np.random.default_rng(1).uniform(
            -1, 1, (1, 4, N, 1)).astype(np.float32))
        with torch.no_grad():
            z = sae.encode_frames(params, frames)
        assert float(z.abs().max()) <= 1.0
        steps = sae.quantize_latents(cfg, z).numpy() / cfg.latent_step
        np.testing.assert_allclose(steps, np.round(steps), atol=1e-5)

    def test_bits_per_frame(self, cfgs):
        # latent_n * log2(2 / step) = 8 * log2(32) = 40
        assert cfgs[1].bits_per_frame() == pytest.approx(40.0)
        assert cfgs[1].bits_per_frame() == cfgs[0].bits_per_frame()

    def test_apply_modes(self, cfgs):
        cfg = cfgs[1]
        params = sae.init_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
        frames = torch.from_numpy(np.random.default_rng(2).uniform(
            -1, 1, (1, 4, N, 1)).astype(np.float32))
        with torch.no_grad():
            det = sae.apply(cfg, params, frames)
            q = sae.apply(cfg, params, frames, quantized=True)
            gen = torch.Generator().manual_seed(3)
            noisy = sae.apply(cfg, params, frames, generator=gen)
            assert float((q - det).abs().max()) > 0
            assert float((noisy - det).abs().max()) > 0
            assert torch.equal(q, sae.apply(cfg, params, frames,
                                            quantized=True))
        with pytest.raises(ValueError, match="ambiguous"):
            sae.apply(cfg, params, frames, generator=gen, quantized=True)

    def test_bf16_params_and_io(self, cfgs):
        p16 = sae.init_params(torch.Generator().manual_seed(0), cfgs[1],
                              torch.bfloat16, device="cpu")
        assert all(p.dtype == torch.bfloat16 for p in p16.values())
        frames = torch.zeros(1, 3, N, 1, dtype=torch.bfloat16)
        assert sae.apply(cfgs[1], p16, frames).dtype == torch.bfloat16

    def test_loss_decreases(self, codecs, cfgs):
        tc = codecs[1]
        step, _ = sae.make_train_step(tc, cfgs[1])
        params = sae.init_params(torch.Generator().manual_seed(0), cfgs[1],
                                 device="cpu")
        opt = torch.optim.Adam(list(params.values()), lr=3e-3)
        gen = torch.Generator().manual_seed(0)
        x = _wave()[1]
        losses = [float(step(params, opt, x, gen)) for _ in range(30)]
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0] * 0.9

    def test_remat_matches(self, codecs, cfgs, params_j):
        """Recomputing the forward changes no number: the latent noise is
        drawn again from the same generator state."""
        tc = codecs[1]
        x = _wave()[1]
        outs = []
        for remat in (False, True):
            step, make_opt = sae.make_train_step(tc, cfgs[1], remat=remat)
            params = _to_port(params_j)
            loss = step(params, make_opt(list(params.values())), x,
                        torch.Generator().manual_seed(0))
            outs.append((float(loss), params))
        assert outs[0][0] == outs[1][0]
        for name, p in outs[0][1].items():
            assert torch.equal(p, outs[1][1][name]), name


class TestPostFilter:
    @pytest.fixture(scope="class")
    def cfgs(self):
        return jax_pf.PostFilter(N, 32), pf.PostFilter(N, 32)

    @pytest.fixture(scope="class")
    def params_j(self, cfgs):
        return jax_pf.init_params(jax.random.key(1), cfgs[0])

    def test_loss_and_grads_match_jax(self, codecs, cfgs, params_j):
        (jc, tc), (cj, ct) = codecs, cfgs
        xj, xt = _wave()
        with pltpu.force_tpu_interpret_mode():
            lj, gj = jax.value_and_grad(
                lambda p: jax_pf.enhancement_loss(jc, cj, p, xj, 0.1, 4.0)
            )(params_j)
        lt, gt = _value_and_grad(
            lambda p: pf.enhancement_loss(tc, ct, p, xt, 0.1, 4.0),
            _to_port(params_j))
        np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_RTOL)
        _assert_grads(gt, gj)

    def test_three_adam_steps_match_jax(self, codecs, cfgs, params_j):
        (jc, tc), (cj, ct) = codecs, cfgs
        xj, xt = _wave(seed=2)
        step_j, opt_j = jax_pf.make_train_step(jc, cj, make_mesh(n_devices=1))
        pj = jax.tree.map(jnp.copy, params_j)
        state_j = opt_j.init(pj)
        step_t, opt_t = pf.make_train_step(tc, ct)
        pt = _to_port(params_j)
        opt = opt_t(list(pt.values()))
        with pltpu.force_tpu_interpret_mode():
            for _ in range(3):
                pj, state_j, lj = step_j(pj, state_j, xj)
                lt = step_t(pt, opt, xt)
                np.testing.assert_allclose(float(lt), float(lj),
                                           rtol=LOSS_RTOL)
        _assert_params(pt, pj)

    def test_identity_at_init(self, cfgs):
        params = pf.init_params(torch.Generator().manual_seed(0), cfgs[1],
                                device="cpu")
        assert params["w1"].shape == (4 * N, 32)
        assert not params["w2"].any() and not params["b2"].any()
        rng = np.random.default_rng(0)
        spec_q = torch.from_numpy(rng.uniform(-0.5, 0.5, (1, 5, N, 1)))
        delta = torch.from_numpy(rng.uniform(1e-6, 1e-3, (1, 5, N, 1)))
        spec_q, delta = spec_q.float(), delta.float()
        with torch.no_grad():
            assert torch.equal(pf.apply(cfgs[1], params, spec_q, delta),
                               spec_q)

    def test_decode_enhanced_is_decode_quantized_at_init(self, codecs, cfgs):
        tc = codecs[1]
        params = pf.init_params(torch.Generator().manual_seed(0), cfgs[1],
                                device="cpu")
        x = _wave()[1]
        with torch.no_grad():
            codes, delta, _ = tc.encode_quantized(x)
            got = pf.decode_enhanced(tc, cfgs[1], params, codes, delta)
            assert torch.equal(got, tc.decode_quantized(codes, delta))

    def test_remat_matches(self, codecs, cfgs, params_j):
        tc = codecs[1]
        x = _wave()[1]
        outs = []
        for remat in (False, True):
            step, make_opt = pf.make_train_step(tc, cfgs[1], remat=remat)
            params = _to_port(params_j)
            loss = step(params, make_opt(list(params.values())), x)
            outs.append((float(loss), params))
        assert outs[0][0] == outs[1][0]
        for name, p in outs[0][1].items():
            assert torch.equal(p, outs[1][1][name]), name


class TestGainsTrainer:
    def test_loss_and_grad_match_jax(self, codecs):
        jc, tc = codecs
        xj, xt = _wave(seed=3)
        gains = np.linspace(0.5, 1.5, N).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            lj, gj = jax.value_and_grad(
                lambda g: jax_train.perceptual_loss(jc, g, xj)
            )(jnp.asarray(gains))
        lt, gt = _value_and_grad(
            lambda p: train.perceptual_loss(tc, p["gains"], xt),
            convert.params_from_arrays({"gains": gains}, device="cpu"))
        np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_RTOL)
        _assert_grads(gt, {"gains": gj})

    def test_one_step_matches_jax(self, codecs):
        """tests/test_parallel.py::TestTrainStep on one device: the same
        loss and the same Adam update of the gains."""
        jc, tc = codecs
        xj, xt = _wave(seed=4)
        step_j, opt_j = jax_train.make_train_step(jc, make_mesh(n_devices=1))
        state_j = jax_train.init_state(jc, opt_j)
        state_t = train.init_state(tc)
        assert state_t.gains.shape == (N,) and bool((state_t.gains == 1).all())
        step_t, _ = train.make_train_step(tc)
        with pltpu.force_tpu_interpret_mode():
            state_j, lj = step_j(state_j, xj)
        lt = step_t(state_t, xt)
        np.testing.assert_allclose(float(lt), float(lj), rtol=LOSS_RTOL)
        _assert_params({"gains": state_t.gains}, {"gains": state_j.gains})
        assert float((state_t.gains.detach() - 1.0).abs().max()) > 0

    def test_runs_and_learns(self, codecs):
        tc = codecs[1]
        state = train.init_state(
            tc, lambda p: torch.optim.Adam(p, lr=5e-2))
        with torch.no_grad():
            state.gains.mul_(0.5)  # a clear downhill direction
        step, _ = train.make_train_step(tc)
        x = torch.from_numpy(np.random.default_rng(3).uniform(
            -0.5, 0.5, (4, 8 * N, 1)).astype(np.float32))
        losses = [float(step(state, x)) for _ in range(5)]
        assert np.isfinite(losses).all() and losses[-1] <= losses[0]

    def test_remat_matches(self, codecs):
        tc = codecs[1]
        x = _wave(seed=5)[1]
        outs = []
        for remat in (False, True):
            state = train.init_state(tc)
            step, _ = train.make_train_step(tc, remat=remat)
            outs.append((float(step(state, x)), state.gains.detach()))
        assert outs[0][0] == outs[1][0]
        assert torch.equal(outs[0][1], outs[1][1])
