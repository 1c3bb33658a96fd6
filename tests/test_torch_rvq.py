"""The port's residual vector quantizer (models/rvq.py) held against the
JAX package on the CPU, from tests/test_rvq.py.

Both sides start from the same codebooks (``convert.rvq_state_from_arrays``),
weights (``convert.params_from_arrays``) and codec
(``convert.codec_from_arrays``: the JAX codec runs its Pallas kernels in
interpret mode, the port its kernels' plain versions), and carry their
states across steps. The port searches with argmin and an index gather
where the JAX package multiplies by one-hots: a code may then differ only
where the two candidates' distances tie within float32 rounding, which
:func:`_assert_codes` checks. Reseeds draw from different generators, so the
comparisons run with ``reseed_threshold=0.0``: with the default 1.0 every
codeword unused in the first step is dead (0.99 < 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from audiocodec_tpu.codec import Codec as JaxCodec
from audiocodec_tpu.models import rvq as jax_rvq
from audiocodec_tpu.models import spectral_ae as jax_sae
from audiocodec_tpu.parallel import make_mesh
from audiocodec_tpu_torch import convert
from audiocodec_tpu_torch.models import rvq
from audiocodec_tpu_torch.models import spectral_ae as sae
from tests.test_torch_codec import _leaves_and_meta
from tests.test_torch_models import _wave

torch.set_num_threads(1)

SR, N = 16000, 256
RVQ_KW = dict(stages=3, codebook_size=16, dim=8, reseed_threshold=0.0)
AE_KW = dict(filters_n=N, hidden_n=32, latent_n=8, latent_step=1 / 16)
# float32 sums in other orders (the one-hot products, index_add_): a few
# ulps of the values compared
ATOL = 1e-6
LOSS_RTOL, GRAD_RTOL, STEP_ATOL = 1e-5, 1e-4, 1e-4


@pytest.fixture(scope="module")
def codecs():
    jc = JaxCodec.create(SR, filters_n=N, bark_bands_n=16, use_pallas=True)
    return jc, convert.codec_from_arrays(*_leaves_and_meta(jc), device="cpu")


@pytest.fixture(scope="module")
def cfgs():
    return (jax_rvq.RVQ(**RVQ_KW), rvq.RVQ(**RVQ_KW),
            jax_sae.SpectralAE(**AE_KW), sae.SpectralAE(**AE_KW))


@pytest.fixture(scope="module")
def state_j(cfgs):
    return jax_rvq.init_state(jax.random.key(0), cfgs[0])


def _to_port_state(state_j):
    return convert.rvq_state_from_arrays(
        {k: np.asarray(v) for k, v in state_j.items()}, device="cpu")


def _to_port_params(params_j):
    return convert.params_from_arrays(
        {k: np.asarray(v) for k, v in params_j.items()}, device="cpu")


def _latents(shape, seed, scale=1.0):
    z = np.random.default_rng(seed).normal(scale=scale, size=shape)
    z = z.astype(np.float32)
    return jnp.asarray(z), torch.from_numpy(z)


def _assert_codes(codes_t, codes_j, z, codebooks, min_equal=0.9):
    """Codes [B, T, C, S] equal, except where a row's first differing
    stage has two candidates at distances that tie within float32
    rounding (its later stages then follow another residual)."""
    ct = np.asarray(codes_t).reshape(-1, codes_t.shape[-1])
    cj = np.asarray(codes_j).reshape(-1, codes_t.shape[-1])
    flat = np.moveaxis(np.asarray(z, np.float64), -1, -2).reshape(
        ct.shape[0], -1)
    cb = np.asarray(codebooks, np.float64)
    rows = np.flatnonzero((ct != cj).any(axis=1))
    assert len(rows) <= (1 - min_equal) * ct.shape[0], len(rows)
    for m in rows:
        s = int(np.flatnonzero(ct[m] != cj[m])[0])
        r = flat[m] - sum(cb[i][cj[m, i]] for i in range(s))
        dt = np.sum((r - cb[s][ct[m, s]]) ** 2)
        dj = np.sum((r - cb[s][cj[m, s]]) ** 2)
        scale = np.sum(r**2) + np.sum(cb[s][ct[m, s]] ** 2)
        assert abs(dt - dj) <= 1e-6 * scale, (m, s, dt, dj)


class TestConfig:
    def test_checks_and_bit_counts(self, cfgs):
        with pytest.raises(ValueError, match="power of two"):
            rvq.RVQ(codebook_size=100)
        with pytest.raises(ValueError, match="stages"):
            rvq.RVQ(stages=0)
        assert cfgs[1].bits_per_index == 4 and cfgs[1].bits_per_frame() == 12
        assert rvq.RVQ().bits_per_frame() == jax_rvq.RVQ().bits_per_frame()
        ae_bits = sae.SpectralAE().bits_per_frame()
        assert rvq.RVQ().bits_per_frame() <= ae_bits / 8  # 40 vs 384

    def test_init_state(self, cfgs):
        st = rvq.init_state(torch.Generator().manual_seed(0), cfgs[1],
                            device="cpu")
        assert st["codebooks"].shape == (3, 16, 8)
        assert st["ema_count"].shape == (3, 16)
        assert torch.equal(st["ema_sum"], st["codebooks"])  # count 1
        assert not any(t.requires_grad for t in st.values())
        assert float(st["codebooks"].std()) == pytest.approx(0.1, rel=0.3)
        st16 = rvq.init_state(torch.Generator().manual_seed(0), cfgs[1],
                              torch.bfloat16, device="cpu")
        assert st16["codebooks"].dtype == torch.bfloat16
        assert st16["ema_sum"].dtype == torch.float32


class TestQuantize:
    @pytest.mark.parametrize("seed,scale", [(1, 1.0), (2, 0.1), (3, 0.3)])
    def test_matches_jax(self, cfgs, state_j, seed, scale):
        zj, zt = _latents((2, 5, 8, 3), seed, scale)
        zqj, cj, comj = jax_rvq.quantize(cfgs[0], state_j, zj)
        zqt, ct, comt = rvq.quantize(cfgs[1], _to_port_state(state_j), zt)
        assert ct.dtype == torch.int32 and ct.shape == (2, 5, 3, 3)
        _assert_codes(ct.numpy(), cj, zj, state_j["codebooks"])
        same = (ct.numpy() == np.asarray(cj)).all(axis=-1).reshape(-1)
        rows = lambda a: np.moveaxis(np.asarray(a), -1, -2).reshape(-1, 8)
        np.testing.assert_allclose(rows(zqt.detach())[same], rows(zqj)[same],
                                   rtol=0, atol=ATOL)
        if same.all():
            np.testing.assert_allclose(float(comt), float(comj), rtol=1e-5)

    def test_decode_codes_matches_jax_and_quantize(self, cfgs, state_j):
        zj, zt = _latents((2, 3, 8, 2), 5)
        _, cj, _ = jax_rvq.quantize(cfgs[0], state_j, zj)
        st = _to_port_state(state_j)
        want = np.asarray(jax_rvq.decode_codes(cfgs[0], state_j, cj))
        got = rvq.decode_codes(cfgs[1], st, torch.from_numpy(np.array(cj)))
        assert got.shape == zt.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
        zq, ct, _ = rvq.quantize(cfgs[1], st, zt)
        np.testing.assert_allclose(rvq.decode_codes(cfgs[1], st, ct).numpy(),
                                   zq.detach().numpy(), atol=1e-5)

    def test_exact_on_codewords(self, cfgs, state_j):
        st = _to_port_state(state_j)
        z = st["codebooks"][0, :4][None, :, :, None]
        _, codes, _ = rvq.quantize(cfgs[1], st, z)
        np.testing.assert_array_equal(codes[0, :, 0, 0].numpy(), np.arange(4))
        cfg1 = rvq.RVQ(stages=1, codebook_size=16, dim=8)
        st1 = {k: v[:1] for k, v in st.items()}
        zq1, _, _ = rvq.quantize(cfg1, st1, z)
        assert torch.equal(zq1, z)

    def test_residual_shrinks_with_stages(self, state_j):
        st = _to_port_state(state_j)
        z = _latents((4, 6, 8, 1), 2, 0.1)[1]
        errs = []
        for s in (1, 2, 3):
            zq, _, _ = rvq.quantize(rvq.RVQ(stages=s, codebook_size=16, dim=8),
                                    {k: v[:s] for k, v in st.items()}, z)
            errs.append(float(torch.mean((zq - z) ** 2)))
        assert errs[1] <= errs[0] + 1e-7 and errs[2] <= errs[1] + 1e-7

    def test_straight_through_gradient_is_identity(self, cfgs, state_j):
        z = _latents((1, 2, 8, 1), 3)[1].requires_grad_()
        tgt = _latents((1, 2, 8, 1), 4)[1]
        zq, _, _ = rvq.quantize(cfgs[1], _to_port_state(state_j), z)
        (grad,) = torch.autograd.grad((zq * tgt).sum(), z)
        assert torch.equal(grad, tgt)

    def test_dim_mismatch_raises(self, cfgs, state_j):
        with pytest.raises(ValueError, match="latent axis"):
            rvq.quantize(cfgs[1], _to_port_state(state_j),
                         torch.zeros(1, 2, 7, 1))

    def test_bf16_latents_match_jax(self, cfgs):
        sj = jax_rvq.init_state(jax.random.key(0), cfgs[0], jnp.bfloat16)
        st = _to_port_state(sj)
        assert st["codebooks"].dtype == torch.bfloat16
        z = np.random.default_rng(6).normal(size=(1, 4, 8, 1))
        zqj, cj, _ = jax_rvq.quantize(cfgs[0], sj,
                                      jnp.asarray(z, jnp.bfloat16))
        zqt, ct, _ = rvq.quantize(cfgs[1], st,
                                  torch.from_numpy(z).to(torch.bfloat16))
        assert zqt.dtype == torch.bfloat16 and ct.dtype == torch.int32
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        np.testing.assert_array_equal(
            zqt.float().numpy(), np.asarray(zqj, np.float32))


class TestPackCodes:
    @pytest.mark.parametrize("shape", [(2, 5, 1, 3), (1, 7, 2, 3),
                                       (3, 1, 1, 3)])
    def test_bytes_equal_to_jax(self, cfgs, shape):
        codes = np.random.default_rng(7).integers(0, 16, size=shape,
                                                  dtype=np.int32)
        data = rvq.pack_codes(cfgs[1], torch.from_numpy(codes))
        assert data == jax_rvq.pack_codes(cfgs[0], codes)
        assert len(data) == int(np.ceil(codes.size * 4 / 8))
        back = rvq.unpack_codes(cfgs[1], data, codes.shape)
        assert back.dtype == np.int32
        np.testing.assert_array_equal(back, codes)

    def test_rejections(self, cfgs):
        with pytest.raises(ValueError, match="out of range"):
            rvq.pack_codes(cfgs[1], np.full((1, 1, 1, 3), 16, np.int32))
        data = rvq.pack_codes(cfgs[1], np.zeros((1, 8, 1, 3), np.int32))
        with pytest.raises(ValueError, match="truncated"):
            rvq.unpack_codes(cfgs[1], data[:-2], (1, 8, 1, 3))


def _clusters(seed, n=256):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, 8)) * 2.0
    pts = centers[rng.integers(0, 4, n)] + 0.05 * rng.normal(size=(n, 8))
    z = np.moveaxis(pts.astype(np.float32)[None, :, None, :], -1, -2)
    return jnp.asarray(z), torch.from_numpy(np.ascontiguousarray(z))


class TestEMA:
    def test_three_updates_match_jax(self, cfgs, state_j):
        """The state carried across three EMA steps on each side."""
        zj, zt = _clusters(8)
        sj, st = state_j, _to_port_state(state_j)
        for i in range(3):
            sj = jax_rvq.ema_update(cfgs[0], sj, zj, jax.random.key(i))
            st = rvq.ema_update(cfgs[1], st, zt, torch.Generator())
            for name in ("codebooks", "ema_count", "ema_sum"):
                np.testing.assert_allclose(
                    st[name].numpy(), np.asarray(sj[name]), rtol=1e-5,
                    atol=ATOL, err_msg=f"{name}, step {i}")

    def test_moves_codebooks_toward_data(self):
        cfg = rvq.RVQ(stages=3, codebook_size=16, dim=8)
        st = rvq.init_state(torch.Generator().manual_seed(1), cfg,
                            device="cpu")
        z = _clusters(8)[1]

        def err(st):
            zq, _, _ = rvq.quantize(cfg, st, z)
            return float(torch.mean((zq - z) ** 2))

        e0, gen = err(st), torch.Generator().manual_seed(2)
        for _ in range(30):
            st = rvq.ema_update(cfg, st, z, gen)
        assert err(st) < e0 * 0.1

    def test_dead_codewords_reseed_from_batch_vectors(self):
        """Far more codewords than the data needs: the dead ones become
        batch vectors exactly, the live ones their EMA means."""
        cfg = rvq.RVQ(stages=1, codebook_size=32, dim=8, ema_decay=0.5,
                      reseed_threshold=0.6)
        st = rvq.init_state(torch.Generator().manual_seed(3), cfg,
                            device="cpu")
        pts = np.random.default_rng(9).normal(size=(64, 8)) * 3.0
        z = torch.from_numpy(np.ascontiguousarray(np.moveaxis(
            pts.astype(np.float32)[None, :, None, :], -1, -2)))
        gen = torch.Generator().manual_seed(4)
        new = rvq.ema_update(cfg, st, z, gen)
        dead = new["ema_count"][0] < cfg.reseed_threshold
        assert 0 < int(dead.sum()) < 32
        batch = {tuple(v) for v in z[0, :, :, 0].numpy().tolist()}
        for row in new["codebooks"][0][dead].numpy().tolist():
            assert tuple(row) in batch
        for _ in range(7):
            new = rvq.ema_update(cfg, new, z, gen)
        norms = new["codebooks"][0].norm(dim=-1)
        assert float(norms.median()) > 1.0


class TestTraining:
    @pytest.fixture(scope="class")
    def params_j(self, cfgs):
        return jax_sae.init_params(jax.random.key(5), cfgs[2])

    @pytest.mark.parametrize("gate", [0.0, 1.0])
    def test_loss_and_grads_match_jax(self, codecs, cfgs, params_j, state_j,
                                      gate):
        jc, tc = codecs
        xj, xt = _wave()
        with pltpu.force_tpu_interpret_mode():
            (lj, zj), gj = jax.value_and_grad(
                lambda p: jax_rvq.perceptual_loss(
                    jc, cfgs[2], cfgs[0], p, state_j, xj,
                    quantizer_gate=gate), has_aux=True)(params_j)
        pt = _to_port_params(params_j)
        lt, zt = rvq.perceptual_loss(tc, cfgs[3], cfgs[1], pt,
                                     _to_port_state(state_j), xt,
                                     quantizer_gate=gate)
        grads = torch.autograd.grad(lt, list(pt.values()))
        np.testing.assert_allclose(float(lt.detach()), float(lj),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(zt.detach().numpy(), np.asarray(zj),
                                   rtol=0, atol=1e-5)
        for name, g in zip(pt, grads):
            want = np.asarray(gj[name], np.float64)
            np.testing.assert_allclose(
                g.double().numpy(), want, rtol=0,
                atol=GRAD_RTOL * max(np.abs(want).max(), 1e-30), err_msg=name)

    def test_three_adam_steps_match_jax(self, codecs, cfgs, params_j,
                                        state_j):
        """warmup_steps=1: one step on the continuous latent, then two with
        the quantizer on the codebooks the first EMA step moved."""
        jc, tc = codecs
        xj, xt = _wave(seed=1)
        step_j, opt_j = jax_rvq.make_train_step(
            jc, cfgs[2], cfgs[0], make_mesh(n_devices=1), warmup_steps=1)
        pj = jax.tree.map(jnp.copy, params_j)
        sj = jax.tree.map(jnp.copy, state_j)
        opt_state = opt_j.init(pj)
        step_t, opt_t = rvq.make_train_step(tc, cfgs[3], cfgs[1],
                                            warmup_steps=1)
        pt, st = _to_port_params(params_j), _to_port_state(state_j)
        opt = opt_t(list(pt.values()))
        gen = torch.Generator().manual_seed(0)
        with pltpu.force_tpu_interpret_mode():
            for i in range(3):
                pj, sj, opt_state, lj = step_j(pj, sj, opt_state, xj,
                                               jax.random.key(i), jnp.int32(i))
                lt = step_t(pt, st, opt, xt, gen, i)
                np.testing.assert_allclose(float(lt), float(lj),
                                           rtol=LOSS_RTOL, err_msg=f"step {i}")
        for name, p in pt.items():
            np.testing.assert_allclose(
                p.detach().numpy(), np.asarray(pj[name]), rtol=0,
                atol=STEP_ATOL, err_msg=name)
        for name in ("codebooks", "ema_count", "ema_sum"):
            np.testing.assert_allclose(st[name].numpy(), np.asarray(sj[name]),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
        assert not any(p.grad is None for p in pt.values())

    def test_warmup_gates_the_quantizer(self, codecs, cfgs):
        """Before warmup_steps the loss is the continuous bottleneck's (no
        quantization error, no commitment); after, the STE engages."""
        tc = codecs[1]
        x = _wave(seed=21)[1]
        params = sae.init_params(torch.Generator().manual_seed(20), cfgs[3],
                                 device="cpu")
        state = rvq.init_state(torch.Generator().manual_seed(21), cfgs[1],
                               device="cpu")
        step, _ = rvq.make_train_step(
            tc, cfgs[3], cfgs[1], warmup_steps=10,
            optimizer=lambda p: torch.optim.SGD(p, lr=0.0))
        with torch.no_grad():
            spec = tc.mdct.transform(x)
            thr = tc.psycho.global_masking_threshold(
                spec, tc.psycho.tonality(spec))
            recon = sae.decode_frames(params, sae.encode_frames(params, spec))
            dec = tc.mdct.inverse_transform(recon)
            ref = float(torch.mean((dec[:, N:-N] - x) ** 2) + 0.1 * torch.mean(
                ((recon - spec) / torch.clamp(thr, min=1e-3)) ** 2))

        def loss_at(i):
            st = {k: v.clone() for k, v in state.items()}
            opt = torch.optim.SGD(list(params.values()), lr=0.0)
            return float(step(params, st, opt, x, None, i))

        warm, hot = loss_at(0), loss_at(10)
        assert abs(warm - ref) < 1e-5 * max(1.0, ref)
        assert hot > warm

    def test_joint_train_step_descends(self, codecs, cfgs):
        tc = codecs[1]
        step, _ = rvq.make_train_step(
            tc, cfgs[3], rvq.RVQ(stages=3, codebook_size=16, dim=8),
            optimizer=lambda p: torch.optim.Adam(p, lr=3e-3))
        params = sae.init_params(torch.Generator().manual_seed(5), cfgs[3],
                                 device="cpu")
        st = rvq.init_state(torch.Generator().manual_seed(6), cfgs[1],
                            device="cpu")
        opt = torch.optim.Adam(list(params.values()), lr=3e-3)
        x, gen = _wave()[1], torch.Generator().manual_seed(7)
        losses = [float(step(params, st, opt, x, gen, i)) for i in range(30)]
        assert np.isfinite(losses).all() and losses[-1] < losses[0] * 0.9

    def test_remat_matches(self, codecs, cfgs, params_j, state_j):
        tc = codecs[1]
        x = _wave(seed=2)[1]
        outs = []
        for remat in (False, True):
            step, make_opt = rvq.make_train_step(tc, cfgs[3], cfgs[1],
                                                 remat=remat)
            pt, st = _to_port_params(params_j), _to_port_state(state_j)
            loss = step(pt, st, make_opt(list(pt.values())), x, None, 0)
            outs.append((float(loss), pt, st))
        assert outs[0][0] == outs[1][0]
        for name, p in outs[0][1].items():
            assert torch.equal(p, outs[1][1][name]), name
        for name, t in outs[0][2].items():
            assert torch.equal(t, outs[1][2][name]), name


class TestDiscreteRoundTrip:
    def test_encode_decode_discrete_match_jax(self, codecs, cfgs, state_j):
        """Waveform -> codes -> packed bytes -> codes -> waveform: codes as
        JAX's, bytes equal, the packed path lossless, the waveform within
        the float32 tolerance of JAX's."""
        jc, tc = codecs
        params_j = jax_sae.init_params(jax.random.key(10), cfgs[2])
        pt, st = _to_port_params(params_j), _to_port_state(state_j)
        xj, xt = _wave(batch=1, blocks=8)
        with pltpu.force_tpu_interpret_mode():
            cj = jax_rvq.encode_discrete(jc, cfgs[2], cfgs[0], params_j,
                                         state_j, xj)
            yj = jax_rvq.decode_discrete(jc, cfgs[2], cfgs[0], params_j,
                                         state_j, cj)
            zj = jax_sae.encode_frames(params_j, jc.mdct.transform(xj))
        ct = rvq.encode_discrete(tc, cfgs[3], cfgs[1], pt, st, xt)
        assert ct.shape == (1, 9, 1, 3) and ct.dtype == torch.int32
        _assert_codes(ct.numpy(), cj, zj, state_j["codebooks"])
        data = rvq.pack_codes(cfgs[1], ct)
        back = rvq.unpack_codes(cfgs[1], data, tuple(ct.shape))
        y1 = rvq.decode_discrete(tc, cfgs[3], cfgs[1], pt, st, back)
        y2 = rvq.decode_discrete(tc, cfgs[3], cfgs[1], pt, st, ct)
        assert torch.equal(y1, y2) and not y1.requires_grad
        assert y1.shape == (1, xt.shape[1] + 2 * N, 1)
        # the decode of JAX's own codes
        yt = rvq.decode_discrete(tc, cfgs[3], cfgs[1], pt, st, np.array(cj))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                                   atol=1e-5)
