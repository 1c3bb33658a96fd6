"""The port's sequence parallelism (``parallel.sequence``), its dp x sp
corpus encoder and the ``mesh`` of its four training steps, held against
the JAX package on the 8 virtual CPU devices of tests/conftest.py, at
tests/test_parallel.py's sizes (16 kHz, N=64, 16 Bark bands), inputs from
a numpy seed; the port's meshes are ``[cpu] * k``.

- ``sp=8`` ``transform`` equals JAX's sharded transform (atol 1e-6).
- The ``dp=4, sp=2`` encoder equals JAX's at float32 (codes exact, steps
  rtol 1e-5). At int8 it equals the port's unsharded encode (JAX's own
  gate, tests/test_parallel.py::TestInt8Sharded); the port's int8 codes
  are JAX's within one step already unsharded.
- Each train step on ``dp=4, sp=2`` equals JAX's
  ``make_train_step(codec, make_mesh(8, sp=2))`` after one step with
  tests/test_torch_models.py's tolerances (RVQ with reseed_threshold=0).
- Sharded equals unsharded in the port, with ragged shards (13 blocks
  over sp=3), the kernels' plain versions (N=256), latent noise, RVQ
  reseeds, and ``remat`` (bit for bit against the sharded step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocodec_tpu.codec import Codec as JaxCodec
from audiocodec_tpu.models import post_filter as jax_pf
from audiocodec_tpu.models import rvq as jax_rvq
from audiocodec_tpu.models import spectral_ae as jax_sae
from audiocodec_tpu.parallel import corpus as jax_corpus
from audiocodec_tpu.parallel import mesh as jax_mesh
from audiocodec_tpu.parallel import train as jax_train
from audiocodec_tpu_torch import Codec, convert
from audiocodec_tpu_torch.models import post_filter as pf
from audiocodec_tpu_torch.models import rvq
from audiocodec_tpu_torch.models import spectral_ae as sae
from audiocodec_tpu_torch.parallel import corpus, sequence, train
from audiocodec_tpu_torch.parallel import mesh as _mesh
from tests.test_torch_codec import _leaves_and_meta

torch.set_num_threads(1)

SR, N = 16000, 64
CPU = torch.device("cpu")
LOSS_RTOL, STEP_ATOL = 1e-5, 1e-4  # tests/test_torch_models.py's
MODELS = ("gains", "spectral_ae", "post_filter", "rvq")
AE_KW = dict(filters_n=N, hidden_n=32, latent_n=8, latent_step=1 / 16)
PF_KW = dict(filters_n=N, hidden_n=32)
RVQ_KW = dict(stages=2, codebook_size=16, dim=8, reseed_threshold=0.0)


@pytest.fixture(scope="module")
def codecs():
    jc = JaxCodec.create(SR, filters_n=N, bark_bands_n=16)
    return jc, convert.codec_from_arrays(*_leaves_and_meta(jc), device="cpu")


def port_mesh(sp, n=8):
    return _mesh.make_mesh(devices=[CPU] * n, sp=sp)


def uniform(shape, seed, scale=0.8):
    x = np.random.default_rng(seed).uniform(-scale, scale, size=shape)
    return x.astype(np.float32)


@pytest.mark.parametrize("blocks, sp, bounds", [
    (430, 2, [(0, 215), (215, 430)]),
    (13, 3, [(0, 5), (5, 9), (9, 13)]),
    (8, 8, [(k, k + 1) for k in range(8)]),
])
def test_block_bounds(blocks, sp, bounds):
    assert sequence.block_bounds(blocks, sp) == bounds


def test_block_bounds_refuses_empty_shards():
    with pytest.raises(ValueError, match="do not split over sp=3"):
        sequence.block_bounds(2, 3)


def test_frame_context_crosses_shards():
    f = torch.arange(2 * 7 * 3, dtype=torch.float32).reshape(2, 7, 3)
    (prev, nxt), = sequence.frame_context([f])
    parts = sequence.frame_context([f[:, :3], f[:, 3:4], f[:, 4:]])
    assert torch.equal(torch.cat([p for p, _ in parts], 1), prev)
    assert torch.equal(torch.cat([n for _, n in parts], 1), nxt)
    assert torch.equal(prev[:, 0], f[:, 0]) and torch.equal(nxt[:, -1],
                                                            f[:, -1])


def test_transform_sp8_matches_jax(codecs):
    """tests/test_parallel.py::test_sequence_sharding_pure_mdct against the
    port: the fold's halo crosses every one of eight shard boundaries."""
    jc, tc = codecs
    x = uniform((2, 64 * N, 1), 1, scale=1.0)
    mesh = jax_mesh.make_mesh(n_devices=8, sp=8)
    xj = jax.device_put(jnp.asarray(x), jax_mesh.waveform_sharding(mesh))
    spec_j = np.asarray(jax.jit(jc.mdct.transform)(xj))
    codecs8 = sequence.replicas(tc, [CPU] * 8)
    shards = sequence.transform(codecs8, torch.from_numpy(x))
    assert [s.shape[1] for s in shards] == [8] * 7 + [9]
    np.testing.assert_allclose(torch.cat(shards, 1).numpy(), spec_j,
                               atol=1e-6)
    out = torch.cat(sequence.inverse_transform(codecs8, shards), 1)
    want = np.asarray(jc.mdct.inverse_transform(jnp.asarray(spec_j)))
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("sp", [2, 3, 8])
@pytest.mark.parametrize("n", [64, 256])
def test_shards_equal_unsharded(n, sp):
    """Ragged shards (13 blocks), stereo; at N=256 through the kernels'
    plain versions."""
    tc = Codec.create(SR, filters_n=n, bark_bands_n=16, device="cpu",
                      use_kernel=n % 256 == 0)
    x = torch.from_numpy(uniform((3, 13 * n, 2), 2))
    codecs_sp = sequence.replicas(tc, [CPU] * sp)
    shards = sequence.transform(codecs_sp, x)
    spec = tc.mdct.transform(x)
    assert torch.equal(torch.cat(shards, 1), spec)
    out = torch.cat(sequence.inverse_transform(codecs_sp, shards), 1)
    torch.testing.assert_close(out, tc.mdct.inverse_transform(spec),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("precision", ["float32", "int8"])
def test_encoder_dp4_sp2_matches_jax(precision):
    kw = {} if precision == "float32" else dict(dct_precision="int8")
    jc = JaxCodec.create(SR, filters_n=N, bark_bands_n=16, **kw)
    tc = convert.codec_from_arrays(*_leaves_and_meta(jc), device="cpu")
    batch = uniform((8, 16 * N, 2), 42)
    codes_j, delta_j = jax_corpus.make_corpus_encoder(
        jc, jax_mesh.make_mesh(n_devices=8, sp=2))(jnp.asarray(batch))
    codes_j, delta_j = np.asarray(codes_j), np.asarray(delta_j)
    codes, delta = corpus.make_corpus_encoder(tc, port_mesh(2))(
        torch.from_numpy(batch))
    if precision == "float32":
        np.testing.assert_array_equal(codes.numpy(), codes_j)
        np.testing.assert_allclose(delta.numpy(), delta_j, rtol=1e-5)
        return
    codes_1, delta_1, _ = tc.encode_quantized(torch.from_numpy(batch))
    assert torch.equal(codes, codes_1)
    torch.testing.assert_close(delta, delta_1, rtol=1e-5, atol=0)
    diff = np.abs(codes.numpy().astype(np.int64) - codes_j)
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01


def test_noise_encoder_and_corpus_sp2_equal_unsharded(codecs):
    tc = codecs[1]
    mesh = port_mesh(2)
    x = torch.from_numpy(uniform((8, 13 * N, 1), 3))
    noisy = corpus.make_corpus_encoder(tc, mesh, quantized=False)(
        x, torch.Generator().manual_seed(9))
    assert torch.equal(noisy, tc.encode(x, torch.Generator().manual_seed(9)))
    clips = uniform((10, 13 * N, 1), 4)
    outs = corpus.encode_corpus(tc, clips, mesh=mesh, batch_size=8)
    assert [c.shape[0] for c, _ in outs] == [8, 2]
    codes, delta, _ = tc.encode_quantized(torch.from_numpy(clips))
    assert torch.equal(torch.cat([c for c, _ in outs]), codes)
    assert torch.equal(torch.cat([d for _, d in outs]), delta)


def jax_step(model, jc, mesh, x, params):
    """One JAX step on ``mesh``: (loss, new params, new RVQ state)."""
    xs = jax.device_put(jnp.asarray(x), jax_mesh.waveform_sharding(mesh))
    if model == "gains":
        step, opt = jax_train.make_train_step(jc, mesh)
        state, loss = step(jax_train.init_state(jc, opt), xs)
        return loss, {"gains": state.gains}, None
    if model == "spectral_ae":
        step, opt = jax_sae.make_train_step(
            jc, jax_sae.SpectralAE(**AE_KW), mesh)
        new, _, loss = step(params, opt.init(params), xs, None)
        return loss, new, None
    if model == "post_filter":
        step, opt = jax_pf.make_train_step(jc, jax_pf.PostFilter(**PF_KW),
                                           mesh)
        new, _, loss = step(params, opt.init(params), xs)
        return loss, new, None
    cfg = jax_rvq.RVQ(**RVQ_KW)
    step, opt = jax_rvq.make_train_step(jc, jax_sae.SpectralAE(**AE_KW), cfg,
                                        mesh)
    state = jax_rvq.init_state(jax.random.key(1), cfg)
    new, state, _, loss = step(params, state, opt.init(params), xs,
                               jax.random.key(2), jnp.int32(0))
    return loss, new, state


def jax_params(model):
    if model == "gains":
        return None
    if model == "post_filter":
        return jax_pf.init_params(jax.random.key(0),
                                  jax_pf.PostFilter(**PF_KW))
    return jax_sae.init_params(jax.random.key(0), jax_sae.SpectralAE(**AE_KW))


def port_trainer(model, tc, mesh, params=None, remat=False, reseed=0.0,
                 warmup=1):
    """(params, rvq state, step(x, generator, i) -> loss) of the port's
    ``model`` on ``tc`` (its widths follow the codec's N) from the given
    parameters (gains: unit); RVQ from the JAX package's initial state."""
    n = tc.mdct.filters_n
    ae = sae.SpectralAE(**dict(AE_KW, filters_n=n))
    if model == "gains":
        st = train.init_state(tc)
        step, _ = train.make_train_step(tc, remat=remat, mesh=mesh)
        return {"gains": st.gains}, None, lambda x, gen, i: step(st, x)
    if params is None:
        params = (pf.init_params if model == "post_filter"
                  else sae.init_params)(
            torch.Generator().manual_seed(0),
            pf.PostFilter(n, PF_KW["hidden_n"]) if model == "post_filter"
            else ae, device="cpu")
    if model == "rvq":
        state = convert.rvq_state_from_arrays(
            {k: np.asarray(v) for k, v in jax_rvq.init_state(
                jax.random.key(1), jax_rvq.RVQ(**RVQ_KW)).items()},
            device="cpu")
        step, make_opt = rvq.make_train_step(
            tc, ae, rvq.RVQ(**dict(RVQ_KW, reseed_threshold=reseed)),
            remat=remat, mesh=mesh, warmup_steps=warmup)
        opt = make_opt(list(params.values()))
        return params, state, lambda x, gen, i: step(params, state, opt, x,
                                                     gen, i)
    if model == "post_filter":
        step, make_opt = pf.make_train_step(
            tc, pf.PostFilter(n, PF_KW["hidden_n"]), remat=remat, mesh=mesh)
    else:
        step, make_opt = sae.make_train_step(tc, ae, remat=remat, mesh=mesh)
    opt = make_opt(list(params.values()))
    return params, None, lambda x, gen, i: step(params, opt, x, gen)


@pytest.mark.parametrize("model", MODELS)
def test_train_step_dp4_sp2_matches_jax(codecs, model):
    jc, tc = codecs
    x = uniform((8, 16 * N, 1), 5, scale=0.5)
    pj = jax_params(model)
    pt = None if pj is None else convert.params_from_arrays(
        {k: np.asarray(v) for k, v in pj.items()}, device="cpu")
    # the JAX step donates its parameters
    loss_j, new_j, state_j = jax_step(
        model, jc, jax_mesh.make_mesh(n_devices=8, sp=2), x, pj)
    pt, st, step = port_trainer(model, tc, port_mesh(2), pt, warmup=0)
    loss = step(torch.from_numpy(x), None, 0)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=LOSS_RTOL)
    for name, p in pt.items():
        np.testing.assert_allclose(
            p.detach().numpy(), np.asarray(new_j[name]), rtol=0,
            atol=STEP_ATOL, err_msg=name)
    if state_j is not None:
        for name in ("codebooks", "ema_count", "ema_sum"):
            np.testing.assert_allclose(
                st[name].numpy(), np.asarray(state_j[name]), rtol=1e-4,
                atol=1e-5, err_msg=name)


@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("model", MODELS)
def test_sharded_equals_unsharded(model, n):
    """dp=2, sp=3 on 13 blocks of stereo, three steps with a generator
    (SAE latent noise; RVQ reseeds at threshold 0.5 after a warm-up step);
    ``remat`` gives the sharded step bit for bit."""
    tc = Codec.create(SR, filters_n=n, bark_bands_n=16, device="cpu",
                      use_kernel=n % 256 == 0)
    x = torch.from_numpy(uniform((4, 13 * n, 2), 6, scale=0.5))
    runs = []
    for mesh, remat in ((None, False), (port_mesh(3, 6), False),
                        (port_mesh(3, 6), True)):
        params, state, step = port_trainer(model, tc, mesh, remat=remat,
                                           reseed=0.5)
        gen = torch.Generator().manual_seed(7)
        losses = [float(step(x, gen, i)) for i in range(3)]
        runs.append((losses, {k: v.detach() for k, v in params.items()},
                     state))
    (l0, p0, s0), (l1, p1, s1), (l2, p2, s2) = runs
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    for name in p0:
        torch.testing.assert_close(p1[name], p0[name], rtol=0,
                                   atol=STEP_ATOL)
    assert l2 == l1
    assert all(torch.equal(p2[k], p1[k]) for k in p1)
    if s0 is not None:
        assert torch.equal(s1["ema_count"], s0["ema_count"])
        for name in ("codebooks", "ema_sum"):
            torch.testing.assert_close(s1[name], s0[name], rtol=1e-5,
                                       atol=1e-6)
        assert all(torch.equal(s2[k], s1[k]) for k in s1)
