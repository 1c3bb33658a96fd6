"""``utils.serialization`` of the port held against the JAX package's on
the CPU.

- A JAX-written codec JSON loads in the port and builds the codec that
  ``convert.codec_from_arrays`` gives for the same JAX codec (the same
  kernel choice): equal encodes and decodes. A port-written JSON loads in
  JAX as the configuration it names; an old config takes JAX's defaults.
- JAX-written SAE, post-filter and RVQ ``.npz`` files load into the port's
  templates as ``convert`` carries the same arrays (bf16 too), and the
  port's files load into JAX's templates; the leaf-count error is JAX's.
- A ``torch.optim`` ``state_dict()`` round-trips; training resumes from a
  checkpoint bit for bit; a stream resumes across ``save_stream_state``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiocodec_tpu.codec import Codec as JaxCodec
from audiocodec_tpu.models import post_filter as jax_pf
from audiocodec_tpu.models import rvq as jax_rvq
from audiocodec_tpu.models import spectral_ae as jax_sae
from audiocodec_tpu.utils import serialization as jax_ser
from audiocodec_tpu_torch import Codec, convert, streaming
from audiocodec_tpu_torch.models import post_filter as pf
from audiocodec_tpu_torch.models import rvq
from audiocodec_tpu_torch.models import spectral_ae as sae
from audiocodec_tpu_torch.utils import serialization
from tests.test_torch_codec import _leaves_and_meta

torch.set_num_threads(1)

SR = 16000
CODECS = {
    "plain": dict(filters_n=64),
    "kernels": dict(filters_n=256, use_pallas=True),
    "radix": dict(filters_n=512, use_pallas=True, pallas_kernel="radix"),
    "bf16": dict(filters_n=256, compute_dtype=jnp.bfloat16, fast_bf16=True,
                 dct_precision="default"),
    "raw_sidecar": dict(filters_n=64, sidecar_grid=0,
                        bark_precision="default"),
}
AE = dict(filters_n=64, hidden_n=32, latent_n=8, latent_step=1 / 16)
RVQ_KW = dict(stages=2, codebook_size=16, dim=8)


def signal(n, dtype, blocks=6, batch=2):
    x = np.random.default_rng(0).uniform(-0.5, 0.5, (batch, blocks * n, 1))
    return torch.from_numpy(x.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("name", sorted(CODECS))
def test_jax_codec_json_loads_in_port(tmp_path, name):
    jc = JaxCodec.create(SR, bark_bands_n=16, **CODECS[name])
    path = str(tmp_path / "codec.json")
    jax_ser.save_codec(path, jc)
    tc = serialization.load_codec(path, device="cpu")
    leaves, meta = _leaves_and_meta(jc)
    meta.update(use_pallas=tc.mdct.use_kernel,  # this machine's choice
                sidecar_grid=jc.sidecar_grid)
    want = convert.codec_from_arrays(leaves, meta, device="cpu")
    assert serialization.codec_config(tc) == serialization.codec_config(want)
    x = signal(tc.mdct.filters_n, tc.mdct.compute_dtype)
    codes, delta, _ = tc.encode_quantized(x)
    codes_w, delta_w, _ = want.encode_quantized(x)
    assert torch.equal(codes, codes_w) and torch.equal(delta, delta_w)
    torch.testing.assert_close(tc.decode_quantized(codes, delta),
                               want.decode_quantized(codes, delta),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CODECS))
def test_port_codec_json_loads_in_jax(tmp_path, name):
    kw = dict(CODECS[name])
    kw["use_kernel"] = kw.pop("use_pallas", "auto")
    kw["kernel_design"] = kw.pop("pallas_kernel", "auto")
    dtype = kw.pop("compute_dtype", jnp.float32)
    tc = Codec.create(SR, bark_bands_n=16, device="cpu",
                      compute_dtype=str(jnp.dtype(dtype)), **kw)
    path = str(tmp_path / "codec.json")
    serialization.save_codec(path, tc)
    jc = jax_ser.load_codec(path)
    want = JaxCodec.create(SR, bark_bands_n=16, **CODECS[name])
    got_cfg, want_cfg = jax_ser.codec_config(jc), jax_ser.codec_config(want)
    want_cfg["use_pallas"] = False  # resolved off a TPU on loading
    assert got_cfg == want_cfg
    assert serialization.codec_config(tc) == dict(
        jax_ser.codec_config(want),
        use_pallas=tc.mdct.use_kernel)


def test_old_config_takes_jax_defaults(tmp_path):
    path = str(tmp_path / "old.json")
    with open(path, "w") as f:
        json.dump(dict(sample_rate=16000.0, filters_n=64, bark_bands_n=16,
                       alpha=0.6, window_type="vorbis",
                       compute_dtype="float32", fast_bf16=False,
                       use_pallas=True), f)
    got = serialization.codec_config(serialization.load_codec(path, "cpu"))
    want = jax_ser.codec_config(jax_ser.load_codec(path))
    assert got == want
    assert (got["dct_precision"], got["bark_precision"],
            got["pallas_kernel"], got["sidecar_grid"]) == (
        "highest", "highest", "mono", 0)


def jax_trees():
    """name -> (JAX tree, the port's template of it, convert's carry)."""
    ae = jax_sae.SpectralAE(**AE)
    sae_j = jax_sae.init_params(jax.random.key(0), ae)
    sae16_j = jax_sae.init_params(jax.random.key(1), ae, jnp.bfloat16)
    pf_j = jax_pf.init_params(jax.random.key(2), jax_pf.PostFilter(64, 32))
    rvq_j = jax_rvq.init_state(jax.random.key(3), jax_rvq.RVQ(**RVQ_KW))
    gen = torch.Generator().manual_seed(9)
    t_ae = sae.SpectralAE(**AE)
    as_np = lambda tree: {k: np.asarray(v)  # noqa: E731
                          for k, v in tree.items()}
    return {
        "sae": (sae_j, sae.init_params(gen, t_ae, device="cpu"),
                convert.params_from_arrays(as_np(sae_j), device="cpu")),
        "sae_bf16": (sae16_j, sae.init_params(gen, t_ae, torch.bfloat16,
                                              device="cpu"),
                     convert.params_from_arrays(as_np(sae16_j),
                                                device="cpu")),
        "post_filter": (pf_j, pf.init_params(gen, pf.PostFilter(64, 32),
                                             device="cpu"),
                        convert.params_from_arrays(as_np(pf_j),
                                                   device="cpu")),
        "rvq": (rvq_j, rvq.init_state(gen, rvq.RVQ(**RVQ_KW), device="cpu"),
                convert.rvq_state_from_arrays(as_np(rvq_j), device="cpu")),
    }


@pytest.mark.parametrize("name", ["sae", "sae_bf16", "post_filter", "rvq"])
def test_jax_trees_load_into_port_templates(tmp_path, name):
    tree_j, template, want = jax_trees()[name]
    path = str(tmp_path / "tree.npz")
    jax_ser.save_pytree(path, tree_j)
    got = serialization.load_pytree(path, template)
    assert list(got) == list(template)
    for k, t in got.items():
        assert t.dtype == want[k].dtype and torch.equal(t, want[k]), k
        assert t.requires_grad == template[k].requires_grad, k


@pytest.mark.parametrize("name", ["sae", "sae_bf16", "post_filter", "rvq"])
def test_port_trees_load_into_jax_templates(tmp_path, name):
    tree_j, template, _ = jax_trees()[name]
    path = str(tmp_path / "tree.npz")
    serialization.save_pytree(path, template)
    got = jax_ser.load_pytree(path, tree_j)
    for k, t in template.items():
        a = np.asarray(got[k])
        assert str(a.dtype) == str(t.dtype).removeprefix("torch."), k
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                a.view(np.uint16),
                t.detach().view(torch.int16).numpy().view(np.uint16))
        else:
            np.testing.assert_array_equal(a, t.detach().numpy())


def test_leaf_count_error_is_jax(tmp_path):
    tree_j, template, _ = jax_trees()["sae"]
    path = str(tmp_path / "pf.npz")
    jax_ser.save_pytree(path, jax_trees()["post_filter"][0])
    with pytest.raises(ValueError) as port_err:
        serialization.load_pytree(path, template)
    with pytest.raises(ValueError) as jax_err:
        jax_ser.load_pytree(path, tree_j)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="pass a template"):
        serialization.load_pytree(path)


def sae_trainer(seed):
    codec = Codec.create(SR, filters_n=256, bark_bands_n=16, device="cpu",
                         use_kernel=True)
    cfg = sae.SpectralAE(256, 32, 8, 1 / 16)
    params = sae.init_params(torch.Generator().manual_seed(seed), cfg,
                             device="cpu")
    step, make_opt = sae.make_train_step(codec, cfg)
    return params, make_opt(list(params.values())), step


def test_optimizer_state_round_trips(tmp_path):
    params, opt, step = sae_trainer(0)
    x = signal(256, torch.float32)
    step(params, opt, x)
    state = opt.state_dict()
    path = str(tmp_path / "opt.npz")
    serialization.save_pytree(path, state)
    for back in (serialization.load_pytree(path),
                 serialization.load_pytree(path, state)):
        assert back["param_groups"] == state["param_groups"]
        assert list(back["state"]) == list(state["state"])
        for i, s in state["state"].items():
            assert all(torch.equal(back["state"][i][k], v)
                       for k, v in s.items())


def test_training_resumes_exactly(tmp_path):
    """Two SAE steps, a checkpoint of the parameters and the optimizer,
    reloaded into a fresh template: step 3 equals the uninterrupted run's
    bit for bit (each step's latent noise from a generator of its own)."""
    x = signal(256, torch.float32)
    params, opt, step = sae_trainer(0)
    for i in range(2):
        step(params, opt, x, torch.Generator().manual_seed(i))
    serialization.save_pytree(str(tmp_path / "p.npz"), params)
    serialization.save_pytree(str(tmp_path / "o.npz"), opt.state_dict())
    want = step(params, opt, x, torch.Generator().manual_seed(2))
    fresh, opt2, step2 = sae_trainer(1)
    fresh = serialization.load_pytree(str(tmp_path / "p.npz"), fresh)
    opt2 = torch.optim.Adam(list(fresh.values()), lr=1e-3)
    opt2.load_state_dict(serialization.load_pytree(str(tmp_path / "o.npz")))
    got = step2(fresh, opt2, x, torch.Generator().manual_seed(2))
    assert torch.equal(got, want)
    assert all(torch.equal(fresh[k], params[k]) for k in params)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_resumes_across_save_stream_state(tmp_path, dtype):
    codec = Codec.create(SR, filters_n=64, bark_bands_n=16, device="cpu",
                         compute_dtype=dtype, fast_bf16=True)
    mdct = codec.mdct
    x = signal(64, dtype, blocks=8, batch=1)
    carry = streaming.mdct_stream_init(mdct, 1, 1)
    carry, f1 = streaming.mdct_stream_step(mdct, carry, x[:, :4 * 64])
    dec = streaming.imdct_stream_init(mdct, 1, 1)
    dec, y1 = streaming.imdct_stream_step(mdct, dec, f1)
    path = str(tmp_path / "state.npz")
    serialization.save_stream_state(path, carry, dec, offset=4)
    enc, dec2, offset = serialization.load_stream_state(path, device="cpu")
    assert offset == 4 and enc.dtype == dtype and torch.equal(enc, carry)
    assert torch.equal(dec2, dec)
    _, f2 = streaming.mdct_stream_step(mdct, enc, x[:, 4 * 64:])
    frames = torch.cat([f1, f2], 1)
    assert torch.equal(frames, streaming.stream_transform(mdct, x, 4)[:, :-1])
    _, y2 = streaming.imdct_stream_step(mdct, dec2, f2)
    assert torch.equal(torch.cat([y1, y2], 1),
                       streaming.stream_inverse_transform(mdct, frames, 4)
                       [:, :8 * 64])
    serialization.save_stream_state(path, carry)
    assert serialization.load_stream_state(path, device="cpu")[1] is None
