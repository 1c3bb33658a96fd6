"""The fused psycho/quantize route on the CPU (ops/cuda_psycho.py): which
inputs take it, what its wrapper refuses, its plain version, and the
kernel's operands with its steps emulated in numpy float32. The kernel
itself runs on the card only (tests/test_torch_cuda_psycho.py)."""

import math
import types
from unittest import mock

import numpy as np
import pytest
import torch

from audiocodec_tpu_torch import Codec, PsychoacousticModel, quantize
from audiocodec_tpu_torch.ops import cuda_psycho

torch.set_num_threads(1)

N = 256
# tests/test_torch_cuda_psycho.py's bounds, for the emulation: only the
# order of the sums differs from the stagewise chain
ULPS = 64
ERR = 1e-9


def _codec(**kw):
    kw.setdefault("filters_n", N)
    return Codec.create(44100, device="cpu", **kw)


def _signal(clips, blocks, channels, seed=0, n=N):
    """Two tones and white noise, each clip and channel at its own gain."""
    g = torch.Generator().manual_seed(seed)
    t = torch.arange(blocks * n, dtype=torch.float64) / 44100
    tones = (0.4 * torch.sin(2 * math.pi * 440 * t)
             + 0.3 * torch.sin(2 * math.pi * 1320 * t))
    noise = 0.05 * torch.randn(clips, blocks * n, channels, generator=g,
                               dtype=torch.float64)
    gains = 0.1 + 0.9 * torch.rand(clips, 1, channels, generator=g,
                                   dtype=torch.float64)
    return ((tones[None, :, None] + noise) * gains).float()


def _stages(model, spectrum, drown):
    """The stagewise chain as the codec ran it before the fused route."""
    thr = model.global_masking_threshold(spectrum, model.tonality(spectrum),
                                         drown)
    codes, delta = quantize.quantize(spectrum, thr)
    return codes, delta, thr, quantize.dequantize(codes, delta,
                                                  dtype=spectrum.dtype)


def _fake(model, **kw):
    """A spectrum that claims to lie on the card and to be what the kernel
    takes, but for ``kw``."""
    n = model.filter_bands_n
    attrs = dict(device=torch.device("cuda"), dtype=torch.float32,
                 shape=(2, 9, n, 1), requires_grad=False,
                 strides=(9 * n, n, 1, 1), address=256)
    attrs.update(kw)
    strides, address = attrs.pop("strides"), attrs.pop("address")
    return types.SimpleNamespace(
        dim=lambda: len(attrs["shape"]), data_ptr=lambda: address,
        stride=lambda d=None: strides if d is None else strides[d], **attrs)


def _emulate(model, spectrum, drown=0.0):
    """csrc/psycho_kernel.cu's steps on its operands (``_tables``,
    ``_scalars``) and its row layout, in numpy float32: (codes, delta,
    threshold, dequantized), each in the spectrum's layout (the bins of a
    row contiguous)."""
    tensors, consts = cuda_psycho._tables(model)
    (band_lo, band_off, band_w, bin_lo, bin_w, spreading, grid, quiet,
     floor) = [None if t is None else t.numpy() for t in tensors]
    (eps, alpha, inv_alpha, neg_alpha, ln10, mean, keep, inv_neg60,
     inv_ten, rsqrt3, step_floor) = np.array(
        list(cuda_psycho._scalars(consts, spectrum, drown)), np.float32)
    b, f, n, c = spectrum.shape
    sb, sf, _, sc = spectrum.stride()
    order = sorted(range(4), key=lambda d: -spectrum.stride(d))
    mem = spectrum.permute(order).reshape(-1).numpy()
    r = np.arange(b * f * c)
    ch, rest = r % c, r // c
    off = (rest // f) * sb + (rest % f) * sf + ch * sc
    idx = off[:, None] + np.arange(n)[None, :]
    a = mem[idx]
    p = a * a
    geo = np.exp(np.log(np.maximum(eps, p)).sum(1, dtype=np.float32) * mean)
    arith = p.sum(1, dtype=np.float32) * mean + eps
    sfm = np.float32(10) * np.log(geo / arith) / ln10
    ton = np.minimum(sfm * inv_neg60, np.float32(1))[:, None]
    k = len(band_lo)
    inten = np.stack([
        (p[:, band_lo[j]:band_lo[j] + band_off[j + 1] - band_off[j]]
         * band_w[band_off[j]:band_off[j + 1]]).sum(1, dtype=np.float32)
        for j in range(k)], axis=1)
    spread = np.maximum(eps, inten) ** alpha @ spreading
    offset = (ton * grid + np.float32(9) * ton + np.float32(5.5)) * keep
    factor = np.float32(10) ** ((neg_alpha * offset) * inv_ten)
    bark = np.maximum(np.maximum(eps, spread * factor) ** inv_alpha, quiet)
    width = bin_w.shape[1]
    bark_padded = np.concatenate(
        [bark, np.zeros((len(bark), width), np.float32)], axis=1)
    back = np.stack([
        (bark_padded[:, bin_lo[i]:bin_lo[i] + width] * bin_w[i]).sum(
            1, dtype=np.float32) for i in range(n)], axis=1)
    thr = np.sqrt(np.maximum(eps, back))
    if floor is not None:
        thr = np.maximum(thr, floor)
    delta = np.maximum(thr * rsqrt3, step_floor)
    codes = np.rint(a / delta).astype(np.int32)
    outs = []
    for v in (codes, delta, thr, codes.astype(np.float32) * delta):
        m = np.zeros(mem.size, v.dtype)
        m[idx] = v
        outs.append(torch.from_numpy(m).as_strided(spectrum.shape,
                                                   spectrum.stride()))
    return outs


def _ulps(a, b):
    return int((a.view(torch.int32).long() - b.view(torch.int32).long())
               .abs().max())


# -- the route ---------------------------------------------------------------

ROUTES = [  # (Codec.create keywords, requires_grad, grad enabled, fused)
    (dict(), False, True, True),
    (dict(dct_precision="high"), False, True, True),
    (dict(), True, False, True),
    (dict(), True, True, False),
    (dict(compute_dtype="bfloat16", fast_bf16=True, dct_precision="default"),
     False, True, False),
    (dict(dct_precision="default"), False, True, False),
    (dict(bark_precision="default"), False, True, False),
    (dict(compute_dtype="float64"), False, True, False),
    (dict(dct_precision="int8"), False, True, False),
    # rows of 258 bins: not a multiple of 4, so not 16-byte aligned
    (dict(filters_n=258), False, True, False),
]


@pytest.mark.parametrize("kw,grad,enabled,fused", ROUTES)
def test_route_follows_device_dtype_precision_and_autograd(kw, grad, enabled,
                                                           fused):
    codec = _codec(**kw)
    x = types.SimpleNamespace(is_cuda=True, requires_grad=grad)
    with torch.set_grad_enabled(enabled):
        assert codec._fused(x) is fused
    real = torch.zeros(1, 4 * N, 1, dtype=codec.mdct.compute_dtype)
    assert codec._fused(real) is False  # a CPU tensor: stagewise


def test_cpu_inputs_take_the_stagewise_path():
    codec = _codec()
    x = _signal(2, 8, 1)
    spec = codec.mdct.transform(x)
    codes, delta, thr, deq = _stages(codec.psycho, spec, 0.0)
    with mock.patch.object(cuda_psycho, "psycho_quantize",
                           side_effect=AssertionError("fused route taken")):
        got = codec.encode_quantized(x)
        rt = codec.round_trip_quantized(x)
    for g, w in zip(got, (codes, delta, thr)):
        assert torch.equal(g, w)
    assert torch.equal(rt, codec.decode(deq))


@pytest.mark.parametrize("channels,drown", [(1, 0.0), (2, 0.3)])
def test_fused_branch_round_trip_is_the_decode_of_its_encode(channels, drown):
    """The codec's fused branch, through the wrapper's plain version: its
    round trip is the decode of its encode's codes and steps, bit for bit,
    and equals the stagewise path."""
    codec = _codec()
    x = _signal(2, 8, channels, seed=channels)
    want_rt = codec.round_trip_quantized(x, drown)
    want_enc = codec.encode_quantized(x, drown)
    with mock.patch.object(Codec, "_fused", return_value=True), \
            mock.patch.object(cuda_psycho, "psycho_quantize",
                              wraps=cuda_psycho.psycho_quantize) as spy:
        rt = codec.round_trip_quantized(x, drown)
        enc = codec.encode_quantized(x, drown)
    assert spy.call_count == 2
    assert spy.call_args_list[1].kwargs == {"encode": True}
    assert torch.equal(rt, codec.decode_quantized(*enc[:2]))
    assert torch.equal(rt, want_rt)
    for g, w in zip(enc, want_enc):
        assert torch.equal(g, w)


# -- the wrapper -------------------------------------------------------------

REFUSED = [  # (model keywords, fake spectrum keywords, error, message)
    (dict(), dict(dtype=torch.float64), TypeError, "float32 spectra"),
    (dict(), dict(dtype=torch.bfloat16), TypeError, "float32 spectra"),
    (dict(compute_dtype="bfloat16"), dict(dtype=torch.bfloat16), TypeError,
     "float32 spectra"),
    (dict(bark_precision="default"), dict(), ValueError, "bark_precision"),
    (dict(), dict(shape=(2, 9, N + 1, 1)), ValueError, "spectrum must be"),
    (dict(), dict(shape=(9, N, 1)), ValueError, "spectrum must be"),
    (dict(), dict(requires_grad=True), NotImplementedError, "no backward"),
    (dict(), dict(strides=(18 * N, 2 * N, 1, 1)), ValueError, "dense"),
    (dict(), dict(strides=(9 * N, N, 2, 1)), ValueError, "dense"),
    # a dense stereo spectrum whose bins lie 2 apart
    (dict(), dict(shape=(2, 9, N, 2), strides=(18 * N, 2 * N, 2, 1)),
     ValueError, "bins of a row must be contiguous"),
    (dict(), dict(address=260), ValueError, "16-byte aligned"),
    (dict(filter_bands_n=258), dict(strides=(9 * 258, 258, 1, 1)),
     ValueError, "16-byte aligned"),
    (dict(), dict(), ValueError, "the model is on cpu"),
    (dict(), dict(device=torch.device("meta")), ValueError,
     "no kernel for a tensor on meta"),
]


@pytest.mark.parametrize("model_kw,fake_kw,error,match", REFUSED)
def test_wrapper_refuses_what_the_kernel_does_not_take(model_kw, fake_kw,
                                                       error, match):
    model = PsychoacousticModel(44100, device="cpu",
                                **{"filter_bands_n": N, **model_kw})
    with pytest.raises(error, match=match):
        cuda_psycho.psycho_quantize(model, _fake(model, **fake_kw))


@pytest.mark.parametrize("calibrated,channels,drown",
                         [(False, 1, 0.0), (True, 1, 0.0), (False, 2, 0.3)])
def test_plain_version_is_the_stage_composition(calibrated, channels, drown):
    codec = _codec(calibrated=calibrated)
    spec = codec.mdct.transform(_signal(2, 8, channels, seed=3))
    codes, delta, thr, deq = _stages(codec.psycho, spec, drown)
    got = cuda_psycho.psycho_quantize(codec.psycho, spec, drown, encode=True)
    for g, w in zip(got, (codes, delta, thr)):
        assert torch.equal(g, w)
    assert torch.equal(cuda_psycho.psycho_quantize(codec.psycho, spec, drown),
                       deq)


@pytest.mark.parametrize("make", [
    lambda t: t, lambda t: t.permute(0, 3, 1, 2).contiguous().permute(
        0, 2, 3, 1), lambda t: t.transpose(0, 1), lambda t: t[:, :1]])
def test_dense_layouts_are_told_from_sliced_ones(make):
    t = make(torch.zeros(2, 9, N, 2))
    want = torch.empty_like(t).stride() == t.stride()
    assert cuda_psycho._dense(t.shape, t.stride()) is want
    assert not cuda_psycho._dense(t[:, :, ::2].shape, t[:, :, ::2].stride())
    assert cuda_psycho._dense(t[:, :0].shape, t[:, :0].stride())


# -- the kernel's operands ---------------------------------------------------

def _dense(lo, off, vals, rows, cols):
    m = np.zeros((rows, cols), np.float32)
    for j in range(cols):
        m[lo[j]:lo[j] + off[j + 1] - off[j], j] = vals[off[j]:off[j + 1]]
    return m


@pytest.mark.parametrize("n,bands,calibrated",
                         [(256, 64, False), (1024, 64, False),
                          (2048, 64, True), (1024, 32, True)])
def test_tables_hold_every_nonzero_of_w_and_w_inv(n, bands, calibrated):
    model = PsychoacousticModel(44100, filter_bands_n=n, bark_bands_n=bands,
                                calibrated=calibrated, device="cpu")
    tensors, consts = cuda_psycho._tables(model)
    w, w_inv = model.W.numpy(), model.W_inv.numpy()
    assert np.array_equal(_dense(*(t.numpy() for t in tensors[:3]), n, bands),
                          w)
    lo, rows = tensors[3].numpy(), tensors[4].numpy()
    width = rows.shape[1]
    w_inv_padded = np.zeros((bands + width, n), np.float32)
    for i in range(n):
        w_inv_padded[lo[i]:lo[i] + width, i] = rows[i]
    assert np.array_equal(w_inv_padded[:bands], w_inv)
    assert not w_inv_padded[bands:].any()
    # the ranges hold few zeros: about one value a bin and a band each way
    assert len(tensors[2]) <= np.count_nonzero(w) + bands
    assert rows.size <= 3 * np.count_nonzero(w_inv)
    assert consts == [float(getattr(model, f"c_{c}")) for c in
                      ("eps", "alpha", "inv_alpha", "neg_alpha", "ln10")]
    assert (tensors[8] is None) is not calibrated


def test_tables_follow_the_model_buffers():
    model = PsychoacousticModel(44100, filter_bands_n=N, device="cpu")
    first = cuda_psycho._tables(model)
    assert cuda_psycho._tables(model) is first
    with torch.no_grad():
        model.W[3, :] = 0.0  # in place
    second = cuda_psycho._tables(model)
    assert second is not first
    assert not np.array_equal(first[0][2].numpy(), second[0][2].numpy())
    model.W_inv = model.W_inv * 2.0  # replaced, as convert does
    third = cuda_psycho._tables(model)
    assert third is not second
    assert torch.equal(third[0][4], 2.0 * second[0][4])


def test_scalars_round_as_the_stagewise_path_on_the_card():
    model = PsychoacousticModel(44100, filter_bands_n=N, device="cpu")
    spec = torch.zeros(3, 5, N, 2)
    s = np.array(list(cuda_psycho._scalars(cuda_psycho._tables(model)[1],
                                           spec, 0.3)), np.float32)
    assert s[5] == np.float32(1.0 / N)  # the mean's factor
    assert s[6] == np.float32(0.7)
    assert s[7] == np.float32(1) / np.float32(-60)
    assert s[8] == np.float32(0.1)
    assert s[9] == np.float32(1 / math.sqrt(3.0))
    assert s[10] == np.float32(1e-12)


EMULATED = [  # (Codec.create keywords, channels, drown)
    (dict(), 1, 0.0),
    (dict(), 2, 0.0),  # channel-major rows, as the MDCT returns
    (dict(calibrated=True), 1, 0.0),
    (dict(), 1, 0.3),
    (dict(filters_n=512, bark_bands_n=48), 1, 0.0),
]


@pytest.mark.parametrize("kw,channels,drown", EMULATED)
def test_kernel_steps_emulated_match_the_plain_version(kw, channels, drown):
    codec = _codec(**kw)
    n = codec.mdct.filters_n
    spec = codec.mdct.transform(_signal(2, 8, channels, seed=5, n=n))
    codes, delta, thr, deq = _emulate(codec.psycho, spec, drown)
    w_codes, w_delta, w_thr, w_deq = _stages(codec.psycho, spec, drown)
    flips = codes != w_codes
    assert int(flips.sum()) <= max(1, flips.numel() // 100_000)
    if flips.any():
        u = (spec.double() / w_delta.double())[flips].abs()
        assert float(((u - u.floor() - 0.5).abs() - 1e-5 * u).max()) <= 0
    assert _ulps(delta, w_delta) <= ULPS and _ulps(thr, w_thr) <= ULPS
    err = ((deq.double() - w_deq.double()) ** 2).sum() / (
        w_deq.double() ** 2).sum()
    assert float(err) <= ERR
    assert torch.equal(deq, codes.float() * delta)
