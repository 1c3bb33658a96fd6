"""The psycho/quantize kernel (ops/cuda_psycho.py) against its plain version,
the stagewise chain, on the card.

These need an NVIDIA GPU with nvcc: run ``python -m pytest --noconftest -m
cuda tests/test_torch_cuda_psycho.py`` there. Without a card they skip; the
skip condition is a string, evaluated when each test is set up and never
while the module is imported.

Bounds, for both routes on the same spectrum. Only the order of the sums
differs (csrc/psycho_kernel.cu): the tonality's sum of N logs of about -20
each carries a few ulps of ~2e4, which exp, the offset's power of ten and
the 1/alpha power pass on to the threshold, ~1e-6 relative at most, so the
steps and thresholds stay within ``ULPS`` ulps (7.6e-6 relative). A code
can then differ only where a / delta lies within that much of a rounding
tie: at most ``FLIPS`` of the codes (about one in 10^5 quotients lies that
close to a tie at the quotients' sizes here), each one step off. The
dequantized spectrum's error energy, the flips' steps and the steps' ulps,
stays under ``ERR`` of the plain one's."""

import math

import pytest
import torch

from audiocodec_tpu_torch import Codec
from audiocodec_tpu_torch.ops import cuda_mdct, cuda_psycho

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()",
                       reason="needs an NVIDIA GPU"),
]

ULPS = 64
FLIPS = 1e-5
ERR = 1e-9
TIE = 1e-5  # a flipped quotient's distance from a tie, relative to it

CASES = {  # (Codec.create keywords, clips, samples, channels, drown)
    "mono44k": (dict(), 32, 440320, 1, 0.0),  # the main path's [32,431,1024,1]
    "stereo": (dict(), 2, 63 * 1024, 2, 0.0),  # [2, 64, 1024, 2]
    "n2048": (dict(filters_n=2048), 4, 40 * 2048, 1, 0.0),
    "calibrated": (dict(calibrated=True), 4, 40 * 1024, 1, 0.0),
    "drown": (dict(), 4, 40 * 1024, 2, 0.3),
}


def _signal(clips, samples, channels, seed=0):
    """Two tones and white noise, each clip and channel at its own gain."""
    g = torch.Generator().manual_seed(seed)
    t = torch.arange(samples, dtype=torch.float64) / 44100
    tones = (0.4 * torch.sin(2 * math.pi * 440 * t)
             + 0.3 * torch.sin(2 * math.pi * 1320 * t))
    noise = 0.05 * torch.randn(clips, samples, channels, generator=g,
                               dtype=torch.float64)
    gains = 0.1 + 0.9 * torch.rand(clips, 1, channels, generator=g,
                                   dtype=torch.float64)
    return ((tones[None, :, None] + noise) * gains).float().cuda()


def _case(name):
    kw, clips, samples, channels, drown = CASES[name]
    codec = Codec.create(44100, device="cuda", **kw)
    x = _signal(clips, samples, channels, seed=len(name))
    return codec, x, drown


def _ulps(a, b):
    return int((a.view(torch.int32).long() - b.view(torch.int32).long())
               .abs().max())


def _hold(spec, got, want):
    """``got`` (codes, delta, threshold, dequantized) within the bounds of
    ``want``'s; returns the count of flipped codes."""
    codes, delta, thr, deq = got
    w_codes, w_delta, w_thr, w_deq = want
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    flips = codes != w_codes
    n = int(flips.sum())
    assert n <= max(1, FLIPS * codes.numel())
    if n:
        u = (spec.double() / w_delta.double())[flips].abs()
        assert float(((u - u.floor() - 0.5).abs() - TIE * u).max()) <= 0
        assert int((codes.long() - w_codes.long()).abs().max()) == 1
    assert _ulps(delta, w_delta) <= ULPS
    assert _ulps(thr, w_thr) <= ULPS
    err = ((deq.double() - w_deq.double()) ** 2).sum() / (
        w_deq.double() ** 2).sum()
    assert float(err) <= ERR
    return n


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain_version(name):
    codec, x, drown = _case(name)
    with torch.no_grad():
        spec = codec.mdct.transform(x)
        cuda_psycho.reset_launch_counts()
        enc = cuda_psycho.psycho_quantize(codec.psycho, spec, drown,
                                          encode=True)
        torch.cuda.synchronize()
        assert cuda_psycho.launch_counts() == {"psycho_quantize": 1}
        deq = cuda_psycho.psycho_quantize(codec.psycho, spec, drown)
        torch.cuda.synchronize()
        assert cuda_psycho.launch_counts() == {"psycho_quantize": 2}
        want = cuda_psycho.psycho_quantize_reference(codec.psycho, spec, drown,
                                                     encode=True)
        want_deq = cuda_psycho.psycho_quantize_reference(codec.psycho, spec,
                                                         drown)
    assert torch.equal(deq, enc[0].float() * enc[1])
    _hold(spec, (*enc, deq), (*want, want_deq))


def test_long_rows_one_a_block_match_plain_version():
    """N = 4096: too long for a group of rows in a block's shared memory,
    so the kernel takes one row a block."""
    from audiocodec_tpu_torch import PsychoacousticModel

    model = PsychoacousticModel(44100, filter_bands_n=4096, device="cuda")
    g = torch.Generator().manual_seed(7)
    spec = (torch.randn(2, 5, 4096, 1, generator=g)
            * torch.logspace(0, -3, 4096)[:, None]).cuda()
    with torch.no_grad():
        enc = cuda_psycho.psycho_quantize(model, spec, encode=True)
        deq = cuda_psycho.psycho_quantize(model, spec)
        want = cuda_psycho.psycho_quantize_reference(model, spec, encode=True)
        want_deq = cuda_psycho.psycho_quantize_reference(model, spec)
    assert torch.equal(deq, enc[0].float() * enc[1])
    _hold(spec, (*enc, deq), (*want, want_deq))


@pytest.mark.parametrize("name", ["mono44k", "stereo", "drown"])
def test_round_trip_is_the_decode_of_the_encode(name):
    codec, x, drown = _case(name)
    with torch.no_grad():
        cuda_psycho.reset_launch_counts()
        cuda_mdct.reset_launch_counts()
        rt = codec.round_trip_quantized(x, drown)
        torch.cuda.synchronize()
        assert cuda_psycho.launch_counts() == {"psycho_quantize": 1}
        assert cuda_mdct.launch_counts()["fold_matmul"] == 1
        assert cuda_mdct.launch_counts()["matmul_scatter"] == 1
        codes, delta, _ = codec.encode_quantized(x, drown)
        torch.cuda.synchronize()
        assert cuda_psycho.launch_counts() == {"psycho_quantize": 2}
        assert torch.equal(rt, codec.decode_quantized(codes, delta))


@pytest.mark.parametrize("kw,grad", [
    (dict(compute_dtype="bfloat16", fast_bf16=True, dct_precision="int8"),
     False),
    (dict(bark_precision="default"), False),
    (dict(), True),
])
def test_other_inputs_take_the_stagewise_path(kw, grad):
    codec = Codec.create(44100, device="cuda", **kw)
    x = _signal(2, 8 * 1024, 1).to(codec.mdct.compute_dtype)
    x.requires_grad_(grad)
    cuda_psycho.reset_launch_counts()
    codec.round_trip_quantized(x)
    codec.encode_quantized(x)
    torch.cuda.synchronize()
    assert cuda_psycho.launch_counts() == {"psycho_quantize": 0}


def test_wrapper_refuses_what_the_kernel_does_not_take():
    codec = Codec.create(44100, device="cuda")
    spec = torch.zeros(2, 9, 1024, 1, device="cuda")
    p = codec.psycho
    with pytest.raises(TypeError, match="float32 spectra"):
        cuda_psycho.psycho_quantize(p, spec.bfloat16())
    with pytest.raises(ValueError, match="spectrum must be"):
        cuda_psycho.psycho_quantize(p, spec[:, :, :512])
    with pytest.raises(ValueError, match="dense"):
        cuda_psycho.psycho_quantize(p, spec[:, ::2])
    with pytest.raises(ValueError, match="bins of a row must be contiguous"):
        cuda_psycho.psycho_quantize(p, torch.zeros(2, 9, 1024, 2,
                                                   device="cuda"))
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_psycho.psycho_quantize(p, torch.zeros(
            spec.numel() + 1, device="cuda")[1:].view(spec.shape))
    with pytest.raises(NotImplementedError, match="no backward"):
        cuda_psycho.psycho_quantize(p, spec.clone().requires_grad_())
    cpu = Codec.create(44100, device="cpu").psycho
    with pytest.raises(ValueError, match="the model is on cpu"):
        cuda_psycho.psycho_quantize(cpu, spec)
