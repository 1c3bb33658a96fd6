"""The port's command line (``python -m audiocodec_tpu_torch``) held against
the JAX package's (``audiocodec_tpu.__main__``) on the same WAV files, on
the CPU: ``main([...], device="cpu")`` beside the JAX CLI's ``main([...])``
(with x64 off, as the JAX CLI runs for a user), at N=256, 32 Bark bands,
16 kHz stereo.

- Lossy ``.acz`` (plain, ``--preset music``, ``--ms``, ``--kbps``): on this
  signal the containers are equal member by member (``np.load``: the zip
  stamps the time), the printed lines are equal, and the decoded WAVs are
  within 4 LSB (each CLI decodes its own file and the other's).
- ``.acs`` (``--chunk-blocks``): the streams are equal byte for byte, and a
  ``--start/--duration`` window decodes within 4 LSB.
- ``--lossless`` at levels 1 and 2 (24-bit): the members are equal, each
  CLI decodes the other's file bit for bit, and a window is the slice.
- ``roundtrip``, ``resample``, ``eval --json``, ``info``,
  ``--tag-loudness`` (the tag equal) and ``--normalize-lufs``.
- The refusals exit as the JAX CLI's do (the bulk commands and serve on
  arguments they refuse too); without CUDA the default device fails with
  exit code 1.
"""

import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import audiocodec_tpu.__main__ as jcli
from audiocodec_tpu_torch import __main__ as cli
from audiocodec_tpu_torch.io import stream_container as sc
from audiocodec_tpu_torch.io import wav

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SR = 16000
SAMPLES = 2 * SR + 123
MODEL = ["--filters-n", "256", "--bark-bands-n", "32"]
LSB = 4


def run(package, argv):
    """One CLI call -> (exit code, stdout lines, stderr). A SystemExit
    (argparse, a usage error) gives its code, 1 for a message."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            if package == "jax":
                with jax.enable_x64(False), mock.patch.object(
                        jcli, "_ensure_compile_cache", lambda: None):
                    rc = jcli.main(argv)
            else:
                rc = cli.main(argv, device="cpu")
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
    return rc, out.getvalue().splitlines(), err.getvalue()


class Work(type(Path())):
    """The module's directory, with the calls already made (``both``)."""

    ran: dict


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """in.wav (stereo tones with noise), mono.wav and pcm24.wav (24-bit
    stereo), and one output directory for each package."""
    d = Work(tmp_path_factory.mktemp("cli"))
    d.ran = {}
    rng = np.random.default_rng(0)
    t = np.arange(SAMPLES) / SR
    x = np.stack([0.3 * np.sin(2 * np.pi * 440 * t)
                  + 0.02 * rng.standard_normal(SAMPLES),
                  0.2 * np.sin(2 * np.pi * 660 * t)
                  + 0.02 * rng.standard_normal(SAMPLES)], 1)
    wav.write_wav(str(d / "in.wav"), x.astype(np.float32), SR)
    wav.write_wav(str(d / "mono.wav"), x[:, :1].astype(np.float32), SR)
    x24 = np.round(x * (1 << 23)).astype(np.int32)
    wav.write_wav_int(str(d / "pcm24.wav"), x24, SR, 24)
    for p in ("jax", "port"):
        (d / p).mkdir()
    return d


def both(work, argv):
    """Run ``argv`` ({out} = each package's directory, {d} the inputs')
    through both CLIs: {package: (rc, stdout lines with the directory as
    {out}, stderr)}. A call made before in this module is not run again:
    later tests reuse its outputs."""
    key = tuple(argv)
    if key in work.ran:
        return work.ran[key]
    res = {}
    for p in ("jax", "port"):
        out = str(work / p)
        rc, lines, err = run(p, [a.format(out=out, d=work) for a in argv])
        res[p] = (rc, [ln.replace(out, "{out}") for ln in lines], err)
    work.ran[key] = res
    return res


def same_lines(res):
    """Both CLIs exited 0 and printed the same lines."""
    return res["jax"][:2] == res["port"][:2] and res["port"][0] == 0


def members(path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def assert_same_members(a, b):
    ma, mb = members(a), members(b)
    assert sorted(ma) == sorted(mb)
    for k in ma:
        assert ma[k].dtype == mb[k].dtype, k
        np.testing.assert_array_equal(ma[k], mb[k], err_msg=k)


def pcm16(path):
    x, rate = wav.read_wav(str(path))
    return np.round(x * 32768.0).astype(np.int64), rate


def assert_wavs_close(a, b, lsb=LSB):
    (xa, ra), (xb, rb) = pcm16(a), pcm16(b)
    assert ra == rb and xa.shape == xb.shape
    assert np.abs(xa - xb).max() <= lsb


ENCODE_PLAIN = ["encode", "{d}/in.wav", "{out}/plain.acz", *MODEL]
ACS = ["encode", "{d}/in.wav", "{out}/s.acs", *MODEL, "--chunk-blocks", "8",
       "--preset", "music"]
RESAMPLE = ["resample", "{d}/in.wav", "{out}/48k.wav", "--rate", "48000"]
LOSSLESS_1 = ["encode", "{d}/pcm24.wav", "{out}/l1.acz", "--lossless",
              "--lossless-level", "1"]

LOSSY = {
    "plain": [],
    "music": ["--preset", "music"],
    "ms": ["--ms"],
    "kbps": ["--kbps", "32"],
}


@pytest.mark.parametrize("case", sorted(LOSSY))
def test_lossy_acz_equals_jax(work, case):
    res = both(work, ["encode", "{d}/in.wav", f"{{out}}/{case}.acz", *MODEL,
                      *LOSSY[case]])
    assert same_lines(res)
    pj, pt = (work / p / f"{case}.acz" for p in ("jax", "port"))
    assert_same_members(pt, pj)
    res = both(work, ["decode", f"{{out}}/{case}.acz",
                      f"{{out}}/{case}.wav"])
    assert same_lines(res)
    wj, wt = (work / p / f"{case}.wav" for p in ("jax", "port"))
    assert pcm16(wt)[0].shape == (1, SAMPLES, 2)  # gapless
    assert_wavs_close(wt, wj)
    # the port decodes the JAX package's file
    rc, _, _ = run("port", ["decode", str(pj), str(work / f"x-{case}.wav")])
    assert rc == 0
    assert_wavs_close(work / f"x-{case}.wav", wj)


def test_acs_stream_and_window(work):
    res = both(work, ACS)
    assert same_lines(res)
    pj, pt = (work / p / "s.acs" for p in ("jax", "port"))
    assert pj.read_bytes() == pt.read_bytes()
    with sc.StreamReader(str(pt)) as r:
        assert r.n_chunks == 17
    for window in ([], ["--start", "0.5", "--duration", "0.7"],
                   ["--start", "1.9"]):
        res = both(work, ["decode", "{out}/s.acs", "{out}/s.wav", *window])
        assert same_lines(res)
        assert_wavs_close(work / "port" / "s.wav", work / "jax" / "s.wav")
        if not window:
            full = pcm16(work / "port" / "s.wav")[0]
    got = pcm16(work / "port" / "s.wav")[0]
    s0 = round(1.9 * SR)
    np.testing.assert_array_equal(got, full[:, s0:])


@pytest.mark.parametrize("level", ["1", "2"])
def test_lossless_equals_jax(work, level):
    res = both(work, ["encode", "{d}/pcm24.wav", f"{{out}}/l{level}.acz",
                      "--lossless", "--lossless-level", level])
    assert same_lines(res)
    pj, pt = (work / p / f"l{level}.acz" for p in ("jax", "port"))
    assert_same_members(pt, pj)
    src, _, _ = wav.read_wav_int(str(work / "pcm24.wav"))
    for dec, blob in (("port", pj), ("jax", pt)):
        out = work / dec / f"l{level}-x.wav"
        assert run(dec, ["decode", str(blob), str(out)])[0] == 0
        y, rate, bits = wav.read_wav_int(str(out))
        assert (rate, bits) == (SR, 24)
        np.testing.assert_array_equal(y, src)
    out = work / "port" / f"l{level}-w.wav"
    rc, _, _ = run("port", ["decode", str(pj), str(out), "--start", "0.3",
                            "--duration", "0.5"])
    assert rc == 0
    s0 = round(0.3 * SR)
    np.testing.assert_array_equal(wav.read_wav_int(str(out))[0],
                                  src[s0:s0 + SR // 2])
    res = both(work, ["info", f"{{out}}/l{level}.acz"])
    assert same_lines(res)


def test_roundtrip_resample_eval_info(work):
    res = both(work, ["roundtrip", "{d}/in.wav", "{out}/rt.wav", *MODEL])
    assert same_lines(res)
    assert_wavs_close(work / "port" / "rt.wav", work / "jax" / "rt.wav")

    res = both(work, RESAMPLE)
    assert same_lines(res)
    assert_wavs_close(work / "port" / "48k.wav", work / "jax" / "48k.wav", 1)

    res = both(work, ["eval", "{d}/in.wav", "{out}/rt.wav", "--json",
                      *MODEL])
    (rj, lj, _), (rt, lt, _) = res["jax"], res["port"]
    assert rj == rt == 0
    want, got = json.loads(lj[-1]), json.loads(lt[-1])
    assert list(got) == list(want)
    for k in ("snr_db", "seg_snr_db", "nmr_db"):
        assert abs(got[k] - want[k]) < 1e-3, k
    assert abs(got["nmr"] - want["nmr"]) <= 1e-4 * want["nmr"]
    for k in ("samples", "sample_rate", "lufs_ref", "lufs_deg"):
        assert got[k] == want[k], k
    res = both(work, ["eval", "{d}/in.wav", "{out}/rt.wav", *MODEL])
    assert res["port"][0] == 0 and len(res["port"][1]) == 5

    assert same_lines(both(work, ["encode", "{d}/in.wav", "{out}/i.acz",
                                  *MODEL, "--preset", "low", "--ms",
                                  "--kbps", "24"]))
    assert same_lines(both(work, ["info", "{out}/i.acz"]))
    assert same_lines(both(work, ACS))
    assert same_lines(both(work, ["info", "{out}/s.acs"]))


def test_loudness_tag_and_normalize(work):
    res = both(work, ["encode", "{d}/in.wav", "{out}/tag.acz", *MODEL,
                      "--tag-loudness"])
    assert same_lines(res)
    pj, pt = (work / p / "tag.acz" for p in ("jax", "port"))
    assert_same_members(pt, pj)
    res = both(work, ["decode", "{out}/tag.acz", "{out}/norm.wav",
                      "--normalize-lufs", "-16"])
    assert same_lines(res)
    assert res["port"][1][0].startswith("loudness: ")
    assert_wavs_close(work / "port" / "norm.wav", work / "jax" / "norm.wav")
    # measured (untagged) normalization after a resample
    assert same_lines(both(work, ENCODE_PLAIN))
    res = both(work, ["decode", "{out}/plain.acz", "{out}/norm48.wav",
                      "--normalize-lufs", "-20", "--resample-to", "48000"])
    assert same_lines(res)
    assert_wavs_close(work / "port" / "norm48.wav",
                      work / "jax" / "norm48.wav")


REFUSALS = {
    "lossless+kbps": ["encode", "{d}/pcm24.wav", "{out}/r.acz",
                      "--lossless", "--kbps", "32"],
    "ms-on-mono": ["encode", "{d}/mono.wav", "{out}/r.acz", "--ms", *MODEL],
    "fec-without-chunks": ["encode", "{d}/in.wav", "{out}/r.acz", "--fec",
                           *MODEL],
    "dtx-with-kbps": ["encode", "{d}/in.wav", "{out}/r.acs", "--dtx",
                      "--kbps", "32", "--chunk-blocks", "8", *MODEL],
    "reservoir-without-cbr": ["encode", "{d}/in.wav", "{out}/r.acz",
                              "--reservoir", "8", *MODEL],
    "tag-on-roundtrip": ["roundtrip", "{d}/in.wav", "{out}/r.wav",
                         "--tag-loudness", *MODEL],
    "eval-rate-mismatch": ["eval", "{d}/in.wav", "{out}/48k.wav", *MODEL],
    "missing-file": ["decode", "{d}/nothing.acz", "{out}/r.wav"],
    "start-past-end": ["decode", "{out}/plain.acz", "{out}/r.wav",
                       "--start", "99"],
    "acs-start-past-end": ["decode", "{out}/s.acs", "{out}/r.wav",
                           "--start", "99"],
    "lossless-resample": ["decode", "{out}/l1.acz", "{out}/r.wav",
                          "--resample-to", "48000"],
    "bad-precision": ["encode", "{d}/in.wav", "{out}/r.acz",
                      "--precision", "fastest"],
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_exit_as_jax(work, case):
    for argv in (ENCODE_PLAIN, ACS, RESAMPLE, LOSSLESS_1):
        assert same_lines(both(work, argv))
    res = both(work, REFUSALS[case])
    assert res["port"][0] == res["jax"][0] != 0, res


@pytest.mark.parametrize("command", ["corpus", "corpus-decode", "serve"])
def test_bulk_and_serve_not_registered(command):
    """The bulk commands and serve are registered now (tests/
    test_torch_corpus.py holds them to the JAX CLI): on arguments they
    refuse, they exit as the JAX CLI does, with its message."""
    rc, _, err = run("port", [command, "a", "b"])
    jrc, _, jerr = run("jax", [command, "a", "b"])
    assert "invalid choice" not in err
    # argparse names its program: compare from "error:" on
    assert rc == jrc != 0 and (err.splitlines()[-1].split("error:")[-1]
                               == jerr.splitlines()[-1].split("error:")[-1])


def test_default_device_needs_cuda(work):
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        err_io = io.StringIO()
        with contextlib.redirect_stderr(err_io):
            rc = cli.main(["info", str(work / "in.wav")])
    assert rc == 1 and "no CUDA device" in err_io.getvalue()


def test_module_entry_point():
    proc = subprocess.run(
        [sys.executable, "-m", "audiocodec_tpu_torch", "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True)
    for command in ("encode", "decode", "roundtrip", "eval", "resample",
                    "info", "corpus", "corpus-decode", "serve"):
        assert command in proc.stdout
