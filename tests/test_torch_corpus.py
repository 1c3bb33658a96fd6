"""The port's bulk corpus path on the CPU: ``native.load_corpus``,
``parallel.{mesh,corpus,pipeline}`` and the command line's ``corpus``,
``corpus-decode`` and ``serve``, held against the JAX package (N=256, 32
Bark bands, 16 kHz, short clips).

- ``load_corpus`` equals the JAX package's on both wires, status codes
  included.
- A mesh is a (dp, sp) grid of ``torch.device``s (``sp`` > 1: see
  tests/test_torch_sharded.py).
  ``encode_corpus`` over dp=2 (two CPU devices) equals dp=1, a ragged final
  batch padded and stripped.
- The loaders (every case of tests/test_pipeline.py): order, errors,
  re-iteration, the int16 wire, final-batch padding, the end-of-stream
  sentinel, the PCM cache and its refusals; ``encode_corpus_streaming``
  equals ``encode_corpus``.
- ``main(["corpus", ...], device="cpu")`` at float64 writes the JAX CLI's
  containers member for member (plain, ``--kbps``, ``--tag-loudness``,
  ``--cache``), the lossless corpus bit for bit, and the same containers
  over a mesh of two devices; ``corpus-decode`` is within one LSB of the
  JAX CLI's and of a solo ``decode`` (also a batch of three lengths and
  threshold scales, and a directory that mixes lossless and lossy files);
  the refusals print the JAX CLI's messages; ``serve --port 0`` in a
  thread answers an 'E' request.
"""

import contextlib
import io
import os
import queue
import shutil
import threading
import time
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiocodec_tpu.__main__ as jcli
from audiocodec_tpu import native as jnative
from audiocodec_tpu_torch import Codec, native, serve
from audiocodec_tpu_torch import __main__ as cli
from audiocodec_tpu_torch.io import bitstream, wav
from audiocodec_tpu_torch.parallel import corpus as _corpus
from audiocodec_tpu_torch.parallel import mesh as _mesh
from audiocodec_tpu_torch.parallel import pipeline
from audiocodec_tpu_torch.parallel.pipeline import (
    PAD_STATUS,
    CachedCorpusLoader,
    PrefetchingCorpusLoader,
    build_corpus_cache,
    encode_corpus_streaming,
    validate_corpus_cache,
)
from audiocodec_tpu_torch.utils.device import dequant_wire

torch.set_num_threads(1)

N = 256
SR = 16000
BARK = 32
CLIP = 4 * N / SR  # 4 blocks
CPU = torch.device("cpu")
MODEL = ["--filters-n", str(N), "--bark-bands-n", str(BARK)]


def mesh(dp=1):
    return _mesh.make_mesh(devices=[CPU] * dp)


@pytest.fixture(scope="module")
def codec():
    return Codec.create(SR, filters_n=N, bark_bands_n=BARK, device="cpu")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Ten PCM16 clips of 4 blocks (the loaders' corpus)."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    paths, clips = [], []
    for i in range(10):
        x = rng.uniform(-0.8, 0.8, size=(4 * N, 1)).astype(np.float32)
        p = str(root / f"clip{i}.wav")
        wav.write_wav(p, x, SR)
        paths.append(p)
        clips.append(x)
    return paths, clips


def batches(loader):
    """[(rows [b, frames, C] on the host, status)] of one pass."""
    return [(torch.cat([s.cpu() for s in shards])[:len(status)], status)
            for shards, status in loader]


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_load_corpus_equals_jax(tmp_path, dtype):
    rng = np.random.default_rng(1)
    paths = []
    for i, (frames, ch) in enumerate([(900, 1), (1500, 1), (700, 2)]):
        x = rng.uniform(-0.9, 0.9, size=(frames, ch)).astype(np.float32)
        paths.append(str(tmp_path / f"c{i}.wav"))
        wav.write_wav(paths[-1], x, SR, width=2 if i != 1 else 4)
    paths.append(str(tmp_path / "missing.wav"))
    (tmp_path / "text.wav").write_bytes(b"not a wav at all")
    paths.append(str(tmp_path / "text.wav"))
    got, status = native.load_corpus(paths, clip_seconds=1000 / SR,
                                     sample_rate=SR, dtype=dtype)
    want, wstatus = jnative.load_corpus(paths, clip_seconds=1000 / SR,
                                        sample_rate=SR, dtype=dtype)
    assert got.dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(status, wstatus)
    assert list(status) == [0, 0, -5, -1, -2]
    with pytest.raises(ValueError, match="dtype"):
        native.load_corpus(paths, 0.1, SR, dtype="int8")


@pytest.mark.parametrize("kw, shape", [
    (dict(), {"dp": 2, "sp": 1}),
    (dict(n_devices=1), {"dp": 1, "sp": 1}),
    (dict(dp=2), {"dp": 2, "sp": 1}),
    (dict(sp=2), {"dp": 1, "sp": 2}),
])
def test_make_mesh_shapes(kw, shape):
    m = _mesh.make_mesh(devices=[CPU, CPU], **kw)
    assert m.shape == shape
    assert m.dp_devices == [CPU] * shape["dp"]
    assert _mesh.pad_batch_to(5, shape["dp"]) == (6 if shape["dp"] == 2
                                                  else 5)


@pytest.mark.parametrize("kw, match", [
    (dict(sp=3), "not divisible by sp=3"),
    (dict(dp=3), r"dp\*sp=3 != n_devices=2"),
    (dict(n_devices=3), "n_devices=3"),
])
def test_make_mesh_errors(kw, match):
    with pytest.raises(ValueError, match=match):
        _mesh.make_mesh(devices=[CPU, CPU], **kw)


def test_encode_corpus_dp2_equals_dp1(codec):
    rng = np.random.default_rng(2)
    clips = rng.uniform(-0.5, 0.5, size=(10, 8 * N, 1)).astype(np.float32)
    one = _corpus.encode_corpus(codec, clips, mesh=mesh(1), batch_size=4)
    two = _corpus.encode_corpus(codec, clips, mesh=mesh(2), batch_size=3)
    # batch 3 rounds up to 4 (dp=2); the last batch is 2 real rows
    assert [c.shape[0] for c, _ in two] == [4, 4, 2]
    for (c1, d1), (c2, d2) in zip(one, two):
        torch.testing.assert_close(c1, c2, rtol=0, atol=0)
        torch.testing.assert_close(d1, d2, rtol=0, atol=0)
    want = codec.encode_quantized(torch.from_numpy(clips[8:]))[0]
    torch.testing.assert_close(two[-1][0], want, rtol=0, atol=0)
    # the noise mode: a generator a dp row, drawn batch after batch
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    noisy = _corpus.encode_corpus(codec, clips[:4], mesh=mesh(2),
                                  batch_size=4, generator=gens,
                                  quantized=False)
    assert noisy[0][0].shape == (4, 9, N, 1)
    again = _corpus.encode_corpus(
        codec, clips[:4], mesh=mesh(2), batch_size=4, quantized=False,
        generator=[torch.Generator().manual_seed(5) for _ in range(2)])
    torch.testing.assert_close(noisy[0][0], again[0][0], rtol=0, atol=0)


def test_corpus_encoder_per_shard_runs_each_row(codec):
    """``per_shard`` runs on every dp row's replica and shard, in row
    order, ungathered: the shards of the int16 wire dequantize exactly."""
    rng = np.random.default_rng(3)
    wire = torch.from_numpy(
        rng.integers(-32768, 32768, size=(4, 8 * N, 1)).astype(np.int16))
    run = _corpus.make_corpus_encoder(
        codec, mesh(2), per_shard=lambda rep, x: rep.encode_quantized(
            dequant_wire(x, torch.float32))[0])
    rows = run(wire)
    assert len(rows) == 2 and [r.shape[0] for r in rows] == [2, 2]
    want = codec.encode_quantized(wire.float() / 32768)[0]
    torch.testing.assert_close(torch.cat(rows), want, rtol=0, atol=0)


def test_loader_yields_all_batches_in_order(corpus):
    paths, clips = corpus
    loader = PrefetchingCorpusLoader(paths, clip_seconds=CLIP,
                                     sample_rate=SR, batch_size=4,
                                     prefetch=2, mesh=mesh())
    assert len(loader) == 3
    seen = 0
    for batch, status in batches(loader):
        assert (status == 0).all()
        for row in range(batch.shape[0]):
            np.testing.assert_allclose(batch[row].numpy(), clips[seen + row],
                                       atol=2.0 / 32768)
        seen += batch.shape[0]
    assert seen == 10


def test_loader_errors_reach_the_consumer(corpus):
    paths, _ = corpus
    loader = PrefetchingCorpusLoader(["/nonexistent/x.wav"] + paths,
                                     clip_seconds=0.01, sample_rate=SR,
                                     batch_size=4, mesh=mesh())
    # a missing file is a status, not an exception
    assert batches(loader)[0][1][0] == -1
    # an exception in the producer is raised where the consumer iterates
    with mock.patch.object(pipeline.native, "load_corpus",
                           side_effect=OSError("disk gone")):
        with pytest.raises(OSError, match="disk gone"):
            list(loader)


def test_loader_reiteration_is_clean(corpus):
    paths, _ = corpus
    loader = PrefetchingCorpusLoader(paths, clip_seconds=CLIP,
                                     sample_rate=SR, batch_size=4,
                                     prefetch=1, mesh=mesh())
    it = iter(loader)
    next(it)  # one batch, then abandon the pass
    it.close()
    counts = [sum(len(s) for _, s in loader) for _ in range(2)]
    assert counts == [10, 10]


def test_int16_wire(corpus):
    paths, _ = corpus
    loader = PrefetchingCorpusLoader(paths, clip_seconds=CLIP,
                                     sample_rate=SR, batch_size=4,
                                     wire_dtype="int16", mesh=mesh())
    shards, status = next(iter(loader))
    assert shards[0].dtype == torch.int16 and (status == 0).all()
    with pytest.raises(ValueError, match="wire_dtype"):
        PrefetchingCorpusLoader(paths, clip_seconds=1.0, sample_rate=SR,
                                wire_dtype="int8", mesh=mesh())


def test_streaming_encode_equals_encode_corpus(codec, corpus):
    """dp=2 over 10 clips in batches of 4: the int16 and float32 wires
    give the same codes (PCM16 sources), equal to ``encode_corpus`` of the
    decoded clips, the padding stripped."""
    paths, _ = corpus
    kw = dict(mesh=mesh(2), clip_seconds=CLIP, sample_rate=SR,
              batch_size=4)
    ref = encode_corpus_streaming(codec, paths, **kw)
    i16 = encode_corpus_streaming(codec, paths, wire_dtype="int16", **kw)
    assert [c.shape for c, _, _ in ref] == [(4, 5, N, 1)] * 2 + [(2, 5, N, 1)]
    clips, _ = native.load_corpus(paths, CLIP, SR)
    want = _corpus.encode_corpus(codec, clips, mesh=mesh(1), batch_size=4)
    for (c0, d0, s0), (c1, d1, _), (c2, d2) in zip(ref, i16, want):
        assert (s0 == 0).all()
        for a, b in ((c0, c1), (d0, d1), (c0, c2), (d0, d2)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cache_round_trip_and_encode(codec, corpus, tmp_path):
    paths, _ = corpus
    cache = str(tmp_path / "corpus_cache.npy")
    status = build_corpus_cache(paths, cache, clip_seconds=CLIP,
                                sample_rate=SR, batch_size=4)
    assert (status == 0).all()
    live = PrefetchingCorpusLoader(paths, clip_seconds=CLIP, sample_rate=SR,
                                   batch_size=4, wire_dtype="int16",
                                   mesh=mesh())
    cached = CachedCorpusLoader(cache, batch_size=4, mesh=mesh())
    assert len(cached) == len(live)
    for (lb, ls), (cb, cs) in zip(batches(live), batches(cached)):
        torch.testing.assert_close(lb, cb, rtol=0, atol=0)
        np.testing.assert_array_equal(ls, cs)
    kw = dict(mesh=mesh(2), batch_size=4, clip_seconds=CLIP, sample_rate=SR)
    ref = encode_corpus_streaming(codec, paths, wire_dtype="int16", **kw)
    got = encode_corpus_streaming(codec, paths, cache_path=cache, **kw)
    for (c0, d0, _), (c1, d1, _) in zip(ref, got):
        torch.testing.assert_close(c0, c1, rtol=0, atol=0)
        torch.testing.assert_close(d0, d1, rtol=0, atol=0)


@pytest.mark.parametrize("cached", [False, True])
def test_loaders_pad_the_final_batch(corpus, tmp_path, cached):
    paths, _ = corpus  # 10 clips in batches of 4: 2 real rows at the end
    if cached:
        cache = str(tmp_path / "pad_cache.npy")
        build_corpus_cache(paths, cache, clip_seconds=CLIP, sample_rate=SR,
                           batch_size=4)
        loader = CachedCorpusLoader(cache, batch_size=4, pad_batches=True,
                                    mesh=mesh())
    else:
        loader = PrefetchingCorpusLoader(
            paths, clip_seconds=CLIP, sample_rate=SR, batch_size=4,
            wire_dtype="int16", pad_batches=True, mesh=mesh())
    out = batches(loader)
    assert all(b.shape[0] == 4 for b, _ in out)
    assert list(out[-1][1]) == [0, 0, PAD_STATUS, PAD_STATUS]
    assert not out[-1][0][2:].any()  # pad rows are zeros


def test_sentinel_survives_a_full_queue():
    """The end-of-stream sentinel waits for room instead of being dropped
    after a fixed timeout (the consumer would then block for ever)."""
    q = queue.Queue(maxsize=1)
    q.put("batch")
    stop = threading.Event()
    t = threading.Thread(target=pipeline._put_sentinel, args=(q, stop))
    t.start()
    time.sleep(0.6)  # longer than the put's timeout slice
    assert q.get() == "batch"
    assert q.get(timeout=5.0) is None
    t.join(timeout=5.0)
    assert not t.is_alive()


def test_sentinel_put_abandons_on_stop():
    q = queue.Queue(maxsize=1)
    q.put("batch")
    stop = threading.Event()
    t = threading.Thread(target=pipeline._put_sentinel, args=(q, stop))
    t.start()
    stop.set()  # the consumer walked away
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert q.get() == "batch" and q.empty()


def test_slow_consumer_still_terminates(corpus):
    paths, _ = corpus
    loader = PrefetchingCorpusLoader(paths, clip_seconds=CLIP,
                                     sample_rate=SR, batch_size=4,
                                     prefetch=1, mesh=mesh())
    seen = 0
    for _ in loader:
        time.sleep(0.4)  # stall with the queue full
        seen += 1
    assert seen == 3


def test_cache_refusals(codec, corpus, tmp_path):
    paths, _ = corpus
    cache = str(tmp_path / "c.npy")
    build_corpus_cache(paths, cache, clip_seconds=CLIP, sample_rate=SR)
    # a stale cache: another file list, another framing
    with pytest.raises(ValueError, match="file list differs"):
        validate_corpus_cache(cache, paths[::-1], clip_seconds=CLIP,
                              sample_rate=SR)
    with pytest.raises(ValueError, match="framing"):
        validate_corpus_cache(cache, paths, clip_seconds=2 * CLIP,
                              sample_rate=SR)
    # without the framing a positional cache cannot be validated
    with pytest.raises(ValueError, match="clip_seconds"):
        encode_corpus_streaming(codec, paths, cache_path=cache,
                                batch_size=4, mesh=mesh())
    # an interrupted build leaves the .npy without its sidecar
    os.unlink(cache + ".meta.npz")
    with pytest.raises(ValueError, match="interrupted"):
        validate_corpus_cache(cache, paths, clip_seconds=CLIP,
                              sample_rate=SR)
    with pytest.raises(ValueError, match="interrupted"):
        CachedCorpusLoader(cache, mesh=mesh())


# -- the command line --------------------------------------------------------


def run(package, argv):
    """One CLI call at float64 (both packages' codec built in float64) ->
    (exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    mod = jcli if package == "jax" else cli
    f64 = jnp.float64 if package == "jax" else torch.float64
    build = mod._build_codec

    def build64(sr, args, compute_dtype=None, bark_precision=None):
        return build(sr, args, compute_dtype or f64, bark_precision)

    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), \
            mock.patch.object(mod, "_build_codec", build64):
        try:
            if package == "jax":
                with mock.patch.object(jcli, "_ensure_compile_cache",
                                       lambda: None):
                    rc = jcli.main(argv)
            else:
                rc = cli.main(argv, device="cpu")
        except SystemExit as e:
            rc = e.code if isinstance(e.code, int) else 1
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """in/: four PCM16 clips of 0.5-0.6 s, in2/: two of them; ll/: two
    24-bit stereo files; the commands already run, by argv (``both``)."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(3)
    (d / "in").mkdir()
    for i in range(4):
        s = SR // 2 + 700 * i
        t = np.arange(s) / SR
        x = (0.3 * np.sin(2 * np.pi * (300 + 150 * i) * t)
             + 0.02 * rng.standard_normal(s)).astype(np.float32)
        wav.write_wav(str(d / "in" / f"c{i}.wav"), x[:, None], SR)
    (d / "in2").mkdir()  # the rate-controlled corpus: its search is long
    for i in range(2):
        shutil.copy(d / "in" / f"c{i}.wav", d / "in2")
    (d / "ll").mkdir()
    for i in range(2):
        x = np.round(rng.uniform(-0.5, 0.5, (SR // 3 + 11 * i, 2))
                     * (1 << 23)).astype(np.int32)
        wav.write_wav_int(str(d / "ll" / f"h{i}.wav"), x, SR, 24)
    return d, {}


def both(work, argv):
    """``argv`` ({d} the work directory, {out} each package's own) through
    both CLIs, once a module: {package: (rc, stdout, stderr)} with the
    package's directory written {out}."""
    d, ran = work
    key = tuple(argv)
    if key not in ran:
        res = {}
        for p in ("jax", "port"):
            out = str(d / p)
            rc, so, se = run(p, [a.format(d=d, out=out) for a in argv])
            res[p] = (rc, so.replace(out, "{out}"), se.replace(out, "{out}"))
        ran[key] = res
    return ran[key]


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


CORPUS = ["corpus", "{d}/in", "{out}/plain", *MODEL, "--sample-rate", "16000",
          "--clip-seconds", "0.6", "--batch", "3"]
CORPORA = {
    "plain": CORPUS,
    "kbps": ["corpus", "{d}/in2", "{out}/kbps", *MODEL, "--sample-rate",
             "16000", "--clip-seconds", "0.3", "--kbps", "48"],
    "tag-music": ["corpus", "{d}/in", "{out}/tag", *MODEL, "--sample-rate",
                  "16000", "--clip-seconds", "0.5", "--tag-loudness",
                  "--preset", "music"],
    "cache": ["corpus", "{d}/in", "{out}/cached", *MODEL, "--sample-rate",
              "16000", "--clip-seconds", "0.6", "--batch", "3", "--cache",
              "{out}/pcm.npy"],
}


@pytest.mark.parametrize("case", sorted(CORPORA))
def test_corpus_equals_jax(work, case):
    d, _ = work
    res = both(work, CORPORA[case])
    assert res["port"][0] == res["jax"][0] == 0, res
    assert res["port"][1] == res["jax"][1]
    name = CORPORA[case][2].split("/")[-1]
    for i in range(2 if case == "kbps" else 4):
        assert_same_members(d / "port" / name / f"c{i}.acz",
                            d / "jax" / name / f"c{i}.acz")
    if case == "cache":
        assert "built PCM cache" in res["port"][1]
        both(work, CORPUS)
        for i in range(4):  # the cached run writes the uncached containers
            a, b = (members(d / "port" / x / f"c{i}.acz")
                    for x in ("cached", "plain"))
            assert all(np.array_equal(a[k], b[k]) for k in a)
        res = both(work, CORPORA[case] + ["--batch", "2"])  # memmap reuse
        assert res["port"][:2] == res["jax"][:2]
        assert "built PCM cache" not in res["port"][1]


def test_corpus_decode_within_one_lsb(work):
    d, _ = work
    both(work, CORPUS)
    res = both(work, ["corpus-decode", "{out}/plain", "{out}/dec"])
    assert res["port"][:2] == res["jax"][:2] and res["port"][0] == 0
    for i in range(4):
        got, rate = pcm16(d / "port" / "dec" / f"c{i}.wav")
        want, _ = pcm16(d / "jax" / "dec" / f"c{i}.wav")
        solo = d / "port" / f"solo{i}.wav"
        assert run("port", ["decode", str(d / "port" / "plain" / f"c{i}.acz"),
                            str(solo)])[0] == 0
        # whole blocks of the 0.6 s framing (no gapless length recorded)
        assert rate == SR and got.shape == (1, int(0.6 * SR) // N * N, 1)
        assert np.abs(got - want).max() <= 1
        assert np.abs(got - pcm16(solo)[0]).max() <= 1


def test_corpus_lossless_and_mixed_decode(work):
    d, _ = work
    res = both(work, ["corpus", "{d}/ll", "{out}/ll", "--lossless"])
    assert res["port"][0] == res["jax"][0] == 0
    assert res["port"][1].split(":")[1].split(",")[0] == (
        res["jax"][1].split(":")[1].split(",")[0])  # the byte counts
    for i in range(2):
        assert_same_members(d / "port" / "ll" / f"h{i}.acz",
                            d / "jax" / "ll" / f"h{i}.acz")
    # a directory mixing lossless and lossy containers
    both(work, CORPUS)
    mixed = d / "port" / "mixed"
    shutil.copytree(d / "port" / "plain", mixed)
    for i in range(2):
        shutil.copy(d / "port" / "ll" / f"h{i}.acz", mixed)
    rc, out, _ = run("port", ["corpus-decode", str(mixed),
                              str(d / "port" / "mixed-dec")])
    assert rc == 0 and out.startswith("2 lossless containers")
    for i in range(2):
        y, rate, bits = wav.read_wav_int(
            str(d / "port" / "mixed-dec" / f"h{i}.wav"))
        src, _, _ = wav.read_wav_int(str(d / "ll" / f"h{i}.wav"))
        assert (rate, bits) == (SR, 24)
        np.testing.assert_array_equal(y, src)
    assert len(list((d / "port" / "mixed-dec").glob("c*.wav"))) == 4


REFUSALS = {
    "chunk-blocks": CORPUS + ["--chunk-blocks", "8"],
    "resample-to": CORPUS + ["--resample-to", "8000"],
    "no-sample-rate": ["corpus", "{d}/in", "{out}/r", *MODEL],
    "rate-with-lossless": ["corpus", "{d}/ll", "{out}/r", "--lossless",
                           "--sample-rate", "16000"],
    "lossless-with-cache": ["corpus", "{d}/ll", "{out}/r", "--lossless",
                            "--cache", "{out}/x.npy"],
    "mixed-configs": ["corpus-decode", "{d}/mixcfg", "{out}/r"],
    "empty-dir": ["corpus-decode", "{d}/ll", "{out}/r"],
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_print_jax_messages(work, case):
    d, _ = work
    if case == "mixed-configs" and not (d / "mixcfg").exists():
        (d / "mixcfg").mkdir()
        for n in ("256", "128"):
            assert run("port", ["encode", str(d / "in" / "c0.wav"),
                                str(d / "mixcfg" / f"n{n}.acz"),
                                "--filters-n", n])[0] == 0
    res = both(work, REFUSALS[case])
    assert res["port"][0] == res["jax"][0] == 1
    assert res["port"][2] == res["jax"][2] != ""


def test_serve_command_answers_in_a_thread(work):
    d, _ = work
    started = []

    class Recording(serve.CodecServer):
        def start(self):
            started.append(self)
            return super().start()

    out = io.StringIO()
    result = []

    def main():
        with contextlib.redirect_stdout(out):
            result.append(cli.main(["serve", "--sample-rate", str(SR),
                                    "--port", "0", *MODEL], device="cpu"))

    with mock.patch.object(serve, "CodecServer", Recording):
        t = threading.Thread(target=main)
        t.start()
        deadline = time.monotonic() + 60
        while not (started and started[0].port) and time.monotonic() < deadline:
            time.sleep(0.05)
        server = started[0]
        blob = (d / "in" / "c1.wav").read_bytes()
        codes, _, meta = serve.bitstream.unpack(
            serve.request("E", blob, port=server.port))
        server.stop()
        t.join(timeout=30)
    assert not t.is_alive() and result == [0]
    assert meta["orig_samples"] == SR // 2 + 700
    assert f"127.0.0.1:{server.port}" in out.getvalue()


def test_chip_smoke_builders(tmp_path):
    """chip_smoke.py's inputs of phases 20-21 at tiny sizes: the serve
    command's port from its first line, the PCM16 request blobs, the
    corpus files."""
    import chip_smoke

    line = ("serving 44100 Hz / N=1024 codec on 127.0.0.1:40123 (max batch "
            "8, wait 5.0 ms); Ctrl-C to stop")
    assert chip_smoke.serve_port(line) == 40123
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke.serve_port("serving on a Unix socket")
    blobs = chip_smoke.serve_clips(3, seconds=0.1, rate=SR)
    assert len(set(blobs)) == 3
    x, rate = wav.read_wav_bytes(blobs[0])
    assert rate == SR and x.shape == (1, SR // 10, 1)
    paths = chip_smoke.write_corpus(tmp_path / "c", 3, seconds=0.1, rate=SR)
    wire, status = native.load_corpus([str(p) for p in paths], 0.1, SR,
                                      dtype="int16")
    assert (status == 0).all() and wire.shape == (3, SR // 10, 1)
    assert len({w.tobytes() for w in wire}) == 3


def test_chip_smoke_plain_hold():
    """chip_smoke.py's hold of served and corpus codes against the
    all-plain encode: equal payloads pass; a level two grid steps apart, or
    a code two steps apart where the levels are equal, fails; a code two
    steps apart on a frame whose levels differ by one passes."""
    import chip_smoke

    rng = np.random.default_rng(4)
    codes = rng.integers(-50, 50, size=(1, 6, 8, 1)).astype(np.int32)
    lv = rng.integers(0, 40, size=(1, 6, 3, 1)).astype(np.int32)
    assert chip_smoke.hold_plain_codes("t", [((codes, lv), (codes, lv))]) \
        == (1.0, 1.0, 0)
    far = codes.copy()
    far[0, 2, 5, 0] += 2
    with pytest.raises(chip_smoke.PhaseError, match="2 steps apart"):
        chip_smoke.hold_plain_codes("t", [((codes, lv), (far, lv))])
    moved = lv.copy()
    moved[0, 2, 1, 0] += 1
    share, lv_share, step = chip_smoke.hold_plain_codes(
        "t", [((codes, lv), (far, moved))] + [((codes, lv), (codes, lv))] * 99)
    assert step == 0 and share == 1 - 1 / (100 * codes.size)
    assert lv_share == 1 - 1 / (100 * lv.size)
    moved[0, 2, 1, 0] += 1
    with pytest.raises(chip_smoke.PhaseError, match="2 grid steps"):
        chip_smoke.hold_plain_codes("t", [((codes, lv), (codes, moved))])
    wave = rng.uniform(-0.9, 0.9, size=(50, 2))
    # the writer stores round(x * 32767); the reader scales by 1/32768
    assert np.array_equal(chip_smoke.pcm16_of(wave, SR)[0],
                          np.round(wave * 32767))


def test_corpus_decode_pads_to_the_longest_clip(work):
    """Containers of four lengths, two rate-controlled (their own threshold
    scales) and one noise-filled, decode in one corpus-decode run as a
    solo ``decode`` of each does, and as the JAX CLI's corpus-decode."""
    d, _ = work
    mixed = d / "lengths"
    if not mixed.exists():
        mixed.mkdir()
        # one dead zone, so c0-c2 share a group: a batch of three lengths
        # and three threshold scales
        extra = {0: [], 1: ["--kbps", "96", "--deadzone", "0.5"],
                 2: ["--kbps", "72", "--deadzone", "0.5"], 3: ["--nf"]}
        for i, flags in extra.items():
            assert run("port", ["encode", str(d / "in" / f"c{i}.wav"),
                                str(mixed / f"c{i}.acz"), *MODEL,
                                *flags])[0] == 0
    res = both(work, ["corpus-decode", "{d}/lengths", "{out}/ldec",
                      "--batch", "3"])
    assert res["port"][0] == res["jax"][0] == 0
    assert "(2 program groups)" in res["port"][1]
    scales = {bitstream.load(str(mixed / f"c{i}.acz"))[2]["threshold_scale"]
              for i in range(3)}
    assert len(scales) == 3
    for i in range(4):
        got, _ = pcm16(d / "port" / "ldec" / f"c{i}.wav")
        solo = d / "port" / f"lsolo{i}.wav"
        assert run("port", ["decode", str(mixed / f"c{i}.acz"),
                            str(solo)])[0] == 0
        want, _ = pcm16(solo)
        assert got.shape == want.shape == (1, SR // 2 + 700 * i, 1)
        assert np.abs(got - want).max() <= 1
        jgot, _ = pcm16(d / "jax" / "ldec" / f"c{i}.wav")
        assert np.abs(got - jgot).max() <= 1


def test_corpus_over_two_devices_equals_one(work):
    """The corpus command over a mesh of two (CPU) devices: the batch split
    over the dp rows, one codec replica each, the same containers."""
    d, _ = work
    both(work, CORPUS)
    argv = [a.format(d=d, out=str(d / "port")) for a in CORPUS]
    argv[2] = str(d / "port" / "dp2")
    with mock.patch.object(cli, "_corpus_mesh", lambda device: mesh(2)):
        rc, out, _ = run("port", argv)
    assert rc == 0 and out.startswith("encoded 4/4 clips")
    for i in range(4):
        a, b = (members(d / "port" / x / f"c{i}.acz")
                for x in ("dp2", "plain"))
        assert sorted(a) == sorted(b)
        assert all(np.array_equal(a[k], b[k]) for k in a)
