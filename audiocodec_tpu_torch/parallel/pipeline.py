"""Prefetching ingest pipeline: host I/O and the copies to the devices
overlap the encode (counterpart of ``audiocodec_tpu/parallel/pipeline.py``).

A corpus encode is ingest-bound when decode -> copy -> encode run one after
another. The loaders decode WAVs (the native thread-pool loader) or read a
PCM cache in a background thread, copy each batch into pinned host memory
and start its shards' copies to their devices on a stream of their own, so
the copy of batch k+1 runs while the card encodes batch k; a bounded queue
keeps ``prefetch`` batches ahead of the consumer.

    loader = PrefetchingCorpusLoader(paths, clip_seconds=10.0,
                                     sample_rate=44100, batch_size=64,
                                     wire_dtype="int16")
    for shards, status in loader:       # one tensor a dp row, on its device
        codes, delta = encoder(shards)
"""

from __future__ import annotations

import hashlib
import queue
import threading

import numpy as np
import torch

from audiocodec_tpu_torch import native
from audiocodec_tpu_torch.parallel import mesh as _mesh
from audiocodec_tpu_torch.utils.device import dequant_wire

#: status value marking synthetic zero rows added by ``pad_batches``
PAD_STATUS = -2


def _pad_batch_host(host, status, batch_size):
    """Zero-pad a short batch to ``batch_size`` rows on the host and mark
    the pad rows' status."""
    real = host.shape[0]
    if real >= batch_size:
        return host, status
    host = np.concatenate(
        [host, np.zeros((batch_size - real,) + host.shape[1:], host.dtype)]
    )
    status = np.concatenate(
        [status, np.full(batch_size - real, PAD_STATUS, dtype=np.int32)]
    )
    return host, status


def _put_sentinel(q, stop):
    """Deliver the end-of-stream sentinel with the same bounded-put loop as
    the batches: a put with a fixed timeout could meet a full queue while
    the consumer is busy and drop the sentinel, leaving the consumer
    blocked in ``q.get()`` for ever."""
    while not stop.is_set():
        try:
            q.put(None, timeout=0.25)
            return
        except queue.Full:
            continue


class _Loader:
    """The producer thread, queue and placement shared by the loaders:
    subclasses give ``_host_batches()``, (host array, status) pairs."""

    def __init__(self, batch_size, prefetch, mesh, pad_batches):
        self._batch_size = batch_size
        self._prefetch = max(1, prefetch)
        self._mesh = _mesh.make_mesh() if mesh is None else mesh
        self._pad_batches = pad_batches

    def _place(self, host, streams):
        """A host batch -> its dp shards on their devices, each with the
        event that marks its copy done (None off the card). Rows pad to a
        multiple of dp (zeros), as a split needs. On the card the batch
        goes through pinned memory and each shard's copy runs on its
        device's side stream of ``streams``, beside the consumer's work."""
        dp = self._mesh.shape["dp"]
        if host.shape[0] % dp:
            host, _ = _pad_batch_host(host, np.zeros(0, np.int32),
                                      _mesh.pad_batch_to(host.shape[0], dp))
        t = torch.from_numpy(np.ascontiguousarray(host))
        if not streams:
            return [(s, None) for s in self._mesh.split(t)]
        t = t.pin_memory()
        rows = t.shape[0] // dp
        out = []
        for i, dev in enumerate(self._mesh.dp_devices):
            with torch.cuda.stream(streams[i]):
                shard = t[i * rows:(i + 1) * rows].to(dev, non_blocking=True)
                event = torch.cuda.Event()
                event.record(streams[i])
            out.append((shard, event))
        return out

    def _producer(self, q, stop, errbox):
        try:
            devices = self._mesh.dp_devices
            streams = ([torch.cuda.Stream(d) for d in devices]
                       if any(d.type == "cuda" for d in devices) else None)
            for host, status in self._host_batches():
                if self._pad_batches:
                    host, status = _pad_batch_host(host, status,
                                                   self._batch_size)
                item = (self._place(host, streams), status)
                # a bounded put that notices an abandoned consumer instead
                # of blocking for ever holding device memory
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.25)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except Exception as e:  # surfaces on the consumer's side
            errbox.append(e)
        finally:
            _put_sentinel(q, stop)

    def __iter__(self):
        # each iteration gets its own queue and thread, so re-iteration or
        # an early break never interleaves stale batches
        q: queue.Queue = queue.Queue(maxsize=self._prefetch)
        stop = threading.Event()
        errbox: list = []
        thread = threading.Thread(target=self._producer,
                                  args=(q, stop, errbox), daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    if errbox:
                        raise errbox[0]
                    return
                placed, status = item
                shards = []
                for shard, event in placed:
                    if event is not None:
                        # the consumer's stream waits for the copy, and the
                        # allocator keeps the shard until that stream is
                        # done with it
                        cur = torch.cuda.current_stream(shard.device)
                        cur.wait_event(event)
                        shard.record_stream(cur)
                    shards.append(shard)
                yield shards, status
        finally:
            stop.set()


class PrefetchingCorpusLoader(_Loader):
    """Iterate device-resident batches of WAV clips decoded ahead of time.

    :param paths: WAV paths of one nominal length (each clip truncated or
        zero-padded to clip_seconds).
    :param batch_size: clips a batch (the last may be short).
    :param prefetch: batches decoded and copied ahead (>= 1).
    :param mesh: the dp rows the batches split over (``parallel.mesh``;
        default every visible CUDA device).
    :param wire_dtype: "float32" (default) or "int16": int16 halves the
        bytes copied to the device, and the consumer dequantizes there
        (``dequant_wire``), bit-exact for PCM16 sources. Float-sourced WAVs
        lose sub-16-bit detail on it: keep float32 there.
    :param pad_batches: zero-pad a short final batch to ``batch_size`` rows
        on the host (one batch shape); pad rows carry status ``PAD_STATUS``.
    :yields: (shards, status): one tensor [rows, frames, channels] a dp
        row, on its device, and int32 status [b] (0 = ok) of the batch's b
        rows. A batch whose b does not divide by dp is padded with zero rows
        beyond b.
    """

    def __init__(self, paths, clip_seconds: float, sample_rate: int,
                 channels: int = 1, batch_size: int = 64, prefetch: int = 2,
                 mesh=None, decode_threads: int = 0,
                 wire_dtype: str = "float32", pad_batches: bool = False):
        if wire_dtype not in ("float32", "int16"):
            raise ValueError(
                f"wire_dtype must be 'float32' or 'int16', got {wire_dtype!r}"
            )
        super().__init__(batch_size, prefetch, mesh, pad_batches)
        self._paths = list(paths)
        self._clip_seconds = clip_seconds
        self._sample_rate = sample_rate
        self._channels = channels
        self._decode_threads = decode_threads
        self._wire_dtype = wire_dtype

    def _host_batches(self):
        for start in range(0, len(self._paths), self._batch_size):
            # the int16 wire decodes straight to PCM16 integers in C++
            yield native.load_corpus(
                self._paths[start:start + self._batch_size],
                clip_seconds=self._clip_seconds,
                sample_rate=self._sample_rate, channels=self._channels,
                n_threads=self._decode_threads, dtype=self._wire_dtype,
            )

    def __len__(self):
        return -(-len(self._paths) // self._batch_size)


def build_corpus_cache(paths, cache_path: str, *, clip_seconds: float,
                       sample_rate: int, channels: int = 1,
                       batch_size: int = 64, decode_threads: int = 0):
    """Decode a WAV corpus once into a raw int16 PCM cache for repeat
    epochs, which then read page-cached PCM: no WAV parsing, no conversion,
    only the copy to the device.

    Writes ``cache_path`` (.npy, [clips, frames, channels] int16) and a
    ``<cache_path>.meta.npz`` sidecar (per-clip status, the framing and a
    digest of the paths), the sidecar last.

    :return: status int32 [n] (0 = ok per clip).
    """
    frames = int(clip_seconds * sample_rate)
    n = len(paths)
    arr = np.lib.format.open_memmap(
        cache_path, mode="w+", dtype=np.int16, shape=(n, frames, channels)
    )
    status_all = np.empty(n, dtype=np.int32)
    for start in range(0, n, batch_size):
        chunk = list(paths[start:start + batch_size])
        host, status = native.load_corpus(
            chunk, clip_seconds=clip_seconds, sample_rate=sample_rate,
            channels=channels, n_threads=decode_threads, dtype="int16",
        )
        arr[start:start + len(chunk)] = host
        status_all[start:start + len(chunk)] = status
    arr.flush()
    del arr
    np.savez(
        cache_path + ".meta.npz",
        status=status_all,
        sample_rate=np.asarray([sample_rate], dtype=np.int64),
        clip_seconds=np.asarray([clip_seconds], dtype=np.float64),
        channels=np.asarray([channels], dtype=np.int64),
        # the identity of the corpus the cache was built from: a stale
        # cache must never pair the wrong audio with a clip
        paths_hash=np.asarray([_paths_digest(paths)]),
    )
    return status_all


def _paths_digest(paths) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(str(p).encode())
        h.update(b"\0")
    return h.hexdigest()


def _load_cache_meta(cache_path: str):
    """The .meta.npz sidecar, or a ValueError: a missing sidecar marks an
    interrupted build (the .npy is created first, the sidecar last)."""
    try:
        return np.load(cache_path + ".meta.npz")
    except FileNotFoundError:
        raise ValueError(
            f"PCM cache {cache_path} has no .meta.npz sidecar — the "
            "cache build was interrupted before completion; delete "
            f"{cache_path} and rebuild"
        ) from None


def validate_corpus_cache(cache_path: str, paths, *, clip_seconds: float,
                          sample_rate: int, channels: int = 1) -> None:
    """Raise ValueError unless the cache at ``cache_path`` was built from
    exactly this corpus and framing: the cache is positional, and a stale
    one would pack one clip's audio under another clip's name."""
    arr = np.load(cache_path, mmap_mode="r")
    meta = _load_cache_meta(cache_path)
    frames = int(clip_seconds * sample_rate)
    problems = []
    if "paths_hash" not in meta.files:
        problems.append("cache predates corpus-identity validation")
    elif str(meta["paths_hash"][0]) != _paths_digest(paths):
        problems.append("file list differs from the one the cache holds")
    if arr.shape[0] != len(paths):
        problems.append(
            f"cache holds {arr.shape[0]} clips, invocation has {len(paths)}"
        )
    if arr.shape[1] != frames:
        problems.append(
            f"cache framing {arr.shape[1]} frames != requested {frames}"
        )
    if arr.shape[2] != channels:
        problems.append(
            f"cache channels {arr.shape[2]} != requested {channels}"
        )
    if "sample_rate" in meta.files and int(meta["sample_rate"][0]) != int(
        sample_rate
    ):
        problems.append(
            f"cache sample_rate {int(meta['sample_rate'][0])} != "
            f"requested {sample_rate}"
        )
    if problems:
        raise ValueError(
            f"PCM cache {cache_path} does not match this corpus/invocation "
            f"({'; '.join(problems)}); delete it (and its .meta.npz) to "
            "rebuild"
        )


class CachedCorpusLoader(_Loader):
    """Iterate device-resident batches from a PCM cache
    (:func:`build_corpus_cache`), the repeat-epoch path: the iterator of
    :class:`PrefetchingCorpusLoader` over the memmapped int16 wire."""

    def __init__(self, cache_path: str, batch_size: int = 64,
                 prefetch: int = 2, mesh=None, pad_batches: bool = False):
        self._status = _load_cache_meta(cache_path)["status"]
        self._arr = np.load(cache_path, mmap_mode="r")
        super().__init__(batch_size, prefetch, mesh, pad_batches)

    def _host_batches(self):
        for start in range(0, self._arr.shape[0], self._batch_size):
            stop = start + self._batch_size
            # a copy out of the read-only memmap (page-cache reads here,
            # on the producer's thread)
            yield (np.array(self._arr[start:stop]),
                   self._status[start:stop])

    def __len__(self):
        return -(-self._arr.shape[0] // self._batch_size)


def encode_corpus_streaming(codec, paths, mesh=None, cache_path=None,
                            **loader_kwargs):
    """Prefetched corpus encode: paths -> per-batch codes.

    The background loader places each dp shard on its row's first device
    and feeds the encoder (``corpus.make_corpus_encoder``), which splits it
    over the row's sp devices; the decode and copy of batch k+1
    overlap the encode of batch k. With ``cache_path`` (a
    :func:`build_corpus_cache` artifact) batches come from the PCM memmap.

    :return: list of (codes, step sizes, status) a batch, on the mesh's
        first device, with the rows of the batch's status.
    """
    from audiocodec_tpu_torch.parallel import corpus as _corpus

    if mesh is None:
        mesh = _mesh.make_mesh()
    loader_kwargs["mesh"] = mesh
    encoder = _corpus.make_corpus_encoder(codec, mesh, quantized=True)

    if cache_path is not None:
        framing = {
            k: loader_kwargs.pop(k)
            for k in ("clip_seconds", "sample_rate", "channels")
            if k in loader_kwargs
        }
        loader_kwargs.pop("wire_dtype", None)
        loader_kwargs.pop("decode_threads", None)
        if not ({"clip_seconds", "sample_rate"} <= framing.keys()):
            # without the framing there is nothing to validate the cache
            # against, and an unvalidated positional cache can pair the
            # wrong audio with a clip: refuse
            raise ValueError(
                "cache_path requires clip_seconds= and sample_rate= so "
                "the cache can be validated against this corpus"
            )
        validate_corpus_cache(
            cache_path, paths,
            clip_seconds=framing["clip_seconds"],
            sample_rate=framing["sample_rate"],
            channels=framing.get("channels", 1),
        )
        loader = CachedCorpusLoader(cache_path, **loader_kwargs)
    else:
        loader = PrefetchingCorpusLoader(paths, **loader_kwargs)

    results = []
    n = codec.mdct.filters_n
    dtype = codec.mdct.compute_dtype
    for shards, status in loader:
        # clip_seconds need not be block-aligned: whole MDCT blocks only
        frames = shards[0].shape[1]
        usable = frames - frames % n
        if usable == 0:
            raise ValueError(
                f"clip_seconds yields {frames} frames — shorter "
                f"than one MDCT block (filters_n={n})"
            )
        shards = [(s.to(dtype) if s.is_floating_point()
                   else dequant_wire(s, dtype))[:, :usable] for s in shards]
        codes, delta = encoder(shards)
        results.append((codes[:len(status)], delta[:len(status)], status))
    return results
