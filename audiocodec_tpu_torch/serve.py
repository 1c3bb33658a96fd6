"""Codec serving with dynamic batching, on the card (counterpart of
``audiocodec_tpu/serve.py``, with its wire protocol, opcodes, errors and
stats).

One process owns the card and many clients feed it; a single clip's encode
uses a sliver of the card, so concurrent requests are batched:

* **Dynamic batching**: encode requests are grouped (up to ``max_batch``,
  waiting at most ``max_wait_ms`` for stragglers). A batch's items are
  grouped by (channels, wire dtype), and each group is one padded batch
  through ``mdct.transform`` (the ``fold_matmul`` kernel) and
  ``Codec.quantize_frames``, padded with zeros to its longest clip.
* **Exact results despite padding**: an MDCT frame i depends only on
  blocks i-1 and i, and the pad blocks are zeros, so a clip's codes trimmed
  to its ``blocks+1`` frames are those of the clip encoded alone.
* **PCM16 wire**: a 16-bit WAV goes to the card as int16 [g, samples, ch]
  (half the bytes) and is dequantized there, exactly (int16/32768 is exact
  in float32).
* **Host/device overlap**: the batch loop dispatches a group's device work
  and queues the copy of its codes and sidecar into pinned memory behind
  an event; a pool thread waits on that event and Rice-packs the
  containers while the loop coalesces the next batch. ``inflight_depth``
  bounds the groups dispatched and not yet packed.

Threads run at once: the batch loop, the pool's packers and one thread a
connection (decodes and sessions). Every tensor is made on the codec's
device, and device work runs under that device made current.

Protocol (length-prefixed binary over TCP or a Unix socket):

  request:  1-byte opcode | u32 big-endian length | payload
  response: 1-byte status (0=ok, 1=error) | u32 length | payload

  opcode 'E': payload = WAV bytes       -> .acz container bytes
  opcode 'D': payload = .acz bytes      -> WAV (16-bit PCM) bytes
  opcode 'Q': payload ignored           -> JSON stats line

Streaming sessions (one of each kind a connection; they bypass the batch
queue):

  opcode 'B': payload = JSON config {channels, chunk_blocks,
              threshold_scale, ms, deadzone, tns, nf, nf_seed, tmask, bs,
              bwe, intensity, cbr, dtx}  -> the .acs header bytes
  opcode 'C': payload = one chunk of float32-LE interleaved PCM
              (chunk_blocks * N * channels samples) -> that chunk's bytes
  opcode 'A': payload = f64-LE scale | one chunk of PCM (cbr sessions)
  opcode 'F': payload ignored           -> flush chunk + index/trailer

The 'B'/'C'/'F' responses concatenated are the bytes offline
``io.stream_container.encode_stream`` writes for the same PCM: the session
runs its chunk encoder (``_ChunkEncoder``).

  opcode 'J': payload = .acs header bytes -> JSON stream meta
  opcode 'K': payload = one chunk's bytes -> float32-LE PCM
  opcode 'L': payload ignored             -> the final overlap-add tail

'K' parses each chunk as a one-chunk stream with the same
``StreamReader`` (CRC checks included) and decodes it as offline
``decode_stream`` does: the same PCM.

Clients: :func:`request` (one-shot) or :class:`Client` (a persistent
connection; begin_stream/feed/finish_stream and the decode mirror).
"""

from __future__ import annotations

import io as _io
import json
import queue
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from audiocodec_tpu_torch import native
from audiocodec_tpu_torch import streaming as _streaming
from audiocodec_tpu_torch.io import bitstream
from audiocodec_tpu_torch.io import stream_container as _sc
from audiocodec_tpu_torch.io import wav as _wav
from audiocodec_tpu_torch.ops import cuda_mdct
from audiocodec_tpu_torch.utils.device import dequant_wire, on_device

_HDR = struct.Struct(">BI")
_MAX_PAYLOAD = 1 << 30


def _read_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def _read_frame(sock):
    op, length = _HDR.unpack(_read_exact(sock, _HDR.size))
    if length > _MAX_PAYLOAD:
        raise ValueError(f"frame of {length} bytes exceeds the 1 GiB cap")
    return op, _read_exact(sock, length)


def _write_frame(sock, op: int, payload: bytes) -> None:
    sock.sendall(_HDR.pack(op, len(payload)) + payload)


def _f32_bytes(samples: torch.Tensor) -> bytes:
    """[1, samples, C] on any device -> interleaved float32-LE bytes."""
    return np.ascontiguousarray(
        samples[0].to(torch.float32).cpu().numpy(), dtype="<f4").tobytes()


class _Request:
    __slots__ = ("payload", "event", "status", "response")

    def __init__(self, payload):
        self.payload = payload
        self.event = threading.Event()
        self.status = 1
        self.response = b"server shutdown"

    def finish(self, status: int, response: bytes):
        self.status = status
        self.response = response
        self.event.set()


class CodecServer:
    """Serve one codec configuration over a socket with dynamic batching.

    :param codec: the :class:`~audiocodec_tpu_torch.codec.Codec` to serve,
        on its device (the card).
    :param sample_rate: the rate encode requests must arrive at (the
        codec's); others get an error frame: resampling belongs to the
        client (the ``resample`` command).
    :param host, port: TCP endpoint; port 0 picks a free port (``.port``
        after :meth:`start`). ``unix_path`` serves a Unix socket instead.
    :param max_batch: dynamic batch cap.
    :param max_wait_ms: how long the batcher waits for stragglers after a
        batch's first request.
    :param entropy: container coder of the responses: "rrice" by default
        (when the native library is present; else "zlib"). "auto" costs
        both coders after deflate for every response: double the host time
        a response for ~1% of size where they differ.
    :param inflight_depth: groups dispatched to the card and not yet
        packed, at most.
    """

    def __init__(self, codec, sample_rate: int, host: str = "127.0.0.1",
                 port: int = 0, unix_path: str = "", max_batch: int = 8,
                 max_wait_ms: float = 5.0, entropy: str | None = None,
                 inflight_depth: int = 2):
        self._codec = codec
        self._device = codec.mdct.wa_r.device
        self._rate = sample_rate
        self._host, self._port0, self._unix = host, port, unix_path
        self._max_batch = max(1, max_batch)
        self._max_wait = max_wait_ms / 1000.0
        self._encode_q: queue.Queue = queue.Queue()
        self._inflight = threading.Semaphore(max(1, int(inflight_depth)))
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._sock = None
        self.port = None
        self._lock = threading.Lock()
        self.stats = {
            "encode_requests": 0, "encode_batches": 0,
            "decode_requests": 0, "errors": 0,
            "stream_sessions": 0, "stream_chunks": 0,
        }
        # EMA latencies (ms) a family of ops, alpha 1/16: a regressing path
        # shows on the 'Q' stats line without a profiler
        self._lat = {}
        if entropy is None:
            entropy = "rrice" if native.available() else "zlib"
        self._meta = dict(
            entropy=entropy,
            sample_rate=sample_rate,
            filters_n=codec.mdct.filters_n,
            bark_bands_n=codec.psycho.bark_bands_n,
            alpha=codec.psycho.alpha,
            window_type=codec.mdct.window_type,
            compute_dtype=bitstream.dtype_name(codec.mdct.compute_dtype),
            ms=False,
            bark_precision=codec.psycho.bark_precision,
            sidecar_grid=codec.sidecar_grid,
        )

    # -- lifecycle ---------------------------------------------------

    def _check_container_config(self, meta) -> None:
        """Refuse containers and streams whose quantization-affecting
        config differs from the served codec's: dtype and Bark precision
        set the step sizes and the window the synthesis, so a mismatched
        decode would not fail, it would be wrong."""
        my = self._meta
        mine = (self._rate, my["filters_n"], my["bark_bands_n"],
                my["compute_dtype"], my["bark_precision"], my["window_type"])
        theirs = (meta["sample_rate"], meta["filters_n"],
                  meta["bark_bands_n"], meta["compute_dtype"],
                  meta["bark_precision"], meta["window_type"])
        if mine != theirs:
            raise ValueError(
                "container was encoded with a different codec config "
                f"(rate/N/bark/dtype/prec/window {theirs}) than this "
                f"server serves ({mine})"
            )

    def _note_latency(self, kind: str, seconds: float) -> None:
        with self._lock:
            prev = self._lat.get(kind)
            ms = seconds * 1e3
            self._lat[kind] = ms if prev is None else prev + (ms - prev) / 16
            self.stats[f"{kind}_ema_ms"] = round(self._lat[kind], 2)

    def _note_stage(self, kind: str, seconds: float) -> None:
        """Cumulative wall seconds of a stage of the batch cycle (parse,
        acquire wait, dispatch, readback, pack)."""
        with self._lock:
            key = f"t_{kind}_s"
            self.stats[key] = round(self.stats.get(key, 0.0) + seconds, 4)

    def _count(self, key: str) -> None:
        with self._lock:
            self.stats[key] += 1

    def start(self):
        if self._unix:
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.bind(self._unix)
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((self._host, self._port0))
            self.port = self._sock.getsockname()[1]
        self._sock.listen(64)
        self._sock.settimeout(0.25)
        for fn in (self._accept_loop, self._batch_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def wait(self, timeout: float | None = None) -> bool:
        """Block until :meth:`stop` (True) or the timeout (False)."""
        return self._stop.wait(timeout)

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        if self._sock is not None:
            self._sock.close()
        # fail any request still parked in the queue
        while True:
            try:
                self._encode_q.get_nowait().finish(1, b"server shutdown")
            except queue.Empty:
                break

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- connection handling ------------------------------------------

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _session_op(self, conn, fn, latency=None, chunk=False):
        """Answer one session op: ``fn()``'s bytes, or its error as an
        error frame (the connection lives on). Returns whether it
        succeeded."""
        try:
            t0 = time.monotonic()
            out = fn()
            if latency:
                self._note_latency(latency, time.monotonic() - t0)
            if chunk:
                self._count("stream_chunks")
            _write_frame(conn, 0, out)
            return True
        except Exception as e:  # a bad request -> an error frame
            _write_frame(conn, 1, str(e).encode())
            return False

    def _serve_conn(self, conn):
        session = None
        dsession = None
        try:
            conn.settimeout(None)
            while not self._stop.is_set():
                try:
                    op, payload = _read_frame(conn)
                except (ConnectionError, OSError):
                    return
                if op == ord("E"):
                    req = _Request(payload)
                    self._count("encode_requests")
                    t0 = time.monotonic()
                    self._encode_q.put(req)
                    req.event.wait()
                    self._note_latency("encode", time.monotonic() - t0)
                    _write_frame(conn, req.status, req.response)
                elif op == ord("D"):
                    t0 = time.monotonic()
                    status, resp = self._decode_one(payload)
                    self._note_latency("decode", time.monotonic() - t0)
                    _write_frame(conn, status, resp)
                elif op == ord("B"):
                    if session is not None:
                        _write_frame(conn, 1,
                                     b"a stream session is already active")
                        continue
                    try:
                        session = _StreamSession(self, payload)
                        self._count("stream_sessions")
                        _write_frame(conn, 0, session.take_bytes())
                    except Exception as e:  # bad config -> error frame
                        session = None
                        _write_frame(conn, 1, str(e).encode())
                elif op in (ord("C"), ord("A")):
                    if session is None:
                        _write_frame(conn, 1, b"no active stream session")
                        continue
                    s = session
                    if op == ord("A"):
                        self._session_op(
                            conn, lambda: s.feed_adaptive(payload),
                            "stream_chunk", chunk=True)
                    else:
                        self._session_op(conn, lambda: s.feed(payload),
                                         "stream_chunk", chunk=True)
                elif op == ord("F"):
                    if session is None:
                        _write_frame(conn, 1, b"no active stream session")
                        continue
                    s, session = session, None
                    self._session_op(conn, s.finish)
                elif op == ord("J"):
                    if dsession is not None:
                        _write_frame(conn, 1,
                                     b"a decode session is already active")
                        continue
                    try:
                        dsession = _DecodeSession(self, payload)
                        self._count("stream_sessions")
                        _write_frame(conn, 0,
                                     json.dumps(dsession.meta).encode())
                    except Exception as e:
                        dsession = None
                        _write_frame(conn, 1, str(e).encode())
                elif op == ord("K"):
                    if dsession is None:
                        _write_frame(conn, 1, b"no active decode session")
                        continue
                    d = dsession
                    self._session_op(conn, lambda: d.feed(payload),
                                     "stream_chunk", chunk=True)
                elif op == ord("L"):
                    if dsession is None:
                        _write_frame(conn, 1, b"no active decode session")
                        continue
                    d, dsession = dsession, None
                    self._session_op(conn, d.finish)
                elif op == ord("Q"):
                    with self._lock:
                        stats = dict(self.stats)
                    # the MDCT kernels' launches in this process
                    stats["kernel_launches"] = cuda_mdct.launch_counts()
                    _write_frame(conn, 0, json.dumps(stats).encode())
                else:
                    _write_frame(conn, 1, f"unknown opcode {op}".encode())
        finally:
            conn.close()

    # -- decode path (one request at a time: containers vary) ----------

    def _decode_one(self, payload):
        try:
            codes, bark, meta = bitstream.unpack(payload)
            self._check_container_config(meta)
            n = self._codec.mdct.filters_n
            frames = codes.shape[1]
            with on_device(self._device), torch.no_grad():
                wave = bitstream.decode_container(self._codec, codes, bark,
                                                  meta)
                wave = wave[:, n:n + (frames - 1) * n].to(torch.float32)
                wave = wave.cpu().numpy()
            nsamp = meta.get("orig_samples", 0)
            if nsamp:  # gapless: trim the encoder's tail padding
                wave = wave[:, :nsamp]
            self._count("decode_requests")
            return 0, _wav.write_wav_bytes(wave[0], self._rate)
        except Exception as e:  # error -> error frame, connection lives
            self._count("errors")
            return 1, str(e).encode()

    # -- batched encode path -------------------------------------------

    def _batch_loop(self):
        with ThreadPoolExecutor(max_workers=8) as pool:
            while not self._stop.is_set():
                try:
                    first = self._encode_q.get(timeout=0.25)
                except queue.Empty:
                    continue
                batch = [first]
                deadline = time.monotonic() + self._max_wait
                while len(batch) < self._max_batch:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    try:
                        batch.append(self._encode_q.get(timeout=left))
                    except queue.Empty:
                        break
                self._run_batch(batch, pool)

    def _fail(self, items, e) -> None:
        self._count("errors")
        for req, *_ in items:
            req.finish(1, str(e).encode())

    def _run_batch(self, batch, pool):
        n = self._codec.mdct.filters_n
        t_parse0 = time.monotonic()
        parsed = []  # (req, wave [s, C] int16 or float32, blocks, samples)
        for req in batch:
            try:
                # PCM16 goes to the card as int16, dequantized there
                i16 = _wav.read_wav_i16_bytes(req.payload)
                if i16 is not None:
                    wave, rate = i16
                else:
                    wave_f, rate = _wav.read_wav_bytes(req.payload)
                    wave = wave_f[0]
                if rate != self._rate:
                    raise ValueError(
                        f"server encodes at {self._rate} Hz, request is "
                        f"{rate} Hz; resample client-side"
                    )
                samples = wave.shape[0]
                if samples < n:
                    raise ValueError(
                        f"need at least one MDCT block ({n} samples)"
                    )
                # gapless: ceil to blocks (zero padding) and record the
                # exact length in the container
                parsed.append((req, wave, -(-samples // n), samples))
            except Exception as e:
                self._fail([(req,)], e)
        if not parsed:
            return
        self._note_stage("parse", time.monotonic() - t_parse0)
        groups: dict = {}
        for item in parsed:
            wave = item[1]
            groups.setdefault((wave.shape[-1], wave.dtype == np.int16),
                              []).append(item)
        # each group's device work is queued without waiting for it; the
        # pool waits for its readback and packs, while this loop goes back
        # to coalescing. The semaphore, taken before the dispatch, bounds
        # the groups in flight.
        for (ch, _), items in groups.items():
            t_acq0 = time.monotonic()
            self._inflight.acquire()
            t_disp0 = time.monotonic()
            self._note_stage("acquire", t_disp0 - t_acq0)
            try:
                handle = self._dispatch(items, ch)
                self._note_stage("dispatch", time.monotonic() - t_disp0)
            except Exception as e:
                self._inflight.release()
                self._fail(items, e)
                continue
            try:
                pool.submit(self._finalize_batch, items, handle)
            except RuntimeError as e:
                # the executor shut down mid-stop: release the slot and
                # fail the group
                self._inflight.release()
                self._fail(items, e)

    def _dispatch(self, items, ch):
        """Queue one group's encode: its clips padded with zeros to the
        longest, one host buffer (pinned for the card) copied to the device
        without blocking, ``quantize_frames(mdct.transform(x))``, and the
        copy of codes and sidecar back into pinned memory ->
        ((host codes, host sidecar), event or None)."""
        codec = self._codec
        dev = self._device
        i16 = items[0][1].dtype == np.int16
        s = max(blocks for _, _, blocks, _ in items) * codec.mdct.filters_n
        x = torch.zeros((len(items), s, ch),
                        dtype=torch.int16 if i16 else torch.float32,
                        pin_memory=dev.type == "cuda")
        xh = x.numpy()
        for j, (_, wave, _, samples) in enumerate(items):
            xh[j, :samples] = wave
        with on_device(dev), torch.no_grad():
            x = x.to(dev, non_blocking=True)
            dtype = codec.mdct.compute_dtype
            x = dequant_wire(x, dtype) if i16 else x.to(dtype)
            codes, bark = codec.quantize_frames(codec.mdct.transform(x))
            return _sc._to_host((codes, bark))

    def _finalize_batch(self, items, handle):
        """Pool side: wait for the group's readback, pack and answer each
        request. Runs beside the batch loop's next dispatch."""
        try:
            t_read0 = time.monotonic()
            (codes_h, bark_h), event = handle
            try:
                if event is not None:
                    event.synchronize()
            except Exception as e:
                self._fail(items, e)
                return
            t_pack0 = time.monotonic()
            self._note_stage("readback", t_pack0 - t_read0)
            self._count("encode_batches")
            for j, (req, _, blocks, samples) in enumerate(items):
                # frames 0..blocks are the clip's own: a frame depends only
                # on blocks i-1 and i, and the pad blocks are zeros
                self._pack_one(req, codes_h[j:j + 1, :blocks + 1],
                               bark_h[j:j + 1, :blocks + 1], samples)
            self._note_stage("pack", time.monotonic() - t_pack0)
        finally:
            self._inflight.release()

    def _pack_one(self, req, codes, bark, orig_samples=0):
        try:
            req.finish(0, bitstream.pack(codes, bark,
                                         orig_samples=orig_samples,
                                         **self._meta))
        except Exception as e:
            self._fail([(req,)], e)


class _StreamSession:
    """A connection's streaming encode: offline ``encode_stream``'s chunk
    encoder, writing into a buffer whose new bytes after each call are the
    responses, so the responses concatenated are the offline .acs file."""

    def __init__(self, server, cfg_payload: bytes):
        cfg = json.loads(cfg_payload.decode() or "{}")
        if not isinstance(cfg, dict):
            raise ValueError("stream config must be a JSON object")
        codec = server._codec
        self.channels = int(cfg.get("channels", 1))
        if not 1 <= self.channels <= 64:
            raise ValueError(f"channels out of range: {self.channels}")
        self.chunk_blocks = int(cfg.get("chunk_blocks", 64))
        if not 1 <= self.chunk_blocks <= 1 << 16:
            raise ValueError(
                f"chunk_blocks out of range: {self.chunk_blocks}"
            )
        ms = bool(cfg.get("ms", False))
        if ms and self.channels != 2:
            raise ValueError("ms coding needs exactly 2 channels")
        self.tscale = float(cfg.get("threshold_scale", 1.0))
        if not 0 < self.tscale < 2**32:
            raise ValueError(f"threshold_scale out of range: {self.tscale}")
        deadzone = float(cfg.get("deadzone", 0.5))
        if not 0.5 <= deadzone <= 2.0:
            raise ValueError(f"deadzone out of range: {deadzone}")
        tmask = float(cfg.get("tmask", 0.0))
        # 0 = off; positive values below 1 dB/s mean a >30 s masking
        # window: senseless physically and an easy resource sink
        if tmask != 0.0 and not 1.0 <= tmask < 1e6:
            raise ValueError(f"tmask out of range: {tmask}")
        intensity = bool(cfg.get("intensity", False))
        if intensity and not ms:
            raise ValueError("intensity stereo needs ms coding")
        self.cbr = bool(cfg.get("cbr", False))
        self.dtx = float(cfg.get("dtx", 0.0))
        if self.dtx and not -200.0 < self.dtx < 0.0:
            raise ValueError(f"dtx out of range: {self.dtx}")
        if self.dtx and self.cbr:
            raise ValueError("dtx does not compose with cbr sessions")
        nf = bool(cfg.get("nf", False))
        # True so that the FIRST chunk gates when below, as offline
        # encode_stream's gate[0] = below[0]
        self._prev_below = True
        self._codec = codec
        self._device = server._device
        self._buf = _io.BytesIO()
        self._sent = 0
        self._encoder = _sc._ChunkEncoder(
            codec, self._buf, self.channels, ms=ms,
            threshold_scale=self.tscale, cbr=self.cbr, deadzone=deadzone,
            tns=bool(cfg.get("tns", False)), nf=nf,
            nf_seed=int(cfg.get("nf_seed", 0)) if nf else 0, tmask=tmask,
            bs=bool(cfg.get("bs", False)), bwe=bool(cfg.get("bwe", False)),
            intensity=intensity, dtx=self.dtx,
        )
        self._samples = self.chunk_blocks * codec.mdct.filters_n

    def take_bytes(self) -> bytes:
        data = self._buf.getvalue()
        out = data[self._sent:]
        self._sent = len(data)
        return out

    def feed_adaptive(self, payload: bytes) -> bytes:
        """The 'A' op: an f64-LE scale for this chunk, then its PCM."""
        if len(payload) < 8:
            raise ValueError("adaptive chunk needs an 8-byte scale prefix")
        (ts,) = struct.unpack("<d", payload[:8])
        return self.feed(payload[8:], tscale=ts)

    def feed(self, payload: bytes, tscale=None) -> bytes:
        """One chunk of PCM -> that chunk's .acs bytes. ``tscale`` (cbr
        sessions only, the 'A' op) is THIS chunk's rate-control scale: it
        rides the chunk as offline ``encode_stream_cbr``'s do."""
        if tscale is not None:
            if not self.cbr:
                raise ValueError(
                    "per-chunk scales need a cbr session (begin_stream "
                    "cfg {'cbr': true})"
                )
            ts = float(tscale)
            if not 0 < ts < 2**32:
                raise ValueError(f"chunk scale out of range: {ts}")
        else:
            ts = self.tscale
        want = self._samples * self.channels * 4
        if len(payload) != want:
            raise ValueError(
                f"chunk payload must be {want} bytes of float32 PCM "
                f"({self._samples} samples x {self.channels} ch), got "
                f"{len(payload)}"
            )
        pcm = torch.from_numpy(np.frombuffer(payload, "<f4").reshape(
            1, self._samples, self.channels).copy())
        if self.dtx:
            # offline encode_stream's gate on the host chunk: float32 RMS a
            # channel against the dBFS threshold, with the one-chunk
            # hangover after active content; a gated chunk costs no copy
            # to the card and no device step
            gate, rms = _sc._dtx_gate(pcm, self._samples, self.dtx)
            below = bool(gate[0])
            gated = below and self._prev_below
            self._prev_below = below
            if gated:
                self._encoder.silent(self.chunk_blocks,
                                     rms[0] * (rms[0] > 1e-12))
                return self.take_bytes()
        with on_device(self._device), torch.no_grad():
            # pushed, then drained: the response is this chunk's bytes
            self._encoder.push(pcm.to(self._codec.mdct.compute_dtype), ts)
            self._encoder.drain()
        return self.take_bytes()

    def finish(self) -> bytes:
        with on_device(self._device), torch.no_grad():
            self._encoder.finish()
        return self.take_bytes()


class _DecodeSession:
    """A connection's streaming decode, the mirror of
    :class:`_StreamSession`: the client sends the .acs header once, then
    each chunk's bytes as they arrive; each response is that chunk's
    float32 PCM. A chunk is parsed as a one-chunk stream by
    ``StreamReader`` (CRC checks included) and decoded as offline
    ``decode_stream`` decodes it."""

    def __init__(self, server, header_bytes: bytes):
        if len(header_bytes) > 1 << 20:
            raise ValueError("stream header too large")
        # a zero-chunk stream validates the magic and the meta
        empty = header_bytes + struct.pack("<QQ", 0, len(header_bytes))
        with _sc.StreamReader(_io.BytesIO(empty)) as r:
            meta = r.meta
        server._check_container_config(meta)
        codec = server._codec
        self._codec = codec
        self._device = server._device
        self._header = header_bytes
        self.meta = meta
        self._kw = _sc._decode_keywords(meta)
        self._frame_off = 0
        self._chunk_idx = 0
        self._carry = _streaming.imdct_stream_init(codec.mdct, 1,
                                                   meta["channels"])

    def feed(self, chunk_bytes: bytes) -> bytes:
        hlen = len(self._header)
        mini = (self._header + chunk_bytes + struct.pack("<Q", hlen)
                + struct.pack("<QQ", 1, hlen + len(chunk_bytes)))
        with _sc.StreamReader(_io.BytesIO(mini)) as r:
            c = r.read_chunk(0)
        dev = self._device
        with on_device(dev), torch.no_grad():
            # comfort noise keyed by the session's chunk counter: offline
            # decode_stream's noise for a stream fed in order from its start
            staged = _sc._staged(c, dev.type == "cuda")
            self._carry, samples, _ = _sc._decode_chunk(
                self._codec, self._carry, c, staged, self._kw,
                self._frame_off, self._chunk_idx)
            out = _f32_bytes(samples)
        self._frame_off += c.codes.shape[0]
        self._chunk_idx += 1
        return out

    def finish(self) -> bytes:
        with on_device(self._device), torch.no_grad():
            return _f32_bytes(_streaming.imdct_stream_flush(
                self._codec.mdct, self._carry))


class Client:
    """Persistent-connection client of :class:`CodecServer`."""

    def __init__(self, host="127.0.0.1", port=None, unix_path=""):
        if unix_path:
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.connect(unix_path)
        else:
            self._sock = socket.create_connection((host, port))

    def _call(self, op: str, payload: bytes) -> bytes:
        _write_frame(self._sock, ord(op), payload)
        status, resp = _read_frame(self._sock)
        if status != 0:
            raise RuntimeError(
                f"server error: {resp.decode(errors='replace')}"
            )
        return resp

    def encode(self, wav_bytes: bytes) -> bytes:
        """WAV blob -> .acz container bytes."""
        return self._call("E", wav_bytes)

    def decode(self, acz_bytes: bytes) -> bytes:
        """.acz container bytes -> WAV (16-bit PCM) blob."""
        return self._call("D", acz_bytes)

    def begin_stream(self, **cfg) -> bytes:
        """Open a streaming encode session; returns the .acs header
        bytes. Config keys: channels, chunk_blocks, threshold_scale, ms,
        deadzone, tns, nf, nf_seed, tmask, bs, bwe, intensity, cbr
        (per-chunk scales through feed(..., threshold_scale=)), dtx (a dBFS
        gate: near-silent chunks cost ~10 bytes; VBR sessions only)."""
        return self._call("B", json.dumps(cfg).encode())

    def feed(self, pcm, threshold_scale=None) -> bytes:
        """One chunk of audio (float32 [samples, channels] or its raw
        little-endian bytes) -> the chunk's .acs bytes.
        ``threshold_scale`` sets THIS chunk's rate-control scale on a cbr
        session; the scale rides the stream, so any decoder plays it."""
        if not isinstance(pcm, (bytes, bytearray)):
            pcm = np.ascontiguousarray(pcm, dtype="<f4").tobytes()
        if threshold_scale is None:
            return self._call("C", bytes(pcm))
        return self._call(
            "A", struct.pack("<d", float(threshold_scale)) + bytes(pcm)
        )

    def finish_stream(self) -> bytes:
        """Close the session; returns the flush chunk + index/trailer.
        header + chunks + this tail = a valid .acs file."""
        return self._call("F", b"")

    def begin_decode_stream(self, header_bytes: bytes) -> dict:
        """Open a streaming decode session from an .acs header; returns
        the stream's meta (sample_rate, channels, ...)."""
        meta = json.loads(self._call("J", header_bytes))
        self._dec_ch = int(meta["channels"])
        return meta

    def feed_chunk(self, chunk_bytes: bytes) -> np.ndarray:
        """One .acs chunk's raw bytes -> its float32 PCM [samples,
        channels]."""
        raw = self._call("K", chunk_bytes)
        return np.frombuffer(raw, "<f4").reshape(-1, self._dec_ch)

    def finish_decode_stream(self) -> np.ndarray:
        """Close the decode session; returns the final overlap-add tail."""
        raw = self._call("L", b"")
        return np.frombuffer(raw, "<f4").reshape(-1, self._dec_ch)

    def stats(self) -> dict:
        return json.loads(self._call("Q", b""))

    def close(self):
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def request(op: str, payload: bytes, host="127.0.0.1", port=None,
            unix_path="") -> bytes:
    """One-shot client call (connect, request, close)."""
    with Client(host, port, unix_path) as c:
        return c._call(op, payload)
