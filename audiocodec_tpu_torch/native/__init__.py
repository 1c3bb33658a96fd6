"""The port's native (C++) host library: WAV decode and write, and the
Rice/Golomb entropy coders of the containers (counterpart of
``audiocodec_tpu/native``, built from the port's own copies of its sources,
``wavio.cpp`` and ``entropy.cpp``).

This is host code, not a device kernel: g++ builds it at first use into
``build/audiocodec_tpu_torch/`` of the checkout, under a name that hashes the
sources, the compiler flags and the host CPU's fingerprint, and ctypes binds
it. A library of that name is up to date by construction, so it is loaded
without any compiler call; a host whose CPU differs gets a name of its own
(``-march=native`` binaries are ISA-specific). Nothing builds when the
package is imported.

Without a compiler everything degrades as in the JAX package: WAV I/O falls
back to ``io/wav.py``, the decoders to pure Python, and ``bitstream.pack``'s
``entropy="auto"`` to zlib; the encoders and the bulk loader
``load_corpus`` raise (``available()`` says which path is live,
``build_error()`` why).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

from audiocodec_tpu_torch.ops._build import BUILD_DIR

SOURCE_DIR = Path(__file__).resolve().parent
SOURCES = ("wavio.cpp", "entropy.cpp")
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
# tried in order: -march=native is worth ~4x on the LPC analyzer's
# autocorrelation (AVX); a compiler or platform that rejects it gets the
# portable build
ARCH_FLAGS = (("-march=native", "-funroll-loops"), ())
_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _host_fingerprint() -> str:
    """The host's machine and CPU flags, hashed: part of the library's
    name."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "Features")):
                    flags = line
                    break
    except OSError:
        pass
    key = f"{platform.machine()}|{flags}".encode()
    return hashlib.sha256(key).hexdigest()[:32]


def library_path(arch_flags) -> Path:
    """Where the library of these flags lives, under ``BUILD_DIR``: its
    name hashes the sources, the flags and the host's fingerprint."""
    digest = hashlib.sha256(" ".join((*CXX_FLAGS, *arch_flags)).encode())
    for name in SOURCES:
        digest.update((SOURCE_DIR / name).read_bytes())
    digest.update(_host_fingerprint().encode())
    return Path(BUILD_DIR) / f"libacx_native-{digest.hexdigest()[:16]}.so"


def _compile(arch_flags, path: Path) -> str | None:
    """Compile the sources into ``path`` (through a temporary file, so that
    concurrent builds agree on one library). Returns an error string or
    None."""
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS[:1], *arch_flags, *CXX_FLAGS[1:],
           *(str(SOURCE_DIR / s) for s in SOURCES), "-o", str(tmp)]
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
        if proc.returncode != 0:
            return f"g++ failed: {proc.stderr[-500:]}"
        os.replace(tmp, path)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ unavailable: {e}"
    finally:
        tmp.unlink(missing_ok=True)
    return None


def _bind(lib):
    """Declare the ctypes signature of every exported symbol."""
    lib.acx_decode_wav.restype = ctypes.c_int
    lib.acx_decode_wav.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.acx_load_corpus.restype = ctypes.c_int64
    lib.acx_load_corpus.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.acx_load_corpus_i16.restype = ctypes.c_int64
    lib.acx_load_corpus_i16.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int16),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.acx_write_wav.restype = ctypes.c_int
    lib.acx_write_wav.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.acx_rice_bound.restype = ctypes.c_int64
    lib.acx_rice_bound.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.acx_rice_encode.restype = ctypes.c_int64
    lib.acx_rice_encode.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
    ]
    lib.acx_rice_decode.restype = ctypes.c_int32
    lib.acx_rice_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.acx_lpc_residual.restype = ctypes.c_int32
    lib.acx_lpc_residual.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.acx_lpc_reconstruct.restype = ctypes.c_int32
    lib.acx_lpc_reconstruct.argtypes = list(lib.acx_lpc_residual.argtypes)
    lib.acx_lossless_score.restype = ctypes.c_int32
    lib.acx_lossless_score.argtypes = [
        ctypes.POINTER(ctypes.c_int32),   # x [F, n, C]
        ctypes.c_int64,                   # frames
        ctypes.c_int64,                   # n
        ctypes.c_int64,                   # channels
        ctypes.c_int32,                   # stereo4
        ctypes.POINTER(ctypes.c_int32),   # orders [F, Cc] out
        ctypes.POINTER(ctypes.c_double),  # bits [F, Cc] out
    ]
    lib.acx_l2_encode.restype = ctypes.c_int32
    lib.acx_l2_encode.argtypes = [
        ctypes.POINTER(ctypes.c_int32),   # x [F, n, C]
        ctypes.c_int64,                   # frames
        ctypes.c_int64,                   # n
        ctypes.c_int64,                   # channels
        ctypes.c_int32,                   # stereo4
        ctypes.POINTER(ctypes.c_int32),   # idx [F, P] (stereo4 only)
        ctypes.POINTER(ctypes.c_int32),   # fixed_orders [F, P]
        ctypes.c_int32,                   # do_lpc
        ctypes.c_int32,                   # max_order
        ctypes.c_int32,                   # precision
        ctypes.c_int32,                   # n_windows
        ctypes.c_double,                  # margin
        ctypes.POINTER(ctypes.c_int32),   # wire [F*P*n] out
        ctypes.POINTER(ctypes.c_int32),   # lorders [F, P] out
        ctypes.POINTER(ctypes.c_int32),   # lshifts [F, P] out
        ctypes.POINTER(ctypes.c_int32),   # qcoef [F, max_order, P] out
        ctypes.POINTER(ctypes.c_double),  # savings [1] out
    ]
    lib.acx_lpc_reconstruct_wire.restype = ctypes.c_int32
    lib.acx_lpc_reconstruct_wire.argtypes = [
        ctypes.POINTER(ctypes.c_int32),   # wire [F*C*n]
        ctypes.c_int64,                   # frames
        ctypes.c_int64,                   # n
        ctypes.c_int64,                   # channels
        ctypes.POINTER(ctypes.c_int32),   # orders [F, C]
        ctypes.POINTER(ctypes.c_int32),   # shifts [F, C]
        ctypes.POINTER(ctypes.c_int32),   # qcoef [F, max_order, C]
        ctypes.c_int64,                   # max_order
        ctypes.POINTER(ctypes.c_int32),   # x [F*n, C] out
    ]
    lib.acx_rrice_bound.restype = ctypes.c_int64
    lib.acx_rrice_bound.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.acx_rrice_encode.restype = ctypes.c_int64
    lib.acx_rrice_encode.argtypes = list(lib.acx_rice_encode.argtypes)
    lib.acx_rrice_decode.restype = ctypes.c_int32
    lib.acx_rrice_decode.argtypes = list(lib.acx_rice_decode.argtypes)
    idx_encode_argtypes = list(lib.acx_rice_encode.argtypes) + [
        ctypes.c_int64,                   # idx_stride (values)
        ctypes.POINTER(ctypes.c_uint64),  # idx_out (bit offsets)
    ]
    lib.acx_rice_encode_idx.restype = ctypes.c_int64
    lib.acx_rice_encode_idx.argtypes = idx_encode_argtypes
    lib.acx_rrice_encode_idx.restype = ctypes.c_int64
    lib.acx_rrice_encode_idx.argtypes = idx_encode_argtypes
    decode_at_argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_uint64,                  # start_bit
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.acx_rice_decode_at.restype = ctypes.c_int32
    lib.acx_rice_decode_at.argtypes = decode_at_argtypes
    lib.acx_rrice_decode_at.restype = ctypes.c_int32
    lib.acx_rrice_decode_at.argtypes = decode_at_argtypes
    return lib


def _load():
    """Load the library, building it first if no library of these sources
    exists for this host; None on any failure, which ``build_error()``
    then names. Never raises: containers must still decode on a machine
    without a compiler."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        paths = [(flags, library_path(flags)) for flags in ARCH_FLAGS]
        # an existing library first (no compiler call), then the builds
        order = ([p for p in paths if p[1].exists()]
                 + [p for p in paths if not p[1].exists()])
        errors = []
        for flags, path in order:
            if not path.exists():
                err = _compile(flags, path)
                if err is not None:
                    errors.append(err)
                    continue
            try:
                _lib = _bind(ctypes.CDLL(str(path)))
                return _lib
            except OSError as e:
                errors.append(f"cannot load native library: {e}")
        _build_error = "; ".join(errors)
        return None


def available() -> bool:
    """True when the native library is built and loadable."""
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


_ERRORS = {
    -1: "cannot read file",
    -2: "not a RIFF/WAVE file",
    -3: "malformed wav (missing fmt/data)",
    -4: "unsupported encoding (want PCM 16/24/32 or float32)",
    -5: "channel count mismatch",
}


def decode_wav(path: str):
    """Decode one WAV -> ([1, frames, channels] float32 in [-1, 1], rate).

    Same contract as io.wav.read_wav, decoded natively.
    """
    lib = _load()
    if lib is None:
        from audiocodec_tpu_torch.io.wav import read_wav

        return read_wav(path)

    # Total decoded values can never exceed file_bytes / 2 (samples are at
    # least 16-bit in every supported encoding), so a buffer of that many
    # float32 values is always sufficient regardless of channel count.
    size = os.path.getsize(path)
    cap_values = max(1, size // 2)
    out = np.empty(cap_values, dtype=np.float32)
    rate = ctypes.c_int32()
    channels = ctypes.c_int32()
    frames = ctypes.c_int64()
    rc = lib.acx_decode_wav(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cap_values,  # frame cap; frames*channels <= values <= cap_values
        ctypes.byref(rate),
        ctypes.byref(channels),
        ctypes.byref(frames),
    )
    if rc != 0:
        raise ValueError(
            f"native wav decode failed for {path}: "
            f"{_ERRORS.get(rc, rc)}"
        )
    n, c = int(frames.value), int(channels.value)
    data = out[: n * c].reshape(1, n, c).copy()
    return data, int(rate.value)


def load_corpus(paths, clip_seconds: float, sample_rate: int,
                channels: int = 1, n_threads: int = 0,
                dtype: str = "float32"):
    """Bulk-decode WAV files into [n, frames, channels], frames =
    int(clip_seconds * sample_rate): each clip truncated or zero-padded to
    that length, in C++ threads (n_threads=0: all cores). The files' own
    rates are not checked (the corpus is uniform by contract).

    :param dtype: "float32" (normalized [-1, 1]) or "int16", the wire to
        the device: PCM16-scale integers decoded in C++ (a copy for PCM16
        sources), dequantized on the device by 1/32768, exactly.
    :return: (array [n, frames, channels], status int32 [n]: 0 ok, -1
        unreadable, -2 not a WAV, -3 malformed, -4 unsupported encoding,
        -5 channel count mismatch; a failed clip's row is zeros).
    :raises RuntimeError: without the native library (no Python decoder
        stands in for it).
    """
    if dtype not in ("float32", "int16"):
        raise ValueError(f"dtype must be 'float32' or 'int16', got {dtype!r}")
    lib = _load()
    if lib is None:
        raise RuntimeError(
            f"load_corpus needs the native library: {_build_error}"
        )
    frames = int(clip_seconds * sample_rate)
    n = len(paths)
    out = np.zeros((n, frames, channels), dtype=np.dtype(dtype))
    status = np.zeros(n, dtype=np.int32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    fn, ptr = ((lib.acx_load_corpus_i16, ctypes.c_int16) if dtype == "int16"
               else (lib.acx_load_corpus, ctypes.c_float))
    fn(arr, n, out.ctypes.data_as(ctypes.POINTER(ptr)), frames, channels,
       n_threads, status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out, status


def write_wav(path: str, data, sample_rate: int, width: int = 2) -> None:
    """Write [frames, channels] or [1, frames, channels] float32 natively."""
    lib = _load()
    x = np.ascontiguousarray(np.asarray(data, dtype=np.float32))
    if x.ndim == 3:
        if x.shape[0] != 1:
            raise ValueError("write_wav takes a single clip")
        x = x[0]
    if x.ndim == 1:
        x = x[:, None]
    if lib is None:
        from audiocodec_tpu_torch.io import wav as _pywav

        _pywav.write_wav(path, x, sample_rate, width=width)
        return
    rc = lib.acx_write_wav(
        path.encode(),
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        x.shape[0],
        x.shape[1],
        sample_rate,
        width,
    )
    if rc != 0:
        raise ValueError(f"native wav write failed: {_ERRORS.get(rc, rc)}")


# -- Rice/Golomb entropy coding ----------------------------------------------

RICE_GROUP = 256  # values per Rice parameter group

# Grow-only per-thread scratch for encoder output: allocating the
# worst-case bound fresh per call made page faults cost 4x the actual
# coding work (measured 80 ms of faults vs 22 ms of coding on a 2.6M-
# value stream). Thread-local because rate.py thread-pools packing.
_scratch = threading.local()


def _scratch_buf(cap: int) -> np.ndarray:
    buf = getattr(_scratch, "buf", None)
    if buf is None or buf.size < cap:
        buf = np.empty(max(cap, 1 << 20), dtype=np.uint8)
        _scratch.buf = buf
    return buf


def rice_encode(codes, group: int = RICE_GROUP) -> bytes:
    """Entropy-code int32 codes (any shape) -> bytes. Native-only (the
    encoder always runs where the framework is installed); decoding has a
    pure-Python fallback so bitstreams stay portable."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            f"rice_encode needs the native library: {_build_error}"
        )
    flat = np.ascontiguousarray(np.asarray(codes, dtype=np.int32).ravel())
    cap = int(lib.acx_rice_bound(flat.size, group))
    out = _scratch_buf(cap)
    written = lib.acx_rice_encode(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        flat.size,
        group,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap,
    )
    if written < 0:
        raise RuntimeError("rice encoder overflow (bound bug)")
    return out[:written].tobytes()


def _encode_indexed(fn_name, codes, idx_stride, group):
    lib = _load()
    if lib is None:
        raise RuntimeError(
            f"{fn_name} needs the native library: {_build_error}"
        )
    flat = np.ascontiguousarray(np.asarray(codes, dtype=np.int32).ravel())
    if idx_stride <= 0 or idx_stride % group != 0:
        raise ValueError(
            f"idx_stride must be a positive multiple of group {group}"
        )
    bound = "acx_rrice_bound" if "rrice" in fn_name else "acx_rice_bound"
    cap = int(getattr(lib, bound)(flat.size, group))
    out = _scratch_buf(cap)
    idx = np.zeros(-(-flat.size // idx_stride), dtype=np.uint64)
    written = getattr(lib, fn_name)(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        flat.size,
        group,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap,
        idx_stride,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if written < 0:
        raise RuntimeError("rice encoder overflow (bound bug)")
    return out[:written].tobytes(), idx


def rice_encode_indexed(codes, idx_stride, group: int = RICE_GROUP):
    """Like :func:`rice_encode`, also returning the bit offset of every
    idx_stride-th value's group header (seek points for
    :func:`rice_decode` start_bit). idx_stride must be a multiple of
    the Rice group so offsets land on resynchronizable boundaries."""
    return _encode_indexed("acx_rice_encode_idx", codes, idx_stride, group)


def rrice_encode_indexed(codes, idx_stride, group: int = RICE_GROUP):
    """Run-length variant of :func:`rice_encode_indexed`."""
    return _encode_indexed("acx_rrice_encode_idx", codes, idx_stride, group)


# Above this many values, the pure-Python fallback takes minutes; tell
# the user how to get the ~100x-faster native decoder instead of looking
# hung. (Streaming .acs decodes go chunk-by-chunk and stay under this.)
_PY_DECODE_WARN_N = 20_000_000


def rice_decode(data: bytes, n: int, group: int = RICE_GROUP,
                start_bit: int = 0) -> np.ndarray:
    """Decode `n` int32 values from a Rice stream (native or pure Python).

    `start_bit` must be a group-boundary bit offset recorded by
    :func:`rice_encode_indexed` (0 = stream start); an arbitrary offset
    decodes garbage values but can never read out of bounds."""
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(n, dtype=np.int32)
    if start_bit < 0 or start_bit > buf.size * 8:
        raise ValueError("corrupt rice stream")
    if lib is not None:
        rc = lib.acx_rice_decode_at(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            buf.size,
            int(start_bit),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n,
            group,
        )
        if rc != 0:
            raise ValueError("corrupt rice stream")
        return out
    if n > _PY_DECODE_WARN_N:
        import warnings

        warnings.warn(
            f"decoding {n:,} Rice values with the pure-Python fallback "
            "(~1 us/value — expect minutes). Install a C++ toolchain so "
            "audiocodec_tpu_torch.native can build its ~100x-faster coder.",
            RuntimeWarning,
            stacklevel=2,
        )
    return _rice_decode_py(buf, n, group, start_bit)


def rrice_encode(codes, group: int = RICE_GROUP) -> bytes:
    """Run-length Rice variant: per group, the encoder costs plain Rice
    against gamma-run/Rice-magnitude RLE and flags the cheaper one. On
    the quantizer's zero-heavy spectra this is 2-6x smaller pre-deflate
    (tonal content quantizes to >99% zeros, each costing a full unary
    bit in plain Rice). Native-only, like :func:`rice_encode`."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            f"rrice_encode needs the native library: {_build_error}"
        )
    flat = np.ascontiguousarray(np.asarray(codes, dtype=np.int32).ravel())
    cap = int(lib.acx_rrice_bound(flat.size, group))
    out = _scratch_buf(cap)
    written = lib.acx_rrice_encode(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        flat.size,
        group,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap,
    )
    if written < 0:
        raise RuntimeError("rrice encoder overflow (bound bug)")
    return out[:written].tobytes()


def rrice_decode(data: bytes, n: int, group: int = RICE_GROUP,
                 start_bit: int = 0) -> np.ndarray:
    """Decode `n` int32 values from a run-length Rice stream
    (optionally from an indexed group-boundary `start_bit`)."""
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)
    if start_bit < 0 or start_bit > buf.size * 8:
        raise ValueError("corrupt rice stream")
    if lib is not None:
        out = np.empty(n, dtype=np.int32)
        rc = lib.acx_rrice_decode_at(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            buf.size,
            int(start_bit),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n,
            group,
        )
        if rc != 0:
            raise ValueError("corrupt rice stream")
        return out
    return _rrice_decode_py(buf, n, group, start_bit)


def _lpc_call(fn_name, data, qcoef, shift):
    """Shared wrapper of the exact integer LPC filters (lossless.py
    level-2 tier). The int64 accumulators run in C++; pure-Python
    fallbacks would be minutes per file, so this pair is native-only like
    rice_encode.

    :param data: int32 [frames, n, channels] (samples or residuals)
    :param qcoef: int32 [frames, p, channels] quantized coefficients
    :param shift: right-shift of the prediction accumulator (0..31)
    :return: int32 [frames, n, channels]
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(
            f"{fn_name} needs the native library: {_build_error}"
        )
    data = np.ascontiguousarray(data, dtype=np.int32)
    qcoef = np.ascontiguousarray(qcoef, dtype=np.int32)
    frames, n, channels = data.shape
    if qcoef.shape[0] != frames or qcoef.shape[2] != channels:
        raise ValueError(
            f"qcoef {qcoef.shape} does not match data {data.shape}"
        )
    p = qcoef.shape[1]
    out = np.empty_like(data)
    rc = getattr(lib, fn_name)(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        frames,
        n,
        channels,
        qcoef.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        p,
        int(shift),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise ValueError(
            f"invalid LPC parameters (order {p}, shift {shift})"
        )
    return out


def lossless_score(x, stereo4=False):
    """Exact fixed-ladder scores for every candidate channel per frame.

    Unlike the device selector's sampled-chunk estimates, these are
    full-frame zigzag sums through the shared min_p n(p+1)+sum/2^p
    model — the level-2 path trades the device program for exact,
    host-bound analysis.

    :param x: int32 [F, n, C] raw frames (l/r when stereo4)
    :param stereo4: score the four stereo candidates l/r/mid/side
        (requires C == 2) instead of the raw channels
    :return: (orders int32 [F, Cc], bits float64 [F, Cc]) with
        Cc = 4 when stereo4 else C
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(
            f"lossless_score needs the native library: {_build_error}"
        )
    x = np.ascontiguousarray(x, dtype=np.int32)
    frames, n, channels = x.shape
    cc = 4 if stereo4 else channels
    orders = np.zeros((frames, cc), dtype=np.int32)
    bits = np.zeros((frames, cc), dtype=np.float64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc = lib.acx_lossless_score(
        x.ctypes.data_as(i32p), frames, n, channels, int(bool(stereo4)),
        orders.ctypes.data_as(i32p),
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        raise ValueError(
            f"invalid lossless_score input (shape {x.shape}, "
            f"stereo4={stereo4})"
        )
    return orders, bits


def l2_encode(x, idx, fixed_orders, do_lpc=True, max_order=26,
              precision=15, n_windows=2, margin=64.0):
    """Level-2 lossless frame encode: fixed-ladder build + LPC search.

    Builds each stored slot's fixed-predictor residual at its chosen
    order directly into the wire layout, then (when do_lpc) runs the
    full LPC candidate per (frame, slot) — Hann+Tukey windowed
    autocorrelation, Levinson-Durbin order search to `max_order`
    (every order's prediction error is a recursion by-product),
    adaptive-shift quantization at `precision` magnitude bits, exact
    integer residual — and keeps whichever side's exact estimated bits
    win by `margin`.

    :param x: int32 [F, n, C] raw frames
    :param idx: int32 [F, 2] stereo candidate picks (0 l, 1 r, 2 mid,
        3 side) or None for the channels-as-slots layout
    :param fixed_orders: int32 [F, P] chosen fixed-ladder order per slot
    :return: (wire int32 [F*P*n], lorders int32 [F, P] — 0 where the
              fixed ladder was kept, lshifts int32 [F, P],
              qcoef int32 [F, max_order, P], savings float)
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(
            f"l2_encode needs the native library: {_build_error}"
        )
    x = np.ascontiguousarray(x, dtype=np.int32)
    frames, n, channels = x.shape
    stereo4 = idx is not None
    slots = 2 if stereo4 else channels
    fixed_orders = np.ascontiguousarray(fixed_orders, dtype=np.int32)
    if fixed_orders.shape != (frames, slots):
        raise ValueError(
            f"fixed_orders {fixed_orders.shape} != ({frames}, {slots})"
        )
    i32p = ctypes.POINTER(ctypes.c_int32)
    if stereo4:
        idx = np.ascontiguousarray(idx, dtype=np.int32)
        if idx.shape != (frames, 2):
            raise ValueError(f"idx {idx.shape} != ({frames}, 2)")
        idx_p = idx.ctypes.data_as(i32p)
    else:
        idx_p = None
    wire = np.empty(frames * slots * n, dtype=np.int32)
    lorders = np.zeros((frames, slots), dtype=np.int32)
    lshifts = np.zeros((frames, slots), dtype=np.int32)
    qcoef = np.zeros((frames, max_order, slots), dtype=np.int32)
    savings = np.zeros(1, dtype=np.float64)
    rc = lib.acx_l2_encode(
        x.ctypes.data_as(i32p), frames, n, channels, int(stereo4),
        idx_p, fixed_orders.ctypes.data_as(i32p), int(bool(do_lpc)),
        int(max_order), int(precision), int(n_windows), float(margin),
        wire.ctypes.data_as(i32p),
        lorders.ctypes.data_as(i32p), lshifts.ctypes.data_as(i32p),
        qcoef.ctypes.data_as(i32p),
        savings.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        raise ValueError(
            f"invalid l2_encode parameters (max_order {max_order}, "
            f"precision {precision}, frame {n})"
        )
    return wire, lorders, lshifts, qcoef, float(savings[0])


def lpc_reconstruct_wire(wire, orders, shifts, qcoef):
    """Variable-order LPC decode over the wire layout.

    :param wire: int32 [F*C*n] residual runs (contiguous per (f, c))
    :param orders: int32 [F, C]; 0 = skip that run (already decoded)
    :param shifts: int32 [F, C]
    :param qcoef: int32 [F, max_order, C]
    :return: int32 [F*n, C] with only the order>0 runs written (zeros
        elsewhere) — callers merge into the device integrator's output
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(
            f"lpc_reconstruct_wire needs the native library: {_build_error}"
        )
    orders = np.ascontiguousarray(orders, dtype=np.int32)
    shifts = np.ascontiguousarray(shifts, dtype=np.int32)
    qcoef = np.ascontiguousarray(qcoef, dtype=np.int32)
    wire = np.ascontiguousarray(wire, dtype=np.int32)
    frames, channels = orders.shape
    max_order = qcoef.shape[1]
    if qcoef.shape[0] != frames or qcoef.shape[2] != channels:
        raise ValueError(f"qcoef {qcoef.shape} does not match orders")
    if wire.size % (frames * channels) != 0:
        raise ValueError("wire size is not a multiple of frames*channels")
    n = wire.size // (frames * channels)
    out = np.zeros((frames * n, channels), dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc = lib.acx_lpc_reconstruct_wire(
        wire.ctypes.data_as(i32p), frames, n, channels,
        orders.ctypes.data_as(i32p), shifts.ctypes.data_as(i32p),
        qcoef.ctypes.data_as(i32p), max_order,
        out.ctypes.data_as(i32p),
    )
    if rc != 0:
        raise ValueError("invalid LPC order/shift in container")
    return out


def lpc_residual(x, qcoef, shift):
    """Quantized-LPC residuals per frame (exact, FLAC-style)."""
    return _lpc_call("acx_lpc_residual", x, qcoef, shift)


def lpc_reconstruct(res, qcoef, shift):
    """Exact inverse of :func:`lpc_residual`."""
    return _lpc_call("acx_lpc_reconstruct", res, qcoef, shift)



def _rrice_decode_py(buf: np.ndarray, n: int, group: int,
                     start_bit: int = 0) -> np.ndarray:
    """Pure-Python run-length Rice decoder (portability fallback).

    Token-paced, not value-paced: RLE groups cost one loop iteration per
    zero-RUN plus one per nonzero, so sparse streams (the ones rrice is
    chosen for) decode quickly even in Python; plain-mode groups fall
    back to a per-value loop. Same 'corrupt rice stream' ValueError
    contract as the native decoder."""
    bits = np.unpackbits(buf)  # MSB-first, matches the BitWriter
    total = bits.size
    out = np.zeros(n, dtype=np.int32)
    pos = int(start_bit)
    max_q = 47  # kMaxQuotient
    escape = max_q + 1

    def fail():
        raise ValueError("corrupt rice stream")

    def get_bits(p, nb):
        if p + nb > total:
            fail()
        v = 0
        for b in bits[p : p + nb]:
            v = (v << 1) | int(b)
        return v, p + nb

    # next-set-bit index table for unary runs and gamma prefixes
    ones = np.flatnonzero(bits)

    def next_one(p):
        i = np.searchsorted(ones, p)
        if i == len(ones):
            fail()
        return int(ones[i])

    def get_rice(p, k):
        # unary run of 1s, 0-stop
        q = 0
        while p < total and bits[p] == 1:
            q += 1
            p += 1
            if q > escape:
                fail()
        if p >= total:
            fail()
        p += 1  # stop bit
        if q == escape:
            u, p = get_bits(p, 32)
        else:
            rem, p = get_bits(p, k)
            u = (q << k) | rem
        return u, p

    def get_gamma(p):
        z = next_one(p)  # leading zeros end at the first 1
        nzeros = z - p
        if nzeros > 31:
            fail()
        p = z
        x, p = get_bits(p, nzeros + 1)
        return x, p

    for g in range(0, n, group):
        end = min(g + group, n)
        k, pos = get_bits(pos, 4)
        if pos >= total:
            fail()
        mode = int(bits[pos])
        pos += 1
        if mode == 0:
            for i in range(g, end):
                u, pos = get_rice(pos, k)
                out[i] = (u >> 1) ^ -(u & 1)
        else:
            i = g
            while i < end:
                runp1, pos = get_gamma(pos)
                run = runp1 - 1
                if run > end - i:
                    fail()
                i += run  # out already zeros
                if i < end:
                    um1, pos = get_rice(pos, k)
                    u = um1 + 1
                    out[i] = (u >> 1) ^ -(u & 1)
                    i += 1
    return out


def _rice_decode_py(buf: np.ndarray, n: int, group: int,
                    start_bit: int = 0) -> np.ndarray:
    """Dependency-free Rice decoder (portability fallback), numpy-paced.

    Instead of per-bit Python loops, it slides a bit window over the
    stream with three vectorized precomputes per window — a next-zero
    table (each unary run resolves in one lookup) and per-k remainder
    tables (each k-bit read resolves in one lookup) — leaving ~1 us of
    Python per VALUE rather than per BIT (~30x over the bit loop).

    Truncated input raises ValueError('corrupt rice stream') — the same
    error contract as the native decoder — never an IndexError, and never
    a silently-truncated raw-bit read."""
    total_bits = buf.size * 8
    out = np.empty(n, dtype=np.int32)
    wbytes = 1 << 19  # 512 KB of input -> 4M-bit windows
    margin = 96  # max codeword: 48 unary + stop + 32 raw < 96 bits

    state = {}

    def load_window(pos):
        ws_byte = pos // 8
        bits_w = np.unpackbits(buf[ws_byte : ws_byte + wbytes])
        idx = np.arange(bits_w.size, dtype=np.int64)
        zero_at = np.where(bits_w == 0, idx, bits_w.size + margin)
        state["bits"] = bits_w
        state["wstart"] = ws_byte * 8
        state["nz"] = np.minimum.accumulate(zero_at[::-1])[::-1]
        state["vk"] = {}
        state["last"] = ws_byte + wbytes >= buf.size

    def vtab(k):
        v = state["vk"].get(k)
        if v is None:
            bits_w = state["bits"]
            m = bits_w.size - k + 1
            if m <= 0:
                raise ValueError("corrupt rice stream")
            # int32 suffices (k <= 16 -> values < 2^16) and bounds the
            # per-table footprint to 4 B/bit; cap the cache so a stream
            # cycling through many k values cannot pile up one table per
            # k per window (17 x window-bits would be hundreds of MB)
            if len(state["vk"]) >= 4:
                state["vk"].clear()
            v = np.zeros(m, dtype=np.int32)
            for j in range(k):
                v += bits_w[j : j + m].astype(np.int32) << (k - 1 - j)
            state["vk"][k] = v
        return v

    load_window(int(start_bit))
    pos = int(start_bit)
    i = 0
    k = 0
    group_end = 0
    while i < n:
        rel = pos - state["wstart"]
        # slide the window when fewer than `margin` bits remain in it
        if rel + margin > state["bits"].size and not state["last"]:
            load_window(pos)
            rel = pos - state["wstart"]
        if i == group_end:  # group header: 4-bit Rice parameter
            if pos + 4 > total_bits:
                raise ValueError("corrupt rice stream")
            k = int(vtab(4)[rel])
            pos += 4
            rel += 4
            group_end = min(i + group, n)
        z = int(state["nz"][rel]) if rel < state["bits"].size else rel
        if z >= state["bits"].size:
            raise ValueError("corrupt rice stream")  # window is stream end
        q = z - rel
        if q > 48:
            raise ValueError("corrupt rice stream")
        s = z + 1  # past the stop bit
        if q == 48:  # escape: 32 raw bits
            if state["wstart"] + s + 32 > total_bits:
                raise ValueError("corrupt rice stream")
            v16 = vtab(16)
            u = (int(v16[s]) << 16) | int(v16[s + 16])
            pos = state["wstart"] + s + 32
        else:
            if state["wstart"] + s + k > total_bits:
                raise ValueError("corrupt rice stream")
            u = (q << k) | int(vtab(k)[s]) if k else q
            pos = state["wstart"] + s + k
        out[i] = (u >> 1) ^ -(u & 1)
        i += 1
    return out
