"""The ``.acz`` container of the port (counterpart of
``audiocodec_tpu/io/bitstream.py``): byte for byte the JAX package's format,
so that either package reads what the other writes.

Integer spectral codes + the compact Bark-domain masking intensity, packed
with numpy's compressed container. Format (npz members):

  codes     int8/int16/int32 [B, blocks, N, C]  (narrowest dtype that fits)
  bark      uint16 view of bfloat16 [B, blocks, bark_bands_n, C]
  meta      int64 [sample_rate, filters_n, bark_bands_n, channels]
  alphaw    float64 [alpha]; window type in 'window' (str array)
  tns       int8 [B, blocks, order, C] TNS reflection indices + 'tnsmeta'
            int64 [order, band_start]; absent = no temporal noise shaping
  nfl       uint8 [B, blocks, C] noise-fill levels + 'nfmeta' int64
            [band_start, seed]; absent = no noise filling (nf.py)
  bsw       uint8 [B, ceil(blocks/8)] per-frame block-switch flag bitmap
            + 'bswmeta' int64 [factor]; absent = all-long frames
            (blockswitch.py)
  bwe       uint8 [B, blocks, groups, C] bandwidth-extension replication
            gains + 'bwemeta' int64 [start, group]; absent = no
            replication. Written whenever the encoder ran with bwe —
            even all-zero — because its PRESENCE caps the noise fill's
            band at the crossover on both sides (bwe.py).
  isg       uint8 [B, blocks, groups] intensity-stereo image gains +
            'ismeta' int64 [start, group]; absent = fully-coded side.
            Requires ms (intensity.py).
  bark_lvl  2-D-delta run-length-Rice coded integer grid levels of the
            sidecar + 'scq' int64 [k2] (levels per octave, scq.py) —
            replaces the bfloat16 sidecar members when the encoder
            quantized the sidecar to the log grid (the default).
  dzr, nsamp, lufs
            float64 [dz_recon], int64 [orig_samples], float64 [lufs]:
            each written only when it is not its default.

Arrays handed to :func:`pack` may be numpy arrays or torch tensors on any
device (bfloat16 included); each moves to the host once. :func:`unpack`
returns the codes as numpy int32, the sidecar as a CPU ``torch.bfloat16``
tensor, and the members in the meta dict as numpy arrays, as the JAX
package returns them (whose sidecar is an ``ml_dtypes`` array; numpy has
no bfloat16 of its own).
"""

from __future__ import annotations

import io as _io

import numpy as np
import torch


def host(a) -> np.ndarray:
    """A numpy array of ``a`` (numpy, or a torch tensor on any device: one
    copy to the host). bfloat16 tensors come back as their uint16 bits,
    since ``.numpy()`` refuses bfloat16."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    return np.asarray(a)


def bf16_bits(bark16) -> np.ndarray:
    """The uint16 bits of a bfloat16 sidecar: a bfloat16 tensor, a numpy
    bfloat16 array (``ml_dtypes``), or the bits themselves (uint16)."""
    arr = host(bark16)
    if arr.dtype == np.uint16 or arr.dtype.name == "bfloat16":
        return arr.view(np.uint16)
    raise ValueError(
        f"the sidecar must be bfloat16 (or its uint16 bits), got {arr.dtype}"
    )


def bf16_from_bits(bits: np.ndarray) -> torch.Tensor:
    """uint16 bits -> a CPU bfloat16 tensor of the same shape."""
    arr = np.array(bits, dtype=np.uint16, copy=True)
    return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)


def dtype_name(dtype) -> str:
    """The compute dtype as the container records it ("float32",
    "bfloat16", "float64"), from a torch dtype or a name: ``str`` of a
    torch dtype reads "torch.float32", which decoders reject."""
    if isinstance(dtype, str):
        return dtype.removeprefix("torch.")
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _deflated_len(b: bytes) -> int:
    """Size of ``b`` after the container's own deflate (zip level 6) —
    the number that actually lands on disk. Candidate coders must be
    compared POST-deflate: run-length Rice always wins pre-deflate on
    sparse data, but deflate exploits cross-band repetition in plain
    Rice's output that the run-length model cannot see, and on the Bark
    sidecar that reverses the pick (measured)."""
    import zlib

    return len(zlib.compress(b, 6))


def encode_int2d(values: np.ndarray, block_axis: int) -> bytes:
    """2-D delta (blocks then bands — algebraically the JPEG-LS MED
    left+up-upleft prediction) + run-length Rice of an integer field.

    THE one implementation of this bit-critical wire coding: the
    bfloat16 sidecar's "rrice2d" coder and the grid-level sidecar
    (scq.py) both ride it, so the predictor/framing can never diverge
    between them."""
    from audiocodec_tpu_torch import native

    d = np.diff(np.asarray(values, dtype=np.int32), axis=block_axis,
                prepend=0)
    d = np.diff(d, axis=block_axis + 1, prepend=0)
    return native.rrice_encode(d)


def decode_int2d(data: bytes, shape, block_axis: int) -> np.ndarray:
    """Inverse of :func:`encode_int2d` -> int32 array of ``shape``."""
    from audiocodec_tpu_torch import native

    d = native.rrice_decode(data, int(np.prod(shape))).reshape(shape)
    d = np.cumsum(d, axis=block_axis + 1)
    return np.cumsum(d, axis=block_axis)


def encode_bark_sidecar(bark16, block_axis: int, coder: str = "rrice") -> bytes:
    """Delta + Rice coding of the bfloat16 Bark sidecar.

    bfloat16 bit patterns are monotonic for positive floats, so smooth
    intensities give small integer deltas. Coders: "rice"/"rrice" delta
    along blocks only; "rrice2d" additionally deltas along the Bark-band
    axis (``block_axis + 1``).

    :param bark16: bfloat16 (tensor on any device or numpy), or its bits.
    """
    from audiocodec_tpu_torch import native

    bark_i32 = bf16_bits(bark16).astype(np.int32)
    if coder == "rrice2d":
        return encode_int2d(bark_i32, block_axis)
    deltas = np.diff(bark_i32, axis=block_axis, prepend=0)
    enc = native.rrice_encode if coder == "rrice" else native.rice_encode
    return enc(deltas)


def decode_bark_sidecar(data: bytes, shape, block_axis: int,
                        coder: str = "rrice") -> torch.Tensor:
    """Inverse of :func:`encode_bark_sidecar` -> bfloat16 CPU tensor."""
    from audiocodec_tpu_torch import native

    if coder == "rrice2d":
        vals = decode_int2d(data, shape, block_axis)
    else:
        dec = (native.rrice_decode if coder == "rrice"
               else native.rice_decode)
        deltas = dec(data, int(np.prod(shape))).reshape(shape)
        vals = np.cumsum(deltas, axis=block_axis)
    return bf16_from_bits(vals.astype(np.uint16))


def pack(codes, bark16, *, sample_rate, filters_n, bark_bands_n, alpha,
         window_type, compute_dtype="float32",
         entropy: str = "auto", ms: bool = False,
         threshold_scale: float = 1.0,
         bark_precision: str = "highest",
         dz_recon: float = 0.0,
         tns_idx=None, tns_band_start: int = 0,
         nf_levels=None, nf_band_start: int = 0,
         nf_seed: int = 0, bs_flags=None,
         bwe_gains=None, bwe_start: int = 0,
         is_gains=None, is_start: int = 0,
         sidecar_grid: int = 0,
         orig_samples: int = 0, lufs=None) -> bytes:
    """Serialize encoder output to bytes (the JAX package's ``pack``).

    :param entropy: "rice" (native Rice/Golomb coder), "rrice" (run-length
        Rice), "zlib" (narrowest-int codes through the container's
        deflate), or "auto" (whichever of rice/rrice is smaller after
        deflate when the native library is available, zlib otherwise).
    :param compute_dtype: the encoder's dtype (torch dtype or name),
        recorded as "float32", "bfloat16" or "float64": decoders derive
        step sizes in it.
    :param bark_precision: matmul tier the encoder derived thresholds with,
        recorded because the decoder must use the same one.
    :param dz_recon: dead-zone reconstruction offset (quantize.
        dz_recon_offset); written only when nonzero.
    :param tns_idx: int8 [B, blocks, order, C]; written (with
        ``tns_band_start``) only when some frame fired.
    :param nf_levels: uint8 [B, blocks, C]; written (with band start and
        ``nf_seed``) only when some level is nonzero.
    :param bs_flags: bool [B, blocks]; written as a packbits bitmap only
        when some frame switched.
    :param bwe_gains: uint8 [B, blocks, groups, C]; written whenever given,
        even all-zero (its presence caps the noise fill at the crossover).
    :param is_gains: uint8 [B, blocks, groups]; requires ``ms``.
    :param orig_samples: the waveform's pre-padding sample count (0 = not
        recorded); decoders trim back to it (gapless round trips).
    :param lufs: the source's integrated loudness tag (None = untagged).
    """
    from audiocodec_tpu_torch import native

    codes = host(codes)
    bark_bits = bf16_bits(bark16)
    code_bytes = None
    if entropy == "auto":
        if native.available():
            # cost both codings at their POST-deflate size — the number
            # that actually hits the disk (see _deflated_len)
            plain = native.rice_encode(codes)
            rle = native.rrice_encode(codes)
            entropy, code_bytes = (
                ("rrice", rle)
                if _deflated_len(rle) < _deflated_len(plain)
                else ("rice", plain)
            )
        else:
            entropy = "zlib"

    members = {}
    if entropy in ("rice", "rrice"):
        if code_bytes is None:
            code_bytes = (
                native.rrice_encode(codes) if entropy == "rrice"
                else native.rice_encode(codes)
            )
        members[entropy] = np.frombuffer(code_bytes, dtype=np.uint8)
        members["shape"] = np.asarray(codes.shape, dtype=np.int64)
        if sidecar_grid:
            # grid-quantized sidecar (scq.py): ship the small-integer levels
            from audiocodec_tpu_torch import scq as _scq

            _scq.validate_k2(int(sidecar_grid))
            lv = _scq.levels_from_bark16(bf16_from_bits(bark_bits),
                                         int(sidecar_grid))
            members["bark_lvl"] = np.frombuffer(
                _scq.encode_levels(lv, block_axis=1), dtype=np.uint8
            )
            members["scq"] = np.asarray([int(sidecar_grid)],
                                        dtype=np.int64)
        else:
            # sidecar_grid=0 is the legacy-compatible mode: the raw
            # bfloat16 sidecar through the coders pre-scq decoders know,
            # the smaller after deflate
            candidates = [
                ("bark_" + c, encode_bark_sidecar(bark_bits, block_axis=1,
                                                  coder=c))
                for c in ("rice", "rrice")
            ]
            bname, side = min(
                candidates, key=lambda kv: _deflated_len(kv[1])
            )
            members[bname] = np.frombuffer(side, dtype=np.uint8)
        members["bark_shape"] = np.asarray(bark_bits.shape, dtype=np.int64)
    else:
        packed = codes
        for dt in (np.int8, np.int16, np.int32):
            if (
                codes.min() >= np.iinfo(dt).min
                and codes.max() <= np.iinfo(dt).max
            ):
                packed = codes.astype(dt)
                break
        members["codes"] = packed

    if "bark_shape" not in members:
        # no coded sidecar was written (bark_shape rides with every coded
        # one): ship the raw bfloat16 bits
        members["bark"] = bark_bits
    if dz_recon:
        if not -1.0 <= dz_recon <= 2.0:
            raise ValueError(f"dz_recon out of range: {dz_recon}")
        members["dzr"] = np.asarray([dz_recon], dtype=np.float64)
    if tns_idx is not None:
        arr = np.ascontiguousarray(host(tns_idx), dtype=np.int8)
        if arr.ndim != 4 or arr.shape[0] != codes.shape[0] \
                or arr.shape[1] != codes.shape[1] \
                or arr.shape[3] != codes.shape[3]:
            raise ValueError(
                f"tns_idx shape {arr.shape} does not match codes "
                f"{codes.shape}"
            )
        if arr.any():  # all-zero = no frame fired = identity filter
            if not 0 < tns_band_start < filters_n:
                raise ValueError(
                    f"tns_band_start out of range: {tns_band_start}"
                )
            members["tns"] = arr
            members["tnsmeta"] = np.asarray(
                [arr.shape[2], tns_band_start], dtype=np.int64
            )
    if nf_levels is not None:
        arr = np.ascontiguousarray(host(nf_levels), dtype=np.uint8)
        if arr.shape != (codes.shape[0], codes.shape[1], codes.shape[3]):
            raise ValueError(
                f"nf_levels shape {arr.shape} does not match codes "
                f"{codes.shape}"
            )
        if arr.any():  # all-zero = nothing to fill
            if not 0 <= nf_band_start < filters_n:
                raise ValueError(
                    f"nf_band_start out of range: {nf_band_start}"
                )
            if not 0 <= int(nf_seed) < 2**32:
                raise ValueError(f"nf_seed out of range: {nf_seed}")
            members["nfl"] = arr
            members["nfmeta"] = np.asarray(
                [nf_band_start, int(nf_seed)], dtype=np.int64
            )
    if bwe_gains is not None:
        from audiocodec_tpu_torch import bwe as _bwe_mod

        arr = np.ascontiguousarray(host(bwe_gains), dtype=np.uint8)
        _bwe_mod.validate_start(filters_n, int(bwe_start))
        groups = _bwe_mod.n_groups(filters_n, int(bwe_start))
        if arr.shape != (
            codes.shape[0], codes.shape[1], groups, codes.shape[3]
        ):
            raise ValueError(
                f"bwe_gains shape {arr.shape} does not match codes "
                f"{codes.shape} at start {bwe_start}"
            )
        members["bwe"] = arr
        members["bwemeta"] = np.asarray(
            [int(bwe_start), _bwe_mod.GROUP], dtype=np.int64
        )
    if is_gains is not None:
        from audiocodec_tpu_torch import intensity as _is_mod

        if not ms:
            raise ValueError("intensity gains require ms=True")
        arr = np.ascontiguousarray(host(is_gains), dtype=np.uint8)
        _is_mod.validate_start(filters_n, int(is_start))
        groups = _is_mod.n_groups(filters_n, int(is_start))
        if arr.shape != (codes.shape[0], codes.shape[1], groups):
            raise ValueError(
                f"is_gains shape {arr.shape} does not match codes "
                f"{codes.shape} at start {is_start}"
            )
        members["isg"] = arr
        members["ismeta"] = np.asarray(
            [int(is_start), _is_mod.GROUP], dtype=np.int64
        )
    if lufs is not None:
        lv = float(lufs)
        if not LUFS_MIN <= lv <= LUFS_MAX:
            raise ValueError(f"lufs out of range: {lv}")
        members["lufs"] = np.asarray([lv], dtype=np.float64)
    if orig_samples:
        max_len = codes.shape[1] * filters_n
        if not 0 < int(orig_samples) <= max_len:
            raise ValueError(
                f"orig_samples={orig_samples} outside (0, {max_len}]"
            )
        members["nsamp"] = np.asarray([int(orig_samples)], dtype=np.int64)
    if bs_flags is not None:
        arr = host(bs_flags)
        if arr.shape != (codes.shape[0], codes.shape[1]):
            raise ValueError(
                f"bs_flags shape {arr.shape} does not match codes "
                f"{codes.shape}"
            )
        if arr.any():  # all-long = nothing to record
            from audiocodec_tpu_torch import blockswitch as _bs

            members["bsw"] = _bs.pack_flags(torch.from_numpy(
                np.array(arr, dtype=bool)))
            members["bswmeta"] = np.asarray([_bs.FACTOR], dtype=np.int64)
    buf = _io.BytesIO()
    np.savez_compressed(
        buf,
        meta=np.asarray(
            [sample_rate, filters_n, bark_bands_n, codes.shape[-1]],
            dtype=np.int64,
        ),
        alphaw=np.asarray([alpha], dtype=np.float64),
        window=np.asarray(
            [window_type if window_type is not None else ""]
        ),
        # the decoder must derive step sizes in the SAME dtype the encoder
        # quantized against, or thresholds diverge by the dtype's epsilon
        dtype=np.asarray([dtype_name(compute_dtype)]),
        ms=np.asarray([1 if ms else 0], dtype=np.int64),
        tscale=np.asarray([threshold_scale], dtype=np.float64),
        barkprec=np.asarray([str(bark_precision)]),
        **members,
    )
    return buf.getvalue()


def _checked_shape(raw, payload_bytes, what, max_per_byte=8):
    """Validate an untrusted shape member before allocating: positive dims
    and a total the payload can actually carry — otherwise a tampered
    container demands a terabyte allocation before any decode error can
    fire. Plain Rice spends >= 1 bit per value (8 values/byte); run-length
    Rice amortizes a 256-zero group to 22 bits, capping at ~93 values per
    byte (pass max_per_byte=96)."""
    shape = tuple(int(v) for v in raw)
    if len(shape) != 4 or any(d <= 0 for d in shape):
        raise ValueError(f"corrupt container: bad {what} {shape}")
    total = 1
    for d in shape:
        total *= d
    if total > max_per_byte * max(payload_bytes, 1):
        raise ValueError(
            f"corrupt container: {what} demands {total} values from a "
            f"{payload_bytes}-byte payload"
        )
    return shape, total


def _bounded_member(z, name, data_len, max_bytes=None):
    """Read an npz member only after bounding its DECLARED uncompressed
    size (the zip central directory field an attacker controls) against
    what deflate can actually have produced from this container —
    otherwise a ~1 MB bomb makes np.load allocate terabytes before any
    validation runs. DEFLATE tops out near 1030:1. ``max_bytes`` gives
    header-like members (meta, window, shapes, …) a tight absolute cap."""
    cap = max(2048 * data_len, 1 << 20) if max_bytes is None else max_bytes
    zf = getattr(z, "zip", None)
    if zf is not None:
        info = zf.NameToInfo.get(name + ".npy")
        if info is not None and info.file_size > cap:
            raise ValueError(
                f"corrupt .acz container: member {name} declares "
                f"{info.file_size} bytes from a {data_len}-byte container"
            )
    try:
        return z[name]
    except KeyError:
        raise  # callers map missing members to their own message
    except Exception as e:
        # numpy's npy-header parser raises whatever its tokenizer or
        # struct layer happens to hit on corrupt bytes (TokenError,
        # SyntaxError, UnicodeDecodeError, struct.error, ...). Corrupt
        # containers raise ValueError, never a parser internal.
        raise ValueError(
            f"corrupt container: unreadable member {name} "
            f"({type(e).__name__}: {e})"
        ) from e


# Absolute size cap for header-like members (a dtype/window string array
# is < 200 bytes, shapes are 4 int64s)
_SMALL_MEMBER_CAP = 1 << 16

# Accepted range for the loudness tag, for the writers and the readers
LUFS_MIN, LUFS_MAX = -150.0, 20.0


def unpack(data: bytes):
    """Deserialize -> (codes int32 numpy, bark bfloat16 CPU tensor, meta
    dict).

    Raises ValueError on corrupt input (bad archive, missing or truncated
    or tampered members) — never a raw zipfile/KeyError/IndexError, and
    never a huge allocation driven by attacker-declared sizes."""
    import zipfile
    import zlib

    try:
        ctx = np.load(_io.BytesIO(data), allow_pickle=False)
    except (
        zipfile.BadZipFile, zlib.error, OSError, EOFError,
        NotImplementedError,  # tampered version-needed / compression fields
        RuntimeError,  # tampered encryption flag bits
    ) as e:
        raise ValueError(f"corrupt .acz container: {e}") from e
    if not hasattr(ctx, "files"):  # a bare .npy payload, not an archive
        raise ValueError("corrupt .acz container: not an npz archive")
    try:
        return _unpack_members(ctx, len(data))
    except KeyError as e:
        raise ValueError(f"corrupt .acz container: missing member {e}") from e
    except (IndexError, TypeError) as e:
        raise ValueError(f"corrupt .acz container: malformed member ({e})") from e
    except (
        zipfile.BadZipFile, zlib.error, OSError, EOFError,
        NotImplementedError,  # tampered compression-method field
        RuntimeError,  # tampered encryption flag bits ("password required")
    ) as e:
        # lazy member reads re-enter zipfile: a corrupted member payload
        # (bad CRC, truncated deflate stream) surfaces HERE, not at np.load
        raise ValueError(f"corrupt .acz container: bad member data ({e})") from e
    finally:
        ctx.close()


def _unpack_members(z, data_len):
    def small(name):
        return _bounded_member(z, name, data_len, _SMALL_MEMBER_CAP)

    if "rice" in z.files or "rrice" in z.files:
        from audiocodec_tpu_torch import native

        name = "rrice" if "rrice" in z.files else "rice"
        rice = _bounded_member(z, name, data_len)
        shape, total = _checked_shape(
            small("shape"), rice.nbytes, "codes shape",
            max_per_byte=96 if name == "rrice" else 8,
        )
        decode = (
            native.rrice_decode if name == "rrice" else native.rice_decode
        )
        codes = decode(rice.tobytes(), total).reshape(shape)
    else:
        codes = _bounded_member(z, "codes", data_len).astype(np.int32)
        if codes.ndim != 4:
            raise ValueError("corrupt container: codes must be 4-D")
    bark_names = {
        "bark_rice": "rice", "bark_rrice": "rrice",
        "bark_rrice2d": "rrice2d",
    }
    bname = next((nm for nm in bark_names if nm in z.files), None)
    if "bark_lvl" in z.files:
        from audiocodec_tpu_torch import scq as _scq

        sm = small("scq")
        if len(sm) != 1:
            raise ValueError("corrupt container: bad scq member")
        try:
            _scq.validate_k2(int(sm[0]))
        except ValueError as e:
            raise ValueError(
                f"container sidecar grid unsupported: {e} — newer "
                "framework version?"
            ) from None
        lvl_bytes = _bounded_member(z, "bark_lvl", data_len)
        bshape, total = _checked_shape(
            small("bark_shape"), lvl_bytes.nbytes, "bark shape",
            max_per_byte=96,
        )
        try:
            bark = _scq.bark16_from_levels(
                _scq.decode_levels(lvl_bytes.tobytes(), bshape,
                                   block_axis=1),
                int(sm[0]), bshape, device="cpu",
            )
        except ValueError as e:
            raise ValueError(f"corrupt container: {e}") from None
    elif bname is not None:
        bark_rice = _bounded_member(z, bname, data_len)
        bshape, _ = _checked_shape(
            small("bark_shape"), bark_rice.nbytes, "bark shape",
            max_per_byte=8 if bname == "bark_rice" else 96,
        )
        bark = decode_bark_sidecar(
            bark_rice.tobytes(), bshape, block_axis=1,
            coder=bark_names[bname],
        )
    else:
        bark = bf16_from_bits(
            _bounded_member(z, "bark", data_len).view(np.uint16))
        if bark.ndim != 4:
            raise ValueError("corrupt container: bark must be 4-D")
    meta_arr = small("meta")
    window = str(small("window")[0]) or None
    alpha = float(small("alphaw")[0])
    dtype = str(small("dtype")[0]) if "dtype" in z.files else "float32"
    ms = bool(int(small("ms")[0])) if "ms" in z.files else False
    tscale = float(small("tscale")[0]) if "tscale" in z.files else 1.0
    barkprec = (
        str(small("barkprec")[0]) if "barkprec" in z.files else "highest"
    )
    dzr = float(small("dzr")[0]) if "dzr" in z.files else 0.0
    if not (-1.0 <= dzr <= 2.0):
        raise ValueError("corrupt container: dzr out of bounds")
    tns_idx, tns_band_start = None, 0
    if "tns" in z.files:
        tns_idx = np.asarray(_bounded_member(z, "tns", data_len))
        tm = small("tnsmeta")
        if len(tm) != 2:
            raise ValueError("corrupt container: bad tnsmeta")
        tns_order, tns_band_start = int(tm[0]), int(tm[1])
        if (
            tns_idx.dtype != np.int8
            or tns_idx.ndim != 4
            or not (1 <= tns_order <= 32)
            or tns_idx.shape[2] != tns_order
            or tns_idx.shape[:2] != codes.shape[:2]
            or tns_idx.shape[3] != codes.shape[3]
            or not (tns_order < tns_band_start < codes.shape[2])
        ):
            raise ValueError(
                f"corrupt container: tns member shape {tns_idx.shape} / "
                f"band_start {tns_band_start} inconsistent with codes "
                f"{codes.shape}"
            )
    nf_levels, nf_band_start, nf_seed = None, 0, 0
    if "nfl" in z.files:
        nf_levels = np.asarray(_bounded_member(z, "nfl", data_len))
        nm = small("nfmeta")
        if len(nm) != 2:
            raise ValueError("corrupt container: bad nfmeta")
        nf_band_start, nf_seed = int(nm[0]), int(nm[1])
        if (
            nf_levels.dtype != np.uint8
            or nf_levels.ndim != 3
            or nf_levels.shape != (
                codes.shape[0], codes.shape[1], codes.shape[3]
            )
            or not (0 <= nf_band_start < codes.shape[2])
            or not (0 <= nf_seed < 2**32)
        ):
            raise ValueError(
                f"corrupt container: nfl member shape {nf_levels.shape} / "
                f"band_start {nf_band_start} inconsistent with codes "
                f"{codes.shape}"
            )
    bwe_gains, bwe_start = None, 0
    if "bwe" in z.files:
        from audiocodec_tpu_torch import bwe as _bwe_mod

        bwe_gains = np.asarray(_bounded_member(z, "bwe", data_len))
        bm = small("bwemeta")
        if len(bm) != 2:
            raise ValueError("corrupt container: bad bwemeta")
        bwe_start, bwe_group = int(bm[0]), int(bm[1])
        if bwe_group != _bwe_mod.GROUP:
            # the fill derives group slices and the copy-up map from
            # GROUP; refuse a mismatch instead of decoding wrong audio
            raise ValueError(
                f"container uses bwe group width {bwe_group}; this "
                f"decoder supports {_bwe_mod.GROUP} (newer framework "
                "version?)"
            )
        try:
            _bwe_mod.validate_start(codes.shape[2], bwe_start)
        except ValueError as e:
            raise ValueError(f"corrupt container: {e}") from None
        if (
            bwe_gains.dtype != np.uint8
            or bwe_gains.ndim != 4
            or bwe_gains.shape != (
                codes.shape[0], codes.shape[1],
                _bwe_mod.n_groups(codes.shape[2], bwe_start),
                codes.shape[3],
            )
        ):
            raise ValueError(
                f"corrupt container: bwe member shape {bwe_gains.shape} "
                f"/ start {bwe_start} inconsistent with codes "
                f"{codes.shape}"
            )
    is_gains, is_start = None, 0
    if "isg" in z.files:
        from audiocodec_tpu_torch import intensity as _is_mod

        is_gains = np.asarray(_bounded_member(z, "isg", data_len))
        im = small("ismeta")
        if len(im) != 2:
            raise ValueError("corrupt container: bad ismeta")
        is_start, is_group = int(im[0]), int(im[1])
        if is_group != _is_mod.GROUP:
            raise ValueError(
                f"container uses intensity group width {is_group}; "
                f"this decoder supports {_is_mod.GROUP} (newer "
                "framework version?)"
            )
        try:
            _is_mod.validate_start(codes.shape[2], is_start)
        except ValueError as e:
            raise ValueError(f"corrupt container: {e}") from None
        if (
            is_gains.dtype != np.uint8
            or is_gains.ndim != 3
            or is_gains.shape != (
                codes.shape[0], codes.shape[1],
                _is_mod.n_groups(codes.shape[2], is_start),
            )
            or codes.shape[3] != 2
        ):
            raise ValueError(
                f"corrupt container: isg member shape {is_gains.shape} "
                f"/ start {is_start} inconsistent with codes "
                f"{codes.shape}"
            )
    bs_flags, bs_factor = None, 0
    if "bsw" in z.files:
        from audiocodec_tpu_torch import blockswitch as _bs

        bsw = np.asarray(small("bsw"))
        bm = small("bswmeta")
        if len(bm) != 1:
            raise ValueError("corrupt container: bad bswmeta")
        bs_factor = int(bm[0])
        if (
            bsw.dtype != np.uint8
            or bsw.ndim != 2
            or bsw.shape[0] != codes.shape[0]
            or bsw.shape[1] * 8 < codes.shape[1]
            or codes.shape[2] % max(bs_factor, 1)
        ):
            raise ValueError(
                f"corrupt container: bsw member shape {bsw.shape} / "
                f"factor {bs_factor} inconsistent with codes "
                f"{codes.shape}"
            )
        if bs_factor != _bs.FACTOR:
            # the decode paths derive pooling groups and the inverse
            # basis from FACTOR; refuse a different recorded factor
            raise ValueError(
                f"container uses block-switch factor {bs_factor}; this "
                f"decoder supports {_bs.FACTOR} (newer framework "
                "version?)"
            )
        bs_flags = _bs.unpack_flags(bsw, codes.shape[1], device="cpu").numpy()
    meta = {
        "sample_rate": int(meta_arr[0]),
        "filters_n": int(meta_arr[1]),
        "bark_bands_n": int(meta_arr[2]),
        "channels": int(meta_arr[3]),
        "alpha": alpha,
        "window_type": window,
        "compute_dtype": dtype,
        "ms": ms,
        "threshold_scale": tscale,
        "bark_precision": barkprec,
        "dz_recon": dzr,
        "tns_idx": tns_idx,
        "tns_band_start": tns_band_start,
        "nf_levels": nf_levels,
        "nf_band_start": nf_band_start,
        "nf_seed": nf_seed,
        "bs_flags": bs_flags,
        "bs_factor": bs_factor,
        "sidecar_grid": (
            int(small("scq")[0]) if "bark_lvl" in z.files else 0
        ),
        "bwe_gains": bwe_gains,
        "bwe_start": bwe_start,
        "is_gains": is_gains,
        "is_start": is_start,
        "orig_samples": (
            int(small("nsamp")[0]) if "nsamp" in z.files else 0
        ),
        "lufs": (
            float(small("lufs")[0]) if "lufs" in z.files else None
        ),
    }
    if not (0 < meta["sample_rate"] <= 10_000_000):
        raise ValueError("corrupt container: sample_rate out of bounds")
    if not (2 <= meta["filters_n"] <= 1 << 16) or meta["filters_n"] % 2:
        raise ValueError("corrupt container: filters_n out of bounds")
    if not (1 <= meta["bark_bands_n"] <= 1 << 16):
        raise ValueError("corrupt container: bark_bands_n out of bounds")
    if not (1 <= meta["channels"] <= 64):
        raise ValueError("corrupt container: channels out of bounds")
    if not (0 <= meta["orig_samples"] <=
            codes.shape[1] * meta["filters_n"]):
        raise ValueError("corrupt container: nsamp out of bounds")
    if meta["lufs"] is not None and not (
        np.isfinite(meta["lufs"])
        and LUFS_MIN <= meta["lufs"] <= LUFS_MAX
    ):
        raise ValueError("corrupt container: lufs out of bounds")
    # cross-check payload shapes against the validated meta so a
    # shape/meta mismatch fails HERE, not as a raw shape error deep
    # inside the decoder
    if is_gains is not None and not ms:
        # the fill rebuilds side = gain * mid; without the mid/side
        # layout it would scale an unrelated channel into another
        raise ValueError(
            "corrupt container: intensity gains without joint stereo"
        )
    bark_ch = 1 if ms else meta["channels"]
    if (
        codes.shape[2] != meta["filters_n"]
        or codes.shape[3] != meta["channels"]
        or bark.shape[2] != meta["bark_bands_n"]
        or bark.shape[3] != bark_ch
        or bark.shape[1] != codes.shape[1]
        or bark.shape[0] != codes.shape[0]
    ):
        raise ValueError(
            f"corrupt container: payload shapes codes{codes.shape} / "
            f"bark{tuple(bark.shape)} do not match header "
            f"(N={meta['filters_n']}, bark={meta['bark_bands_n']}, "
            f"ch={meta['channels']}, ms={ms})"
        )
    return codes, bark, meta


def save(path: str, codes, bark16, **meta) -> int:
    """Pack and write to disk; returns the byte size."""
    data = pack(codes, bark16, **meta)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def load(path: str):
    """Read and :func:`unpack` an ``.acz`` file."""
    with open(path, "rb") as f:
        return unpack(f.read())
