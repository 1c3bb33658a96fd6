#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from audiocodec_tpu_torch/csrc/; each of the
   ten ``tc_kernel`` instances and the three ``probe_kernel`` ones
   (bf16, int8, int8g) must hold warpgroup MMA (HGMMA or IGMMA) and TMA
   load (UTMALDG) instructions in its SASS (cuobjdump), each
   ``split_gemm_kernel`` instance (the split tiers and the radix products)
   bf16 HGMMA into float32 (``HGMMA.*.F32.BF16``) and UTMALDG, and no
   FFMA or WMMA GEMM (``ffma_gemm_kernel``, ``mma_gemm_kernel``) is left
   in the library;
3. hold each kernel against its plain torch version on the card, at the
   main path's shapes and at every tier the path uses, plus ``highest``
   and ``high`` (the int8 tiers bit for bit); the mono kernels also at 5
   rows of 1, 127 and 129 frames (tiles of 64 or 128 frames, no full
   wave), with their registers, spills and shared memory, and the bare
   product's time through ``torch.matmul`` (bf16) and ``torch._int_mm``
   (int8) beside them as yardsticks the port never calls;
4. run ``Codec.round_trip_quantized`` at full width (44.1 kHz, N=1024, 64
   Bark bands, 32 mono clips of 10 s) in the three configurations of
   bench.py: (a) bf16 int8, (b) bf16 default, (c) f32 default. Each kernel
   must launch exactly once per call, and the quantized SNR must be within
   0.05 dB of the same codec with its kernels swapped for their plain
   versions;
5. an f32 ``highest`` MDCT round trip through the kernels must reach
   130 dB SNR (the ``high`` one is printed);
6. time the kernels against their plain versions with CUDA events, and the
   three configurations in audio-seconds per second with the device time of
   each of their stages;
7. the noise kernel against its plain version at [32, 431, 1024, 1] in
   float32 and bfloat16, and there at counts that are not a multiple of 8
   and from a base one element in (its scalar path): its uniforms equal the
   plain generator's bit for bit (the full count, a ragged one and 1-9),
   its output is within tolerance, the noise of spectrum 0 and threshold 1
   has the moments of N(0, 1/36), and a seed reproduces its output while
   another seed does not;
8. the radix kernels against their plain versions at N=2048, [32, 215,
   2048] -> [32, 216, 2048], at ``highest`` (float32) and ``default``
   (bfloat16), and the mono kernels there at ``highest``, ``high``,
   ``default`` and int8 (bit for bit);
9. ``Codec.round_trip`` and ``round_trip_fast`` at full width in three
   configurations: (r) float32 ``highest``, N=1024, mono design (the
   reference's configuration); (r2) float32 ``highest``, N=2048, radix
   design; (b) bfloat16 ``fast_bf16`` ``default``, N=1024. Each kernel of
   the path launches exactly once a call, and the SNR is within 0.05 dB of
   the same codec with every kernel swapped for its plain version and the
   same seed or generator;
10. an f32 ``highest`` MDCT round trip through the radix kernels at N=2048
   must reach 125 dB and come within 1 dB of their plain versions'; the
   mono and radix designs are timed side by side in ``round_trip_fast`` at
   N=2048, at ``highest`` and bf16 ``default``, and the mono design at
   ``high`` and int8 (its one-pass kernels run K in two passes there);
11. each VJP (``ops/cuda_mdct.py`` ``*_vjp``) against
   ``torch.autograd.grad`` through its plain forward version on the same
   seeded cotangent, at the main path's shapes: mono [32, 430, 1024] at f32
   ``highest``, f32 ``high``, f32 ``default``, bf16 ``default`` and int8
   (straight-through: against the ``default`` forward on the dequantized
   matrix), radix [32, 215, 2048] at f32 ``highest`` and bf16 ``default``;
   each timed against its plain version and a conv1d / conv_transpose1d
   call of the same function. Each VJP is one call of the other direction's
   route in a transposed mode that reads the cotangent in place (the
   synthesis VJPs: the analysis route's transposed fold; the analysis VJPs:
   the synthesis route's transposed scatter) and must equal the flip route
   (the other direction's wrapper on the reversed cotangent, lane-swapped
   before it for the synthesis VJPs and after it for the analysis ones,
   reversed and cut; composed here, and timed) bit for bit at every tier,
   there and at 5 rows of 1, 127 and 129 frames, and its trace must hold
   the route's device functions only;
12. training at full width (32 mono clips of 10 s, 64 Bark bands), Adam
   1e-3: ``SpectralAE(1024, 512, 64, 1/32)`` in (r) f32 ``highest`` and (b)
   bf16 ``default``, the per-band-gain trainer in (r2) f32 ``highest``
   N=2048 radix and (a) bf16 int8, ``PostFilter(1024, 512)`` in (c) f32
   ``default``. Each step launches the analysis, the synthesis and the
   synthesis VJP once and no other kernel; the first step's loss and
   gradients agree with the all-plain step's (``TRAIN_TOL``); five steps
   stay finite; ms per step, training audio-s/s and peak memory;
13. the gradient of ``inverse_transform(transform(x))`` with respect to
   the waveform in every configuration of phase 11 ((r) and (r2) among
   them), which fires both VJPs, against the all-plain gradient;
14. the int8 probe (``python -m audiocodec_tpu_torch.probes.int8_probe``,
   x [14336, 1024] float32 @ the DCT-IV matrix) through its entry point,
   which must launch each of its three kernels (bf16, int8, int8g); each
   kernel against its plain version at 14336 rows and at 1, 127 and 1000
   (int8 and int8g bit for bit, bf16 within 1e-5 of the peak), its SNR
   within 0.05 dB of its plain version's, with ``torch.matmul`` (bf16,
   on x already in bf16, and after ``x.to(bfloat16)``, the library path
   from the same float32 x, with the bytes each moves) and
   ``torch._int_mm`` (int8) at the same shape as library calls, and each
   kernel's shared memory equal to ``cuda_probe.shared_bytes``;
15. the discrete RVQ codec at full width in (r): ``SpectralAE(1024, 512,
   64, 1/32)`` + ``RVQ(4, 1024, 64)``. Serving (``encode_discrete``,
   ``pack_codes``, ``unpack_codes``, ``decode_discrete``) launches the
   analysis and the synthesis once, the codes survive the pack bit for
   bit, at least 99.9% of them equal the all-plain encode's, and the
   decode is within the synthesis tolerance of the all-plain decode of the
   same codes; three training steps (``warmup_steps=1``) each launch the
   analysis, the synthesis and its VJP once, and the first step's loss
   and gradients meet ``TRAIN_TOL`` against the all-plain step; ms,
   audio-s/s and peak memory;
16. the bitstream feature ladder at full width through its entry points
   (``Codec.encode_frames`` on ``mdct.transform``, then
   ``decode_bitstream``/``decode_bitstream_ms``), in the CLI's presets:
   "music" (TNS, block switching, dead zone 0.7) on 32 mono clips of 10 s
   in (r), "low" (mid/side, TNS, block switching, noise fill, temporal
   masking 130 dB/s, bandwidth extension, intensity stereo, dead zone 1.0,
   noise seed 5) on 16 stereo clips of 10 s in (r) and (b), on tones, noise,
   attacks after gaps and impulses. Each encode launches ``fold_matmul``
   once and each decode ``matmul_scatter`` once, and no other kernel; TNS,
   block switching and noise filling fire; the payload meets the same
   codec's with every kernel swapped for its plain version (codes at least
   99.9% equal, each within one step; the sidecar's grid levels, TNS
   indices, nf levels, bwe and intensity gains and block-switch flags at
   least 99.9% equal, at float32 each within one level); the kernels' and
   the plain versions' decodes of one payload agree within ``tolerance``'s
   synthesis bound; the SNR is within 0.05 dB of the all-plain codec's; the
   noise fill's threefry draw [16, 431, 416, 2] on the card equals the
   CPU's bit for bit. Printed: the share of frames where each feature
   fired, ms and audio-s/s of an encode and a decode (CUDA events), each
   stage's device ms run alone, the draw's ms with and without its key
   derivation, and the traced split and idle share;
17. the .acz clip path, the CLI's non-chunked encode and decode composed
   from the port's library calls in (r) with the native host library
   (``audiocodec_tpu_torch.native``, built with g++; the phase fails
   without it, and on any zlib-coded container): the six lossy golden
   vectors (tests/vectors/) decode on the card through ``io.bitstream.load``
   with codes equal to the manifest's sha256 and PCM within 4 LSB; a 60 s
   stereo PCM16 file written by ``native.write_wav`` is read back by
   ``native.decode_wav`` (equal to ``io.wav.read_wav``'s samples), padded
   to whole blocks, encoded with the "music" preset (TNS, block switching,
   plain rounding), saved, loaded, decoded, trimmed and written: the
   output has the input's sample count, the loaded codes equal the
   encoded ones, the container is Rice-coded, the encode launches one
   ``fold_matmul`` and the decode one ``matmul_scatter``, codes at least
   99.9% equal (each within one step) and SNR within 0.05 dB of the same
   path with every kernel plain; the "low" preset (mid/side) on phase
   16's 16 stereo clips is rate-controlled to 40 kbps
   (``rate.encode_with_target_bitrate_batch``: one ``fold_matmul`` for the
   whole search), every clip within 15% of the target, every winning
   container Rice-coded and decoding through ``decode_bitstream_ms``, and
   where a clip's scale equals the all-plain search's, its SNR within 0.05
   dB. Printed: each step's ms (WAV read, transform + encode_frames, pack,
   unpack, decode, WAV write), audio-s/s both ways, and the search's wall
   ms, traced device busy ms, idle share and host spans (``rate.*``);
18. the .acs stream path (``audiocodec_tpu_torch.streaming`` and
   ``io.stream_container``) in BASELINE.md's configuration 5: 48 kHz
   stereo, N=1024, 64 Bark bands, chunks of 256 blocks, (r). The streaming
   drivers on 60 s equal the batch transforms (max-abs printed, held to the
   tier's tolerance) in (r) and (b) with chunks of 256 and 7 blocks, one
   kernel launch a step and one for the flush; ``encode_stream`` and
   ``decode_stream`` of ``--stream-seconds`` (600: 110 chunks) launch
   ``fold_matmul`` once a chunk and for the flush frame, ``matmul_scatter``
   once a chunk, for the flush chunk and the tail, with codes and sidecar
   levels at least 99.9% equal to the all-plain stream's (levels within
   one grid step, codes within one step where the levels are equal) and
   the decode equal to the plain synthesis's decode of the same file
   within the synthesis tolerance (both SNRs and the all-plain stream's
   are printed); seeks from chunk 1 and the
   middle equal the full decode bit for bit; on 60 s the feature ladder
   (mid/side, TNS, noise fill, block switching, bandwidth extension,
   intensity) with FEC and without, one chunk corrupted: the decode raises
   without concealment, and with it (the FEC rebuild; the interpolating
   concealment, whose signs equal the CPU's threefry draw) matches the
   CPU's decode of the same chunks within the synthesis tolerance; a DTX
   stream (-60 dBFS) over silence and a noise floor; a CBR stream at 64
   kbps with a 64 kbit reservoir, every prefix within its excursion bound;
   the golden vector cbr_stream.acs (codes' sha256, PCM within 4 LSB).
   Printed, each with the card's name and power limit: audio-s/s each way,
   the time to a seek's first chunk, and a traced encode and decode of 4
   chunks (device busy, idle share, host spans ``stream.*``);
19. the command line (``python -m audiocodec_tpu_torch``) through
   ``main([...])`` in-process at its defaults ((r), sidecar grid 4) on a
   60 s 44.1 kHz stereo PCM16 file and 10 s of 24-bit stereo, written
   from a numpy seed: ``encode --preset music`` to ``.acz`` and ``decode``
   launch one ``fold_matmul`` and one ``matmul_scatter``, the output has
   the input's length, the codes are at least 99.9% equal to the same
   commands' with every kernel plain (within one step where the sidecar
   levels are equal, the levels within one grid step), the decode is
   within 4 LSB of the plain synthesis's decode of the same file and its
   SNR within 0.05 dB of the all-plain CLI's; a ``.acs`` stream's
   ``--start 20 --duration 10`` window equals the full decode's samples;
   ``--lossless`` at levels 1 and 2 and a window of it decode bit for
   bit, and so do the golden vectors lossless_v2/v3 on the card;
   ``resample --rate 48000`` (the resampler within 1e-5 of the peak of
   its plain CPU run) and ``encode --resample-to 48000``; ``eval --json``
   launches two ``fold_matmul`` and is within 1e-3 dB (SNRs, NMR) and
   0.01 LU (loudness) of the same command on the CPU; the
   ``--tag-loudness`` tag equals the CPU's loudness and
   ``--normalize-lufs`` reads it; ``python -m audiocodec_tpu_torch info``
   runs in a subprocess. Printed, with the card's name and power limit:
   each command's wall ms and audio-s/s (the second of two calls) and
   the loudness pass alone (ms, kernel launches);
20. serving: ``python -m audiocodec_tpu_torch serve --port 0`` at its
   defaults in two subprocesses, at 44.1 kHz and 48 kHz (the port read
   from each one's first line; SIGINT, exit code 0). 8 client threads
   (``serve.Client``) send 8 encode requests each of 2 s 44.1 kHz mono
   PCM16 (after a warm-up round), then a 'D' of each response: codes at
   least 99.99% equal to the solo encode on the card, each decode within
   1 LSB of the offline decode; a 'B'/'C'/'F' session of 60 s of 48 kHz
   stereo in chunks of 256 blocks equals offline ``encode_stream`` on the
   card byte for byte, and a 'J'/'K'/'L' session of its bytes equals
   ``decode_stream`` bit for bit. The servers' 'Q' stats count their MDCT
   launches: one ``fold_matmul`` a batch group and one ``matmul_scatter``
   a 'D'; chunks + 1 of each in the sessions (the flush; the tail). An
   in-process server's batch cycle of 8 requests is traced. Printed:
   audio-s/s of the requests and the sessions, the 'Q' line, the batch
   count, the traced device busy time and idle share;
21. the bulk corpus, BASELINE.md's configuration 4 (``--corpus-clips``,
   default 1,000 clips of 10 s 44.1 kHz mono PCM16, written under
   ``build/chip_smoke/`` and removed after), through ``main([...])``:
   ``corpus --batch 64`` (one ``fold_matmul`` a batch),
   ``corpus-decode`` (one ``matmul_scatter`` a batch), ``corpus --cache``
   building the PCM cache and once more from it (traced); 16 sampled
   clips' codes at least 99.99% equal to their solo encode and their
   decoded WAVs within 1 LSB of the solo decode, the cached run's
   containers equal to the uncached run's member for member; ``--kbps
   64`` on 64 clips (one ``fold_matmul``, every clip within 15%);
   ``corpus --lossless`` of four 24-bit stereo files and its
   ``corpus-decode`` bit for bit. Printed: each command's wall s,
   audio-s/s and launches, the traced device busy time and idle share;
22. scale-out and checkpoints, every mesh over repeated entries of the one
   card (``parallel.sequence``, ``parallel.multihost``,
   ``utils.serialization``): (a) ``transform``, ``inverse_transform`` and
   ``encode_quantized`` with the 430 blocks split over sp=2 shards in (r)
   and (b): one launch a shard, codes equal to the unsharded call's on
   the card (frames and synthesis max-abs printed), and the all-plain
   call's within the tier's tolerance; (b) the corpus encoder on a dp=2,
   sp=2 mesh over 64 clips of 10 s: one ``fold_matmul`` a shard, the
   unsharded codes, audio-s/s; (c) the gains (r2), SAE (r), post-filter
   (c) and RVQ (r) trainers on a dp=2, sp=2 mesh: the analysis, synthesis
   and synthesis VJP once a shard, the first step's loss, gradients and
   parameters within ``TRAIN_TOL`` of the unsharded step's, five steps
   finite, ms a step; (d) child processes of this script: a gloo group of
   two ranks on the card (the gains and SAE steps on half the batch each)
   and a one-rank NCCL group (``all_reduce``, an SAE step), each within
   ``TRAIN_TOL`` of the one-process step on the whole batch, the gloo
   ranks equal bit for bit, each child under a timeout; (e) two SAE steps,
   ``save_pytree`` of the parameters and the optimizer, reloaded into a
   fresh template: step 3 equals the uninterrupted run's bit for bit, and
   ``load_codec`` of a ``save_codec`` file gives a bit-equal round trip.

Each kernel line names the device functions its tier runs and carries its
bound (the larger of its operations over the card's peak for the tier and
its bytes over 3.35 TB/s; at ``highest``/``high`` the operations are the
split tiers' six bf16 passes, with the float32 FFMA figure beside it) and
the time of one PyTorch call computing the same function where there is
one. The line before the last is a JSON object with one entry per kernel
and tier; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside it, the script exits non-zero and prints no
result. It never imports jax.
"""

from __future__ import annotations

import dataclasses
import json
import math
import signal
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

SAMPLE_RATE = 44100
FILTERS_N = 1024
BATCH = 32
SAMPLES = SAMPLE_RATE * 10 // FILTERS_N * FILTERS_N  # 440320: 430 blocks
RADIX_N = 2048  # 440320 samples = 215 blocks of 2048
SNR_MARGIN_DB = 0.05
FIDELITY_SNR_DB = 130.0
RADIX_FIDELITY_SNR_DB = 125.0
RADIX_FIDELITY_MARGIN_DB = 1.0
SEED = 1234
SOURCE = "audiocodec_tpu_torch/csrc/mdct_kernels.cu"
NOISE_SOURCE = "audiocodec_tpu_torch/csrc/noise_kernel.cu"
PROBE_SOURCE = "audiocodec_tpu_torch/csrc/probe_kernels.cu"
# the probe's variants -> their kernel instances, in the order of the
# variant codes (csrc/probe_kernels.cu ``Variant``)
PROBE_VARIANTS = {"bf16": "BF16", "int8": "INT8", "int8_grouped": "INT8G"}
PROBE_RAGGED_ROWS = (1, 127, 1000)
REPLACES = {
    **{f"probe_{v}": "benchmarks/pallas_int8_probe.py:108"
       for v in PROBE_VARIANTS},
    "fold_matmul": "audiocodec_tpu/ops/pallas_mdct.py:607",
    "matmul_scatter": "audiocodec_tpu/ops/pallas_mdct.py:620",
    "radix_fold_matmul": "audiocodec_tpu/ops/pallas_mdct.py:696",
    "radix_matmul_scatter": "audiocodec_tpu/ops/pallas_mdct.py:708",
    "add_masked_noise": "audiocodec_tpu/ops/pallas_noise.py:53",
    "fold_matmul_vjp": "audiocodec_tpu/ops/pallas_mdct.py:641",
    "matmul_scatter_vjp": "audiocodec_tpu/ops/pallas_mdct.py:675",
    "radix_fold_matmul_vjp": "audiocodec_tpu/ops/pallas_mdct.py:729",
    "radix_matmul_scatter_vjp": "audiocodec_tpu/ops/pallas_mdct.py:760",
}
# Dense peaks of an H100 SXM at 700 W (NVIDIA data sheet), TFLOP/s or TOP/s:
# int8 and bf16 on the tensor cores, float32 FFMA beside them; and its
# memory rate, TB/s
PEAK = {"int8": 1979.0, "default": 989.0, "float32": 67.0}
MEMORY_TB_S = 3.35
# Operations an element of the noise kernel, counted against the float32
# rate: one Philox4x32-10 call a four elements (10 rounds of 2 32x32->64-bit
# products, 4 xors and 2 key additions: 20 an element), one Box-Muller a
# pair (2 uniform maps of 3, a log, a product, a sqrt, a product, a sin and
# cos, 2 products: 14, 7 an element) and the masked add (2 products and a
# sum)
NOISE_OPS_PER_ELEMENT = 30
# Ragged views of phase 7: (first element, elements cut from the end); the
# counts are not a multiple of 8, and a first element of 1 is not 16-byte
# aligned (the kernel's scalar path)
NOISE_RAGGED = ((0, 13), (1, 0), (1, 5))

CONFIGS = {
    "a": dict(compute_dtype="bfloat16", fast_bf16=True,
              dct_precision="int8", bark_precision="default"),
    "b": dict(compute_dtype="bfloat16", fast_bf16=True,
              dct_precision="default", bark_precision="default"),
    "c": dict(compute_dtype="float32", fast_bf16=False,
              dct_precision="default", bark_precision=None),
}
# The noise-injection codec's configurations (phase 9)
NOISE_CONFIGS = {
    "r": dict(filters_n=FILTERS_N, compute_dtype="float32",
              dct_precision="highest", kernel_design="mono"),
    "r2": dict(filters_n=RADIX_N, compute_dtype="float32",
               dct_precision="highest", kernel_design="radix"),
    "b": dict(filters_n=FILTERS_N, compute_dtype="bfloat16", fast_bf16=True,
              dct_precision="default", kernel_design="mono"),
}
# The mono-vs-radix comparison at N=2048 (phase 10)
DESIGN_CONFIGS = {
    "highest-mono": dict(NOISE_CONFIGS["r2"], kernel_design="mono"),
    "highest-radix": NOISE_CONFIGS["r2"],
    "default-mono": dict(filters_n=RADIX_N, compute_dtype="bfloat16",
                         fast_bf16=True, dct_precision="default",
                         kernel_design="mono"),
    "default-radix": dict(filters_n=RADIX_N, compute_dtype="bfloat16",
                          fast_bf16=True, dct_precision="default",
                          kernel_design="radix"),
    "int8-mono": dict(filters_n=RADIX_N, compute_dtype="bfloat16",
                      fast_bf16=True, dct_precision="int8",
                      kernel_design="mono"),
    "high-mono": dict(NOISE_CONFIGS["r2"], kernel_design="mono",
                      dct_precision="high"),
}

# The VJPs' tiers (phase 11) and the MDCTs of the gradient paths (phases
# 12-13), by label: (r), (c), (b), (a) and (r2) are the configurations of
# phases 4 and 9, (h) the mono f32 ``high`` tier, (b2) the radix bf16 tier
VJP_CASES = {
    "r": NOISE_CONFIGS["r"],
    "h": dict(NOISE_CONFIGS["r"], dct_precision="high"),
    "c": dict(filters_n=FILTERS_N, compute_dtype="float32",
              dct_precision="default"),
    "b": NOISE_CONFIGS["b"],
    "a": dict(filters_n=FILTERS_N, compute_dtype="bfloat16", fast_bf16=True,
              dct_precision="int8"),
    "r2": NOISE_CONFIGS["r2"],
    "b2": DESIGN_CONFIGS["default-radix"],
}
# The trainers of phase 12, on the codec of the VJP case of the same label
TRAIN_CONFIGS = {"r": "spectral_ae", "b": "spectral_ae", "r2": "gains",
                 "a": "gains", "c": "post_filter"}
# (loss rtol, gradient atol as a share of each gradient's peak) of a
# training step through the kernels against the all-plain step: float32
# tiers agree to a few float32 ulps of the spectrum, bfloat16 ones to a few
# bf16 ulps, which the quantizer's rounding and the nonlinearities carry on
TRAIN_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (1e-2, 5e-2)}
# The discrete codec of phase 15, on the codec of configuration (r)
RVQ_AE = dict(filters_n=FILTERS_N, hidden_n=512, latent_n=64,
              latent_step=1 / 32)
RVQ_CFG = dict(stages=4, codebook_size=1024, dim=64)
RVQ_CODES_EQUAL = 0.999
RVQ_TRAIN_STEPS = 3
# The bitstream ladder of phase 16: the CLI's presets
# (audiocodec_tpu/__main__.py _PRESETS) with their dead zones fixed,
# preset -> (configurations, channels, clips, encode_frames keywords)
LADDER_PRESETS = {
    "music": (("r",), 1, BATCH, dict(tns=True, bs=True, deadzone=0.7)),
    "low": (("r", "b"), 2, BATCH // 2,
            dict(ms=True, deadzone=1.0, tns=True, bs=True, nf=True,
                 tmask=130.0, bwe=True, intensity=True)),
}
LADDER_NF_SEED = 5
# share of the codes, and of each member, equal to the all-plain codec's;
# at float32 each difference is within one step or level (at the bf16
# tier an intensity gain of an uncorrelated group, a projection near 0,
# can flip its sign and with it its wire value)
LADDER_EQUAL = 0.999
# the payload's members held against the all-plain payload
LADDER_MEMBERS = ("tns_idx", "nf_levels", "bs_flags", "bwe_gains",
                  "is_gains")
# The .acz path of phase 17, the CLI's non-chunked encode and decode in
# (r) with its sidecar grid 4: the six lossy golden vectors (their codes'
# sha256 and PCM within 4 LSB, tests/test_vectors.py's rule); one "music"
# file of 60 s stereo (audiocodec_tpu/__main__.py _PRESETS: TNS and block
# switching; its dead zone "auto" is plain rounding without --kbps); and
# the "low" preset (mid/side) rate-controlled to 40 kbps on phase 16's 16
# stereo clips of 10 s, each clip within tests/test_rate.py::
# TestBatchRateControl's 15% of the target
ACZ_VECTORS = ("plain", "scq", "bwe", "intensity", "ladder", "stereo_ms")
ACZ_VECTOR_LSB = 4
ACZ_SECONDS = 60
ACZ_MUSIC = dict(tns=True, bs=True, deadzone=0.5)
ACZ_LOW = dict(ms=True, deadzone="auto", tns=True, bs=True, nf=True,
               tmask=130.0, bwe=True, intensity=True)
ACZ_KBPS = 40.0
ACZ_KBPS_TOLERANCE = 0.15
ACZ_RATE_CLIPS = BATCH // 2
# The .acs stream path of phase 18: BASELINE.md's configuration 5 (48 kHz
# stereo, N=1024, 64 Bark bands, chunks of 256 blocks) in (r); (b) for the
# stream-vs-batch check only. Streams are whole chunks: 60 s is 11 chunks,
# the default 600 s 110 (``--stream-seconds``)
STREAM_SR = 48000
STREAM_CB = 256
STREAM_SECONDS = 600
STREAM_EQUAL_SECONDS = 60
STREAM_EQUAL_CHUNKINGS = (256, 7)
STREAM_TRACE_CHUNKS = 4
# the feature ladder of the stream (the CLI's "low" preset's features
# without temporal masking), with FEC at a 4x coarser threshold
STREAM_LADDER = dict(ms=True, tns=True, nf=True, nf_seed=LADDER_NF_SEED,
                     bs=True, bwe=True, intensity=True)
STREAM_LADDER_FEC = 4.0
STREAM_DTX = -60.0
STREAM_CBR_KBPS = 64.0
STREAM_RESERVOIR_KBITS = 64.0

# The command line of phase 19 (audiocodec_tpu_torch/__main__.py) at its
# defaults: a 60 s 44.1 kHz stereo PCM16 file, the "music" preset to .acz,
# .acs chunks of 256 blocks and a window of it, 10 s of 24-bit stereo for
# lossless levels 1 and 2 (and a window of 3 s from 2 s), a resample to
# 48 kHz (within 1e-5 of the peak of the CPU's), eval within 1e-3 dB and
# loudness within 0.01 LU of the CPU's
CLI_SECONDS = 60
CLI_CHUNK_BLOCKS = 256
CLI_WINDOW = (20, 10)
CLI_LOSSLESS_SECONDS = 10
CLI_LOSSLESS_WINDOW = (2, 3)
CLI_RESAMPLE_RATE = 48000
CLI_RESAMPLE_TOL = 1e-5
CLI_EVAL_DB = 1e-3
CLI_LUFS = 0.01
# Serving (phase 20): README's serving row, 8 concurrent clients of 2 s
# 44.1 kHz mono PCM16, 8 requests each, at the serve command's defaults;
# one session of phase 18's 48 kHz stereo in chunks of 256 blocks
SERVE_SECONDS = 2
SERVE_CLIENTS = 8
SERVE_REQUESTS = 8
SERVE_START_S = 120
SERVE_CODES_EQUAL = 0.9999
SERVE_STREAM_SECONDS = 60
SERVE_TRACE_CYCLES = 3
# The bulk corpus (phase 21): BASELINE.md configuration 4, 1,000 clips of
# 10 s 44.1 kHz mono PCM16 in batches of 64 (``--corpus-clips`` cuts the
# count); --kbps on 64 of them; lossless on four 24-bit stereo files
CORPUS_CLIPS = 1000
CORPUS_SECONDS = 10
CORPUS_BATCH = 64
CORPUS_SAMPLED = 16
CORPUS_CODES_EQUAL = 0.9999
CORPUS_KBPS = 64.0
CORPUS_KBPS_TOLERANCE = 0.15
CORPUS_LOSSLESS_SECONDS = 10


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def make_signal(torch, device, dtype):
    """Two tones (440 and 1320 Hz) plus white noise, each clip scaled by
    its own seeded gain: [BATCH, SAMPLES, 1]."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    t = torch.arange(SAMPLES, dtype=torch.float64) / SAMPLE_RATE
    base = (0.4 * torch.sin(2 * math.pi * 440 * t)
            + 0.3 * torch.sin(2 * math.pi * 1320 * t)
            + 0.05 * torch.randn(SAMPLES, generator=gen, dtype=torch.float64))
    gains = 0.5 + 0.5 * torch.rand(BATCH, 1, generator=gen,
                                   dtype=torch.float64)
    x = (base[None, :] * gains)[..., None].to(torch.float32)
    return x.to(device=device, dtype=dtype)


def snr_db(x, out, n=FILTERS_N):
    ref = x.double()
    err = ((ref - out[:, n:-n].double()) ** 2).sum()
    return float(10 * math.log10(float((ref**2).sum()) / max(float(err),
                                                             1e-300)))


def all_launch_counts():
    from audiocodec_tpu_torch.ops import cuda_mdct, cuda_noise, cuda_probe

    return {**cuda_mdct.launch_counts(), **cuda_noise.launch_counts(),
            **cuda_probe.launch_counts()}


def reset_all_launch_counts():
    from audiocodec_tpu_torch.ops import cuda_mdct, cuda_noise, cuda_probe

    cuda_mdct.reset_launch_counts()
    cuda_noise.reset_launch_counts()
    cuda_probe.reset_launch_counts()


def expected_counts(**ones):
    """Every kernel's count 0, except the named ones at 1."""
    return {k: int(k in ones) for k in all_launch_counts()}


def plain_kernels():
    """Every kernel wrapper and VJP swapped for its plain version (the
    wrappers are looked up at each call, by the MDCT's autograd Functions
    too)."""
    from contextlib import ExitStack

    from audiocodec_tpu_torch.ops import cuda_mdct, cuda_noise

    stack = ExitStack()
    mdct_names = [k.__name__ for k in cuda_mdct.KERNELS + cuda_mdct.VJPS]
    for module, names in ((cuda_mdct, mdct_names),
                          (cuda_noise, ("add_masked_noise",))):
        for name in names:
            stack.enter_context(mock.patch.object(
                module, name, getattr(module, f"{name}_reference")))
    return stack


def cuda_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stage_ms(torch, codec, x, noise=None):
    """Device time of each stage of round_trip_quantized, run alone; with
    ``noise`` = (name, fn(spectrum, threshold)), of the noise path whose
    noise stage that is, in place of quantize and dequantize."""
    from audiocodec_tpu_torch import quantize

    out = {}

    def stage(name, fn):
        out[name] = cuda_ms(torch, fn, iters=10)
        return fn()

    spec = stage("transform", lambda: codec.mdct.transform(x))
    ton = stage("tonality", lambda: codec.psycho.tonality(spec))
    thr = stage("global_masking_threshold",
                lambda: codec.psycho.global_masking_threshold(spec, ton))
    if noise is None:
        codes, delta = stage("quantize", lambda: quantize.quantize(spec, thr))
        deq = stage("dequantize", lambda: quantize.dequantize(
            codes, delta, dtype=codec.mdct.compute_dtype))
    else:
        deq = stage(noise[0], lambda: noise[1](spec, thr))
    stage("inverse_transform", lambda: codec.mdct.inverse_transform(deq))
    return out


def ptxas_summary(log):
    """One line per compiled kernel from nvcc's -Xptxas=-v output: its
    (mangled) name, registers, barriers and static shared memory, stack
    frame and spills; then ptxas's notes on serialized wgmma."""
    lines, notes, name, frame = [], [], None, ""
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.rsplit(" ", 1)[-1]
        elif "stack frame" in ln:
            frame = ln.strip()
        elif "Used" in ln and "registers" in ln and name:
            used = ln.split("Used", 1)[1].strip()
            lines.append(f"{name}: {used}; {frame}")
            name, frame = None, ""
        elif "C7514" in ln or "C7517" in ln:
            notes.append(ln.split("ptxas info    : ", 1)[-1].strip())
    return lines + notes


# The tensor-core kernels' warpgroup products (bf16 into float32 among
# them) and TMA loads in SASS, and the kernels that must hold them
SASS_OPS = ("HGMMA", "HGMMA.F32.BF16", "IGMMA", "UTMALDG")
TENSOR_CORE_KERNELS = ("tc_kernel", "split_gemm_kernel", "probe_kernel")
# tc_kernel's instances: (float32, bf16 input) x (analysis, synthesis) x
# (default, int8), the synthesis VJP's transposed fold and the analysis
# VJP's transposed scatter at default
TC_INSTANCES = 12
# GEMMs that the split wgmma core replaced, which must not come back
RETIRED_GEMMS = ("ffma_gemm_kernel", "mma_gemm_kernel")


def sass_summary(lib_path):
    """Per tensor-core kernel instance of the built library (tc_kernel,
    split_gemm_kernel, probe_kernel), the count of its warpgroup MMA (HGMMA bf16, those
    into float32, IGMMA int8) and TMA load (UTMALDG) instructions in the
    SASS (cuobjdump), one such line of each, and the (mangled) names of
    every kernel in the library."""
    import shutil

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, lines, names, name = {}, {}, [], None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :", 1)[1].strip()
            names.append(name)
        elif name and any(k in name for k in TENSOR_CORE_KERNELS):
            for op in SASS_OPS:
                head, _, tail = op.partition(".")
                if head in ln and (not tail or f".{tail}" in ln):
                    counts.setdefault(name, dict.fromkeys(SASS_OPS, 0))
                    counts[name][op] += 1
                    lines.setdefault(op, ln.strip())
    return counts, lines, names


def tolerance(torch, ref, kernel, tier, dtype):
    """The CPU tests' tolerances, in the working dtype; none at int8, whose
    kernels keep integer sums and the plain version's float order."""
    if tier == "int8":
        return 0.0
    peak = float(ref.float().abs().max())
    if dtype == torch.bfloat16:
        return 2.0 * 2.0 ** (math.floor(math.log2(peak)) - 7)  # 2 bf16 ulp
    if tier == "highest":
        if kernel == "radix_fold_matmul":  # the CPU tests' bound at N>=512
            return 2e-6
        return 1e-6 if kernel == "fold_matmul" else 1e-4
    return 1e-5 * peak


# The route whose device functions a VJP runs: the other direction's (the
# synthesis VJPs run the analysis route in its transposed-fold mode, the
# analysis VJPs the synthesis route in its transposed-scatter mode)
VJP_RUNS = {"fold_matmul": "matmul_scatter", "matmul_scatter": "fold_matmul",
            "radix_fold_matmul": "radix_matmul_scatter",
            "radix_matmul_scatter": "radix_fold_matmul"}


def device_functions(name, tier):
    """The device functions (csrc/) the wrapper ``name`` launches at
    ``tier``, in order: the route of that tier."""
    if name.endswith("_vjp"):
        return device_functions(VJP_RUNS[name.removesuffix("_vjp")], tier)
    if name == "add_masked_noise":
        return "noise_kernel"
    if name.startswith("probe_"):
        return f"probe_kernel<{PROBE_VARIANTS[name.removeprefix('probe_')]}>"
    if name.startswith("radix"):
        passes = 1 if tier == "default" else split_passes(tier)
        gemm = f"split_gemm_kernel<{passes}>"
        if name == "radix_fold_matmul":
            return f"fold_rotate_kernel + {gemm} + butterfly_out_kernel"
        return f"butterfly_in_kernel + {gemm} + scatter_kernel"
    if tier in ("highest", "high"):
        route = f"split_kernel + split_gemm_kernel<{split_passes(tier)}>"
        return route if name == "fold_matmul" else f"{route} + scatter_kernel"
    return "tc_kernel"


def entry(name, tier, dtype, config, n, route_tier=None, **numbers):
    """One kernel's line of the kernels JSON (``tier`` None for the noise
    kernel, which has one; ``route_tier`` the tier whose device functions
    it runs, if not ``tier``); ``launches`` is filled in by the run of the
    path ``config`` names."""
    label = dtype if tier is None else f"{tier},{dtype}"
    source = {"add_masked_noise": NOISE_SOURCE}.get(
        name, PROBE_SOURCE if name.startswith("probe_") else SOURCE)
    return dict(name=f"{name}[{label}]", config=config, n=n,
                route="cuda",
                device_functions=device_functions(name, route_tier or tier),
                source=source, replaces=REPLACES[name], launches=None,
                **numbers)


def nbytes(*tensors):
    """Bytes of the tensors among the arguments, each counted once."""
    return sum(t.numel() * t.element_size() for t in tensors
               if hasattr(t, "element_size"))


def read_args(mdct, args):
    """The arguments a kernel of ``mdct`` (or its VJP) reads: the matrix's
    (mono) or the factors' (radix) operand form and not the float32 matrix
    or factors, which its plain version reads."""
    skip = 4 if mdct.kernel_design == "mono" else 5
    return args[:skip] + args[skip + 1:]


def split_passes(tier):
    """The bf16 passes a split tier's kernels run: one per pair (i, j) of
    its operands' planes with i + j < planes (ops/cuda_mdct.py
    SPLIT_PLANES)."""
    from audiocodec_tpu_torch.ops import cuda_mdct

    planes = cuda_mdct.SPLIT_PLANES[tier]
    return planes * (planes + 1) // 2


def bound(flops, n_bytes, tier):
    """(bound_ms, bound_by, ffma_bound_ms): the larger of the operations
    over the tier's peak and the bytes over the memory rate. ``flops`` are
    the products'; at ``highest`` and ``high`` the operations are the split
    tiers' bf16 passes (:func:`split_passes` times ``flops``) at the bf16
    rate, the least work that gives those tiers' error on the card, for
    every kernel of the tier (radix and VJPs too), and ``ffma_bound_ms`` is
    the same bound with ``flops`` at the float32 FFMA rate (None at the
    other tiers). Tier "float32" counts float32 operations (the noise
    kernel)."""
    bytes_ms = n_bytes / (MEMORY_TB_S * 1e9)

    def larger(ops_ms):
        return (ops_ms, "operations") if ops_ms >= bytes_ms else (
            bytes_ms, "bytes")

    if tier in ("highest", "high"):
        ffma_ms = larger(flops / (PEAK["float32"] * 1e9))[0]
        return (*larger(split_passes(tier) * flops / (PEAK["default"] * 1e9)),
                ffma_ms)
    return (*larger(flops / (PEAK[tier] * 1e9)), None)


def gemm_flops(spectrum_frames, n, radix):
    """The products' operations: one [N, N] product (two [N/2, N/2] ones in
    the radix design) per spectrum frame and row."""
    return 2.0 * BATCH * spectrum_frames * (n * n // 2 if radix else n * n)


def library_call(torch, mdct, direction, adjoint=False):
    """One PyTorch call computing the same function as the kernel of
    ``direction`` (or, with ``adjoint``, as its VJP), taking and giving the
    kernels' [rows, frames, N] layout: the analysis is a conv1d of stride N
    whose [N, 1, 2N] weight is its response to unit frames, the synthesis a
    conv_transpose1d likewise, and the VJP of each the other on the same
    weight (built in float64 on the card from the plain versions). cuDNN's
    TF32 is off at ``highest`` and on at ``default``; the int8 tiers have
    no such call (None). Timed for ``library_ms`` only."""
    from audiocodec_tpu_torch.ops import cuda_mdct, dct, folding

    tier = mdct.kernel_precision
    if tier == "int8":
        return None
    n, dev = mdct.filters_n, mdct.wa_r.device
    coeffs = folding.make_fold_coefficients(n, mdct.window_type)
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64,  # noqa: E731
                                    device=dev)
    m64, s = dct.dct4_matrix(n), math.sqrt(4.0 * n)
    eye = torch.eye(n, dtype=torch.float64, device=dev)[:, None, :]
    analysis = direction == "forward"
    if analysis:  # frame 1 answers x[0] through taps 0..N-1, frame 0 N..2N-1
        out = cuda_mdct.fold_matmul_reference(
            eye, *(f64(getattr(coeffs, k)) for k in ("wa_r", "wb", "wc",
                                                      "ffr")), f64(m64 / s))
        w = torch.cat([out[:, 1], out[:, 0]]).T
    else:
        out = cuda_mdct.matmul_scatter_reference(
            eye, *(f64(getattr(coeffs, k)) for k in ("p", "q", "r", "s_r")),
            f64(m64 * s))
        w = out.reshape(n, 2 * n)
    weight = w[:, None, :].contiguous().to(mdct.kernel_dtype)
    pad = n if analysis else 0
    conv = analysis != adjoint
    fn = torch.nn.functional

    def call(inp):
        torch.backends.cudnn.allow_tf32 = tier == "default"
        rows = inp.shape[0]
        if conv:
            out = fn.conv1d(inp.reshape(rows, 1, -1), weight, stride=n,
                            padding=pad)
            return out.transpose(1, 2)
        out = fn.conv_transpose1d(inp.transpose(1, 2), weight, stride=n,
                                  padding=pad)
        return out.reshape(rows, -1, n)

    return call


def function_ms(torch, fn, calls=5):
    """Device time per call of ``fn`` by device function (the MDCT
    kernels' names, csrc/; others by the start of theirs), from a
    torch.profiler trace of ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((f for f in MDCT_DEVICE_FUNCTIONS if f in e.name),
                    e.name[:40])
        span = (e.time_range.end - e.time_range.start) / 1e3 / calls
        out[name] = out.get(name, 0.0) + span
    return out


def compare_kernels(torch, mdct, label, entries):
    """Both kernels of ``mdct``'s design against their plain versions on
    the card, on the test signal cut into [BATCH, blocks, N] rows: error,
    tolerance, CUDA-event times, the rate of the products, the bound and
    the library call's time."""
    from audiocodec_tpu_torch.ops import cuda_mdct

    n = mdct.filters_n
    x = make_signal(torch, mdct.wa_r.device, mdct.kernel_dtype)
    rows = x.reshape(BATCH, SAMPLES // n, n)
    fwd_args = mdct.kernel_args("forward")
    inv_args = mdct.kernel_args("inverse")
    with torch.no_grad():
        spectrum = mdct.kernel("forward")(rows, *fwd_args)
    tier = mdct.kernel_precision
    radix = mdct.kernel_design == "radix"
    for direction, inp, args in (("forward", rows, fwd_args),
                                 ("inverse", spectrum, inv_args)):
        kernel = mdct.kernel(direction)
        name = kernel.__name__
        plain = getattr(cuda_mdct, f"{name}_reference")
        got = kernel(inp, *args)
        want = plain(inp, *args)
        torch.cuda.synchronize()
        check(got.shape == want.shape == (BATCH, inp.shape[1] + 1, n),
              f"{name} {tier}: shape {tuple(got.shape)}")
        err = float((got.float() - want.float()).abs().max())
        tol = tolerance(torch, want, name, tier, inp.dtype)
        ms = cuda_ms(torch, lambda: kernel(inp, *args))
        by_function = function_ms(torch, lambda: kernel(inp, *args))
        plain_ms = cuda_ms(torch, lambda: plain(inp, *args))
        spectrum_frames = got.shape[1] if direction == "forward" else (
            inp.shape[1])
        flops = gemm_flops(spectrum_frames, n, radix)
        read = nbytes(inp, got, *read_args(mdct, args))
        bound_ms, bound_by, ffma_bound_ms = bound(flops, read, tier)
        library = library_call(torch, mdct, direction)
        library_ms = library_err = None
        if library is not None:
            library_err = float((library(inp).float() - want.float())
                                .abs().max())
            library_ms = cuda_ms(torch, lambda: library(inp), iters=5)
        tflops = flops / (ms * 1e-3) / 1e12
        dtype = str(inp.dtype).removeprefix("torch.")
        ffma = ("" if ffma_bound_ms is None
                else f", at the FFMA rate {ffma_bound_ms:.4f} ms")
        print(f"kernel {name} {tier} {dtype} {tuple(inp.shape)}: "
              f"max_abs_err {err:.3e} (tol {tol:.3e}), {ms:.4f} ms vs "
              f"plain {plain_ms:.4f} ms, library {library_ms} ms (max_abs_err "
              f"{library_err}), bound {bound_ms:.4f} ms ({bound_by}{ffma}) = "
              f"{100 * bound_ms / ms:.1f}% of the time, {tflops:.1f} TF/s of "
              f"products; device ms " + ", ".join(
                  f"{f} {t:.4f}" for f, t in by_function.items()))
        check(err <= tol, f"{name} {tier} {dtype}: error {err} > {tol}")
        entries.append(entry(name, tier, dtype, label, n, max_abs_err=err,
                             tol=tol, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             ffma_bound_ms=ffma_bound_ms,
                             library_ms=library_ms, tflops=tflops,
                             function_ms=by_function))


def tensor_core_phase(torch, mdcts):
    """3, continued. The mono kernels of the MDCTs ``mdcts`` (those of
    configurations (a), (b), (c), ``highest`` and ``high``) at 5 rows of 1,
    127 and 129 frames (around their tiles of 64 or 128 frames; no full
    wave of the card) against their plain versions, each tensor-core
    kernel's dynamic shared memory, and the bare [13792 x 1024] x [1024 x
    1024] product through torch.matmul (bf16) and torch._int_mm (int8):
    yardsticks of the product alone, which the port never calls."""
    from audiocodec_tpu_torch.ops import _build, cuda_mdct

    lib = _build.library()
    out = dict(ragged_max_abs_err={}, shared_bytes={}, yardsticks={})
    for tier, code in (("default", 1), ("int8", 2)):
        for fold, name in ((1, "fold_matmul"), (0, "matmul_scatter")):
            for n in (FILTERS_N, RADIX_N):
                b = lib.acx_tc_shared_bytes(code, fold, n)
                out["shared_bytes"][f"{name} {tier} N={n}"] = b
                print(f"build: tc_kernel {name} {tier} N={n}: {b} bytes "
                      "of dynamic shared memory")
    for tier, code in (("highest", 0), ("high", 3)):  # either direction, N
        b = lib.acx_tc_shared_bytes(code, 1, FILTERS_N)
        out["shared_bytes"][f"split_gemm_kernel {tier}"] = b
        print(f"build: split_gemm_kernel<{split_passes(tier)}> {tier}: {b} "
              "bytes of dynamic shared memory")
    for k, mdct in mdcts.items():
        tier = mdct.kernel_precision
        for blocks in (1, 127, 129):
            gen = torch.Generator(device="cpu").manual_seed(blocks)
            x = (torch.rand(5, blocks, FILTERS_N, generator=gen) * 2 - 1).to(
                mdct.wa_r.device, mdct.kernel_dtype)
            for direction in ("forward", "inverse"):
                kernel = mdct.kernel(direction)
                name = kernel.__name__
                plain = getattr(cuda_mdct, f"{name}_reference")
                args = mdct.kernel_args(direction)
                if direction == "inverse" and tier in ("highest", "high"):
                    # a spectrum of the path's scale, the forward's (as
                    # tests/test_torch_cuda.py feeds it): these tiers'
                    # synthesis tolerance is an absolute 1e-4, ~3 float32
                    # ulps of the ~300 that uniform spectra give
                    x = cuda_mdct.fold_matmul_reference(
                        x, *mdct.kernel_args("forward"))[:, :blocks]
                    x = x.contiguous()
                got, want = kernel(x, *args), plain(x, *args)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                tol = tolerance(torch, want, name, tier, x.dtype)
                out["ragged_max_abs_err"][f"{name} ({k}) T={blocks}"] = err
                check(got.shape == want.shape == (5, blocks + 1, FILTERS_N),
                      f"{name} ({k}) T={blocks}: shape {tuple(got.shape)}")
                check(err <= tol, f"{name} ({k}) T={blocks}: error {err} > "
                      f"{tol}")
    print("ragged frame counts, max_abs_err: "
          + ", ".join(f"{c} {e:.3e}"
                      for c, e in out["ragged_max_abs_err"].items()))
    dev = mdcts["b"].wa_r.device
    m, n = BATCH * (SAMPLES // FILTERS_N + 1), FILTERS_N
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    a = torch.randn(m, n, generator=gen).to(dev, torch.bfloat16)
    b = torch.randn(n, n, generator=gen).to(dev, torch.bfloat16)
    qa = torch.randint(-127, 128, (m, n), generator=gen,
                       dtype=torch.int8).to(dev)
    qb = torch.randint(-127, 128, (n, n), generator=gen,
                       dtype=torch.int8).to(dev)
    for label, fn, peak in (
            ("torch.matmul bf16", lambda: torch.matmul(a, b), PEAK["default"]),
            ("torch._int_mm int8", lambda: torch._int_mm(qa, qb),
             PEAK["int8"])):
        ms = cuda_ms(torch, fn)
        tflops = 2.0 * m * n * n / (ms * 1e-3) / 1e12
        out["yardsticks"][label] = dict(ms=ms, tflops=tflops)
        print(f"yardstick {label} [{m} x {n}] x [{n} x {n}]: {ms:.4f} ms = "
              f"{tflops:.1f} TF/s = {100 * tflops / peak:.1f}% of {peak:.0f}")
    return out


def set_launches(entries, config, counts):
    for e in entries:
        if e["config"] == config:
            e["launches"] = counts[e["name"].split("[")[0]]


def noise_kernel_phase(torch, codecs, entries):
    """7. The noise kernel against its plain version at the main path's
    spectra, its uniforms bit for bit, its moments and its seeding."""
    from audiocodec_tpu_torch.ops import cuda_noise, philox

    for label, codec in codecs.items():
        x = make_signal(torch, codec.mdct.wa_r.device,
                        codec.mdct.compute_dtype)
        with torch.no_grad():
            spec, thr = codec._analyze(x)
        del x
        dtype = str(spec.dtype).removeprefix("torch.")
        check(spec.is_contiguous() and thr.is_contiguous(),
              f"noise ({label}): the codec's spectrum or threshold is not "
              "contiguous")
        got = cuda_noise.add_masked_noise(spec, thr, SEED)
        want = cuda_noise.add_masked_noise_reference(spec, thr, SEED)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if spec.dtype == torch.float32:
            tol = 1e-5 * float(thr.float().max())
        else:
            tol = tolerance(torch, want, "add_masked_noise", None, spec.dtype)
        ms = cuda_ms(torch, lambda: cuda_noise.add_masked_noise(spec, thr,
                                                                SEED))
        plain_ms = cuda_ms(torch, lambda: cuda_noise.add_masked_noise_reference(
            spec, thr, SEED), iters=5)
        gbs = 3 * spec.numel() * spec.element_size() / (ms * 1e-3) / 1e9
        print(f"kernel add_masked_noise {dtype} {tuple(spec.shape)}: "
              f"max_abs_err {err:.3e} (tol {tol:.3e}), {ms:.4f} ms vs plain "
              f"{plain_ms:.4f} ms, {gbs:.0f} GB/s")
        check(err <= tol, f"add_masked_noise {dtype}: error {err} > {tol}")
        bound_ms, bound_by, _ = bound(
            NOISE_OPS_PER_ELEMENT * spec.numel(), nbytes(spec, thr, got),
            "float32")
        ragged = noise_ragged(torch, spec, thr, tol)
        print(f"add_masked_noise {dtype}: ragged views (first element, "
              f"count): max_abs_err {ragged}")
        entries.append(entry("add_masked_noise", None, dtype,
                             f"noise ({label})", codec.mdct.filters_n,
                             max_abs_err=err, tol=tol, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=None,
                             gb_per_s=gbs, ragged_max_abs_err=ragged))
        del got, want

    dev = spec.device
    del spec, thr
    count = BATCH * (SAMPLES // FILTERS_N + 1) * FILTERS_N
    ku = cuda_noise.uniforms(SEED, count, dev)
    pu = philox.uniforms(SEED, count, dev)
    same = all(torch.equal(a, b) for a, b in zip(ku, pu))
    lo = min(float(u.min()) for u in ku)
    hi = max(float(u.max()) for u in ku)
    for c in (*range(1, 10), count - 13):  # counts that end inside a call
        same = same and all(
            torch.equal(a, b) for a, b in zip(
                cuda_noise.uniforms(SEED, c, dev), philox.uniforms(SEED, c,
                                                                   dev)))
    print(f"noise uniforms: {count} pairs, and the first 1-9 and "
          f"{count - 13}, equal to the plain generator bit for bit: {same}; "
          f"range [{lo:.3e}, {hi}]")
    check(same, "noise uniforms differ from the plain generator's")
    check(0.0 < lo and hi <= 1.0, f"uniforms outside (0, 1]: {lo}, {hi}")
    del ku, pu

    zero = torch.zeros(BATCH, SAMPLES // FILTERS_N + 1, FILTERS_N, 1,
                       device=dev)
    one = torch.ones_like(zero)
    z = cuda_noise.add_masked_noise(zero, one, SEED)
    zd = z.double().flatten()
    n, sigma = zd.numel(), 1.0 / 6.0
    std = float(zd.std())
    moments = dict(
        mean=float(zd.mean()), std=std,
        beyond_3_sigma=float((zd.abs() > 3 * sigma).double().mean()),
        kurtosis=float(((zd / std) ** 4).mean()),
    )
    print(f"noise moments over {n} samples: {moments}")
    check(abs(moments["mean"]) < 5 * sigma / math.sqrt(n), f"mean {moments}")
    check(abs(std / sigma - 1.0) < 0.01, f"std {moments}")
    check(0.0020 < moments["beyond_3_sigma"] < 0.0035, f"tail {moments}")
    check(abs(moments["kurtosis"] - 3.0) < 0.1, f"kurtosis {moments}")
    again = cuda_noise.add_masked_noise(zero, one, SEED)
    other = cuda_noise.add_masked_noise(zero, one, SEED + 1)
    check(torch.equal(again, z), "the same seed gave another output")
    check(float((other - z).abs().max()) > 1e-3,
          "another seed gave the same output")
    return moments


def noise_ragged(torch, spec, thr, tol):
    """7, continued: the noise kernel on flat views of ``spec`` and ``thr``
    (NOISE_RAGGED) against its plain version on the same views, each one
    launch; returns {"first,count": max_abs_err}."""
    from audiocodec_tpu_torch.ops import cuda_noise

    out = {}
    for first, cut in NOISE_RAGGED:
        end = spec.numel() - cut
        s, t = spec.flatten()[first:end], thr.flatten()[first:end]
        reset_all_launch_counts()
        got = cuda_noise.add_masked_noise(s, t, SEED)
        torch.cuda.synchronize()
        counts = all_launch_counts()
        want = cuda_noise.add_masked_noise_reference(s, t, SEED)
        err = float((got.float() - want.float()).abs().max())
        out[f"{first},{s.numel()}"] = err
        check(counts == expected_counts(add_masked_noise=1),
              f"add_masked_noise at {first}:{end}: launch counts {counts}")
        check(err <= tol, f"add_masked_noise at {first}:{end}: error {err} "
              f"> {tol}")
    return out


def noise_path_phase(torch, dev, entries):
    """9. round_trip and round_trip_fast at full width in the noise
    configurations: launches, SNR against the all-plain run."""
    from audiocodec_tpu_torch import Codec

    results = {}
    for k, cfg in NOISE_CONFIGS.items():
        codec = Codec.create(SAMPLE_RATE, bark_bands_n=64, device=dev, **cfg)
        n = codec.mdct.filters_n
        check(codec.mdct.use_kernel is True,
              f"noise ({k}): use_kernel='auto' did not resolve to the kernels")
        x = make_signal(torch, dev, codec.mdct.compute_dtype)
        mdct_once = {codec.mdct.kernel_name(d): 1
                     for d in ("forward", "inverse")}
        gen = lambda: torch.Generator(device=dev).manual_seed(SEED)  # noqa
        calls = {
            "round_trip_fast": (lambda: codec.round_trip_fast(x, SEED),
                                dict(mdct_once, add_masked_noise=1)),
            "round_trip": (lambda: codec.round_trip(x, gen()), mdct_once),
        }
        noise_stages = {
            "round_trip_fast": ("add_noise_fast", lambda s, t:
                                codec.psycho.add_noise_fast(SEED, s, t)),
            "round_trip": ("add_noise", lambda s, t:
                           codec.psycho.add_noise(gen(), s, t)),
        }
        res = {}
        with torch.no_grad():
            for name, (call, once) in calls.items():
                reset_all_launch_counts()
                out = call()
                torch.cuda.synchronize()
                counts = all_launch_counts()
                check(counts == expected_counts(**once),
                      f"noise ({k}) {name}: launch counts {counts}")
                check(out.shape == (BATCH, SAMPLES + 2 * n, 1)
                      and out.dtype == codec.mdct.compute_dtype,
                      f"noise ({k}) {name}: output {tuple(out.shape)} "
                      f"{out.dtype}")
                check(bool(torch.isfinite(out).all()),
                      f"noise ({k}) {name}: non-finite output")
                snr = snr_db(x, out, n)
                with plain_kernels():
                    plain_snr = snr_db(x, call(), n)
                ms = cuda_ms(torch, call, iters=10)
                stages = stage_ms(torch, codec, x, noise_stages[name])
                rate = BATCH * SAMPLES / SAMPLE_RATE / (ms * 1e-3)
                res[name] = dict(snr_db=snr, plain_snr_db=plain_snr, ms=ms,
                                 audio_s_per_s=rate, stages_ms=stages)
                print(f"noise ({k}) {cfg}: {name} launches {counts}, SNR "
                      f"{snr:.4f} dB (plain {plain_snr:.4f} dB), {ms:.3f} ms "
                      f"= {rate:.1f} audio-s/s; stages (ms) "
                      + ", ".join(f"{s} {t:.3f}" for s, t in stages.items()))
                check(abs(snr - plain_snr) <= SNR_MARGIN_DB,
                      f"noise ({k}) {name}: SNR {snr} vs plain {plain_snr}")
                if name == "round_trip_fast":
                    set_launches(entries, f"noise ({k})", counts)
                del out
        results[k] = res
        del x, codec
    return results


def radix_kernel_phase(torch, dev, entries):
    """8. The radix kernels against their plain versions at N=2048, and the
    mono kernels there for comparison."""
    from audiocodec_tpu_torch import MDCT

    for k in ("highest-radix", "default-radix", "highest-mono",
              "high-mono", "default-mono", "int8-mono"):
        label = "noise (r2)" if k == "highest-radix" else f"design {k}"
        compare_kernels(torch, MDCT(use_kernel=True, device=dev,
                                    **DESIGN_CONFIGS[k]), label, entries)


def design_phase(torch, dev, entries):
    """10. The f32 highest round trip through the radix kernels, against
    their plain versions, and the two designs timed side by side in
    round_trip_fast at N=2048."""
    from audiocodec_tpu_torch import Codec, MDCT

    fid_mdct = MDCT(use_kernel=True, device=dev,
                    **DESIGN_CONFIGS["highest-radix"])
    x = make_signal(torch, dev, torch.float32)
    with torch.no_grad():
        reset_all_launch_counts()
        rt = fid_mdct.inverse_transform(fid_mdct.transform(x))
        torch.cuda.synchronize()
        counts = all_launch_counts()
        with plain_kernels():
            plain_rt = fid_mdct.inverse_transform(fid_mdct.transform(x))
    check(counts == expected_counts(radix_fold_matmul=1,
                                    radix_matmul_scatter=1),
          f"radix fidelity: launch counts {counts}")
    fid, plain_fid = snr_db(x, rt, RADIX_N), snr_db(x, plain_rt, RADIX_N)
    print(f"radix fidelity: f32 highest MDCT round trip at N={RADIX_N} SNR "
          f"{fid:.2f} dB (plain {plain_fid:.2f} dB)")
    check(fid >= RADIX_FIDELITY_SNR_DB,
          f"radix fidelity SNR {fid} < {RADIX_FIDELITY_SNR_DB}")
    check(fid >= plain_fid - RADIX_FIDELITY_MARGIN_DB,
          f"radix fidelity SNR {fid} more than "
          f"{RADIX_FIDELITY_MARGIN_DB} dB below plain {plain_fid}")
    del rt, plain_rt

    designs = {}
    for k, cfg in DESIGN_CONFIGS.items():
        codec = Codec.create(SAMPLE_RATE, bark_bands_n=64, device=dev, **cfg)
        xk = x.to(codec.mdct.compute_dtype)
        with torch.no_grad():
            reset_all_launch_counts()
            codec.round_trip_fast(xk, SEED)
            torch.cuda.synchronize()
            counts = all_launch_counts()
            ms = cuda_ms(torch, lambda: codec.round_trip_fast(xk, SEED),
                         iters=10)
        set_launches(entries, f"design {k}", counts)
        rate = BATCH * SAMPLES / SAMPLE_RATE / (ms * 1e-3)
        designs[k] = dict(round_trip_fast_ms=ms, audio_s_per_s=rate)
        print(f"design {k} at N={RADIX_N}: round_trip_fast {ms:.3f} ms = "
              f"{rate:.1f} audio-s/s")
        del codec, xk
    return dict(radix_fidelity_snr_db=fid, radix_plain_fidelity_snr_db=plain_fid,
                designs_n2048=designs)


def vjp_tolerance(torch, want, tier, dtype):
    """A VJP's tolerance against autograd through the plain forward
    version, relative to the peak since a VJP's scale follows its
    cotangent. ``highest``/``high``: 2e-5 of the peak (the forward
    analysis's 1e-6 at its outputs' peak of ~0.05). The one-pass tiers
    (``default``, and ``int8``, whose backward is ``default``): four bf16
    ulps of the peak: the VJP rounds its cotangent (and, in bf16, its fold,
    rotation and butterfly) before each product where autograd rounds each
    product's gradient after it (up to 1.5 ulps apart, measured on the
    plain versions at these shapes), on top of the kernel's two ulps
    against its plain version."""
    peak = float(want.float().abs().max())
    if tier in ("highest", "high") and dtype == torch.float32:
        return 2e-5 * peak
    return 4.0 * 2.0 ** (math.floor(math.log2(peak)) - 7)


def flip_route(torch, mdct, direction, g):
    """The VJP of ``mdct``'s kernel of ``direction`` composed from the other
    direction's public wrapper and torch flips, which the transposed route
    must equal bit for bit: the wrapper on the block-reversed cotangent,
    reversed back and cut by its first and last frame, with the lane halves
    exchanged before the wrapper (the synthesis VJP) or after it (the
    analysis VJP)."""
    from audiocodec_tpu_torch.ops import cuda_mdct

    args = mdct.vjp_args(direction)
    h = g.shape[-1] // 2

    def swap(t):
        return torch.cat([t[..., h:], t[..., :h]], dim=-1)

    synthesis = direction == "inverse"
    gr = torch.flip(g, (1,))
    gr = (swap(gr) if synthesis else gr).contiguous()
    radix = mdct.kernel_design == "radix"
    if synthesis:
        wrapper = cuda_mdct.radix_fold_matmul if radix else cuda_mdct.fold_matmul
    else:
        wrapper = (cuda_mdct.radix_matmul_scatter if radix
                   else cuda_mdct.matmul_scatter)
    if not radix:  # the mono wrappers take mat_scale before the operand
        args = (*args[:-1], 1.0, args[-1])
    out = torch.flip(wrapper(gr, *args), (1,))[:, 1:-1]
    return out if synthesis else swap(out)


def autograd_vjp(torch, mdct, direction, inp, cot):
    """The gradient of the plain forward version of ``mdct``'s kernel of
    ``direction`` at ``inp`` along ``cot`` (at int8 the straight-through
    reference: the ``default`` forward on the dequantized matrix)."""
    from audiocodec_tpu_torch.ops import cuda_mdct

    name = mdct.kernel_name(direction)
    args = mdct.kernel_args(direction)
    if mdct.kernel_precision == "int8":
        d = "fwd" if direction == "forward" else "inv"
        deq = cuda_mdct.dequantized(getattr(mdct, f"kernel_q_{d}"), args[6])
        args = (*args[:4], deq, "default", 1.0)
    xg = inp.detach().requires_grad_()
    plain = getattr(cuda_mdct, f"{name}_reference")
    return torch.autograd.grad(plain(xg, *args), xg, cot)[0]


def vjp_phase(torch, dev, entries):
    """11. Each VJP against torch.autograd through its plain forward
    version on the same cotangent (numpy seed) at the main path's shapes,
    timed against its plain version. Each VJP (one call of the other
    direction's route in its transposed mode) also equals the flip route
    bit for bit, there and at 5 rows of 1, 127 and 129 frames, and its
    trace holds the route's device functions only."""
    import numpy as np

    from audiocodec_tpu_torch import MDCT
    from audiocodec_tpu_torch.ops import cuda_mdct

    rng = np.random.default_rng(SEED)
    for k, cfg in VJP_CASES.items():
        mdct = MDCT(use_kernel=True, device=dev, **cfg)
        n, tier = mdct.filters_n, mdct.kernel_precision
        radix = mdct.kernel_design == "radix"
        rows = make_signal(torch, dev, mdct.kernel_dtype).reshape(
            BATCH, SAMPLES // n, n)
        with torch.no_grad():
            spectrum = mdct.kernel("forward")(rows,
                                              *mdct.kernel_args("forward"))
        for direction, inp in (("forward", rows), ("inverse", spectrum)):
            name = mdct.kernel_name(direction)
            vjp_args = mdct.vjp_args(direction)
            cot = torch.from_numpy(rng.uniform(
                -1.0, 1.0, (BATCH, inp.shape[1] + 1, n)).astype(np.float32)
            ).to(dev, inp.dtype)
            vjp = getattr(cuda_mdct, f"{name}_vjp")
            plain_vjp = getattr(cuda_mdct, f"{name}_vjp_reference")
            got = vjp(cot, *vjp_args)
            want = autograd_vjp(torch, mdct, direction, inp, cot)
            torch.cuda.synchronize()
            check(got.shape == want.shape == inp.shape,
                  f"{name}_vjp {tier}: shape {tuple(got.shape)}")
            err = float((got.float() - want.float()).abs().max())
            plain_err = float((got.float() - plain_vjp(cot, *vjp_args)
                               .float()).abs().max())
            tol = vjp_tolerance(torch, want, tier, inp.dtype)
            ms = cuda_ms(torch, lambda: vjp(cot, *vjp_args))
            by_function = function_ms(torch, lambda: vjp(cot, *vjp_args))
            plain_ms = cuda_ms(torch, lambda: plain_vjp(cot, *vjp_args),
                               iters=10)
            analysis = direction == "forward"
            route = vjp_route(torch, mdct, direction, cot, got, rng,
                              by_function)
            extra = (f"the flip route {route['flip_route_ms']:.4f} ms "
                     "(bit-equal here and at T=" + ", ".join(
                         map(str, route["ragged"])) + ")")
            spectrum_frames = cot.shape[1] if analysis else got.shape[1]
            bound_ms, bound_by, ffma_bound_ms = bound(
                gemm_flops(spectrum_frames, n, radix),
                nbytes(cot, got, *read_args(mdct, vjp_args)),
                mdct.vjp_precision)
            library = library_call(torch, mdct, direction, adjoint=True)
            library_ms = library_err = None
            if library is not None:
                library_err = float((library(cot).float() - want.float())
                                    .abs().max())
                library_ms = cuda_ms(torch, lambda: library(cot), iters=5)
            dtype = str(inp.dtype).removeprefix("torch.")
            print(f"vjp {name}_vjp {tier} {dtype} {tuple(cot.shape)} -> "
                  f"{tuple(got.shape)}: max_abs_err {err:.3e} (tol "
                  f"{tol:.3e}; against the VJP's plain version "
                  f"{plain_err:.3e}), {ms:.4f} ms vs plain {plain_ms:.4f} ms, "
                  f"{extra}, library {library_ms} ms (max_abs_err "
                  f"{library_err}), bound {bound_ms:.4f} ms ({bound_by}); "
                  "device ms " + ", ".join(
                      f"{f} {t:.4f}" for f, t in by_function.items()))
            check(err <= tol, f"{name}_vjp {tier} {dtype}: error {err} > "
                  f"{tol}")
            config = (f"train ({k})" if not analysis and k in TRAIN_CONFIGS
                      else f"waveform grad ({k})")
            entries.append(entry(f"{name}_vjp", tier, dtype, config, n,
                                 route_tier=mdct.vjp_precision,
                                 max_abs_err=err, tol=tol,
                                 plain_version_err=plain_err, ms=ms,
                                 plain_ms=plain_ms, **route,
                                 bound_ms=bound_ms, bound_by=bound_by,
                                 ffma_bound_ms=ffma_bound_ms,
                                 library_ms=library_ms,
                                 function_ms=by_function))
            del cot, got, want
        del mdct, rows, spectrum


def vjp_route(torch, mdct, direction, cot, got, rng, by_function):
    """11, continued: the VJP ``got`` of ``mdct``'s kernel of ``direction``
    at the main path's shape equals the flip route bit for bit, and its
    trace ``by_function`` holds the other direction's device functions only
    (no torch pass); then the same equality, and the tolerance against
    autograd, at 5 rows of 1, 127 and 129 frames. Returns the flip route's
    time and the ragged errors."""
    import numpy as np

    from audiocodec_tpu_torch.ops import cuda_mdct

    name = f"{mdct.kernel_name(direction)}_vjp"
    tier, n = mdct.kernel_precision, mdct.filters_n
    vjp = getattr(cuda_mdct, name)
    vjp_args = mdct.vjp_args(direction)
    old = flip_route(torch, mdct, direction, cot)
    check(torch.equal(got, old), f"{name} {tier}: not the flip route's bits "
          f"(max_abs_err {float((got.float() - old.float()).abs().max())})")
    route = device_functions(name, mdct.vjp_precision)
    stray = [f for f in by_function if f not in route]
    check(not stray, f"{name} {tier}: device functions {stray} outside its "
          f"route {route}")
    ragged = {}
    for blocks in (1, 127, 129):
        y = torch.from_numpy(rng.uniform(-1.0, 1.0, (5, blocks, n)).astype(
            np.float32)).to(cot.device, cot.dtype)
        g = torch.from_numpy(rng.uniform(
            -1.0, 1.0, (5, blocks + 1, n)).astype(np.float32)).to(
            cot.device, cot.dtype)
        out = vjp(g, *vjp_args)
        want = autograd_vjp(torch, mdct, direction, y, g)
        err = float((out.float() - want.float()).abs().max())
        tol = vjp_tolerance(torch, want, tier, g.dtype)
        check(out.shape == (5, blocks, n) and torch.equal(
            out, flip_route(torch, mdct, direction, g)),
              f"{name} {tier} T={blocks}: not the flip route's bits")
        check(err <= tol, f"{name} {tier} T={blocks}: error {err} > {tol}")
        ragged[blocks] = err
    return dict(flip_route_ms=cuda_ms(
        torch, lambda: flip_route(torch, mdct, direction, cot)),
        ragged=ragged)


def trainer(torch, codec, model, x, mesh=None):
    """(params, loss_fn(params, generator), step(generator)) of phase 12's
    trainer ``model`` on ``codec`` at full width, Adam 1e-3, from seeded
    weights; "rvq" is phase 15's discrete codec (no warm-up), with its RVQ
    state in place of ``loss_fn``. ``mesh`` shards the step (phase 22)."""
    from audiocodec_tpu_torch.models import post_filter, rvq, spectral_ae
    from audiocodec_tpu_torch.parallel import train

    n, dtype = codec.mdct.filters_n, codec.mdct.compute_dtype
    init = torch.Generator(device="cpu").manual_seed(SEED)
    if model == "gains":
        state = train.init_state(codec)
        step, _ = train.make_train_step(codec, mesh=mesh)
        return ({"gains": state.gains},
                lambda p, gen: train.perceptual_loss(codec, p["gains"], x),
                lambda gen: step(state, x))
    if model == "rvq":
        ae, cfg = spectral_ae.SpectralAE(**RVQ_AE), rvq.RVQ(**RVQ_CFG)
        params = spectral_ae.init_params(init, ae, dtype, device=x.device)
        state = rvq.init_state(init, cfg, dtype, device=x.device)
        step, make_opt = rvq.make_train_step(codec, ae, cfg, mesh=mesh)
        opt = make_opt(list(params.values()))
        return params, state, lambda gen: step(params, state, opt, x, gen)
    if model == "spectral_ae":
        cfg = spectral_ae.SpectralAE(filters_n=n, hidden_n=512, latent_n=64,
                                     latent_step=1 / 32)
        params = spectral_ae.init_params(init, cfg, dtype, device=x.device)
        loss = lambda p, gen: spectral_ae.perceptual_loss(  # noqa: E731
            codec, cfg, p, x, gen)
        step, make_opt = spectral_ae.make_train_step(codec, cfg, mesh=mesh)
    else:
        cfg = post_filter.PostFilter(n, 512)
        params = post_filter.init_params(init, cfg, dtype, device=x.device)
        loss = lambda p, gen: post_filter.enhancement_loss(  # noqa: E731
            codec, cfg, p, x)
        step, make_opt = post_filter.make_train_step(codec, cfg, mesh=mesh)
    opt = make_opt(list(params.values()))
    return params, loss, lambda gen: step(params, opt, x, gen)


# The MDCT kernels' device functions (csrc/mdct_kernels.cu), for the trace
MDCT_DEVICE_FUNCTIONS = ("tc_kernel", "split_kernel", "split_gemm_kernel",
                         "scatter_kernel", "fold_rotate_kernel",
                         "butterfly_in_kernel", "butterfly_out_kernel")


def trace_steps(torch, step, steps=5):
    """Device time of ``steps`` calls of ``step`` under torch.profiler, per
    step: the MDCT kernels, cuBLAS's GEMMs, every other kernel, and the
    share of the device's span (first kernel start to last kernel end)
    with no kernel running."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    spans, split = [], dict(mdct_kernels=0.0, library_gemms=0.0, other=0.0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        if any(f in e.name for f in MDCT_DEVICE_FUNCTIONS):
            key = "mdct_kernels"
        elif "gemm" in e.name.lower() or "cutlass" in e.name.lower():
            key = "library_gemms"
        else:
            key = "other"
        split[key] += (end - start) / 1e3 / steps
    busy, span = covered(spans)
    return dict(device_ms_per_step=split, idle_share=1.0 - busy / span)


def covered(spans):
    """(time some span covers, the spans' whole extent) of [(start, end)]."""
    spans = sorted(spans)
    busy, reach = 0.0, None
    for start, end in spans:
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    return busy, max(end for _, end in spans) - spans[0][0]


def training_phase(torch, dev, entries):
    """12. The trainers at full width: each step launches the analysis,
    the synthesis and the synthesis VJP once and no other kernel; the
    first step's loss and gradients agree with the all-plain step's; five
    steps stay finite; ms per step, training audio-s/s and peak memory."""
    from audiocodec_tpu_torch import Codec

    results = {}
    for k, model in TRAIN_CONFIGS.items():
        codec = Codec.create(SAMPLE_RATE, bark_bands_n=64, device=dev,
                             **VJP_CASES[k])
        mdct = codec.mdct
        dtype = str(mdct.compute_dtype).removeprefix("torch.")
        x = make_signal(torch, dev, mdct.compute_dtype)
        params, loss_fn, step = trainer(torch, codec, model, x)
        gen = lambda: torch.Generator(device=dev).manual_seed(SEED)  # noqa

        def value_and_grads():
            loss = loss_fn(params, gen())
            grads = torch.autograd.grad(loss, list(params.values()))
            return float(loss.detach()), grads

        loss, grads = value_and_grads()
        with plain_kernels():
            plain_loss, plain_grads = value_and_grads()
        loss_rtol, grad_share = TRAIN_TOL[dtype]
        grad_errs = {}
        for name, g, pg in zip(params, grads, plain_grads):
            err = float((g.float() - pg.float()).abs().max())
            tol = grad_share * float(pg.float().abs().max())
            grad_errs[name] = (err, tol)
            check(err <= tol, f"train ({k}): gradient of {name} {err} > "
                  f"{tol} from the all-plain step's")
        loss_err = abs(loss - plain_loss) / abs(plain_loss)
        check(loss_err <= loss_rtol, f"train ({k}): loss {loss} vs "
              f"all-plain {plain_loss}")
        del grads, plain_grads

        names = [mdct.kernel_name(d) for d in ("forward", "inverse")]
        reset_all_launch_counts()
        losses = [float(step(gen()))]
        torch.cuda.synchronize()
        counts = all_launch_counts()
        want = expected_counts(**{names[0]: 1, names[1]: 1,
                                  f"{names[1]}_vjp": 1})
        check(counts == want, f"train ({k}): launch counts {counts}")
        set_launches(entries, f"train ({k})", counts)
        losses += [float(step(gen())) for _ in range(4)]
        check(all(math.isfinite(v) for v in losses),
              f"train ({k}): losses {losses}")
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(torch, lambda: step(gen()), iters=10)
        peak_bytes = torch.cuda.max_memory_allocated()
        forward_ms = cuda_ms(torch, lambda: loss_fn(params, gen()), iters=10)
        trace = trace_steps(torch, lambda: step(gen()))
        rate = BATCH * SAMPLES / SAMPLE_RATE / (ms * 1e-3)
        results[k] = dict(
            model=model, loss=loss, plain_loss=plain_loss, loss_rel_err=
            loss_err, grad_err_tol=grad_errs, losses=losses, ms=ms,
            forward_ms=forward_ms, audio_s_per_s=rate,
            max_memory_allocated=peak_bytes, trace=trace)
        print(f"train ({k}) {model} {VJP_CASES[k]}: launches {counts}; "
              f"loss {loss:.7g} vs all-plain {plain_loss:.7g} (rel "
              f"{loss_err:.2e}); gradient err/tol "
              + ", ".join(f"{nm} {e:.2e}/{t:.2e}"
                          for nm, (e, t) in grad_errs.items())
              + f"; 5 losses {losses}; {ms:.3f} ms/step (forward "
              f"{forward_ms:.3f}) = {rate:.1f} training audio-s/s; peak "
              f"memory {peak_bytes / 2**30:.2f} GiB; traced device ms a step "
              f"{trace['device_ms_per_step']}, idle {trace['idle_share']:.3f}")
        del codec, x, params, loss_fn, step
    return results


def waveform_grad_phase(torch, dev, entries):
    """13. The gradient of inverse_transform(transform(x)) with respect to
    the waveform (a seeded cotangent), through all four kernels of the
    design, against the same gradient through their plain versions."""
    import numpy as np

    from audiocodec_tpu_torch import MDCT

    rng = np.random.default_rng(SEED + 1)
    results = {}
    for k, cfg in VJP_CASES.items():
        mdct = MDCT(use_kernel=True, device=dev, **cfg)
        n = mdct.filters_n
        x = make_signal(torch, dev, mdct.compute_dtype).requires_grad_()
        cot = torch.from_numpy(rng.uniform(
            -1.0, 1.0, (BATCH, SAMPLES + 2 * n, 1)).astype(np.float32)
        ).to(dev, mdct.compute_dtype)

        def grad():
            out = mdct.inverse_transform(mdct.transform(x))
            return torch.autograd.grad(out, x, cot)[0]

        reset_all_launch_counts()
        got = grad()
        torch.cuda.synchronize()
        counts = all_launch_counts()
        names = [mdct.kernel_name(d) for d in ("forward", "inverse")]
        check(counts == expected_counts(**{m: 1 for m in names},
                                        **{f"{m}_vjp": 1 for m in names}),
              f"waveform grad ({k}): launch counts {counts}")
        set_launches(entries, f"waveform grad ({k})", counts)
        with plain_kernels():
            want = grad()
        err = float((got.float() - want.float()).abs().max())
        # two VJPs chained: twice the one VJP's tolerance
        tol = 2.0 * vjp_tolerance(torch, want, mdct.kernel_precision,
                                  mdct.kernel_dtype)
        finite = bool(torch.isfinite(got).all())
        results[k] = dict(max_abs_err=err, tol=tol,
                          peak=float(want.float().abs().max()))
        print(f"waveform grad ({k}) {cfg}: launches {counts}; max_abs_err "
              f"{err:.3e} (tol {tol:.3e}) against the all-plain gradient")
        check(finite and err <= tol,
              f"waveform grad ({k}): error {err} > {tol} (finite {finite})")
        del mdct, x, cot, got, want
    return results


def probe_phase(torch, dev, entries):
    """14. The int8 probe through its entry point (its launches), then each
    of its kernels against its plain version at the probe's shape and at
    ragged row counts, its SNR against its plain version's, and the
    library call of the same product."""
    from audiocodec_tpu_torch.ops import _build, cuda_probe
    from audiocodec_tpu_torch.ops import dct as _dct
    from audiocodec_tpu_torch.probes import int8_probe

    m, x_np, y_ref = probe_inputs = int8_probe.inputs()
    reset_all_launch_counts()
    res = int8_probe.run(dev, probe_inputs=probe_inputs)
    torch.cuda.synchronize()
    counts = all_launch_counts()
    names = [k.__name__ for k in cuda_probe.KERNELS]
    check(all(counts[k] for k in names)
          and not any(v for k, v in counts.items() if k not in names),
          f"probe: launch counts {counts}")
    print(f"probe: {json.dumps(res)}; launches {counts}")

    x = torch.from_numpy(x_np).to(dev)
    rows, n = x.shape
    mats = {"bf16": m["bf16"].to(dev), "int8": m["int8"].to(dev)}
    ops = {k: cuda_probe.operand(v) for k, v in mats.items()}
    xb, (q, _) = x.to(torch.bfloat16), _dct.int8_rowquant(x)
    library = {"bf16": lambda: torch.matmul(xb, mats["bf16"]),
               "int8": lambda: torch._int_mm(q, mats["int8"])}
    # the library path from the kernel's own float32 x: a cast, then the
    # product (bf16 out); and the bytes each library call moves, each
    # input read once and each output written once
    cast_matmul = lambda: torch.matmul(x.to(torch.bfloat16),  # noqa: E731
                                       mats["bf16"])
    cast_matmul_ms = cuda_ms(torch, cast_matmul)
    out_bf16 = rows * n * 2
    library_bytes = {
        "torch.matmul bf16 x": nbytes(xb, mats["bf16"]) + out_bf16,
        "x.to(bfloat16) + torch.matmul": nbytes(x, xb) + nbytes(
            xb, mats["bf16"]) + out_bf16,
        "torch._int_mm": nbytes(q, mats["int8"]) + rows * n * 4,
    }
    print(f"probe library calls: x.to(bfloat16) + torch.matmul "
          f"{cast_matmul_ms:.4f} ms; bytes moved {library_bytes}")
    results = {"library_bytes": library_bytes,
               "cast_matmul_ms": cast_matmul_ms}
    for code, (variant, label) in enumerate(PROBE_VARIANTS.items()):
        name = f"probe_{variant}"
        shared = _build.library().acx_probe_shared_bytes(code)
        print(f"build: probe_kernel<{label}>: {shared} bytes of dynamic "
              "shared memory")
        check(shared == cuda_probe.shared_bytes(variant),
              f"probe_kernel<{label}>: {shared} bytes of shared memory, "
              f"cuda_probe.shared_bytes says {cuda_probe.shared_bytes(variant)}")
        key, tier = ("bf16", "default") if variant == "bf16" else (
            "int8", "int8")
        args = (mats[key],) if key == "bf16" else (mats[key], m["rescale"])
        kernel = getattr(cuda_probe, name)
        plain = getattr(cuda_probe, f"{name}_reference")
        errs = {}
        for r in (*PROBE_RAGGED_ROWS, rows):  # the full shape last
            got, want = kernel(x[:r], *args, ops[key]), plain(x[:r], *args)
            torch.cuda.synchronize()
            check(got.shape == want.shape == (r, n),
                  f"{name}: shape {tuple(got.shape)} at {r} rows")
            err = float((got - want).abs().max())
            tol = 0.0 if key == "int8" else tolerance(
                torch, want, name, "default", torch.float32)
            check(err <= tol, f"{name} at {r} rows: error {err} > {tol}")
            errs[r] = err
        snr = res[f"cuda_{variant}_snr_db"]
        plain_snr = int8_probe.snr_db(want.cpu().numpy(), y_ref)
        check(abs(snr - plain_snr) <= SNR_MARGIN_DB,
              f"{name}: SNR {snr} vs plain {plain_snr}")
        plain_ms = cuda_ms(torch, lambda: plain(x, *args), iters=5)
        library_ms = cuda_ms(torch, library[key])
        bound_ms, bound_by, _ = bound(2.0 * rows * n * n,
                                      nbytes(x, ops[key], got), tier)
        ms = res[f"cuda_{variant}_ms"]
        results[variant] = dict(snr_db=snr, plain_snr_db=plain_snr,
                                max_abs_err=errs, shared_bytes=shared)
        from_f32_ms = cast_matmul_ms if key == "bf16" else None
        print(f"kernel {name} [{rows} x {n}] x [{n} x {n}]: max_abs_err "
              f"{errs} (tol {tol:.3e}), SNR {snr:.4f} dB (plain "
              f"{plain_snr:.4f}), {ms:.4f} ms vs plain {plain_ms:.4f} ms, "
              f"library {library_ms:.4f} ms (from float32 x "
              f"{from_f32_ms} ms), bound {bound_ms:.4f} ms "
              f"({bound_by}) = {100 * bound_ms / ms:.1f}% of the time, "
              f"{res[f'cuda_{variant}_tf_s']:.1f} TF/s")
        entries.append(entry(name, tier, "float32", "probe", n,
                             max_abs_err=errs[rows], tol=tol, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=library_ms,
                             library_from_f32_ms=from_f32_ms,
                             snr_db=snr, plain_snr_db=plain_snr,
                             ragged_max_abs_err=errs))
        del got, want
    set_launches(entries, "probe", counts)
    return dict(run=res, kernels=results)


def rvq_phase(torch, dev):
    """15. The discrete RVQ codec at full width in (r): serving and three
    training steps, each through the kernels and against the all-plain
    run."""
    import numpy as np

    from audiocodec_tpu_torch import Codec
    from audiocodec_tpu_torch.models import rvq, spectral_ae

    codec = Codec.create(SAMPLE_RATE, bark_bands_n=64, device=dev,
                         **NOISE_CONFIGS["r"])
    ae, cfg = spectral_ae.SpectralAE(**RVQ_AE), rvq.RVQ(**RVQ_CFG)
    init = torch.Generator(device="cpu").manual_seed(SEED)
    params = spectral_ae.init_params(init, ae, torch.float32, device=dev)
    state = rvq.init_state(init, cfg, torch.float32, device=dev)
    x = make_signal(torch, dev, torch.float32)
    audio_s = BATCH * SAMPLES / SAMPLE_RATE

    def encode():
        return rvq.encode_discrete(codec, ae, cfg, params, state, x)

    def decode(codes):
        return rvq.decode_discrete(codec, ae, cfg, params, state, codes)

    reset_all_launch_counts()
    codes = encode()
    data = rvq.pack_codes(cfg, codes)
    back = rvq.unpack_codes(cfg, data, tuple(codes.shape))
    y = decode(back)
    torch.cuda.synchronize()
    counts = all_launch_counts()
    check(counts == expected_counts(fold_matmul=1, matmul_scatter=1),
          f"rvq serving: launch counts {counts}")
    check(codes.shape == (BATCH, SAMPLES // FILTERS_N + 1, 1, cfg.stages)
          and codes.dtype == torch.int32,
          f"rvq: codes {tuple(codes.shape)} {codes.dtype}")
    check(np.array_equal(back, codes.cpu().numpy())
          and len(data) * 8 == codes.numel() * cfg.bits_per_index,
          "rvq: the codes did not survive pack_codes/unpack_codes")
    check(y.shape == (BATCH, SAMPLES + 2 * FILTERS_N, 1)
          and bool(torch.isfinite(y).all()),
          f"rvq: decode {tuple(y.shape)}, finite "
          f"{bool(torch.isfinite(y).all())}")
    with plain_kernels():
        plain_codes, plain_y = encode(), decode(back)
    same = float((codes == plain_codes).float().mean())
    peak = float(plain_y.abs().max())
    err = float((y - plain_y).abs().max())
    # the synthesis's absolute 1e-4 (tolerance()), at the decode's scale
    tol = 1e-4 * max(1.0, peak)
    check(same >= RVQ_CODES_EQUAL, f"rvq: {same} of the codes equal the "
          "all-plain encode's")
    check(err <= tol, f"rvq: decode {err} > {tol} from the all-plain decode")
    encode_ms = cuda_ms(torch, encode, iters=10)
    decode_ms = cuda_ms(torch, lambda: decode(codes), iters=10)
    traces = {"encode": trace_steps(torch, encode),
              "decode": trace_steps(torch, lambda: decode(codes))}
    t0 = time.perf_counter()
    rvq.unpack_codes(cfg, rvq.pack_codes(cfg, codes), tuple(codes.shape))
    pack_ms = (time.perf_counter() - t0) * 1e3
    serving = dict(codes_equal=same, decode_max_abs_err=err, decode_tol=tol,
                   payload_bytes=len(data), encode_ms=encode_ms,
                   decode_ms=decode_ms, pack_unpack_wall_ms=pack_ms,
                   encode_audio_s_per_s=audio_s / (encode_ms * 1e-3),
                   decode_audio_s_per_s=audio_s / (decode_ms * 1e-3),
                   traces=traces)
    print(f"rvq serving {NOISE_CONFIGS['r']} {RVQ_AE} {RVQ_CFG}: launches "
          f"{counts}; codes equal to plain {100 * same:.4f}%, {len(data)} "
          f"bytes packed and unpacked bit for bit ({pack_ms:.1f} ms on the "
          f"host); decode max_abs_err {err:.3e} (tol {tol:.3e}); encode "
          f"{encode_ms:.3f} ms = {serving['encode_audio_s_per_s']:.1f} "
          f"audio-s/s, decode {decode_ms:.3f} ms = "
          f"{serving['decode_audio_s_per_s']:.1f} audio-s/s; traced "
          + ", ".join(f"{k} {t['device_ms_per_step']}, idle "
                      f"{t['idle_share']:.3f}" for k, t in traces.items()))
    del y, plain_y, plain_codes, back

    loss_rtol, grad_share = TRAIN_TOL["float32"]

    def within(label, got, want):
        """max |got - want| against grad_share of want's peak."""
        err = (float((got - want).abs().max()),
               grad_share * float(want.abs().max()))
        check(err[0] <= err[1], f"rvq train: {label} {err}")
        return err

    def held(label, gate, st):
        """Loss and gradients at one gate from the same params and RVQ
        state through the kernels and all plain; the latents of both."""
        def value_and_grads():
            loss, z = rvq.perceptual_loss(codec, ae, cfg, params, st, x,
                                          quantizer_gate=gate)
            grads = torch.autograd.grad(loss, list(params.values()))
            return float(loss.detach()), grads, z.detach()

        loss, grads, z = value_and_grads()
        with plain_kernels():
            plain_loss, plain_grads, plain_z = value_and_grads()
        loss_err = abs(loss - plain_loss) / abs(plain_loss)
        check(loss_err <= loss_rtol, f"rvq train ({label}): loss {loss} vs "
              f"all-plain {plain_loss}")
        grad_errs = {name: within(f"({label}) gradient of {name}", g, pg)
                     for name, g, pg in zip(params, grads, plain_grads)}
        print(f"rvq train ({label}, gate {gate}): loss {loss:.7g} vs "
              f"all-plain {plain_loss:.7g} (rel {loss_err:.2e}); gradient "
              "err/tol " + ", ".join(f"{nm} {e:.2e}/{t:.2e}"
                                     for nm, (e, t) in grad_errs.items()))
        return dict(loss=loss, plain_loss=plain_loss, loss_rel_err=loss_err,
                    grad_err_tol=grad_errs), z, plain_z

    # the first step's loss: the quantizer is off
    warmup, z, plain_z = held("warmup", 0.0, state)
    loss, plain_loss = warmup["loss"], warmup["plain_loss"]
    # its EMA step on the card, from each side's latents, with no reseed
    # (a draw is the only thing the two sides could not share); codewords
    # that a frame whose codes differ touches are left out of the compare
    ema_cfg = dataclasses.replace(cfg, reseed_threshold=0.0)
    ema, plain_ema = (rvq.ema_update(ema_cfg, state, v) for v in (z, plain_z))
    ema_codes, plain_ema_codes = (
        rvq.quantize(ema_cfg, state, v)[1].reshape(-1, cfg.stages)
        for v in (z, plain_z))
    moved = (ema_codes != plain_ema_codes).any(dim=-1)
    ema_same = 1.0 - float(moved.float().mean())
    check(ema_same >= RVQ_CODES_EQUAL, f"rvq train: {ema_same} of the EMA "
          "step's frames have the all-plain codes")
    keep = torch.ones(cfg.stages, cfg.codebook_size, dtype=torch.bool,
                      device=dev)
    for side in (ema_codes, plain_ema_codes):
        for s in range(cfg.stages):
            keep[s, side[moved, s].long()] = False
    ema_errs = {k: within(f"EMA {k}", ema[k][keep], plain_ema[k][keep])
                for k in ema}
    print(f"rvq train EMA step (reseed_threshold 0): frames with the "
          f"all-plain codes {100 * ema_same:.4f}%, codewords compared "
          f"{int(keep.sum())}/{keep.numel()}; err/tol "
          + ", ".join(f"{k} {e:.2e}/{t:.2e}" for k, (e, t) in
                      ema_errs.items()))
    # the engaged quantizer (STE, commitment) on the EMA-fitted codebooks
    engaged, _, _ = held("engaged", 1.0, ema)
    del z, plain_z, ema, plain_ema

    step, make_opt = rvq.make_train_step(codec, ae, cfg, warmup_steps=1)
    opt = make_opt(list(params.values()))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    losses = []
    once = expected_counts(fold_matmul=1, matmul_scatter=1,
                           matmul_scatter_vjp=1)
    for i in range(RVQ_TRAIN_STEPS):
        reset_all_launch_counts()
        losses.append(float(step(params, state, opt, x, gen, i)))
        counts = all_launch_counts()
        check(counts == once, f"rvq train step {i}: launch counts {counts}")
    check(all(math.isfinite(v) for v in losses), f"rvq train: {losses}")
    check(all(bool(torch.isfinite(t).all()) for t in state.values()),
          "rvq train: non-finite RVQ state")
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(torch, lambda: step(params, state, opt, x, gen,
                                     RVQ_TRAIN_STEPS), iters=10)
    peak_bytes = torch.cuda.max_memory_allocated()
    trace = trace_steps(torch, lambda: step(params, state, opt, x, gen,
                                            RVQ_TRAIN_STEPS))
    training = dict(warmup=warmup, engaged=engaged,
                    ema=dict(frames_equal=ema_same, err_tol=ema_errs),
                    losses=losses, ms=ms,
                    audio_s_per_s=audio_s / (ms * 1e-3),
                    max_memory_allocated=peak_bytes, trace=trace)
    print(f"rvq train: launches a step {counts}; first loss {loss:.7g} vs "
          f"all-plain {plain_loss:.7g}; {RVQ_TRAIN_STEPS} losses {losses}; "
          f"{ms:.3f} ms/step = "
          f"{training['audio_s_per_s']:.1f} training audio-s/s; peak memory "
          f"{peak_bytes / 2**30:.2f} GiB; traced device ms a step "
          f"{trace['device_ms_per_step']}, idle {trace['idle_share']:.3f}")
    return dict(serving=serving, training=training)


def ladder_signal(torch, device, dtype, clips, channels, samples=SAMPLES):
    """Tones (440 and 7000 Hz) over a noise floor, with an attack after a
    gap every 20 frames (block switching fires) and an impulse 10 frames
    later (TNS fires), each clip scaled by its own seeded gain; the second
    channel is the first at 0.8 plus a little noise (a panned image):
    [clips, samples, channels]."""
    gen = torch.Generator(device="cpu").manual_seed(1)
    n = FILTERS_N
    t = torch.arange(samples, dtype=torch.float64) / SAMPLE_RATE
    x = (0.3 * torch.sin(2 * math.pi * 440 * t)
         + 0.02 * torch.sin(2 * math.pi * 7000 * t)
         + 0.03 * torch.randn(samples, generator=gen, dtype=torch.float64))
    for frame in range(4, samples // n - 1, 20):
        start = frame * n - n // 4
        x[start:start + n // 2] *= 0.01
        x[start + n // 2:start + 3 * n // 4] += 0.6 * torch.randn(
            n // 4, generator=gen, dtype=torch.float64)
        if frame + 10 < samples // n:
            x[(frame + 10) * n + 300] += 0.9
    x = x.clamp(-1.0, 1.0)
    x = torch.stack([x, 0.8 * x + 0.01 * torch.randn(
        samples, generator=gen, dtype=torch.float64)], dim=-1)[:, :channels]
    gains = 0.5 + 0.5 * torch.rand(clips, 1, 1, generator=gen,
                                   dtype=torch.float64)
    return (x[None] * gains).to(torch.float32).to(device=device, dtype=dtype)


def ladder_levels(torch, a, b, label, within_one):
    """Share of entries of two integer tensors that are equal, checked >=
    LADDER_EQUAL, and with ``within_one`` every difference within one
    level: bf16 sidecars by their grid levels, intensity gains
    (``is_gains``: bit 7 the sign) by their signed magnitude levels.

    :return: (share equal, count of entries more than one level apart)."""
    from audiocodec_tpu_torch import scq

    if a.dtype == torch.bfloat16:
        a, b = (torch.from_numpy(scq.levels_from_bark16(v, scq.DEFAULT_K2))
                for v in (a, b))
    a, b = a.long(), b.long()
    if label.endswith("is_gains"):
        a, b = (torch.where(v >= 128, -(v & 127), v) for v in (a, b))
    diff = (a - b).abs()
    same = float((diff == 0).float().mean())
    far = int((diff > 1).sum())
    check(same >= LADDER_EQUAL and (far == 0 or not within_one),
          f"{label}: {same} equal to the all-plain payload, {far} more than "
          f"one level apart (max {int(diff.max())})")
    return same, far


def ladder_stage_ms(torch, codec, x, kw, enc):
    """Device ms of each stage of one encode and one decode, run alone on
    their inputs (CUDA events, 10 after 3 warm-ups), in the methods' order
    (codec.py quantize_frames_tns, decode_bitstream_ms)."""
    from audiocodec_tpu_torch import (blockswitch, bwe, intensity, nf,
                                      quantize, tns)

    out = {}
    prec = codec.mdct.dct_precision

    def stage(name, fn):
        out[name] = cuda_ms(torch, fn, iters=10)
        return fn()

    ms, dz = bool(kw.get("ms")), kw["deadzone"]
    frames = stage("analysis MDCT", lambda: codec.mdct.transform(x))
    flags = stage("bs detect", lambda: blockswitch.detect(frames,
                                                          precision=prec))
    spec, _, thr, _ = stage("psycho + sidecar", lambda: (
        codec.analyze_for_quantization(frames, ms=ms,
                                       tmask=kw.get("tmask", 0.0))))
    tbs = codec.tns_band_start
    idx = torch.where(flags[:, :, None, None], 0, stage(
        "TNS analyze", lambda: tns.analyze(spec, tbs)))
    spec_f = stage("TNS forward", lambda: tns.filter_forward(spec, idx, tbs))
    thr = stage("TNS scale + bs pool", lambda: blockswitch.pool_threshold(
        tns.scaled_threshold(thr, idx, tbs), flags))
    spec_f = stage("bs split", lambda: blockswitch.split_spectrum(
        spec_f, flags, precision=prec))
    codes, delta = stage("quantize", lambda: quantize.quantize(
        spec_f, thr, deadzone=dz))
    excl = None
    if kw.get("intensity"):
        codes, excl = stage("intensity force", lambda: codec._intensity_force(
            codes, flags, ms))
    if kw.get("nf"):
        stage("nf analyze", lambda: nf.analyze(
            spec_f, codes, delta, codec.nf_band_start, deadzone=dz,
            band_end=codec.bwe_start if kw.get("bwe") else None,
            exclude=excl))
    if kw.get("bwe"):
        stage("bwe analyze", lambda: bwe.analyze(spec_f, codes, delta,
                                                 codec.bwe_start, excl))
    if kw.get("intensity"):
        stage("intensity analyze", lambda: codec._intensity_gains(
            spec_f, codes, delta, flags, enc.bwe_gains, excl))
    # the decode, on the payload
    cdt = codec.mdct.compute_dtype
    thr = stage("sidecar threshold", lambda: (
        codec._ms_threshold(enc.bark16) if ms else
        codec.psycho.bark_intensity_to_threshold(enc.bark16.to(cdt))))
    delta = stage("TNS scale + bs pool + step", lambda: quantize.step_size(
        codec._decode_threshold(thr, enc.tns_idx, tbs, enc.bs_flags)))
    spec = stage("dequantize", lambda: quantize.dequantize(
        enc.codes, delta, dtype=cdt,
        recon_offset=quantize.dz_recon_offset(dz)))
    excl = (intensity.owned_mask(codec.mdct.filters_n, codec.is_start,
                                 x.device) if kw.get("intensity") else None)
    if kw.get("bwe"):
        spec = stage("bwe fill", lambda: bwe.fill(
            spec, enc.codes, delta, enc.bwe_gains, codec.bwe_start, excl))
    if kw.get("nf"):
        spec = stage("nf fill (threefry draw)", lambda: nf.fill(
            spec, enc.codes, delta, enc.nf_levels, codec.nf_band_start,
            LADDER_NF_SEED, band_end=codec.bwe_start if kw.get("bwe")
            else None, exclude=excl))
    if kw.get("intensity"):
        spec = stage("intensity fill", lambda: intensity.fill(
            spec, enc.codes, delta, enc.is_gains, codec.is_start,
            mid_ref=intensity.mid_reference(
                enc.codes, delta, codec.mdct.compute_dtype, enc.bwe_gains,
                codec.bwe_start, excl)))
    spec = stage("bs merge", lambda: blockswitch.merge_spectrum(
        spec, enc.bs_flags, precision=prec))
    spec = stage("TNS inverse", lambda: tns.filter_inverse(
        spec, enc.tns_idx, tbs))
    if ms:
        spec = stage("mid/side derotation",
                     lambda: codec.from_mid_side(spec))
    stage("synthesis MDCT", lambda: codec.mdct.inverse_transform(spec))
    return out


def ladder_phase(torch, dev):
    """16. The bitstream ladder at full width through its entry points, in
    the CLI's presets: "music" in (r), "low" (mid/side) in (r) and (b).
    Each encode launches the analysis kernel once and each decode the
    synthesis kernel once, and no other kernel; TNS, block switching and
    noise filling fire; the payload meets the all-plain codec's (codes and
    members at least 99.9% equal, the codes each within one step, and at
    float32 each member within one level), the
    kernels' and the plain versions' decodes of one payload agree within
    the synthesis tolerance, and the SNR is within SNR_MARGIN_DB of the
    all-plain codec's; the noise fill's threefry draw on the card equals
    the CPU's bit for bit. Times, stage split and traced idle share."""
    from audiocodec_tpu_torch import Codec, nf, quantize
    from audiocodec_tpu_torch.ops import threefry

    results = {}
    for preset, (configs, channels, clips, kw) in LADDER_PRESETS.items():
        for k in configs:
            codec = Codec.create(SAMPLE_RATE, bark_bands_n=64, device=dev,
                                 **NOISE_CONFIGS[k])
            check(codec.mdct.use_kernel is True and codec.sidecar_grid == 4,
                  f"ladder {preset} ({k}): kernels off or sidecar grid "
                  f"{codec.sidecar_grid}")
            dtype = codec.mdct.compute_dtype
            x = ladder_signal(torch, dev, dtype, clips, channels)
            name = ("decode_bitstream_ms" if kw.get("ms")
                    else "decode_bitstream")

            def encode():
                return codec.encode_frames(codec.mdct.transform(x), **kw)

            def decode(enc):
                extra = dict(is_gains=enc.is_gains) if kw.get("ms") else {}
                return getattr(codec, name)(
                    enc.codes, enc.bark16,
                    dz_recon=quantize.dz_recon_offset(kw["deadzone"]),
                    tns_idx=enc.tns_idx, nf_levels=enc.nf_levels,
                    nf_seed=LADDER_NF_SEED, bs_flags=enc.bs_flags,
                    bwe_gains=enc.bwe_gains, **extra)

            label = f"ladder {preset} ({k})"
            with torch.no_grad():
                reset_all_launch_counts()
                enc = encode()
                torch.cuda.synchronize()
                enc_counts = all_launch_counts()
                reset_all_launch_counts()
                y = decode(enc)
                torch.cuda.synchronize()
                dec_counts = all_launch_counts()
                check(enc_counts == expected_counts(fold_matmul=1),
                      f"{label}: encode launch counts {enc_counts}")
                check(dec_counts == expected_counts(matmul_scatter=1),
                      f"{label}: decode launch counts {dec_counts}")
                check(y.shape == (clips, SAMPLES + 2 * FILTERS_N, channels)
                      and y.dtype == dtype
                      and bool(torch.isfinite(y).all()),
                      f"{label}: decode {tuple(y.shape)} {y.dtype}")
                fired = {
                    "tns": float((enc.tns_idx != 0).any(dim=2).float()
                                 .mean()),
                    "bs": float(enc.bs_flags.float().mean()),
                }
                if kw.get("nf"):
                    fired["nf"] = float((enc.nf_levels > 0).float().mean())
                    fired["bwe"] = float((enc.bwe_gains > 0).float().mean())
                    fired["intensity"] = float((enc.is_gains > 0).float()
                                               .mean())
                check(all(v > 0 for v in fired.values()),
                      f"{label}: a feature never fired: {fired}")
                with plain_kernels():
                    plain = encode()
                    plain_y = decode(plain)
                    plain_same = decode(enc)
                f32 = dtype == torch.float32
                equal = {"codes": ladder_levels(
                    torch, enc.codes, plain.codes, f"{label}: codes", True)}
                equal["bark16"] = ladder_levels(
                    torch, enc.bark16.cpu(), plain.bark16.cpu(),
                    f"{label}: bark16", f32)
                for m in LADDER_MEMBERS:
                    if getattr(enc, m) is not None:
                        equal[m] = ladder_levels(
                            torch, getattr(enc, m), getattr(plain, m),
                            f"{label}: {m}", f32)
                err = float((y.float() - plain_same.float()).abs().max())
                tol = tolerance(torch, plain_same, "matmul_scatter",
                                codec.mdct.dct_precision, dtype)
                check(err <= tol, f"{label}: decode of one payload {err} > "
                      f"{tol} from the plain versions'")
                snr, plain_snr = (snr_db(x, v) for v in (y, plain_y))
                check(abs(snr - plain_snr) <= SNR_MARGIN_DB,
                      f"{label}: SNR {snr} vs all-plain {plain_snr}")
                draw = None
                if kw.get("nf"):
                    shape = (clips, enc.codes.shape[1],
                             codec.bwe_start - codec.nf_band_start,
                             channels)
                    on_card = nf.noise(LADDER_NF_SEED, *shape[:2],
                                       shape[2:], dtype, device=dev)
                    on_cpu = nf.noise(LADDER_NF_SEED, *shape[:2], shape[2:],
                                      dtype, device="cpu")
                    check(torch.equal(on_card.cpu(), on_cpu),
                          f"{label}: the threefry draw {shape} on the card "
                          "differs from the CPU's")
                    keys = threefry.fold_in(threefry.fold_in(
                        threefry.key(LADDER_NF_SEED),
                        torch.arange(clips, device=dev)[:, None]),
                        torch.arange(shape[1], device=dev)[None, :])
                    draw = dict(shape=shape, bit_equal=True,
                                ms=cuda_ms(torch, lambda: nf.noise(
                                    LADDER_NF_SEED, *shape[:2], shape[2:],
                                    dtype, device=dev), iters=10),
                                uniform_ms=cuda_ms(torch, lambda: (
                                    threefry.uniform(keys, shape[2:], dtype,
                                                     -1.0, 1.0)), iters=10))
                del plain, plain_y, plain_same
                encode_ms = cuda_ms(torch, encode, iters=10)
                decode_ms = cuda_ms(torch, lambda: decode(enc), iters=10)
                stages = ladder_stage_ms(torch, codec, x, kw, enc)
                traces = {"encode": trace_steps(torch, encode),
                          "decode": trace_steps(torch, lambda: decode(enc))}
            audio_s = clips * SAMPLES / SAMPLE_RATE
            results[f"{preset} ({k})"] = dict(
                launches=dict(encode=enc_counts, decode=dec_counts),
                fired=fired, equal_to_plain=equal, decode_max_abs_err=err,
                decode_tol=tol, snr_db=snr, plain_snr_db=plain_snr,
                encode_ms=encode_ms, decode_ms=decode_ms,
                encode_audio_s_per_s=audio_s / (encode_ms * 1e-3),
                decode_audio_s_per_s=audio_s / (decode_ms * 1e-3),
                stages_ms=stages, traces=traces, threefry=draw)
            r = results[f"{preset} ({k})"]
            print(f"{label} {NOISE_CONFIGS[k]} {kw}, {clips} x {channels} ch "
                  f"x 10 s: launches encode {enc_counts}, decode "
                  f"{dec_counts}; fired {fired}; equal to the all-plain "
                  f"payload {equal}; decode of one payload max_abs_err "
                  f"{err:.3e} (tol {tol:.3e}); SNR {snr:.4f} dB (all-plain "
                  f"{plain_snr:.4f}); threefry draw {draw}; encode "
                  f"(transform + encode_frames) {encode_ms:.3f} ms = "
                  f"{r['encode_audio_s_per_s']:.1f} audio-s/s, {name} "
                  f"{decode_ms:.3f} ms = {r['decode_audio_s_per_s']:.1f} "
                  "audio-s/s; stages (ms) " + ", ".join(
                      f"{s} {t:.3f}" for s, t in stages.items())
                  + "; traced " + ", ".join(
                      f"{s} {t['device_ms_per_step']}, idle "
                      f"{t['idle_share']:.3f}" for s, t in traces.items()))
            del codec, x, enc, y
    return results


def container_decode(torch, codec, codes, bark, meta):
    """Decode a loaded container on the codec's device through the command
    line's ``decode_container`` (the meta -> keywords mapping of its
    ``decode``: the recorded band starts and crossovers verbatim)."""
    from audiocodec_tpu_torch.__main__ import decode_container

    return decode_container(codec, codes, bark, meta)


def launched(counts):
    """The kernels of a launch count that ran, with their counts."""
    return {k: v for k, v in counts.items() if v}


def container_entropy(path_or_bytes):
    """The codes' coder of a container: "rice", "rrice" or "zlib"."""
    import io

    import numpy as np

    src = (io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes)
           else path_or_bytes)
    with np.load(src) as z:
        return next((c for c in ("rice", "rrice") if c in z.files), "zlib")


def acz_vectors(torch, dev):
    """17a. The six lossy golden vectors through the port's load and
    decode on the card: codes' sha256 and PCM within ACZ_VECTOR_LSB."""
    import hashlib

    import numpy as np

    from audiocodec_tpu_torch import Codec
    from audiocodec_tpu_torch.io import bitstream

    vec = Path(__file__).resolve().parent / "tests" / "vectors"
    manifest = json.loads((vec / "manifest.json").read_text())
    out = {}
    for name in ACZ_VECTORS:
        codes, bark, meta = bitstream.load(str(vec / f"{name}.acz"))
        want = manifest[f"{name}.acz"]
        check(hashlib.sha256(codes.tobytes()).hexdigest()
              == want["codes_sha256"], f"vector {name}: codes' sha256")
        codec = Codec.create(meta["sample_rate"],
                             filters_n=meta["filters_n"],
                             bark_bands_n=meta["bark_bands_n"],
                             compute_dtype=meta["compute_dtype"],
                             bark_precision=meta["bark_precision"],
                             device=dev)
        n = meta["filters_n"]
        with torch.no_grad():
            wave = container_decode(torch, codec, codes, bark, meta)
        wave = wave[0, n:-n].double().cpu().numpy()
        if meta["orig_samples"]:
            wave = wave[:meta["orig_samples"]]
        pcm = np.load(vec / f"{name}.acz.pcm.npy").astype(np.int64)
        got = np.round(np.clip(wave, -1, 1) * 32767.0).astype(np.int64)
        check(got.shape == pcm.shape, f"vector {name}: {got.shape}")
        lsb = int(np.abs(got - pcm).max())
        check(lsb <= ACZ_VECTOR_LSB, f"vector {name}: PCM {lsb} LSB away")
        out[name] = dict(max_lsb=lsb, entropy=container_entropy(
            str(vec / f"{name}.acz")))
    print(f"acz vectors on the card: {out}")
    return out


def acz_music(torch, dev, codec, workdir):
    """17b. One 60 s stereo PCM16 file through the CLI's encode and decode
    (read, pad, transform + encode_frames, save; load, decode, trim,
    write), gapless, Rice-coded, one MDCT kernel launch each way, against
    the same path with every kernel swapped for its plain version."""
    import numpy as np

    from audiocodec_tpu_torch import native
    from audiocodec_tpu_torch.io import bitstream, wav

    n = FILTERS_N
    samples = ACZ_SECONDS * SAMPLE_RATE
    src, acz, dst = (str(workdir / f) for f in ("music.wav", "music.acz",
                                                "restored.wav"))
    x = ladder_signal(torch, "cpu", torch.float32, 1, 2, samples=samples)
    native.write_wav(src, x[0].numpy(), SAMPLE_RATE)
    meta = dict(sample_rate=SAMPLE_RATE, filters_n=n, bark_bands_n=64,
                alpha=codec.psycho.alpha,
                window_type=codec.mdct.window_type,
                compute_dtype=bitstream.dtype_name(
                    codec.mdct.compute_dtype),
                ms=False, bark_precision=codec.psycho.bark_precision,
                sidecar_grid=codec.sidecar_grid,
                tns_band_start=codec.tns_band_start)

    def run(times):
        """One pass of the path, timed step by step on the host's clock
        (each device step ends in a synchronize): (payload, restored)."""
        def step(name, fn):
            t0 = time.perf_counter()
            out = fn()
            times[name] = (time.perf_counter() - t0) * 1e3
            return out

        data, rate = step("wav read", lambda: native.decode_wav(src))
        check(rate == SAMPLE_RATE, f"music: read rate {rate}")
        pad = (-data.shape[1]) % n  # __main__.py _pad_to_blocks
        padded = np.pad(data, ((0, 0), (0, pad), (0, 0)))

        def encode():
            xd = torch.from_numpy(padded).to(dev)
            enc = codec.encode_frames(codec.mdct.transform(xd),
                                      **ACZ_MUSIC)
            torch.cuda.synchronize()
            return enc

        reset_all_launch_counts()
        enc = step("transform + encode_frames", encode)
        enc_counts = all_launch_counts()
        blob = step("pack", lambda: bitstream.pack(
            enc.codes, enc.bark16, tns_idx=enc.tns_idx,
            bs_flags=enc.bs_flags, orig_samples=data.shape[1], **meta))
        with open(acz, "wb") as f:
            f.write(blob)
        codes, bark, got = step("unpack", lambda: bitstream.load(acz))

        def decode():
            y = container_decode(torch, codec, codes, bark, got)
            y = y[:, n:-n][:, :got["orig_samples"]].float().cpu().numpy()
            return y

        reset_all_launch_counts()
        y = step("decode", decode)
        dec_counts = all_launch_counts()
        step("wav write", lambda: native.write_wav(dst, y, SAMPLE_RATE))
        return dict(data=data, enc=enc, blob=blob, codes=codes, meta=got,
                    y=y, counts=dict(encode=enc_counts, decode=dec_counts))

    with torch.no_grad():
        first = run({})
        times = {}
        r = run(times)
        with plain_kernels():
            plain = run({})
    data = r["data"]
    read_back, _ = wav.read_wav(src)
    check(np.array_equal(data, read_back),
          "music: native.decode_wav differs from io.wav.read_wav")
    restored, _ = native.decode_wav(dst)
    check(restored.shape == data.shape,
          f"music: restored {restored.shape} vs input {data.shape}")
    check(np.array_equal(r["codes"], r["enc"].codes.cpu().numpy()),
          "music: loaded codes differ from the encoded ones")
    entropy = container_entropy(r["blob"])
    check(entropy in ("rice", "rrice"), f"music: entropy {entropy}")
    check(r["counts"] == first["counts"] and r["counts"] == dict(
        encode=expected_counts(fold_matmul=1),
        decode=expected_counts(matmul_scatter=1)),
        f"music: launches {r['counts']}")
    same, far = ladder_levels(torch, r["enc"].codes, plain["enc"].codes,
                              "music: codes", True)

    def snr(y):
        ref = data.astype(np.float64)
        err = ((ref - y.astype(np.float64)) ** 2).sum()
        return float(10 * math.log10((ref ** 2).sum() / max(err, 1e-300)))

    got_snr, plain_snr = snr(r["y"]), snr(plain["y"])
    check(abs(got_snr - plain_snr) <= SNR_MARGIN_DB,
          f"music: SNR {got_snr} vs all-plain {plain_snr}")
    audio_s = ACZ_SECONDS
    enc_ms = sum(times[k] for k in ("wav read", "transform + encode_frames",
                                    "pack"))
    dec_ms = sum(times[k] for k in ("unpack", "decode", "wav write"))
    out = dict(samples=data.shape[1], channels=data.shape[2],
               frames=int(r["codes"].shape[1]), bytes=len(r["blob"]),
               kbps=len(r["blob"]) * 8 / audio_s / 1e3, entropy=entropy,
               launches=r["counts"], codes_equal_to_plain=same,
               snr_db=got_snr, plain_snr_db=plain_snr, steps_ms=times,
               encode_audio_s_per_s=audio_s / (enc_ms * 1e-3),
               decode_audio_s_per_s=audio_s / (dec_ms * 1e-3))
    print(f"acz music (r) {ACZ_MUSIC}, 1 x 2 ch x {ACZ_SECONDS} s: "
          f"{out['samples']} samples -> {out['frames']} frames, "
          f"{out['bytes']} bytes ({out['kbps']:.1f} kbps, {entropy}); "
          f"gapless; launches encode {launched(r['counts']['encode'])}, "
          f"decode {launched(r['counts']['decode'])}; codes equal to the "
          "all-plain "
          f"path {same}; SNR {got_snr:.4f} dB (all-plain {plain_snr:.4f}); "
          "steps (ms) " + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f"; encode (read + encode + pack) "
          f"{out['encode_audio_s_per_s']:.1f} audio-s/s, decode (unpack + "
          f"decode + write) {out['decode_audio_s_per_s']:.1f} audio-s/s")
    return out


def trace_search(torch, fn, prefix="rate."):
    """One call of ``fn`` under torch.profiler: its result, and the device's
    busy ms (kernels, their union), its span and idle share, and the host
    spans labelled ``prefix*`` (the rate search's ``rate.*``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    spans, host = [], {}
    for e in prof.events():
        ms = (e.time_range.end - e.time_range.start) / 1e3
        if e.name.startswith(prefix):
            if e.device_type != torch.autograd.DeviceType.CUDA:
                host[e.name] = host.get(e.name, 0.0) + ms
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
    busy, span = covered(spans)
    return out, dict(wall_ms=wall, device_busy_ms=busy / 1e3,
                     device_span_ms=span / 1e3,
                     idle_share=1.0 - busy / span, host_ms=host)


def acz_rate(torch, dev, codec):
    """17c. The "low" preset rate-controlled to ACZ_KBPS on phase 16's
    stereo clips: one analysis launch for the whole search, every clip
    within ACZ_KBPS_TOLERANCE, every winning container Rice-coded and
    decoding through decode_bitstream_ms; where a clip's scale equals the
    all-plain search's, its SNR is within SNR_MARGIN_DB of that one's."""
    from audiocodec_tpu_torch import rate
    from audiocodec_tpu_torch.io import bitstream

    x = ladder_signal(torch, dev, torch.float32, ACZ_RATE_CLIPS, 2)

    def search():
        return rate.encode_with_target_bitrate_batch(
            codec, x, ACZ_KBPS, orig_samples=SAMPLES, **ACZ_LOW)

    def decoded(results):
        out = []
        for res in results:
            codes, bark, meta = bitstream.unpack(res.packed)
            check(meta["threshold_scale"] == res.threshold_scale
                  and meta["ms"] and meta["is_gains"] is not None,
                  f"rate: container meta {meta['threshold_scale']}")
            out.append(container_decode(torch, codec, codes, bark, meta))
        return out

    with torch.no_grad():
        reset_all_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        results = search()
        torch.cuda.synchronize()
        search_ms = (time.perf_counter() - t0) * 1e3
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        search_counts = all_launch_counts()
        reset_all_launch_counts()
        ys = decoded(results)
        torch.cuda.synchronize()
        dec_counts = all_launch_counts()
        _, traced = trace_search(torch, search)
        with plain_kernels():
            plain = search()
            plain_ys = decoded(plain)
    check(search_counts == expected_counts(fold_matmul=1),
          f"rate: search launches {search_counts}")
    check(dec_counts == {k: len(results) * int(k == "matmul_scatter")
                         for k in dec_counts},
          f"rate: decode launches {dec_counts}")
    kbps = [r.kbps for r in results]
    check(all(abs(k - ACZ_KBPS) <= ACZ_KBPS_TOLERANCE * ACZ_KBPS
              for k in kbps), f"rate: kbps {kbps}")
    entropy = [container_entropy(r.packed) for r in results]
    check(all(e in ("rice", "rrice") for e in entropy),
          f"rate: entropy {entropy}")
    same_scale, snrs = [], []
    for b, (res, ref) in enumerate(zip(results, plain)):
        check(ys[b].shape == (1, SAMPLES + 2 * FILTERS_N, 2)
              and bool(torch.isfinite(ys[b]).all()),
              f"rate: clip {b} decode {tuple(ys[b].shape)}")
        snr, plain_snr = (snr_db(x[b:b + 1], y) for y in (ys[b],
                                                          plain_ys[b]))
        snrs.append((snr, plain_snr))
        if res.threshold_scale == ref.threshold_scale:
            same_scale.append(b)
            check(abs(snr - plain_snr) <= SNR_MARGIN_DB,
                  f"rate: clip {b} SNR {snr} vs all-plain {plain_snr}")
    out = dict(clips=ACZ_RATE_CLIPS, target_kbps=ACZ_KBPS, kbps=kbps,
               scales=[r.threshold_scale for r in results],
               plain_scales=[r.threshold_scale for r in plain],
               entropy=entropy, clips_at_plain_scale=len(same_scale),
               snr_db=snrs, launches=dict(search=search_counts,
                                          decode=dec_counts),
               search_ms=search_ms, peak_mb=peak_mb, traced=traced)
    print(f"acz rate (r) {ACZ_LOW} at {ACZ_KBPS} kbps, {ACZ_RATE_CLIPS} x 2 "
          f"ch x 10 s: kbps {[round(k, 2) for k in kbps]}; entropy "
          f"{sorted(set(entropy))}; launches search "
          f"{launched(search_counts)}, decodes {launched(dec_counts)}; "
          f"{len(same_scale)} clips at the all-plain "
          f"scale, SNR (dB, kernels vs all-plain) "
          + ", ".join(f"{a:.3f}/{p:.3f}" for a, p in snrs)
          + f"; search {search_ms:.1f} ms wall, peak {peak_mb:.0f} MB; "
          f"traced: wall "
          f"{traced['wall_ms']:.1f} ms, device busy "
          f"{traced['device_busy_ms']:.1f} ms of a "
          f"{traced['device_span_ms']:.1f} ms span (idle share "
          f"{traced['idle_share']:.3f}), host "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in traced["host_ms"]
                      .items()))
    return out


def acz_phase(torch, dev):
    """17. The .acz path: the golden vectors, one "music" file round trip,
    and the "low" rate-controlled batch. Fails unless the native library
    built and every container it writes is Rice-coded."""
    import tempfile

    from audiocodec_tpu_torch import Codec, native

    check(native.available(), f"native library: {native.build_error()}")
    out = dict(vectors=acz_vectors(torch, dev))
    codec = Codec.create(SAMPLE_RATE, bark_bands_n=64, device=dev,
                         **NOISE_CONFIGS["r"])
    check(codec.mdct.use_kernel is True and codec.sidecar_grid == 4,
          f"acz: kernels off or sidecar grid {codec.sidecar_grid}")
    work = Path(__file__).resolve().parent / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        out["music"] = acz_music(torch, dev, codec, Path(tmp))
    out["rate"] = acz_rate(torch, dev, codec)
    return out


def stream_samples(seconds):
    """``seconds`` of STREAM_SR audio rounded up to whole chunks."""
    chunk = STREAM_CB * FILTERS_N
    return -(-round(seconds * STREAM_SR) // chunk) * chunk


def stream_codec(torch, dev, cfg):
    from audiocodec_tpu_torch import Codec

    return Codec.create(STREAM_SR, bark_bands_n=64, device=dev,
                        **NOISE_CONFIGS[cfg])


def stream_signal(torch, device, seconds):
    """Phase 16's stereo ladder signal (tones, noise, attacks after gaps,
    impulses), ``seconds`` rounded up to whole chunks: [1, samples, 2]."""
    return ladder_signal(torch, device, torch.float32, 1, 2,
                         samples=stream_samples(seconds))


def stream_counts(**counts):
    """Every kernel's count 0, except the named ones at theirs."""
    return {k: counts.get(k, 0) for k in all_launch_counts()}


def stream_equal(torch, dev, card):
    """18a. ``stream_transform`` / ``stream_inverse_transform`` of 60 s of
    stereo against the batch transforms, chunks of STREAM_EQUAL_CHUNKINGS
    blocks, in (r) and (b): one kernel launch a step and one for the
    flush; the maximum difference is printed and held to the tier's
    tolerance (0 expected: each step runs the batch transform's kernel on
    the same rows)."""
    from audiocodec_tpu_torch import streaming

    n = FILTERS_N
    x = stream_signal(torch, dev, STREAM_EQUAL_SECONDS)
    out = {}
    for cfg in ("r", "b"):
        mdct = stream_codec(torch, dev, cfg).mdct
        xc = x.to(mdct.compute_dtype)
        tier = mdct.kernel_precision
        for cb in STREAM_EQUAL_CHUNKINGS:
            blocks = xc.shape[1] // n // cb * cb
            xs = xc[:, :blocks * n]
            with torch.no_grad():
                batch = mdct.transform(xs)
                y = batch[:, :blocks]
                ibatch = mdct.inverse_transform(y)
                reset_all_launch_counts()
                fwd = streaming.stream_transform(mdct, xs, cb)
                torch.cuda.synchronize()
                fwd_counts = all_launch_counts()
                reset_all_launch_counts()
                inv = streaming.stream_inverse_transform(mdct, y, cb)
                torch.cuda.synchronize()
                inv_counts = all_launch_counts()
            steps = blocks // cb + 1  # the chunks and the flush
            check(fwd_counts == stream_counts(fold_matmul=steps),
                  f"stream ({cfg}) {cb}: analysis launches {fwd_counts}")
            check(inv_counts == stream_counts(matmul_scatter=steps),
                  f"stream ({cfg}) {cb}: synthesis launches {inv_counts}")
            err_f = float((fwd.float() - batch.float()).abs().max())
            err_i = float((inv.float() - ibatch.float()).abs().max())
            tol_f = tolerance(torch, batch, "fold_matmul", tier,
                              mdct.compute_dtype)
            tol_i = tolerance(torch, ibatch, "matmul_scatter", tier,
                              mdct.compute_dtype)
            check(fwd.shape == batch.shape and err_f <= tol_f,
                  f"stream ({cfg}) {cb}: analysis max-abs {err_f} > {tol_f}")
            check(inv.shape == ibatch.shape and err_i <= tol_i,
                  f"stream ({cfg}) {cb}: synthesis max-abs {err_i} > "
                  f"{tol_i}")
            out[f"{cfg}/{cb}"] = dict(
                blocks=blocks, launches=dict(analysis=steps, synthesis=steps),
                analysis_max_abs=err_f, synthesis_max_abs=err_i,
                bit_equal=err_f == 0.0 and err_i == 0.0)
            print(f"stream == batch ({cfg}) {tier}, 1 x 2 ch x {blocks} "
                  f"blocks in chunks of {cb}: launches fold_matmul "
                  f"{fwd_counts['fold_matmul']}, matmul_scatter "
                  f"{inv_counts['matmul_scatter']}; max-abs analysis "
                  f"{err_f:.3g} (tolerance {tol_f:.3g}), synthesis "
                  f"{err_i:.3g} ({tol_i:.3g}) [{card}]")
        del mdct
    return out


def stream_chunks(sc, path, levels=False):
    """The codes of every chunk of a stream, on the host; with ``levels``
    also the sidecar's grid levels."""
    import numpy as np

    from audiocodec_tpu_torch import scq

    with sc.StreamReader(path) as r:
        chunks = [r.read_chunk(i) for i in range(r.n_chunks)]
        k2 = r.meta.get("scq", 0)
    codes = np.concatenate([c.codes for c in chunks], axis=0)
    if not levels:
        return codes
    return codes, np.concatenate(
        [scq.levels_from_bark16(c.bark, k2) for c in chunks], axis=0)


def stream_throughput(torch, dev, codec, seconds, workdir, card):
    """18b. ``encode_stream`` and ``decode_stream`` of ``seconds`` of
    stereo in (r), default features: audio-s/s each way, the launches (one
    analysis a chunk and the flush; one synthesis a chunk, the flush chunk
    and the tail), codes against the all-plain stream's, the decode
    against the plain synthesis's decode of the same file (an all-plain
    stream's SNR differs from it by the codes that a rounding flipped,
    which add up with the stream's length: it is printed, not held);
    seeks from chunk 1 and the middle equal the full
    decode bit for bit (time to the first chunk); a traced encode and
    decode of STREAM_TRACE_CHUNKS chunks: device busy, idle share and the
    ``stream.*`` host spans (the decoder's read runs in its worker thread,
    which the trace does not record: it is timed alone)."""
    import numpy as np

    from audiocodec_tpu_torch.io import stream_container as sc

    x = stream_signal(torch, "cpu", seconds)
    s = x.shape[1]
    n_body = s // (STREAM_CB * FILTERS_N)
    audio_s = s / STREAM_SR
    path, plain_path = (str(workdir / f) for f in ("long.acs", "plain.acs"))

    def decode(p):
        out = torch.cat(list(sc.decode_stream(codec, p)), dim=1)
        torch.cuda.synchronize()
        return out

    # a short stream first: the first call's allocations and the native
    # library's load are not the path's steady state
    warm = str(workdir / "warm.acs")
    sc.encode_stream(codec, x[:, :2 * STREAM_CB * FILTERS_N], warm,
                     chunk_blocks=STREAM_CB)
    decode(warm)
    reset_all_launch_counts()
    t0 = time.perf_counter()
    n_chunks = sc.encode_stream(codec, x, path, chunk_blocks=STREAM_CB)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    enc_counts = all_launch_counts()
    reset_all_launch_counts()
    t0 = time.perf_counter()
    y = decode(path)
    dec_s = time.perf_counter() - t0
    dec_counts = all_launch_counts()
    check(n_chunks == n_body + 1, f"stream: {n_chunks} chunks")
    check(enc_counts == stream_counts(fold_matmul=n_body + 1),
          f"stream: encode launches {enc_counts}")
    check(dec_counts == stream_counts(matmul_scatter=n_body + 2),
          f"stream: decode launches {dec_counts}")
    n = FILTERS_N
    check(y.shape == (1, s + 2 * n, 2) and bool(torch.isfinite(y).all()),
          f"stream: decode {tuple(y.shape)}")
    xd = x.to(dev)
    snr = snr_db(xd, y)
    # seeks: from chunk 1 and from the middle, bit for bit
    seeks = {}
    for k in (1, n_body // 2):
        t0 = time.perf_counter()
        gen = sc.decode_stream(codec, path, start_chunk=k)
        first = next(gen)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        rest = torch.cat([first] + list(gen), dim=1)
        check(torch.equal(rest, y[:, k * STREAM_CB * n:]),
              f"stream: seek from chunk {k} differs from the full decode")
        seeks[k] = first_ms
    with plain_kernels():
        plain_dec = decode(path)
        sc.encode_stream(codec, x, plain_path, chunk_blocks=STREAM_CB)
        plain_y = decode(plain_path)
    dec_err = float((y - plain_dec).abs().max())
    dec_tol = tolerance(torch, plain_dec, "matmul_scatter",
                        codec.mdct.kernel_precision, codec.mdct.compute_dtype)
    plain_dec_snr = snr_db(xd, plain_dec)
    plain_snr = snr_db(xd, plain_y)
    t0 = time.perf_counter()
    codes = stream_chunks(sc, path)
    read_ms = (time.perf_counter() - t0) * 1e3
    codes, lv = stream_chunks(sc, path, levels=True)
    plain_codes, plain_lv = stream_chunks(sc, plain_path, levels=True)
    diff = np.abs(codes.astype(np.int64) - plain_codes)
    same = float((diff == 0).mean())
    lv_diff = np.abs(lv - plain_lv)
    lv_same = float((lv_diff == 0).mean())
    # a sidecar level one grid step away (0.75 dB) moves every step size of
    # its band, and a large code by more than one: codes are held within
    # one step on the frames whose sidecar is equal
    frames_same = (lv_diff == 0).all(axis=(1, 2))
    max_diff = int(diff[frames_same].max(initial=0))
    del codes, plain_codes, lv, plain_lv
    del xd, y, plain_dec, plain_y

    # a traced window of a few chunks, after a first trace that starts the
    # profiler
    trace_search(torch, lambda: decode(warm), prefix="stream.")
    short = x[:, :STREAM_TRACE_CHUNKS * STREAM_CB * n]
    tpath = str(workdir / "trace.acs")
    _, enc_trace = trace_search(torch, lambda: sc.encode_stream(
        codec, short, tpath, chunk_blocks=STREAM_CB), prefix="stream.")
    _, dec_trace = trace_search(torch, lambda: decode(tpath),
                                prefix="stream.")
    size = Path(path).stat().st_size
    out = dict(seconds=audio_s, chunks=n_chunks, bytes=size,
               kbps=size * 8 / audio_s / 1e3,
               encode_s=enc_s, decode_s=dec_s,
               encode_audio_s_per_s=audio_s / enc_s,
               decode_audio_s_per_s=audio_s / dec_s,
               launches=dict(encode=launched(enc_counts),
                             decode=launched(dec_counts)),
               read_ms_per_chunk=read_ms / n_chunks,
               codes_equal_to_plain=same, sidecar_equal_to_plain=lv_same,
               frames_of_unequal_sidecar=int((~frames_same).sum()),
               max_code_diff_on_equal_sidecar=max_diff,
               decode_max_abs_to_plain=dec_err, decode_tolerance=dec_tol,
               snr_db=snr, plain_decode_snr_db=plain_dec_snr,
               plain_snr_db=plain_snr,
               seek_first_chunk_ms=seeks, traced_encode=enc_trace,
               traced_decode=dec_trace)

    def spans(t):
        return ", ".join(f"{k} {v:.1f} ms" for k, v in
                         sorted(t["host_ms"].items()))

    print(f"stream (r) 1 x 2 ch x {audio_s:.1f} s at {STREAM_SR} Hz, "
          f"{n_chunks} chunks of {STREAM_CB} blocks: {size} bytes "
          f"({out['kbps']:.1f} kbps); encode {enc_s:.3f} s = "
          f"{out['encode_audio_s_per_s']:.1f} audio-s/s, decode "
          f"{dec_s:.3f} s = {out['decode_audio_s_per_s']:.1f} audio-s/s "
          f"(a chunk's read, CRC and Rice decode on the host alone "
          f"{out['read_ms_per_chunk']:.2f} ms); "
          f"launches encode {launched(enc_counts)}, decode "
          f"{launched(dec_counts)}; codes equal to the all-plain stream "
          f"{same} (sidecar levels {lv_same}, "
          f"{out['frames_of_unequal_sidecar']} frames with a level apart, "
          f"elsewhere codes within {max_diff}); decode vs the plain "
          f"synthesis's max-abs {dec_err:.3g} (tolerance {dec_tol:.3g}); "
          f"SNR {snr:.9f} dB (plain synthesis {plain_dec_snr:.9f}, all-plain "
          f"stream {plain_snr:.9f}); seek to "
          f"first chunk " + ", ".join(f"from {k} {v:.1f} ms" for k, v in
                                      seeks.items()) + f" [{card}]")
    for name, t in (("encode", enc_trace), ("decode", dec_trace)):
        print(f"stream traced {name} of {STREAM_TRACE_CHUNKS} chunks: wall "
              f"{t['wall_ms']:.1f} ms, device busy {t['device_busy_ms']:.1f} "
              f"ms of a {t['device_span_ms']:.1f} ms span (idle share "
              f"{t['idle_share']:.3f}), host {spans(t)} [{card}]")
    # the numbers are printed first: a run that misses a bound still
    # reports what it measured
    check(same >= LADDER_EQUAL and lv_same >= LADDER_EQUAL
          and int(lv_diff.max()) <= 1 and max_diff <= 1,
          f"stream: codes {same} and sidecar levels {lv_same} equal to "
          f"all-plain, level diff {lv_diff.max()}, code diff {max_diff} on "
          "frames of equal sidecars")
    check(dec_err <= dec_tol,
          f"stream: decode max-abs {dec_err} > {dec_tol} from the plain "
          "synthesis's")
    return out


def corrupt_chunk(sc, src, dst, chunk):
    """A copy of the stream ``src`` with one byte of a chunk's codes
    flipped."""
    data = bytearray(Path(src).read_bytes())
    with sc.StreamReader(src) as r:
        off = r._index[chunk] + 12
    data[off] ^= 0xFF
    Path(dst).write_bytes(bytes(data))


def stream_window(torch, sc, codec, path, start, chunks, **kw):
    """``chunks`` chunks of a decode from chunk ``start``, on the host."""
    import itertools

    gen = sc.decode_stream(codec, path, start_chunk=start, **kw)
    out = torch.cat(list(itertools.islice(gen, chunks)), dim=1)
    gen.close()
    return out.float().cpu()


def stream_features(torch, dev, codec, workdir, card):
    """18c. The feature ladder (STREAM_LADDER) on 60 s of stereo: one chunk
    corrupted, decoded with concealment on the card (the FEC rebuild; with
    ``fec=0`` the interpolating concealment, whose signs equal the CPU's
    threefry draw) against the CPU's decode of the same chunks; a DTX
    stream over silent spans; a CBR stream at STREAM_CBR_KBPS with the bit
    reservoir, each chunk within its excursion bound; the golden vector
    cbr_stream.acs."""
    import hashlib

    import numpy as np

    from audiocodec_tpu_torch.io import stream_container as sc

    n = FILTERS_N
    chunk = STREAM_CB * n
    cpu = stream_codec(torch, "cpu", "r")
    x = stream_signal(torch, "cpu", STREAM_EQUAL_SECONDS)
    n_body = x.shape[1] // chunk
    lost = n_body // 2
    out = {}
    for fec in (STREAM_LADDER_FEC, 0.0):
        src, bad = (str(workdir / f"ladder{fec}{s}.acs") for s in ("", "b"))
        reset_all_launch_counts()
        with torch.no_grad():
            sc.encode_stream(codec, x, src, chunk_blocks=STREAM_CB, fec=fec,
                             **STREAM_LADDER)
        torch.cuda.synchronize()
        counts = all_launch_counts()
        check(counts == stream_counts(fold_matmul=n_body + 1),
              f"stream ladder fec={fec}: launches {counts}")
        corrupt_chunk(sc, src, bad, lost)
        try:
            stream_window(torch, sc, codec, bad, lost, 1)
            check(False, "stream ladder: a corrupt chunk decoded")
        except ValueError:
            pass
        got = stream_window(torch, sc, codec, bad, lost - 1, 3, conceal=True)
        want = stream_window(torch, sc, cpu, bad, lost - 1, 3, conceal=True)
        tol = tolerance(torch, want, "matmul_scatter", "highest",
                        torch.float32)
        err = float((got - want).abs().max())
        check(got.shape == want.shape == (1, 3 * chunk, 2) and err <= tol,
              f"stream ladder fec={fec}: card vs CPU {err} > {tol}")
        span = got[:, chunk:2 * chunk]
        check(float(span.abs().max()) > 1e-3,
              f"stream ladder fec={fec}: the concealed chunk is silent")
        entry = dict(bytes=Path(src).stat().st_size, max_abs_vs_cpu=err,
                     tolerance=tol)
        if not fec:
            like = torch.zeros(1, 1, n, 2, device=dev)
            signs = {}
            for key in (sc._CONCEAL_KEY, sc._INTERP_KEY):
                card_signs = sc._signs(key, lost, like, STREAM_CB).cpu()
                cpu_signs = sc._signs(key, lost, like.cpu(), STREAM_CB)
                check(torch.equal(card_signs, cpu_signs),
                      f"stream: concealment signs {key:#x} differ")
                signs[f"{key:#x}"] = float((card_signs > 0).float().mean())
            entry["signs_positive_share"] = signs
        out[f"fec={fec}"] = entry
        print(f"stream ladder (r) {STREAM_LADDER} fec={fec}, 60 s stereo: "
              f"{entry['bytes']} bytes; chunk {lost} corrupted: decode "
              f"raises without conceal; with conceal ("
              f"{'FEC rebuild' if fec else 'interpolation'}) card vs CPU "
              f"max-abs {err:.3g} (tolerance {tol:.3g})"
              + (f"; signs equal to the CPU's threefry draw "
                 f"{entry['signs_positive_share']}" if not fec else "")
              + f" [{card}]")

    # DTX over digital silence and a -100 dBFS noise floor
    xd = x.clone()
    xd[:, 3 * chunk:6 * chunk] = 0.0
    xd[:, 5 * chunk:6 * chunk] += 1e-5 * torch.randn(
        chunk, 2, generator=torch.Generator().manual_seed(2))
    dtx_path = str(workdir / "dtx.acs")
    with torch.no_grad():
        sc.encode_stream(codec, xd, dtx_path, chunk_blocks=STREAM_CB,
                         dtx=STREAM_DTX)
    with sc.StreamReader(dtx_path) as r:
        silent = [i for i in range(r.n_chunks)
                  if r.read_chunk(i).silent is not None]
    check(silent == [4, 5], f"stream dtx: silent records {silent}")
    got = stream_window(torch, sc, codec, dtx_path, 3, 3)
    want = stream_window(torch, sc, cpu, dtx_path, 3, 3)
    err = float((got - want).abs().max())
    tol = tolerance(torch, want, "matmul_scatter", "highest", torch.float32)
    check(err <= tol and float(got[:, chunk:2 * chunk].abs().max()) == 0.0
          and 0 < float(got[:, 2 * chunk:].abs().max()) < 1e-3,
          f"stream dtx: card vs CPU {err}, silence or comfort noise wrong")
    dtx_bytes = Path(dtx_path).stat().st_size
    out["dtx"] = dict(silent_chunks=silent, bytes=dtx_bytes,
                      max_abs_vs_cpu=err)
    print(f"stream dtx {STREAM_DTX} dBFS: silent records {silent}, "
          f"{dtx_bytes} bytes; chunks 3-5 card vs CPU max-abs {err:.3g} "
          f"[{card}]")

    # CBR with the bit reservoir
    cbr_path = str(workdir / "cbr.acs")
    t0 = time.perf_counter()
    with torch.no_grad():
        n_chunks, scales, kbps = sc.encode_stream_cbr(
            codec, x, cbr_path, chunk_blocks=STREAM_CB,
            target_kbps=STREAM_CBR_KBPS,
            reservoir_kbits=STREAM_RESERVOIR_KBITS)
    torch.cuda.synchronize()
    cbr_s = time.perf_counter() - t0
    with sc.StreamReader(cbr_path) as r:
        check(r.meta.get("cbr") == 1, "stream cbr: no cbr flag")
        sizes = np.array([r.chunk_bytes(i) for i in range(n_body)])
    dev_kbit = (np.cumsum(sizes) - sizes.mean() * np.arange(1, n_body + 1)
                ) * 8e-3
    # tests/test_stream_container.py's bound: the reservoir plus the
    # per-chunk search tolerance (5%) accumulated over the prefix
    bound = STREAM_RESERVOIR_KBITS + 0.05 * sizes.mean() * 8e-3 * n_body
    check(np.abs(dev_kbit).max() <= bound
          and abs(kbps - STREAM_CBR_KBPS) <= 0.15 * STREAM_CBR_KBPS,
          f"stream cbr: excursion {np.abs(dev_kbit).max()} > {bound} or "
          f"{kbps} kbps")
    y = torch.cat(list(sc.decode_stream(codec, cbr_path)), dim=1)
    check(bool(torch.isfinite(y).all()), "stream cbr: non-finite decode")
    out["cbr"] = dict(kbps=kbps, scales=scales, search_s=cbr_s,
                      max_excursion_kbit=float(np.abs(dev_kbit).max()),
                      bound_kbit=bound)
    print(f"stream cbr {STREAM_CBR_KBPS} kbps, reservoir "
          f"{STREAM_RESERVOIR_KBITS} kbit: {kbps:.2f} kbps, {n_chunks} "
          f"chunks, max excursion {np.abs(dev_kbit).max():.2f} kbit "
          f"(bound {bound:.2f}), {cbr_s:.1f} s [{card}]")

    # the golden vector, on the card
    vec = Path(__file__).resolve().parent / "tests" / "vectors"
    manifest = json.loads((vec / "manifest.json").read_text())
    want = manifest["cbr_stream.acs"]
    path = str(vec / "cbr_stream.acs")
    with sc.StreamReader(path) as r:
        meta = r.meta
    codes = stream_chunks(sc, path)
    check(hashlib.sha256(np.ascontiguousarray(codes, np.int32).tobytes())
          .hexdigest() == want["codes_sha256"],
          "vector cbr_stream.acs: codes' sha256")
    from audiocodec_tpu_torch import Codec

    vcodec = Codec.create(meta["sample_rate"], filters_n=meta["filters_n"],
                          bark_bands_n=meta["bark_bands_n"], device=dev)
    wave = torch.cat(list(sc.decode_stream(vcodec, path)), dim=1)
    wave = wave[0, :meta["nsamp"]].double().cpu().numpy()
    pcm = np.load(vec / "cbr_stream.acs.pcm.npy").astype(np.int64)
    got = np.round(np.clip(wave, -1, 1) * 32767.0).astype(np.int64)
    check(got.shape == pcm.shape, f"vector cbr_stream.acs: {got.shape}")
    lsb = int(np.abs(got - pcm).max())
    check(lsb <= ACZ_VECTOR_LSB, f"vector cbr_stream.acs: PCM {lsb} LSB away")
    out["vector_max_lsb"] = lsb
    print(f"stream vector cbr_stream.acs on the card: codes' sha256 equal, "
          f"PCM within {lsb} LSB [{card}]")
    return out


def stream_phase(torch, dev, seconds, card):
    """18. The .acs stream path (BASELINE.md config 5) on the card."""
    import tempfile

    from audiocodec_tpu_torch import native

    check(native.available(), f"native library: {native.build_error()}")
    codec = stream_codec(torch, dev, "r")
    check(codec.mdct.use_kernel is True,
          "stream: kernels off in configuration (r)")
    out = dict(equal=stream_equal(torch, dev, card))
    work = Path(__file__).resolve().parent / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        out["throughput"] = stream_throughput(torch, dev, codec, seconds,
                                              Path(tmp), card)
        out["features"] = stream_features(torch, dev, codec, Path(tmp), card)
    return out


def cli_signal(seconds, rate, channels=2, seed=SEED, noise=0.03):
    """Music-like float64 [samples, channels] in [-1, 1] from a numpy seed:
    three tones over a noise floor of ``noise`` RMS, an attack after a gap
    every half second, the second channel the first at 0.8 plus its own
    noise at a third of the floor."""
    import numpy as np

    rng = np.random.default_rng(seed)
    s = int(seconds * rate)
    t = np.arange(s) / rate
    x = (0.3 * np.sin(2 * np.pi * 440 * t)
         + 0.1 * np.sin(2 * np.pi * 1320 * t)
         + 0.02 * np.sin(2 * np.pi * 7000 * t)
         + noise * rng.standard_normal(s))
    half = rate // 2
    for start in range(half, s - half, half):
        x[start:start + 512] *= 0.01
        x[start + 512:start + 768] += 0.5 * rng.standard_normal(256)
    x = np.clip(x, -1.0, 1.0)
    x = np.stack([x, 0.8 * x + noise / 3 * rng.standard_normal(s)], axis=1)
    return x[:, :channels]


def kernel_launches(torch, fn):
    """The device kernels that one call of ``fn`` launches (a trace)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def cli_call(torch, argv, device="cuda"):
    """``audiocodec_tpu_torch.__main__.main(argv)`` in-process, the launch
    counters set to 0 just before it: (wall ms, the counts, stdout). Fails
    unless it exits 0."""
    import contextlib
    import io

    from audiocodec_tpu_torch.__main__ import main as cli_main

    out = io.StringIO()
    card = torch.device(device).type == "cuda"
    if card:
        torch.cuda.synchronize()
    reset_all_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv, device=device)
    if card:
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = all_launch_counts()
    check(rc == 0, f"cli {' '.join(argv)}: exit {rc}; {out.getvalue()}")
    return ms, counts, out.getvalue()


def pcm16(path):
    """A 16-bit WAV's samples as int64 [1, samples, channels]."""
    import numpy as np

    from audiocodec_tpu_torch import native

    x, rate = native.decode_wav(str(path))
    return np.round(x.astype(np.float64) * 32768.0).astype(np.int64), rate


def cli_lossless(torch, dev, work, card):
    """19c. ``encode --lossless`` at levels 1 and 2 of a 24-bit stereo file
    and ``decode``, bit for bit, a ``--start/--duration`` window equal to
    the slice, and the golden v2/v3 vectors decoded on the card."""
    import numpy as np

    from audiocodec_tpu_torch import lossless
    from audiocodec_tpu_torch.io import wav

    src = work / "pcm24.wav"
    # a noise floor near -80 dBFS: ~10 of the 24 bits are noise
    x24 = np.round(cli_signal(CLI_LOSSLESS_SECONDS, SAMPLE_RATE, seed=SEED + 1,
                              noise=1e-4) * ((1 << 23) - 1)).astype(np.int32)
    wav.write_wav_int(str(src), x24, SAMPLE_RATE, 24)
    out = {}
    for level in ("1", "2"):
        blob, dst = work / f"l{level}.acz", work / f"l{level}.wav"
        enc = ["encode", str(src), str(blob), "--lossless",
               "--lossless-level", level]
        dec = ["decode", str(blob), str(dst)]
        # the second of two calls each, as phase 19's ``timed``
        cli_call(torch, enc, dev)
        enc_ms, enc_counts, _ = cli_call(torch, enc, dev)
        cli_call(torch, dec, dev)
        dec_ms, _, _ = cli_call(torch, dec, dev)
        y, rate, bits = wav.read_wav_int(str(dst))
        check((rate, bits) == (SAMPLE_RATE, 24) and np.array_equal(y, x24),
              f"cli lossless level {level}: decode differs from the input")
        start, dur = CLI_LOSSLESS_WINDOW
        win = work / f"l{level}-w.wav"
        cli_call(torch, ["decode", str(blob), str(win), "--start", str(start),
                         "--duration", str(dur)], dev)
        s0 = start * SAMPLE_RATE
        check(np.array_equal(wav.read_wav_int(str(win))[0],
                             x24[s0:s0 + dur * SAMPLE_RATE]),
              f"cli lossless level {level}: window differs from the slice")
        size = blob.stat().st_size
        out[f"level{level}"] = dict(
            bytes=size, share_of_pcm=size / x24.nbytes * 4 / 3,
            encode_ms=enc_ms, decode_ms=dec_ms,
            encode_audio_s_per_s=CLI_LOSSLESS_SECONDS / enc_ms * 1e3,
            decode_audio_s_per_s=CLI_LOSSLESS_SECONDS / dec_ms * 1e3,
            describe=lossless.describe(blob.read_bytes()))
        check(not launched(enc_counts), f"cli lossless: {enc_counts}")
    vec = Path(__file__).resolve().parent / "tests" / "vectors"
    for name in ("lossless_v2", "lossless_v3"):
        y, _, _ = lossless.decode_lossless((vec / f"{name}.bin").read_bytes(),
                                           device=dev)
        check(np.array_equal(y, np.load(vec / f"{name}.pcm.npy")),
              f"cli lossless: vector {name} differs on the card")
    for level in ("1", "2"):
        r = out[f"level{level}"]
        print(f"cli lossless level {level} ({CLI_LOSSLESS_SECONDS} s, 2 ch "
              f"24-bit): {r['bytes']} bytes ({100 * r['share_of_pcm']:.1f}% "
              f"of PCM, {r['describe']['entropy']}), encode "
              f"{r['encode_ms']:.1f} ms = {r['encode_audio_s_per_s']:.1f} "
              f"audio-s/s, decode {r['decode_ms']:.1f} ms = "
              f"{r['decode_audio_s_per_s']:.1f} audio-s/s; bit for bit, "
              f"window equal [{card}]")
    print(f"cli lossless: vectors lossless_v2, lossless_v3 bit for bit on "
          f"the card [{card}]")
    return out


def cli_phase(torch, dev, card):
    """19. The command line (``audiocodec_tpu_torch.__main__``) on the card
    at its defaults (N=1024, 64 Bark bands, f32 ``highest``, sidecar grid
    4), in-process through ``main([...])``, on a 60 s 44.1 kHz stereo
    PCM16 file and a 10 s 24-bit stereo one; one ``python -m
    audiocodec_tpu_torch info`` in a subprocess."""
    import tempfile

    import numpy as np

    from audiocodec_tpu_torch import metrics, native, scq
    from audiocodec_tpu_torch.io import bitstream
    from audiocodec_tpu_torch.resample import Resampler

    check(native.available(), f"native library: {native.build_error()}")
    work_root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    work_root.mkdir(parents=True, exist_ok=True)
    audio_s = CLI_SECONDS
    out = {}
    with tempfile.TemporaryDirectory(dir=work_root) as tmp:
        work = Path(tmp)
        src = work / "music.wav"
        native.write_wav(str(src), cli_signal(CLI_SECONDS, SAMPLE_RATE),
                         SAMPLE_RATE)
        x, _ = native.decode_wav(str(src))
        times = {}

        def timed(name, argv, seconds=audio_s):
            """The second of two calls: the first warms the path (the
            native library, the kernels' first loads, the allocator)."""
            cli_call(torch, argv, dev)
            ms, counts, text = cli_call(torch, argv, dev)
            times[name] = dict(ms=ms, audio_s_per_s=seconds / ms * 1e3)
            return counts, text

        # 19a. encode --preset music -> .acz, decode
        acz, dst = work / "music.acz", work / "music_out.wav"
        enc = ["encode", str(src), str(acz), "--preset", "music"]
        enc_counts, _ = timed("encode .acz", enc)
        dec_counts, _ = timed("decode .acz", ["decode", str(acz), str(dst)])
        check(enc_counts == expected_counts(fold_matmul=1)
              and dec_counts == expected_counts(matmul_scatter=1),
              f"cli: launches encode {enc_counts}, decode {dec_counts}")
        y, rate = pcm16(dst)
        check(rate == SAMPLE_RATE and y.shape == (1, x.shape[1], 2),
              f"cli: decoded {y.shape} @ {rate} vs input {x.shape}")
        plain_acz = work / "plain.acz"
        with plain_kernels():
            cli_call(torch, ["encode", str(src), str(plain_acz),
                             "--preset", "music"], dev)
            cli_call(torch, ["decode", str(acz), str(work / "pdec.wav")],
                     dev)
            cli_call(torch, ["decode", str(plain_acz),
                             str(work / "plain_out.wav")], dev)
        codes, bark, meta = bitstream.load(str(acz))
        pcodes, pbark, _ = bitstream.load(str(plain_acz))
        check(container_entropy(str(acz)) in ("rice", "rrice"),
              "cli: the container is not Rice-coded")
        lv, plv = (scq.levels_from_bark16(b, meta["sidecar_grid"])
                   for b in (bark, pbark))
        lv_diff = np.abs(lv - plv)
        check(lv_diff.max() <= 1, f"cli: sidecar levels {lv_diff.max()} "
              "grid steps from the all-plain container")
        diff = np.abs(codes.astype(np.int64) - pcodes)
        same = float((diff == 0).mean())
        frames_same = (lv_diff == 0).all(axis=(2, 3))[..., None, None]
        max_diff = int(np.where(frames_same, diff, 0).max())
        check(same >= LADDER_EQUAL and max_diff <= 1,
              f"cli: codes {same} equal to the all-plain container's, "
              f"{max_diff} steps apart where the sidecar is equal")
        lsb = int(np.abs(y - pcm16(work / "pdec.wav")[0]).max())
        check(lsb <= ACZ_VECTOR_LSB,
              f"cli: decode {lsb} LSB from the plain synthesis's")

        def snr(path):
            ref = np.round(x.astype(np.float64) * 32768.0)
            err = ((ref - pcm16(path)[0]) ** 2).sum()
            return float(10 * math.log10((ref ** 2).sum() / max(err, 1e-300)))

        got_snr, plain_snr = snr(dst), snr(work / "plain_out.wav")
        check(abs(got_snr - plain_snr) <= SNR_MARGIN_DB,
              f"cli: SNR {got_snr} vs all-plain {plain_snr}")
        out["acz"] = dict(bytes=acz.stat().st_size, frames=codes.shape[1],
                          launches=dict(encode=launched(enc_counts),
                                        decode=launched(dec_counts)),
                          codes_equal_to_plain=same,
                          sidecar_equal_to_plain=float((lv_diff == 0).mean()),
                          decode_lsb_to_plain_synthesis=lsb,
                          snr_db=got_snr, plain_snr_db=plain_snr)

        # 19b. .acs: the full decode and a window of it
        acs = work / "music.acs"
        acs_counts, _ = timed("encode .acs", [
            "encode", str(src), str(acs), "--chunk-blocks",
            str(CLI_CHUNK_BLOCKS)])
        timed("decode .acs", ["decode", str(acs), str(work / "full.wav")])
        start, dur = CLI_WINDOW
        timed("decode .acs window", [
            "decode", str(acs), str(work / "win.wav"), "--start", str(start),
            "--duration", str(dur)], seconds=dur)
        full, _ = pcm16(work / "full.wav")
        win, _ = pcm16(work / "win.wav")
        s0 = start * SAMPLE_RATE
        check(full.shape == y.shape
              and np.array_equal(win, full[:, s0:s0 + dur * SAMPLE_RATE]),
              "cli: the .acs window differs from the full decode")
        out["acs"] = dict(bytes=acs.stat().st_size,
                          launches=launched(acs_counts))

        # 19c. lossless
        out["lossless"] = cli_lossless(torch, dev, work, card)

        # 19d. resample, against the plain CPU run of the same Resampler
        r48 = work / "r48.wav"
        res_counts, _ = timed("resample", ["resample", str(src), str(r48),
                                           "--rate", str(CLI_RESAMPLE_RATE)])
        xr = torch.from_numpy(x)
        want = Resampler.create(SAMPLE_RATE, CLI_RESAMPLE_RATE,
                                device="cpu").resample(xr)
        got = Resampler.create(SAMPLE_RATE, CLI_RESAMPLE_RATE,
                               device=dev).resample(xr.to(dev)).cpu()
        rs_err = float((got - want).abs().max() / want.abs().max())
        check(rs_err <= CLI_RESAMPLE_TOL,
              f"cli: resample {rs_err} of the peak from the CPU's")
        r, rate = pcm16(r48)
        check(rate == CLI_RESAMPLE_RATE and r.shape[1] == want.shape[1],
              f"cli: resampled {r.shape} @ {rate}")
        cli_call(torch, ["encode", str(src), str(work / "r.acz"),
                         "--resample-to", str(CLI_RESAMPLE_RATE)], dev)
        _, _, rmeta = bitstream.load(str(work / "r.acz"))
        check(rmeta["sample_rate"] == CLI_RESAMPLE_RATE
              and rmeta["orig_samples"] == want.shape[1],
              f"cli: --resample-to container {rmeta['sample_rate']}, "
              f"{rmeta['orig_samples']} samples")
        out["resample"] = dict(max_err_to_cpu=rs_err,
                               launches=launched(res_counts))

        # 19e. eval --json against the same call on the CPU
        ev = ["eval", str(src), str(dst), "--json"]
        ev_counts, text = timed("eval", ev)
        card_ev = json.loads(text.splitlines()[-1])
        _, _, text = cli_call(torch, ev, device="cpu")
        cpu_ev = json.loads(text.splitlines()[-1])
        check(ev_counts == {k: 2 * int(k == "fold_matmul")
                            for k in ev_counts},
              f"cli: eval launches {ev_counts}")
        for k in ("snr_db", "seg_snr_db", "nmr_db"):
            check(abs(card_ev[k] - cpu_ev[k]) <= CLI_EVAL_DB,
                  f"cli: eval {k} {card_ev[k]} vs the CPU's {cpu_ev[k]}")
        for k in ("lufs_ref", "lufs_deg"):
            check(abs(card_ev[k] - cpu_ev[k]) <= CLI_LUFS + 1e-9,
                  f"cli: eval {k} {card_ev[k]} vs the CPU's {cpu_ev[k]}")
        out["eval"] = dict(card=card_ev, cpu=cpu_ev,
                           launches=launched(ev_counts))

        # 19f. the loudness pass alone (CUDA events; its kernel launches from
        # a trace) and the --tag-loudness tag against the CPU's
        xd = torch.from_numpy(x).to(dev)
        metrics.loudness_lufs(xd, SAMPLE_RATE)
        lufs_ms = cuda_ms(torch, lambda: metrics.loudness_lufs(
            xd, SAMPLE_RATE), iters=5, warmup=1)
        lufs_kernels = kernel_launches(
            torch, lambda: metrics.loudness_lufs(xd, SAMPLE_RATE))
        tagged = work / "tagged.acz"
        timed("encode --tag-loudness", ["encode", str(src), str(tagged),
                                        "--tag-loudness"])
        _, _, tmeta = bitstream.load(str(tagged))
        cpu_tag = round(float(metrics.loudness_lufs(
            torch.from_numpy(x), SAMPLE_RATE)), 2)
        check(tmeta["lufs"] == cpu_tag,
              f"cli: tag {tmeta['lufs']} vs the CPU's {cpu_tag}")
        _, text = timed("decode --normalize-lufs", [
            "decode", str(tagged), str(work / "norm.wav"),
            "--normalize-lufs", "-16"])
        check(text.startswith(f"loudness: {cpu_tag:.2f} LUFS"),
              f"cli: normalize printed {text.splitlines()[0]}")
        out["loudness"] = dict(ms=lufs_ms, kernel_launches=lufs_kernels,
                               tag=tmeta["lufs"], cpu_tag=cpu_tag)

        # 19g. the module entry point, in a subprocess
        proc = subprocess.run(
            [sys.executable, "-m", "audiocodec_tpu_torch", "info", str(acz)],
            cwd=Path(__file__).resolve().parent, capture_output=True,
            text=True, timeout=300)
        check(proc.returncode == 0 and "blocks:" in proc.stdout,
              f"cli: python -m audiocodec_tpu_torch info: "
              f"{proc.returncode} {proc.stderr[-500:]}")
    out["times"] = times
    print(f"cli music (--preset music, {CLI_SECONDS} s 2 ch, (r) defaults): "
          f"{out['acz']['bytes']} bytes; launches encode "
          f"{out['acz']['launches']['encode']}, decode "
          f"{out['acz']['launches']['decode']}; gapless; codes equal to the "
          f"all-plain CLI's {same}, sidecar {out['acz']['sidecar_equal_to_plain']}"
          f"; decode {lsb} LSB from the plain synthesis's; SNR "
          f"{got_snr:.4f} dB (all-plain {plain_snr:.4f}) [{card}]")
    print(f"cli .acs window --start {start} --duration {dur} bit for bit; "
          f"resample {rs_err:.3g} of the peak from the CPU; eval on the card "
          f"{card_ev} vs CPU {cpu_ev}; launches eval "
          f"{out['eval']['launches']} [{card}]")
    print(f"cli loudness pass alone: {lufs_ms:.3f} ms on {CLI_SECONDS} s 2 "
          f"ch, {lufs_kernels} kernel launches; tag {tmeta['lufs']} (CPU "
          f"{cpu_tag}) [{card}]")
    print("cli times: " + ", ".join(
        f"{k} {v['ms']:.1f} ms = {v['audio_s_per_s']:.1f} audio-s/s"
        for k, v in times.items()) + f" [{card}]")
    return out


def cli_codec(torch, dev, argv):
    """The codec the command line builds for ``argv`` (its defaults: N=1024,
    64 Bark bands, f32 ``highest``, sidecar grid 4) on ``dev``."""
    from audiocodec_tpu_torch import __main__ as cli

    args = cli._parser().parse_args(argv)
    args.device = torch.device(dev)
    rate = args.sample_rate
    return cli._build_codec(rate, args)


def serve_clips(count, seconds=SERVE_SECONDS, rate=SAMPLE_RATE):
    """``count`` PCM16 WAV blobs of ``seconds`` mono, from a numpy seed:
    windows of one ``cli_signal`` at their own offsets and gains."""
    import numpy as np

    from audiocodec_tpu_torch.io import wav

    s = int(seconds * rate)
    base = cli_signal(2 * seconds, rate, channels=1)[:, 0]
    rng = np.random.default_rng(SEED + 20)
    offsets = rng.integers(0, s, count)
    gains = rng.uniform(0.4, 1.0, count)
    return [wav.write_wav_bytes((base[o:o + s] * g)[:, None], rate)
            for o, g in zip(offsets, gains)]


def serve_port(line):
    """The TCP port in the serve command's first line ("serving ... on
    host:port (max batch ...")."""
    import re

    m = re.search(r" on [^ ]+:(\d+) \(", line)
    if m is None:
        raise PhaseError(f"serve: no port in {line!r}")
    return int(m.group(1))


def spawn_server(rate, work):
    """``python -m audiocodec_tpu_torch serve --sample-rate rate --port 0``
    in a subprocess, its standard error to a file of ``work``."""
    with open(work / f"serve{rate}.err", "w") as err:
        return subprocess.Popen(
            [sys.executable, "-m", "audiocodec_tpu_torch", "serve",
             "--sample-rate", str(rate), "--port", "0"],
            cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
            stderr=err, text=True)


def server_port(proc, rate, work):
    """The port of a spawned server, from its first line."""
    import select

    ready, _, _ = select.select([proc.stdout], [], [], SERVE_START_S)
    line = proc.stdout.readline() if ready else ""
    if not line:
        raise PhaseError(f"serve {rate}: no first line in {SERVE_START_S} s: "
                         + (work / f"serve{rate}.err").read_text()[-2000:])
    print(f"serve: {line.strip()}")
    return serve_port(line)


def stop_server(proc, rate, work):
    """Wait for a server sent SIGINT: its exit code must be 0."""
    try:
        rc = proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise PhaseError(f"serve {rate}: no exit 30 s after SIGINT")
    finally:
        proc.stdout.close()
    check(rc == 0, f"serve {rate}: exit {rc} after SIGINT: "
          + (work / f"serve{rate}.err").read_text()[-2000:])


def launch_delta(before, after):
    """The server's MDCT kernel launches between two 'Q' stats lines."""
    a, b = before["kernel_launches"], after["kernel_launches"]
    return {k: b[k] - a[k] for k in b if b[k] - a[k]}


def hold_plain_codes(label, pairs):
    """Codes and sidecar levels made by the kernels against the all-plain
    encode of the same audio, held as phase 19 holds them: levels within
    one grid step, codes equal in LADDER_EQUAL of positions and within one
    step on the frames whose levels are all equal.

    :param pairs: ((codes, levels), (plain codes, plain levels)) a clip,
        numpy [1, frames, N, C] and [1, frames, bands, C].
    :return: (share of codes equal, share of levels equal, largest code
        step on frames of equal levels)."""
    import numpy as np

    same = total = lv_same = lv_total = max_diff = lv_max = 0
    for (codes, lv), (plain_codes, plain_lv) in pairs:
        lv_diff = np.abs(lv.astype(np.int64) - plain_lv)
        diff = np.abs(codes.astype(np.int64) - plain_codes)
        frames_same = (lv_diff == 0).all(axis=(2, 3))[..., None, None]
        same += int((diff == 0).sum())
        total += diff.size
        lv_same += int((lv_diff == 0).sum())
        lv_total += lv_diff.size
        max_diff = max(max_diff, int(np.where(frames_same, diff, 0).max()))
        lv_max = max(lv_max, int(lv_diff.max()))
    share, lv_share = same / total, lv_same / lv_total
    check(lv_max <= 1 and share >= LADDER_EQUAL and max_diff <= 1,
          f"{label}: codes {share} equal to the all-plain encode's, sidecar "
          f"levels {lv_share} ({lv_max} grid steps apart at most), codes "
          f"{max_diff} steps apart where the levels are equal")
    return share, lv_share, max_diff


def pcm16_of(wave, rate):
    """A float wave [samples, channels] as the 16-bit integers the WAV
    writer stores."""
    from audiocodec_tpu_torch.io import wav

    return pcm16_bytes(wav.write_wav_bytes(wave, rate))


def pcm16_bytes(blob):
    """A PCM16 WAV blob's samples as integers [1, samples, channels]."""
    import numpy as np

    from audiocodec_tpu_torch.io import wav

    x, _ = wav.read_wav_bytes(blob)
    return np.round(x.astype(np.float64) * 32768).astype(np.int64)


def serve_encode(torch, dev, port, codec, card):
    """20a. 8 client threads x 8 encode requests of 2 s 44.1 kHz mono
    PCM16 (README's serving row), then a 'D' of each response; each held
    against the solo offline encode and decode on the card, and against
    the all-plain encode and the plain synthesis's decode (the served
    groups [g, 87, 1024] and the 'D's reach the kernels at shapes no other
    phase holds)."""
    import concurrent.futures as cf

    import numpy as np

    from audiocodec_tpu_torch import scq, serve
    from audiocodec_tpu_torch.io import bitstream, wav

    clips = serve_clips(SERVE_CLIENTS * SERVE_REQUESTS)

    def client(requests):
        with serve.Client(port=port) as c:
            return [(i, c.encode(clips[i])) for i in requests]

    def round_of(ids):
        with cf.ThreadPoolExecutor(SERVE_CLIENTS) as ex:
            return dict(r for part in ex.map(client, ids) for r in part)

    # a warm-up round: the server's first loads, allocator, native library
    round_of([[k] for k in range(SERVE_CLIENTS)])
    with serve.Client(port=port) as c:
        before = c.stats()
    t0 = time.perf_counter()
    got = round_of([list(range(k, len(clips), SERVE_CLIENTS))
                    for k in range(SERVE_CLIENTS)])
    wall = time.perf_counter() - t0
    responses = [got[i] for i in range(len(clips))]
    with serve.Client(port=port) as c:
        mid = c.stats()
        decoded = [c.decode(r) for r in responses]
        after = c.stats()
    enc_launches = launch_delta(before, mid)
    dec_launches = launch_delta(mid, after)
    batches = mid["encode_batches"] - before["encode_batches"]
    check(enc_launches == {"fold_matmul": batches} and batches > 0,
          f"serve: encode launches {enc_launches} for {batches} batches")
    check(dec_launches == {"matmul_scatter": len(clips)},
          f"serve: decode launches {dec_launches} for {len(clips)} decodes")
    n = codec.mdct.filters_n
    grid = codec.sidecar_grid
    same = total = 0
    members_equal = True
    lsb = plain_lsb = 0
    plain_pairs = []
    for blob, acz, out in zip(clips, responses, decoded):
        codes, bark, meta = bitstream.unpack(acz)
        x, _ = wav.read_wav_bytes(blob)
        s = x.shape[1]
        xt = torch.nn.functional.pad(torch.from_numpy(x),
                                     (0, 0, 0, (-s) % n)).to(dev)
        with torch.no_grad():
            solo_codes, solo_bark = codec.quantize_frames(
                codec.mdct.transform(xt))
            solo = bitstream.decode_container(codec, codes, bark, meta)
            with plain_kernels():
                plain_codes, plain_bark = codec.quantize_frames(
                    codec.mdct.transform(xt))
                plain = bitstream.decode_container(codec, codes, bark, meta)
        solo_codes = solo_codes.cpu().numpy()
        same += int((solo_codes == codes).sum())
        total += codes.size
        members_equal &= (np.array_equal(solo_codes, codes) and np.array_equal(
            bitstream.bf16_bits(solo_bark), bitstream.bf16_bits(bark)))
        plain_pairs.append((
            (codes, scq.levels_from_bark16(bark, grid)),
            (plain_codes.cpu().numpy(),
             scq.levels_from_bark16(plain_bark, grid))))
        frames = codes.shape[1]
        got = pcm16_bytes(out)
        check(got.shape == (1, s, 1), f"serve: decoded {got.shape} of {s}")
        for wave, name in ((solo, "offline"), (plain, "plain")):
            ref = pcm16_of(wave[0, n:n + (frames - 1) * n].float().cpu()
                           .numpy()[:s], SAMPLE_RATE)
            apart = int(np.abs(got - ref).max())
            if name == "offline":
                lsb = max(lsb, apart)
            else:
                plain_lsb = max(plain_lsb, apart)
    share = same / total
    plain_share, plain_lv, plain_step = hold_plain_codes("serve", plain_pairs)
    check(share >= SERVE_CODES_EQUAL, f"serve: codes {share} equal to solo")
    check(lsb <= 1, f"serve: 'D' {lsb} LSB from the offline decode")
    check(plain_lsb <= ACZ_VECTOR_LSB,
          f"serve: 'D' {plain_lsb} LSB from the plain synthesis's decode")
    audio = len(clips) * SERVE_SECONDS
    # the stage seconds of the timed round alone, the EMAs as they stand
    stats = {k: v for k, v in mid.items() if k.endswith("_ema_ms")}
    stats.update({k: round(v - before.get(k, 0.0), 4)
                  for k, v in mid.items() if k.startswith("t_")})
    out = dict(requests=len(clips), clients=SERVE_CLIENTS, wall_s=wall,
               audio_s_per_s=audio / wall, batches=batches,
               codes_equal_to_solo=share, members_equal_to_solo=members_equal,
               decode_max_lsb=lsb, codes_equal_to_plain=plain_share,
               sidecar_equal_to_plain=plain_lv,
               max_code_step_to_plain=plain_step,
               decode_max_lsb_to_plain=plain_lsb, launches_encode=enc_launches,
               launches_decode=dec_launches, stats=stats)
    print(f"serve encode: {len(clips)} requests of {SERVE_SECONDS} s from "
          f"{SERVE_CLIENTS} clients in {wall:.3f} s = "
          f"{out['audio_s_per_s']:.1f} audio-s/s, {batches} batches, "
          f"launches {enc_launches}; codes equal to the solo card encode "
          f"{share!r} (containers' codes and sidecars equal: "
          f"{members_equal}), to the all-plain encode {plain_share!r} "
          f"(sidecar levels {plain_lv!r}, codes within {plain_step} where "
          f"they are equal); 'D' launches {dec_launches}, within {lsb} LSB "
          f"of the offline decode and {plain_lsb} of the plain synthesis's "
          f"[{card}]")
    print(f"serve Q (stage seconds of the timed round): "
          f"{json.dumps(out['stats'])}")
    return out


def serve_sessions(torch, dev, port, card, work):
    """20b. One 'B'/'C'/'F' session of 60 s of 48 kHz stereo in chunks of
    256 blocks and one 'J'/'K'/'L' session of the bytes it returned,
    against offline ``encode_stream`` / ``decode_stream`` on the card, and
    against the all-plain ``encode_stream`` and the plain synthesis's
    ``decode_stream`` of the same bytes."""
    import struct

    import numpy as np

    from audiocodec_tpu_torch import serve
    from audiocodec_tpu_torch.io import stream_container as sc

    codec = cli_codec(torch, dev, ["serve", "--sample-rate", str(STREAM_SR)])
    x = stream_signal(torch, "cpu", SERVE_STREAM_SECONDS)
    pcm = x[0].numpy()
    chunk = STREAM_CB * FILTERS_N
    chunks = pcm.shape[0] // chunk
    with serve.Client(port=port) as c:
        # a warm-up session and its decode: the process's first loads
        warm = [c.begin_stream(channels=2, chunk_blocks=STREAM_CB),
                c.feed(pcm[:chunk]), c.finish_stream()]
        c.begin_decode_stream(warm[0])
        c.feed_chunk(warm[1])
        c.finish_decode_stream()
        before = c.stats()
        t0 = time.perf_counter()
        parts = [c.begin_stream(channels=2, chunk_blocks=STREAM_CB)]
        for k in range(chunks):
            parts.append(c.feed(pcm[k * chunk:(k + 1) * chunk]))
        parts.append(c.finish_stream())
        enc_wall = time.perf_counter() - t0
        mid = c.stats()
        streamed = b"".join(parts)
        path = work / "session.acs"
        path.write_bytes(streamed)
        _, index_off = struct.unpack("<QQ", streamed[-16:])
        with sc.StreamReader(str(path)) as r:
            offs = list(r._index)
        t0 = time.perf_counter()
        c.begin_decode_stream(streamed[:offs[0]])
        live = [c.feed_chunk(streamed[o:e])
                for o, e in zip(offs, offs[1:] + [index_off])]
        live.append(c.finish_decode_stream())
        dec_wall = time.perf_counter() - t0
        after = c.stats()
    offline, plain_path = work / "offline.acs", work / "plain.acs"
    with torch.no_grad():
        sc.encode_stream(codec, x.to(dev), str(offline),
                         chunk_blocks=STREAM_CB)
        want = torch.cat(list(sc.decode_stream(codec, str(offline))),
                         dim=1)[0].cpu().numpy()
        with plain_kernels():
            sc.encode_stream(codec, x.to(dev), str(plain_path),
                             chunk_blocks=STREAM_CB)
            plain_dec = torch.cat(list(sc.decode_stream(codec, str(path))),
                                  dim=1)[0]
    plain_share, plain_lv, plain_step = hold_plain_codes(
        "serve session", [tuple(tuple(a[None] for a in stream_chunks(
            sc, str(p), levels=True)) for p in (path, plain_path))])
    dec_tol = tolerance(torch, plain_dec, "matmul_scatter",
                        codec.mdct.kernel_precision, codec.mdct.compute_dtype)
    same_bytes = streamed == offline.read_bytes()
    check(same_bytes, f"serve session: {len(streamed)} bytes differ from "
          f"offline encode_stream's {offline.stat().st_size}")
    got = np.concatenate(live)
    check(got.shape == want.shape and np.array_equal(got, want),
          "serve decode session: PCM differs from decode_stream's")
    dec_err = float(np.abs(got - plain_dec.cpu().numpy()).max())
    check(dec_err <= dec_tol, f"serve decode session: max-abs {dec_err} > "
          f"{dec_tol} from the plain synthesis's decode_stream")
    enc_launches = launch_delta(before, mid)
    dec_launches = launch_delta(mid, after)
    check(enc_launches == {"fold_matmul": chunks + 1},
          f"serve session: launches {enc_launches} for {chunks} chunks + "
          "the flush")
    check(dec_launches == {"matmul_scatter": len(offs) + 1},
          f"serve decode session: launches {dec_launches} for {len(offs)} "
          "chunks + the tail")
    seconds = pcm.shape[0] / STREAM_SR
    out = dict(seconds=seconds, chunks=chunks, bytes=len(streamed),
               encode_s=enc_wall, encode_audio_s_per_s=seconds / enc_wall,
               decode_s=dec_wall, decode_audio_s_per_s=seconds / dec_wall,
               codes_equal_to_plain=plain_share,
               sidecar_equal_to_plain=plain_lv,
               max_code_step_to_plain=plain_step,
               decode_max_abs_to_plain=dec_err, decode_tolerance=dec_tol,
               launches_encode=enc_launches, launches_decode=dec_launches)
    print(f"serve session: {seconds:.2f} s of {STREAM_SR} Hz stereo in "
          f"{chunks} chunks + flush, {len(streamed)} bytes equal to offline "
          f"encode_stream's: {same_bytes}; encode {enc_wall:.3f} s = "
          f"{out['encode_audio_s_per_s']:.1f} audio-s/s, launches "
          f"{enc_launches}; codes equal to the all-plain stream "
          f"{plain_share!r} (sidecar levels {plain_lv!r}, codes within "
          f"{plain_step} where they are equal); decode session equal to "
          f"decode_stream bit for bit, max-abs {dec_err:.3g} from the plain "
          f"synthesis's (tolerance {dec_tol:.3g}), {dec_wall:.3f} s = "
          f"{out['decode_audio_s_per_s']:.1f} audio-s/s, launches "
          f"{dec_launches} [{card}]")
    return out


def serve_trace(torch, dev, codec, card):
    """20c. Batch cycles of an in-process server at the serve command's
    defaults (max batch 8, max wait 5 ms): 8 concurrent 2 s requests, the
    wall ms of SERVE_TRACE_CYCLES cycles untraced, then one cycle under
    torch.profiler (after a cycle that starts the profiler) inside a
    ``serve.cycle`` label: the device's busy ms within that label's span,
    its idle share of the cycle, and the device's own span (first kernel
    to last)."""
    import concurrent.futures as cf

    from torch.profiler import ProfilerActivity, profile, record_function

    from audiocodec_tpu_torch import serve

    clips = serve_clips(SERVE_CLIENTS)
    with serve.CodecServer(codec, SAMPLE_RATE, port=0) as s:
        def cycle():
            with cf.ThreadPoolExecutor(SERVE_CLIENTS) as ex:
                return list(ex.map(
                    lambda b: serve.request("E", b, port=s.port), clips))

        cycle()  # warm
        walls = []
        for _ in range(SERVE_TRACE_CYCLES):
            t0 = time.perf_counter()
            cycle()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            cycle()
            batches = s.stats["encode_batches"]
            with record_function("serve.cycle"):
                cycle()
                torch.cuda.synchronize()
            batches = s.stats["encode_batches"] - batches
    label = [e.time_range for e in prof.events() if e.name == "serve.cycle"
             and e.device_type != torch.autograd.DeviceType.CUDA]
    check(len(label) == 1, f"serve trace: {len(label)} serve.cycle spans")
    lo, hi = label[0].start, label[0].end
    spans = [(max(e.time_range.start, lo), min(e.time_range.end, hi))
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.time_range.end > lo and e.time_range.start < hi]
    check(spans, "serve trace: no kernel in the traced cycle")
    busy, span = covered(spans)
    out = dict(batches=batches, cycle_ms_untraced=walls,
               cycle_ms_traced=(hi - lo) / 1e3, device_busy_ms=busy / 1e3,
               device_span_ms=span / 1e3,
               idle_share=1.0 - busy / (hi - lo),
               idle_share_of_device_span=1.0 - busy / span)
    print(f"serve traced batch cycle at the serve command's defaults "
          f"({SERVE_CLIENTS} x {SERVE_SECONDS} s, {batches} batches): "
          f"untraced cycles " + ", ".join(f"{w:.2f}" for w in walls)
          + f" ms; the traced cycle {out['cycle_ms_traced']:.2f} ms, device "
          f"busy {out['device_busy_ms']:.3f} ms of it, idle share "
          f"{out['idle_share']:.5f} (of the device's own "
          f"{out['device_span_ms']:.2f} ms span, first kernel to last: "
          f"{out['idle_share_of_device_span']:.4f}) [{card}]")
    return out


def serve_phase(torch, dev, card):
    """20. The serve command (``python -m audiocodec_tpu_torch serve``) in
    subprocesses at 44.1 kHz (encode and decode requests) and at 48 kHz
    (the sessions), at the command line's defaults; each stopped with
    SIGINT and exit code 0."""
    import tempfile

    work_root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    work_root.mkdir(parents=True, exist_ok=True)
    codec = cli_codec(torch, dev, ["serve", "--sample-rate",
                                   str(SAMPLE_RATE)])
    out = {}
    with tempfile.TemporaryDirectory(dir=work_root) as tmp:
        work = Path(tmp)
        # both start at once: a process takes seconds to reach the card
        procs = {rate: spawn_server(rate, work)
                 for rate in (SAMPLE_RATE, STREAM_SR)}
        try:
            ports = {rate: server_port(p, rate, work)
                     for rate, p in procs.items()}
            out["encode"] = serve_encode(torch, dev, ports[SAMPLE_RATE],
                                         codec, card)
            out["sessions"] = serve_sessions(torch, dev, ports[STREAM_SR],
                                             card, work)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.send_signal(signal.SIGINT)
            for rate, p in procs.items():
                stop_server(p, rate, work)
        out["traced_cycle"] = serve_trace(torch, dev, codec, card)
    return out


def corpus_signal(count, seconds, rate, channels=1, seed=SEED + 21):
    """``count`` clips of ``seconds``: windows of one ``cli_signal`` at
    their own offsets and gains, float64 [count][samples, channels]."""
    import numpy as np

    s = int(seconds * rate)
    base = cli_signal(2 * seconds, rate, channels=channels, seed=seed)
    rng = np.random.default_rng(seed)
    offsets = rng.integers(0, s, count)
    gains = rng.uniform(0.4, 1.0, count)
    for o, g in zip(offsets, gains):
        yield base[o:o + s] * g


def write_corpus(directory, count, seconds=CORPUS_SECONDS, rate=SAMPLE_RATE):
    """BASELINE.md configuration 4's corpus: ``count`` PCM16 mono WAVs of
    ``seconds`` in ``directory`` -> their paths."""
    from audiocodec_tpu_torch import native

    directory.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, x in enumerate(corpus_signal(count, seconds, rate)):
        paths.append(directory / f"clip{i:04d}.wav")
        native.write_wav(str(paths[-1]), x.astype("float32"), rate)
    return paths


def corpus_call(torch, argv, audio_s, trace=False):
    """One ``main(argv)`` of the bulk commands, the counters set to 0 just
    before: its numbers (wall s, audio-s/s, launches; traced busy and idle
    share)."""
    fn = lambda: cli_call(torch, argv)  # noqa: E731
    if trace:
        (ms, counts, text), traced = trace_search(torch, fn, prefix="corpus.")
    else:
        ms, counts, text = fn()
        traced = None
    out = dict(wall_s=ms / 1e3, audio_s_per_s=audio_s / ms * 1e3,
               launches=launched(counts), printed=text.strip())
    if traced:
        out.update(device_busy_ms=traced["device_busy_ms"],
                   device_span_ms=traced["device_span_ms"],
                   idle_share=traced["idle_share"])
    return out


def corpus_phase(torch, dev, card, clips):
    """21. BASELINE.md configuration 4 through the command line, in-process
    (``main([...])`` at its defaults, (r)): ``corpus`` of ``clips`` 10 s
    44.1 kHz mono PCM16 clips in batches of 64, ``corpus-decode`` of its
    containers, ``corpus --cache`` (building the PCM cache) and once more
    from the cache (traced); ``--kbps 64`` on 64 of the clips; ``corpus
    --lossless`` of four 24-bit stereo files and its ``corpus-decode``."""
    import io
    import shutil
    import tempfile

    import numpy as np

    from audiocodec_tpu_torch import native, scq
    from audiocodec_tpu_torch.io import bitstream, wav
    from audiocodec_tpu_torch.utils.device import dequant_wire

    check(native.available(), f"native library: {native.build_error()}")
    work_root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    work_root.mkdir(parents=True, exist_ok=True)
    codec = cli_codec(torch, dev, ["corpus", "a", "b", "--sample-rate",
                                   str(SAMPLE_RATE)])
    n = codec.mdct.filters_n
    audio = clips * CORPUS_SECONDS
    batches = -(-clips // CORPUS_BATCH)
    out = {}
    with tempfile.TemporaryDirectory(dir=work_root) as tmp:
        work = Path(tmp)
        t0 = time.perf_counter()
        paths = write_corpus(work / "in", clips)
        out["write_s"] = time.perf_counter() - t0
        enc = ["corpus", str(work / "in"), str(work / "acz"),
               "--sample-rate", str(SAMPLE_RATE), "--clip-seconds",
               str(CORPUS_SECONDS), "--batch", str(CORPUS_BATCH)]
        out["corpus"] = corpus_call(torch, enc, audio)
        out["corpus_decode"] = corpus_call(
            torch, ["corpus-decode", str(work / "acz"), str(work / "dec")],
            audio)
        check(out["corpus"]["launches"] == {"fold_matmul": batches}
              and out["corpus_decode"]["launches"]
              == {"matmul_scatter": batches},
              f"corpus: launches {out['corpus']['launches']}, decode "
              f"{out['corpus_decode']['launches']} for {batches} batches")
        # 16 sampled clips against their solo encode and decode on the
        # card, and against the all-plain encode and the plain synthesis's
        # decode (the batches [64, 431, 1024] reach the kernels at a shape
        # no other phase holds)
        picks = np.unique(np.linspace(0, clips - 1, CORPUS_SAMPLED).round()
                          .astype(int))
        wire, _ = native.load_corpus([str(paths[i]) for i in picks],
                                     CORPUS_SECONDS, SAMPLE_RATE,
                                     dtype="int16")
        grid = codec.sidecar_grid
        same = total = lsb = plain_lsb = 0
        plain_pairs = []
        for j, i in enumerate(picks):
            codes, bark, meta = bitstream.load(
                str(work / "acz" / f"{paths[i].stem}.acz"))
            x = dequant_wire(torch.from_numpy(wire[j:j + 1]).to(dev),
                             codec.mdct.compute_dtype)
            usable = x.shape[1] - x.shape[1] % n
            with torch.no_grad():
                solo = codec.encode_frames(codec.mdct.transform(
                    x[:, :usable])).codes.cpu().numpy()
                wave = bitstream.decode_container(codec, codes, bark, meta)
                with plain_kernels():
                    plain = codec.encode_frames(codec.mdct.transform(
                        x[:, :usable]))
                    plain_wave = bitstream.decode_container(codec, codes,
                                                            bark, meta)
            same += int((solo == codes).sum())
            total += codes.size
            plain_pairs.append((
                (codes, scq.levels_from_bark16(bark, grid)),
                (plain.codes.cpu().numpy(),
                 scq.levels_from_bark16(plain.bark16, grid))))
            frames = codes.shape[1]
            got, _ = pcm16(work / "dec" / f"{paths[i].stem}.wav")
            for ref_wave, name in ((wave, "solo"), (plain_wave, "plain")):
                ref_wav = work / f"{name}{i}.wav"
                native.write_wav(str(ref_wav),
                                 ref_wave[0, n:n + (frames - 1) * n]
                                 .float().cpu().numpy(), SAMPLE_RATE)
                ref, _ = pcm16(ref_wav)
                check(got.shape == ref.shape, f"corpus-decode {got.shape} "
                      f"vs {name} {ref.shape}")
                apart = int(np.abs(got - ref).max())
                if name == "solo":
                    lsb = max(lsb, apart)
                else:
                    plain_lsb = max(plain_lsb, apart)
        share = same / total
        plain_share, plain_lv, plain_step = hold_plain_codes("corpus",
                                                             plain_pairs)
        check(share >= CORPUS_CODES_EQUAL,
              f"corpus: codes {share} equal to the solo encode")
        check(lsb <= 1, f"corpus-decode: {lsb} LSB from the solo decode")
        check(plain_lsb <= ACZ_VECTOR_LSB, f"corpus-decode: {plain_lsb} LSB "
              "from the plain synthesis's decode")
        out.update(codes_equal_to_solo=share, decode_max_lsb=lsb,
                   codes_equal_to_plain=plain_share,
                   sidecar_equal_to_plain=plain_lv,
                   max_code_step_to_plain=plain_step,
                   decode_max_lsb_to_plain=plain_lsb)
        shutil.rmtree(work / "dec")
        # the PCM cache: built on the first run, memmapped on the next
        cached = enc[:2] + [str(work / "cached")] + enc[3:] + [
            "--cache", str(work / "pcm.npy")]
        out["corpus_cache_build"] = corpus_call(torch, cached, audio)
        out["corpus_cached"] = corpus_call(torch, cached, audio, trace=True)
        stamps_only = 0
        for p in paths:
            a = (work / "acz" / f"{p.stem}.acz").read_bytes()
            b = (work / "cached" / f"{p.stem}.acz").read_bytes()
            if a != b:
                ma, mb = (np.load(io.BytesIO(v)) for v in (a, b))
                check(sorted(ma.files) == sorted(mb.files) and all(
                    np.array_equal(ma[k], mb[k]) for k in ma.files),
                    f"corpus --cache: {p.stem}.acz differs")
                stamps_only += 1
        out["cached_differ_in_zip_time_stamps_only"] = stamps_only
        for d in ("cached", "acz"):
            shutil.rmtree(work / d)
        (work / "pcm.npy").unlink()
        # --kbps on 64 clips: one search, every clip within 15%
        kin = work / "kin"
        kin.mkdir()
        for p in paths[:CORPUS_BATCH]:
            shutil.copy(p, kin)
        kbps_n = min(CORPUS_BATCH, clips)
        out["corpus_kbps"] = corpus_call(
            torch, ["corpus", str(kin), str(work / "kacz"), "--sample-rate",
                    str(SAMPLE_RATE), "--clip-seconds", str(CORPUS_SECONDS),
                    "--kbps", str(CORPUS_KBPS)],
            kbps_n * CORPUS_SECONDS)
        check(out["corpus_kbps"]["launches"] == {"fold_matmul": 1},
              f"corpus --kbps: launches {out['corpus_kbps']['launches']}")
        rates = np.array([p.stat().st_size * 8 / CORPUS_SECONDS / 1000
                          for p in sorted((work / "kacz").glob("*.acz"))])
        check(len(rates) == kbps_n and np.all(
            np.abs(rates / CORPUS_KBPS - 1) <= CORPUS_KBPS_TOLERANCE),
            f"corpus --kbps: rates {rates.min()}..{rates.max()}")
        out["kbps_range"] = [float(rates.min()), float(rates.max())]
        # --lossless: four 24-bit stereo files, bit for bit
        lin = work / "lin"
        lin.mkdir()
        srcs = []
        for i, x in enumerate(corpus_signal(4, CORPUS_LOSSLESS_SECONDS,
                                            SAMPLE_RATE, channels=2)):
            srcs.append(np.round(x * ((1 << 23) - 1)).astype(np.int32))
            wav.write_wav_int(str(lin / f"h{i}.wav"), srcs[-1], SAMPLE_RATE,
                              24)
        ll_audio = 4 * CORPUS_LOSSLESS_SECONDS
        out["corpus_lossless"] = corpus_call(
            torch, ["corpus", str(lin), str(work / "lacz"), "--lossless"],
            ll_audio)
        out["corpus_decode_lossless"] = corpus_call(
            torch, ["corpus-decode", str(work / "lacz"), str(work / "ldec")],
            ll_audio)
        for i, src in enumerate(srcs):
            y, rate, bits = wav.read_wav_int(str(work / "ldec" / f"h{i}.wav"))
            check((rate, bits) == (SAMPLE_RATE, 24) and np.array_equal(y, src),
                  f"corpus --lossless: h{i} differs after corpus-decode")
    for name in ("corpus", "corpus_decode", "corpus_cache_build",
                 "corpus_cached", "corpus_kbps", "corpus_lossless",
                 "corpus_decode_lossless"):
        r = out[name]
        traced = (f"; traced device busy {r['device_busy_ms']:.1f} ms of "
                  f"{r['device_span_ms']:.1f}, idle share "
                  f"{r['idle_share']:.4f}" if "idle_share" in r else "")
        print(f"{name}: {r['wall_s']:.3f} s = {r['audio_s_per_s']:.1f} "
              f"audio-s/s, launches {r['launches']}{traced} [{card}]")
    print(f"corpus ({clips} x {CORPUS_SECONDS} s, written in "
          f"{out['write_s']:.1f} s): codes of {len(picks)} clips equal to "
          f"their solo encode {out['codes_equal_to_solo']!r} and to the "
          f"all-plain encode {plain_share!r} (sidecar levels {plain_lv!r}, "
          f"codes within {plain_step} where they are equal), corpus-decode "
          f"within {out['decode_max_lsb']} LSB of the solo decode and "
          f"{plain_lsb} of the plain synthesis's; cached "
          f"containers equal member for member "
          f"({out['cached_differ_in_zip_time_stamps_only']} differ in the "
          f"zip's time stamps only); --kbps {CORPUS_KBPS:g}: "
          f"{out['kbps_range'][0]:.1f}..{out['kbps_range'][1]:.1f} kbit/s; "
          f"lossless bit for bit [{card}]")
    return out


# 22. Scale-out on one card: every mesh repeats the card (as the CPU tests'
# [cpu] * k), dp rows of sp shards; the two-process groups share it
SCALE_SP = 2
SCALE_DP = 2
SCALE_CORPUS_CLIPS = 64
SCALE_STEPS = 5
# The trainers of phase 22c by the VJP case of their codec (phase 12's and
# phase 15's: the gains at N=2048 through the radix kernels)
SCALE_TRAIN = (("r2", "gains"), ("r", "spectral_ae"), ("c", "post_filter"),
               ("r", "rvq"))
# The steps of the process groups of phase 22d, on (r)
SCALE_GROUP_MODELS = {"gloo": ("gains", "spectral_ae"),
                      "nccl": ("spectral_ae",)}
SCALE_CHILD_TIMEOUT_S = 300


def counted(torch, fn):
    """(fn(), every kernel's launches in it): the counts set to 0 just
    before and read just after."""
    reset_all_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, all_launch_counts()


def max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


def scale_mdct(torch, dev, card):
    """22a. ``MDCT.transform``/``inverse_transform`` and ``encode_quantized``
    with the blocks split over SCALE_SP shards (215 blocks each), in (r)
    and (b): one launch a shard, the same frames, synthesis and codes as
    the unsharded call on the card, and the all-plain unsharded call's
    within the tier's tolerance."""
    import numpy as np

    from audiocodec_tpu_torch import Codec
    from audiocodec_tpu_torch.parallel import sequence

    out = {}
    for k in ("r", "b"):
        codec = Codec.create(SAMPLE_RATE, bark_bands_n=64, device=dev,
                             **NOISE_CONFIGS[k])
        mdct = codec.mdct
        tier, dtype = mdct.kernel_precision, mdct.compute_dtype
        fwd, inv = (mdct.kernel_name(d) for d in ("forward", "inverse"))
        codecs = sequence.replicas(codec, [dev] * SCALE_SP)
        x = make_signal(torch, dev, dtype)

        def encode():
            shards = sequence.map_frames(
                codecs, x, lambda c, p: c.encode_quantized(p)[:2])
            return [torch.cat([s[i] for s in shards], 1) for i in (0, 1)]

        with torch.no_grad():
            shards, c_fwd = counted(
                torch, lambda: sequence.transform(codecs, x))
            outs, c_inv = counted(
                torch, lambda: sequence.inverse_transform(codecs, shards))
            (codes, delta), c_enc = counted(torch, encode)
            for label, c, name in (("transform", c_fwd, fwd),
                                   ("inverse_transform", c_inv, inv),
                                   ("encode_quantized", c_enc, fwd)):
                check(c == stream_counts(**{name: SCALE_SP}),
                      f"sharded {label} ({k}): launch counts {c}")
            frames = [b - a for a, b in sequence.block_bounds(
                SAMPLES // mdct.filters_n, SCALE_SP)]
            frames[-1] += 1  # the trailing frame
            check([s.shape[1] for s in shards] == frames,
                  f"sharded ({k}): frames {[s.shape[1] for s in shards]}")
            spec, synth = torch.cat(shards, 1), torch.cat(outs, 1)
            whole = mdct.transform(x)
            whole_synth = mdct.inverse_transform(whole)
            whole_codes, whole_delta, _ = codec.encode_quantized(x)
            with plain_kernels():
                plain_spec = mdct.transform(x)
                plain_synth = mdct.inverse_transform(spec)
                plain_codes = codec.encode_quantized(x)[0]
            errs = dict(
                transform_vs_unsharded=max_abs(spec, whole),
                inverse_vs_unsharded=max_abs(synth, whole_synth),
                delta_vs_unsharded=max_abs(delta, whole_delta),
                transform_vs_plain=max_abs(spec, plain_spec),
                inverse_vs_plain=max_abs(synth, plain_synth))
            tols = dict(transform=tolerance(torch, plain_spec, fwd, tier,
                                            dtype),
                        inverse=tolerance(torch, plain_synth, inv, tier,
                                          dtype))
            check(torch.equal(codes, whole_codes),
                  f"sharded encode ({k}): codes differ from the unsharded "
                  f"encode's on the card ({errs})")
            check(errs["transform_vs_plain"] <= tols["transform"]
                  and errs["inverse_vs_plain"] <= tols["inverse"],
                  f"sharded ({k}) vs all-plain: {errs} > {tols}")
            diff = np.abs(codes.cpu().numpy().astype(np.int64)
                          - plain_codes.cpu().numpy())
            plain_share = float((diff == 0).mean())
            check(plain_share >= LADDER_EQUAL and diff.max() <= 1,
                  f"sharded encode ({k}): codes {plain_share} equal to the "
                  f"all-plain encode's, {diff.max()} steps apart")
            ms = {}
            for label, sharded, unsharded in (
                    ("transform", lambda: sequence.transform(codecs, x),
                     lambda: mdct.transform(x)),
                    ("inverse_transform",
                     lambda: sequence.inverse_transform(codecs, shards),
                     lambda: mdct.inverse_transform(whole)),
                    ("encode_quantized", encode,
                     lambda: codec.encode_quantized(x))):
                ms[label] = dict(sharded=cuda_ms(torch, sharded, iters=10),
                                 unsharded=cuda_ms(torch, unsharded,
                                                   iters=10))
        out[k] = dict(launches=dict(transform=c_fwd[fwd],
                                    inverse_transform=c_inv[inv],
                                    encode_quantized=c_enc[fwd]),
                      bit_equal=dict(transform=errs[
                          "transform_vs_unsharded"] == 0.0,
                          inverse=errs["inverse_vs_unsharded"] == 0.0),
                      max_abs_err=errs, tol=tols,
                      codes_equal_to_plain=plain_share, ms=ms)
        print(f"sharded MDCT ({k}) {NOISE_CONFIGS[k]} sp={SCALE_SP} "
              f"[{BATCH},{SAMPLES // mdct.filters_n},{mdct.filters_n}]: "
              f"launches {out[k]['launches']}; max-abs vs unsharded "
              f"transform {errs['transform_vs_unsharded']:.3e}, inverse "
              f"{errs['inverse_vs_unsharded']:.3e}, codes equal, step "
              f"sizes {errs['delta_vs_unsharded']:.3e}; vs all-plain "
              f"{errs['transform_vs_plain']:.3e} / "
              f"{errs['inverse_vs_plain']:.3e} (tol {tols['transform']:.3e}"
              f" / {tols['inverse']:.3e}), codes {100 * plain_share:.4f}% "
              f"equal; ms sharded/unsharded " + ", ".join(
                  f"{n} {t['sharded']:.3f}/{t['unsharded']:.3f}"
                  for n, t in ms.items()) + f" [{card}]")
        del codec, codecs, x, shards, outs, spec, synth, whole, whole_synth
    return out


def tie_flips(torch, label, codes, want_codes, spec, want_delta, rtol=1e-5):
    """Codes of one spectrum quantized with two step-size tensors that
    agree to ``rtol`` (JAX's gate on them): every code that differs must
    be one step off and sit within ``rtol`` of a rounding tie of
    spec / delta, the only place such a difference can flip a code.
    Returns how many differ."""
    flips = codes != want_codes
    n = int(flips.sum())
    if n:
        u = (spec.double() / want_delta.double())[flips].abs()
        off_tie = float(((u - u.floor() - 0.5).abs() - rtol * u).max())
        step = int((codes.long() - want_codes.long()).abs().max())
        check(step <= 1 and off_tie <= 1e-9,
              f"{label}: {n} codes differ, {step} steps apart, "
              f"{off_tie} past a rounding tie")
    return n


def scale_corpus(torch, dev, card):
    """22b. The corpus encoder on a dp=2, sp=2 mesh over SCALE_CORPUS_CLIPS
    clips of 10 s in (r): one ``fold_matmul`` a shard, the unsharded
    frames bit for bit, step sizes within 1e-5 and codes equal to the
    unsharded encode's but where those step sizes' last bits flip a
    rounding tie; audio-s/s beside the unsharded encode's."""
    import numpy as np

    from audiocodec_tpu_torch import Codec
    from audiocodec_tpu_torch.parallel import corpus, mesh, sequence

    codec = Codec.create(SAMPLE_RATE, bark_bands_n=64, device=dev,
                         **NOISE_CONFIGS["r"])
    grid = mesh.make_mesh(devices=[dev] * (SCALE_DP * SCALE_SP), sp=SCALE_SP)
    clips = np.stack(list(corpus_signal(SCALE_CORPUS_CLIPS, CORPUS_SECONDS,
                                        SAMPLE_RATE)))[:, :SAMPLES]
    x = torch.from_numpy(clips.astype(np.float32)).to(dev)
    encoder = corpus.make_corpus_encoder(codec, grid)
    with torch.no_grad():
        (codes, delta), counts = counted(torch, lambda: encoder(x))
        check(counts == stream_counts(fold_matmul=SCALE_DP * SCALE_SP),
              f"sharded corpus: launch counts {counts}")
        rows = sequence.mesh_rows(codec, grid)
        frames = torch.cat([torch.cat(sequence.transform(r, xr), 1)
                            for r, xr in zip(rows, grid.split(x))])
        whole = codec.mdct.transform(x)
        check(torch.equal(frames, whole),
              "sharded corpus: frames differ from the unsharded analysis")
        whole_codes, whole_delta, _ = codec.encode_quantized(x)
        delta_rel = float(((delta.double() - whole_delta.double()).abs()
                           / whole_delta.double()).max())
        check(delta_rel <= 1e-5, f"sharded corpus: step sizes {delta_rel} "
              "from the unsharded encode's")
        flipped = tie_flips(torch, "sharded corpus", codes, whole_codes,
                            whole, whole_delta)
        audio_s = SCALE_CORPUS_CLIPS * SAMPLES / SAMPLE_RATE
        walls = {}
        for label, fn in (("sharded", lambda: encoder(x)),
                          ("unsharded", lambda: codec.encode_quantized(x))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            walls[label] = (time.perf_counter() - t0) / 3
    out = dict(launches=counts["fold_matmul"], delta_max_rel_err=delta_rel,
               codes_differing=flipped, codes=codes.numel(), wall_s=walls,
               audio_s_per_s={k: audio_s / v for k, v in walls.items()})
    print(f"sharded corpus dp={SCALE_DP} sp={SCALE_SP}, "
          f"{SCALE_CORPUS_CLIPS} x {CORPUS_SECONDS} s (r): {out['launches']} "
          f"fold_matmul, frames equal to the unsharded analysis, step sizes "
          f"within {delta_rel:.3e} (relative), {flipped} of {codes.numel()} "
          f"codes differ from the unsharded encode's, each one step at a "
          f"rounding tie; " + ", ".join(
              f"{k} {walls[k] * 1e3:.2f} ms = "
              f"{out['audio_s_per_s'][k]:.1f} audio-s/s" for k in walls)
          + f" [{card}]")
    return out


def step_report(params, loss):
    """(loss, parameters, gradients) of a trainer after its step."""
    return (float(loss), {k: p.detach().clone() for k, p in params.items()},
            {k: p.grad.detach().clone() for k, p in params.items()
             if p.grad is not None})


# Adam's first step (the trainers' default, optax.adam(1e-3)'s rule) moves
# each parameter by lr * g / (|g| + eps)
ADAM_LR, ADAM_EPS = 1e-3, 1e-8


def hold_step(label, got, want, dtype):
    """A sharded first step's (loss, params, grads) against the unsharded
    one's: the loss within TRAIN_TOL's rtol, each gradient within its share
    (delta) of the peak, and each parameter within what that allows Adam's
    first update: lr * min(2, 2 delta / (|g| + eps)) of the unsharded
    gradient g (a gradient within delta of g moves lr * g / (|g| + eps) by
    no more), plus 4 float32 ulps of the parameter. Returns the loss's
    relative error and, by tensor, (max error, tolerance) of the gradients
    and the largest share of its bound a parameter's error takes."""
    loss_rtol, share = TRAIN_TOL[dtype]
    loss_err = abs(got[0] - want[0]) / abs(want[0])
    check(loss_err <= loss_rtol, f"{label}: loss {got[0]} vs {want[0]}")
    errs = {}
    for name, w in want[2].items():
        delta = share * float(w.float().abs().max())
        err = max_abs(got[2][name], w)
        errs[f"grad {name}"] = (err, delta)
        check(err <= delta, f"{label}: gradient of {name} {err} > {delta}")
        p_got, p_want = got[1][name].float(), want[1][name].float()
        bound = (ADAM_LR * (2 * delta / (w.float().abs() + ADAM_EPS))
                 .clamp(max=2.0) + 4 * 2.0**-23 * p_want.abs())
        used = float(((p_got - p_want).abs() / bound.clamp(min=1e-30))
                     .max())
        errs[f"param {name}"] = (used, 1.0)
        check(used <= 1.0, f"{label}: parameter {name} {used} of the bound "
              "its gradient's tolerance allows Adam's first step")
    return loss_err, errs


def scale_train(torch, dev, card):
    """22c. Each trainer at phase 12's widths on a dp=2, sp=2 mesh: the
    first step's loss, gradients and parameters against the unsharded
    step's (TRAIN_TOL), the analysis, synthesis and synthesis VJP once a
    shard, SCALE_STEPS steps finite, ms a step beside the unsharded."""
    from audiocodec_tpu_torch import Codec
    from audiocodec_tpu_torch.parallel import mesh

    grid = mesh.make_mesh(devices=[dev] * (SCALE_DP * SCALE_SP), sp=SCALE_SP)
    shards = SCALE_DP * SCALE_SP
    out = {}
    for case, model in SCALE_TRAIN:
        codec = Codec.create(SAMPLE_RATE, bark_bands_n=64, device=dev,
                             **VJP_CASES[case])
        mdct = codec.mdct
        dtype = str(mdct.compute_dtype).removeprefix("torch.")
        x = make_signal(torch, dev, mdct.compute_dtype)
        gen = lambda: torch.Generator(device=dev).manual_seed(SEED)  # noqa
        runs, steps, counts, ema = {}, {}, None, {}
        for label, m in (("unsharded", None), ("sharded", grid)):
            params, extra, step = trainer(torch, codec, model, x, mesh=m)
            loss, counts = counted(torch, lambda: step(gen()))
            runs[label] = step_report(params, loss)
            steps[label] = step
            if model == "rvq":  # the RVQ state after the step
                ema[label] = {k: v.clone() for k, v in extra.items()}
        names = [mdct.kernel_name(d) for d in ("forward", "inverse")]
        want = stream_counts(**{names[0]: shards, names[1]: shards,
                                f"{names[1]}_vjp": shards})
        check(counts == want,
              f"sharded train ({case} {model}): launch counts {counts}")
        loss_err, errs = hold_step(f"sharded train ({case} {model})",
                                   runs["sharded"], runs["unsharded"], dtype)
        ema = ema and {k: max_abs(ema["sharded"][k], ema["unsharded"][k])
                       for k in ema["sharded"]}
        losses = [runs["sharded"][0]] + [
            float(steps["sharded"](gen())) for _ in range(SCALE_STEPS - 1)]
        check(all(math.isfinite(v) for v in losses),
              f"sharded train ({case} {model}): losses {losses}")
        ms = {k: cuda_ms(torch, lambda: steps[k](gen()), iters=5, warmup=1)
              for k in steps}
        worst = max(errs.items(), key=lambda e: e[1][0] / max(e[1][1],
                                                              1e-30))
        out[f"{case} {model}"] = dict(
            launches=counts, loss=runs["sharded"][0],
            unsharded_loss=runs["unsharded"][0], loss_rel_err=loss_err,
            err_tol=errs, rvq_state_max_abs_diff=ema, losses=losses, ms=ms)
        print(f"sharded train ({case}) {model} dp={SCALE_DP} sp={SCALE_SP}: "
              f"launches {launched(counts)}; loss "
              f"{runs['sharded'][0]:.7g} vs unsharded "
              f"{runs['unsharded'][0]:.7g} (rel {loss_err:.2e}); worst "
              f"{worst[0]} {worst[1][0]:.2e}/{worst[1][1]:.2e}"
              + (f"; RVQ state max-abs diff {ema}" if ema else "")
              + f"; {SCALE_STEPS} losses {losses}; ms a step sharded "
              f"{ms['sharded']:.3f} vs unsharded {ms['unsharded']:.3f} "
              f"[{card}]")
        del codec, x, runs, steps
    return out


def group_steps(torch, dev, x, mesh, models):
    """The first step of each of ``models`` on (r) over ``mesh`` from phase
    12's seeded weights: its loss, parameters and gradients, and ms a step
    of three more."""
    from audiocodec_tpu_torch import Codec

    codec = Codec.create(SAMPLE_RATE, bark_bands_n=64, device=dev,
                         **NOISE_CONFIGS["r"])
    out = {}
    for model in models:
        params, _, step = trainer(torch, codec, model, x, mesh=mesh)
        gen = lambda: torch.Generator(device=dev).manual_seed(SEED)  # noqa
        loss, params, grads = step_report(params, step(gen()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step(gen())
        torch.cuda.synchronize()
        out[model] = dict(loss=loss, params=params, grads=grads,
                          ms=(time.perf_counter() - t0) / 3 * 1e3)
    return out


def scale_child(torch, argv):
    """A rank of phase 22d's process groups: ``RANK WORLD PORT BACKEND
    DEVICE OUT``. Joins the group at localhost:PORT, steps on its share of
    the batch over a dp=1, sp=SCALE_SP mesh of DEVICE and writes what the
    steps leave to OUT (``save_pytree``)."""
    import torch.distributed as dist

    from audiocodec_tpu_torch.parallel import multihost
    from audiocodec_tpu_torch.utils import serialization

    rank, world, port, backend, dev, path = argv
    rank, world, dev = int(rank), int(world), torch.device(dev)
    check(multihost.initialize(f"localhost:{port}", world, rank,
                               device=dev, backend=backend),
          "multihost.initialize did not join the group")
    try:
        out = {}
        if backend == "nccl":
            t = torch.arange(3.0, device=dev) + rank
            dist.all_reduce(t)
            out["all_reduce"] = t
        grid = multihost.global_mesh(sp=SCALE_SP, devices=[dev] * SCALE_SP)
        check((grid.rank, grid.world) == (rank, world),
              f"global_mesh: rank {grid.rank} of {grid.world}")
        local = multihost.process_local_batch(BATCH)
        x = make_signal(torch, dev, torch.float32)[rank * local:
                                                   (rank + 1) * local]
        out.update(group_steps(torch, dev, x, grid,
                               SCALE_GROUP_MODELS[backend]))
        serialization.save_pytree(path, out)
    finally:
        dist.destroy_process_group()
    return 0


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def scale_groups(torch, dev, card, work):
    """22d. Two ranks of a gloo group share the card (NCCL refuses two
    ranks on one GPU), each stepping the gains and the SAE on half the
    batch; a one-rank NCCL group runs ``all_reduce`` and an SAE step. Each
    child has a timeout and fails the run if it fails; every rank must end
    with the state of the one-process step on the whole batch."""
    from audiocodec_tpu_torch.utils import serialization

    jobs = [("gloo", 2, r) for r in range(2)] + [("nccl", 1, 0)]
    ports = {"gloo": free_port(), "nccl": free_port()}
    paths = {(b, r): str(work / f"{b}{r}.npz") for b, _, r in jobs}
    t0 = time.perf_counter()
    procs = {(b, r): subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--scale-child",
         str(r), str(w), str(ports[b]), b, str(dev), paths[(b, r)]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for b, w, r in jobs}
    logs = {}
    try:
        for key, p in procs.items():
            logs[key] = p.communicate(timeout=SCALE_CHILD_TIMEOUT_S)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for key, p in procs.items():
        check(p.returncode == 0, f"process group child {key}: exit "
              f"{p.returncode}: {logs.get(key, '')[-2000:]}")
    ranks = {key: serialization.load_pytree(path, device=dev)
             for key, path in paths.items()}
    x = make_signal(torch, dev, torch.float32)
    want = group_steps(torch, dev, x, None, ("gains", "spectral_ae"))
    def report(run):
        return run["loss"], run["params"], run["grads"]

    out = dict(wall_s=wall)
    for key, got in ranks.items():
        for model in SCALE_GROUP_MODELS[key[0]]:
            loss_err, errs = hold_step(f"group {key} {model}",
                                       report(got[model]),
                                       report(want[model]), "float32")
            out[f"{key[0]}{key[1]} {model}"] = dict(
                loss=got[model]["loss"], loss_rel_err=loss_err,
                worst=max(e / max(t, 1e-30) for e, t in errs.values()),
                ms=got[model]["ms"], one_process_ms=want[model]["ms"])
    for model in SCALE_GROUP_MODELS["gloo"]:
        a, b = (ranks[("gloo", r)][model] for r in (0, 1))
        check(a["loss"] == b["loss"] and all(
            torch.equal(a[kind][k], b[kind][k])
            for kind in ("params", "grads") for k in a[kind]),
            f"gloo group: the ranks' {model} states differ")
    reduced = ranks[("nccl", 0)]["all_reduce"]
    check(torch.equal(reduced.cpu(), torch.arange(3.0)),
          f"nccl group: all_reduce gave {reduced}")
    gloo = ", ".join(SCALE_GROUP_MODELS["gloo"])
    print(f"process groups: gloo 2 ranks on the card ({gloo}; ranks equal "
          f"bit for bit) and nccl 1 rank (all_reduce, spectral_ae), each "
          f"step against the "
          f"one-process step on the whole batch: " + ", ".join(
              f"{k} loss rel {v['loss_rel_err']:.2e}, worst err/tol "
              f"{v['worst']:.3f}, {v['ms']:.1f} ms a step (one process "
              f"{v['one_process_ms']:.1f})" for k, v in out.items()
              if k != "wall_s") + f"; children's wall {wall:.1f} s [{card}]")
    return out


def scale_resume(torch, dev, card, work):
    """22e. Two SAE steps in (r), the parameters and the optimizer saved
    (``save_pytree``), reloaded into a fresh template: step 3 equals the
    uninterrupted run's bit for bit. ``save_codec``/``load_codec`` on the
    card rebuild a codec whose round trip is bit-equal."""
    from audiocodec_tpu_torch import Codec
    from audiocodec_tpu_torch.models import spectral_ae
    from audiocodec_tpu_torch.utils import serialization

    codec = Codec.create(SAMPLE_RATE, bark_bands_n=64, device=dev,
                         **NOISE_CONFIGS["r"])
    x = make_signal(torch, dev, torch.float32)
    cfg = spectral_ae.SpectralAE(filters_n=FILTERS_N, hidden_n=512,
                                 latent_n=64, latent_step=1 / 32)
    step, make_opt = spectral_ae.make_train_step(codec, cfg)

    def fresh(seed):
        params = spectral_ae.init_params(
            torch.Generator(device="cpu").manual_seed(seed), cfg,
            device=dev)
        return params, make_opt(list(params.values()))

    gen = lambda i: torch.Generator(device=dev).manual_seed(SEED + i)  # noqa
    params, opt = fresh(SEED)
    for i in range(2):
        step(params, opt, x, gen(i))
    t0 = time.perf_counter()
    serialization.save_pytree(str(work / "params.npz"), params)
    serialization.save_pytree(str(work / "opt.npz"), opt.state_dict())
    save_s = time.perf_counter() - t0
    want = step(params, opt, x, gen(2))
    t0 = time.perf_counter()
    params2, _ = fresh(SEED + 1)
    params2 = serialization.load_pytree(str(work / "params.npz"), params2)
    opt2 = make_opt(list(params2.values()))
    opt2.load_state_dict(serialization.load_pytree(str(work / "opt.npz")))
    load_s = time.perf_counter() - t0
    got = step(params2, opt2, x, gen(2))
    check(torch.equal(got, want) and all(
        torch.equal(params2[k], params[k]) for k in params),
        f"resume: step 3 {float(got)} vs uninterrupted {float(want)}")
    path = str(work / "codec.json")
    serialization.save_codec(path, codec)
    loaded = serialization.load_codec(path, device=dev)
    check(loaded.mdct.use_kernel is True,
          "load_codec: the kernels did not resolve on the card")
    with torch.no_grad():
        same = torch.equal(loaded.round_trip_quantized(x),
                           codec.round_trip_quantized(x))
    check(same, "load_codec: the round trip differs from the saved codec's")
    out = dict(step3_loss=float(got), save_s=save_s, load_s=load_s,
               config=serialization.codec_config(loaded))
    print(f"resume: SAE (r) step 3 after save_pytree/load_pytree equals the "
          f"uninterrupted step bit for bit (loss {float(got):.7g}); saved "
          f"in {save_s * 1e3:.1f} ms, loaded in {load_s * 1e3:.1f} ms; "
          f"load_codec's round trip bit-equal [{card}]")
    return out


def scale_phase(torch, dev, card):
    """22. Scale-out and checkpoints (a-e)."""
    import tempfile

    work_root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    work_root.mkdir(parents=True, exist_ok=True)
    out = dict(mdct=scale_mdct(torch, dev, card),
               corpus=scale_corpus(torch, dev, card),
               train=scale_train(torch, dev, card))
    with tempfile.TemporaryDirectory(dir=work_root) as tmp:
        out["groups"] = scale_groups(torch, dev, card, Path(tmp))
        out["resume"] = scale_resume(torch, dev, card, Path(tmp))
    return out


def noise_phases(torch, dev, entries):
    """Phases 7-10."""
    from audiocodec_tpu_torch import Codec

    kernel_codecs = {
        k: Codec.create(SAMPLE_RATE, bark_bands_n=64, device=dev,
                        **NOISE_CONFIGS[k])
        for k in ("r", "b")
    }
    moments = noise_kernel_phase(torch, kernel_codecs, entries)
    del kernel_codecs
    radix_kernel_phase(torch, dev, entries)
    configs = noise_path_phase(torch, dev, entries)
    return dict(noise_moments=moments, noise_configs=configs,
                **design_phase(torch, dev, entries))


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--stream-seconds", type=float,
                        default=STREAM_SECONDS,
                        help="length of phase 18's stream, rounded up to "
                             "whole chunks (default %(default)s)")
    parser.add_argument("--corpus-clips", type=int, default=CORPUS_CLIPS,
                        help="clips of phase 21's corpus (default "
                             "%(default)s)")
    # a rank of phase 22d's process groups, started by this script
    parser.add_argument("--scale-child", nargs=6, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    if args.scale_child:
        return scale_child(torch, args.scale_child)
    from audiocodec_tpu_torch import Codec, MDCT
    from audiocodec_tpu_torch.ops import _build

    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {kind}")

    # 2. build
    t0 = time.monotonic()
    lib_path, log = _build.build()
    _build.library()
    print(f"build: {lib_path.name} in {time.monotonic() - t0:.1f} s"
          + ("" if log else " (cached)"))
    for line in ptxas_summary(log):
        print(f"build: {line}")
    sass, sass_lines, kernel_names = sass_summary(lib_path)
    for name, ops in sass.items():
        print(f"sass: {name}: " + ", ".join(f"{n} {op}" for op, n in
                                             ops.items()))
    for line in sass_lines.values():
        print(f"sass: e.g. {line}")
    tc = {k: ops for k, ops in sass.items() if "tc_kernel" in k}
    split = {k: ops for k, ops in sass.items() if "split_gemm_kernel" in k}
    check(len(tc) == TC_INSTANCES and all(
        (ops["HGMMA"] or ops["IGMMA"]) and ops["UTMALDG"]
        for ops in tc.values()),
        f"tc_kernel: not {TC_INSTANCES} instances with wgmma and TMA in "
        f"SASS: {tc}")
    check(split and all(
        ops["HGMMA.F32.BF16"] and ops["UTMALDG"] for ops in split.values()),
        "split_gemm_kernel: an instance without bf16 wgmma into float32 or "
        f"TMA in SASS: {split}")
    probe = {k: ops for k, ops in sass.items() if "probe_kernel" in k}
    check(len(probe) == len(PROBE_VARIANTS) and all(
        (ops["HGMMA"] or ops["IGMMA"]) and ops["UTMALDG"]
        for ops in probe.values()),
        f"probe_kernel: not {len(PROBE_VARIANTS)} instances with wgmma and "
        f"TMA in SASS: {probe}")
    # every GEMM of the library runs on the tensor cores' wgmma
    retired = [k for k in kernel_names if any(g in k for g in RETIRED_GEMMS)]
    check(not retired, f"FFMA or WMMA GEMMs left in the library: {retired}")

    codecs = {k: Codec.create(SAMPLE_RATE, filters_n=FILTERS_N,
                              bark_bands_n=64, device=dev, **cfg)
              for k, cfg in CONFIGS.items()}
    for k, codec in codecs.items():
        check(codec.mdct.use_kernel is True,
              f"config ({k}): use_kernel='auto' did not resolve to the kernels")
    fidelity = {tier: MDCT(FILTERS_N, use_kernel=True, dct_precision=tier,
                           device=dev) for tier in ("highest", "high")}

    # 3. every kernel against its plain version, at the main path's shapes
    entries = []
    cases = {**{k: codecs[k].mdct for k in "abc"}, **fidelity}
    for label, mdct in cases.items():
        compare_kernels(torch, mdct, label, entries)
    tensor_core = tensor_core_phase(torch, cases)

    # 4. the main path, through the entry point a user calls
    results = {}
    for k, codec in codecs.items():
        x = make_signal(torch, dev, codec.mdct.compute_dtype)
        with torch.no_grad():
            reset_all_launch_counts()
            out = codec.round_trip_quantized(x)
            torch.cuda.synchronize()
            counts = all_launch_counts()
            check(counts == expected_counts(fold_matmul=1, matmul_scatter=1),
                  f"config ({k}): launch counts {counts}")
            check(out.shape == (BATCH, SAMPLES + 2 * FILTERS_N, 1)
                  and out.dtype == codec.mdct.compute_dtype,
                  f"config ({k}): output {tuple(out.shape)} {out.dtype}")
            check(bool(torch.isfinite(out).all()),
                  f"config ({k}): non-finite output")
            snr = snr_db(x, out)
            codes = codec.encode_quantized(x)[0]
            with plain_kernels():
                plain_out = codec.round_trip_quantized(x)
                plain_codes = codec.encode_quantized(x)[0]
            plain_snr = snr_db(x, plain_out)
            same = float((codes == plain_codes).float().mean())
            rt_ms = cuda_ms(torch, lambda: codec.round_trip_quantized(x),
                            iters=10)
            stages = stage_ms(torch, codec, x)
        rate = BATCH * SAMPLES / SAMPLE_RATE / (rt_ms * 1e-3)
        results[k] = dict(snr_db=snr, plain_snr_db=plain_snr, ms=rt_ms,
                          audio_s_per_s=rate, codes_equal=same,
                          stages_ms=stages)
        print(f"config ({k}) {CONFIGS[k]}: launches {counts}, quantized SNR "
              f"{snr:.4f} dB (plain {plain_snr:.4f} dB), codes equal to "
              f"plain {100 * same:.4f}%, round_trip_quantized {rt_ms:.3f} "
              f"ms = {rate:.1f} audio-s/s; stages (ms) "
              + ", ".join(f"{s} {t:.3f}" for s, t in stages.items()))
        check(abs(snr - plain_snr) <= SNR_MARGIN_DB,
              f"config ({k}): SNR {snr} vs plain {plain_snr}")
        set_launches(entries, k, counts)
        del x, out, plain_out, codes, plain_codes

    # 5. fidelity: f32 highest (and high) MDCT round trips through the
    # kernels
    x = make_signal(torch, dev, torch.float32)
    fid = {}
    for tier, mdct in fidelity.items():
        with torch.no_grad():
            reset_all_launch_counts()
            rt = mdct.inverse_transform(mdct.transform(x))
            torch.cuda.synchronize()
            counts = all_launch_counts()
        check(counts == expected_counts(fold_matmul=1, matmul_scatter=1),
              f"fidelity {tier}: launch counts {counts}")
        fid[tier] = snr_db(x, rt)
        print(f"fidelity: f32 {tier} MDCT round trip SNR {fid[tier]:.2f} dB")
        set_launches(entries, tier, counts)
    check(fid["highest"] >= FIDELITY_SNR_DB,
          f"fidelity SNR {fid['highest']} < {FIDELITY_SNR_DB}")

    # 7-10. the noise-injection codec and its kernels
    noise = noise_phases(torch, dev, entries)

    # 11-13. the VJPs and the training paths
    t11 = time.monotonic()
    vjp_phase(torch, dev, entries)
    t12 = time.monotonic()
    training = training_phase(torch, dev, entries)
    t13 = time.monotonic()
    waveform_grads = waveform_grad_phase(torch, dev, entries)

    # 14-15. the int8 probe and the discrete RVQ codec
    t14 = time.monotonic()
    probe = probe_phase(torch, dev, entries)
    t15 = time.monotonic()
    rvq = rvq_phase(torch, dev)

    # 16. the bitstream ladder
    t16 = time.monotonic()
    ladder = ladder_phase(torch, dev)

    # 17. the .acz path
    t17 = time.monotonic()
    acz = acz_phase(torch, dev)

    # 18. the .acs stream path
    t18 = time.monotonic()
    stream = stream_phase(torch, dev, args.stream_seconds, smi)

    # 19. the command line
    t19 = time.monotonic()
    cli = cli_phase(torch, dev, smi)

    # 20-21. serving and the bulk corpus
    t20 = time.monotonic()
    served = serve_phase(torch, dev, smi)
    t21 = time.monotonic()
    corpus = corpus_phase(torch, dev, smi, args.corpus_clips)

    # 22. scale-out and checkpoints
    t22 = time.monotonic()
    scale = scale_phase(torch, dev, smi)
    print(f"wall: phases 1-10 {t11 - t0:.1f} s, 11 {t12 - t11:.1f} s, 12 "
          f"{t13 - t12:.1f} s, 13 {t14 - t13:.1f} s, 14 {t15 - t14:.1f} s, "
          f"15 {t16 - t15:.1f} s, 16 {t17 - t16:.1f} s, 17 "
          f"{t18 - t17:.1f} s, 18 {t19 - t18:.1f} s, 19 "
          f"{t20 - t19:.1f} s, 20 {t21 - t20:.1f} s, 21 "
          f"{t22 - t21:.1f} s, 22 {time.monotonic() - t22:.1f} s")

    # 6. the numbers
    print(json.dumps({"configs": results, "fidelity_snr_db": fid,
                      "tensor_core": tensor_core, **noise,
                      "training": training,
                      "waveform_grads": waveform_grads, "probe": probe,
                      "rvq": rvq, "ladder": ladder, "acz": acz,
                      "stream": stream, "cli": cli, "serve": served,
                      "corpus": corpus, "scale": scale}))
    for e in entries:
        check(e["launches"], f"{e['name']}: no launch in the path's run")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (PhaseError, ImportError, RuntimeError, OSError,
            subprocess.CalledProcessError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
