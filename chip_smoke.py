#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`cineform_tpu_torch`) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
(sm_90a) and the CUDA toolkit.  It

1. builds the CUDA kernels from `cineform_tpu_torch/csrc/`, one nvcc per
   source, all at once;
2. holds each kernel against its plain PyTorch version, on the card, at
   the shapes of a batch-8 1080p encode (the forward DWT's three launches:
   level 1 from the YUY2 bytes and the two three-channel levels, on that
   batch and on the 1080p golden's frame, and the single-plane level on
   the batch's luma; every chunk_pack and merge_network call of the band
   groups, one frame being seeded noise so that chunks overflow, which
   chunk_pack packs by its tree and whose rows merge_network sends
   through its network: the counts of both must equal those of the plain
   criteria `_pack_fits` and `_concat_guard`) and of a batch-8 1080p
   decode (the merge_network_tgt compaction and the
   merge_network_highfirst spread of every band row class), and times
   both with CUDA events, the DWT's launches also by their device time
   apart from the wrapper's host path (`device_ms`: CUDA events around a
   call queued behind a spin kernel);
3. drives the main path through `IntraCodec`: the 1080p golden sample
   (`tests/golden/samples/s_1920x1080_q6_p1`) encoded, decoded with host
   entropy and decoded on the device (`decode_batch_device`), each byte
   for byte; then a batch of 8 1080p frames at quality 4 (the content of
   `bench.py`) encoded and decoded both ways, with the round-trip PSNR,
   the compression ratio, the overflowed band count, the per-frame times
   of each part and the device decode's peak device memory; the device
   decode must equal the host-entropy decode for all 8 frames with no
   frame falling back to the host;
   It also feeds the two decoder forms rows of the level-1 luma class
   that break their guard, which must take the network branch and still
   equal the plain network.  Each kernel's bound (the bytes it must move
   over the card's memory rate, or its operations over the float32 rate,
   whichever is larger) and, where one PyTorch call computes the same
   function, that call's time, go beside its time;
4. fails unless every kernel was launched by that main-path run (the DWT
   3 times a batch, the single-plane level never), and, for
   the three merge forms, unless both branches were launched, and no
   decoder row failed its guard (encoder rows may: their count is
   printed, as is the count of chunks chunk_pack packed by its tree);
5. holds frames 0 and 7 of the batch, encoded and decoded, against the
   port's own plain path on the CPU (the plain PyTorch versions of the
   kernels), byte for byte, and the batch's overflow count, PSNR and ratio
   against the content figures of BENCH_r05.json;
6. runs the RGB 4:4:4 and RGBA 4:4:4:4 path: first each kernel against its
   plain version at the shapes of a batch-8 1080p RG48 encode and decode
   (`dwt_forward_planes`' three levels, timed like the YUY2 DWT, and every
   chunk_pack, merge_network and decoder merge call), then the same for
   B64A, checked but not timed; then, with the launch counts set to 0,
   the main path: the 320x240 RG48, B64A and RG64 encode goldens and the
   RGB and RGBA decode goldens (both routes, both outputs) byte for byte,
   and a batch of 8 1080p RG48 frames (`rg48_frame` pattern 1, rolled one
   row a frame, quality 4), then of B64A, each encoded both ways (equal)
   and decoded both ways (equal, no frame falling back to the host), with
   the overflowed bands, the per-frame times and the peak device memory;
   it fails unless `dwt_forward_planes` was launched 3 times an encode,
   the YUY2 DWT entry points never, and every other kernel of the path;
7. runs the 4:2:2 10-bit and Bayer path: first each kernel against its
   plain version at the shapes of batch-8 encodes of 1080p V210, UYVY and
   YU64 (`dwt_forward_groups`' level 1 from the group buffers the plain
   unpack builds, and levels 2-3) and of a 4K UHD BYR4 mosaic (four
   1920x1080 planes through `dwt_forward_planes`), with every chunk_pack
   and merge call of the V210 and BYR4 encodes and decodes, the plain
   unpacks' and the level-1 launches' device times against their bounds;
   then, with the launch counts set to 0, the main path of each family:
   the 320x240 UYVY, V210 and YU64 encode goldens (both routes), the BGRA
   decode golden (both routes), the V210 batch encoded both ways (equal)
   and decoded both ways to YUY2 and to BGRA (equal, no frame falling
   back), its transform round trip `inverse(dequantize(forward))` equal to
   `decode_batch`, the UYVY and YU64 batches encoded both ways (equal); it
   fails unless that launched `dwt_forward_groups` 3 times an encode and
   no other DWT entry point; then the BYR4 and BYR5 encode goldens, the
   BYR4 decode golden and the BYR4 batch the same way (decoded to BYR4),
   which must launch `dwt_forward_planes` 3 times an encode; then, counts
   reset, the Bayer RGB path: the 320x240 Bayer decode goldens through
   `api.Decoder` on the card to every Bayer output (RG48, b64a, WP13,
   W13A, YUY2, UYVY, BYR2, BYR4; the COLM, WBAL, WBAL2 and SATU/EXPS
   develop matrices) byte for byte, and the 4K BYR4 batch's samples
   decoded to RG48, b64a, WP13 and YUY2, and to RG48 through the WBAL
   golden's develop matrix, on both routes (equal, no frame falling back),
   frames 0 and 7 of each equal to the port's path on the CPU; it prints
   the demosaic's, the develop's and the YUY2 conversion's device times a
   frame against their bounds, the decodes' ms a frame and their peak
   device memory, beside the card's name and power limit, and fails
   unless the decoder merge forms were launched;
8. runs the two-frame GOP path (`GopCodec`): first each kernel against its
   plain version at the shapes of a batch of 8 1080p YUY2 groups (the two
   `dwt_forward_yuy2` launches of frames 0 and 1, `dwt_forward_groups` at
   w3 (too wide for the row-0 carry), w4 with prescale 2 and w5, each
   with its device time and bound, and the decoder merge forms of the 6
   band row classes), and w3 of 64x48 groups, whose chroma takes the
   carry; then,
   with the launch counts set to 0, the GOP goldens
   (`gop_320x240_q4_p1`, `gop2_320x240_q4_p100`) encoded and decoded on
   both routes byte for byte, and the batch encoded and decoded both
   ways in both reference modes (equal, no frame falling back), with the
   per-group times and the decodes' peak device memory; it fails unless
   that launched `dwt_forward_yuy2` 2 and `dwt_forward_groups` 3 times an
   encode, and each decoder merge form 6 times a device decode; then,
   counts reset, a batch of 8 1080p stereo 3D samples (`models.stereo`),
   both eyes decoded on the device equal to `decode_batch` of the split
   eyes, no frame falling back;
9. drives the public API and the pools (`cineform_tpu_torch.api`,
   `pool`) at 1920x1080, quality 4, with fixed metadata: the sync
   `Encoder` on 8 YUY2, then 8 RG48 and 8 V210 frames, one call each,
   equal to `encode_batch_device` of the same frames and frame numbers
   (the DWT 3 times a frame); the sync `Decoder` on the YUY2 samples to
   YUY2 and UYVY and on the RG48 samples to RG48, equal to
   `decode_batch_device` with no frame falling back; the 320x240 API
   goldens (the `gopstream` encode and decode series, `fs2`/`fs3`) and
   stereo eye selection; then, the launch counts set to 0 before each
   pool, an `EncoderPool` of 32 YUY2 frames (the batcher takes what is
   queued, up to 8 jobs: the DWT 3 times, `chunk_pack` and
   `merge_network` 6 times a batch taken) and of 8 GOP pairs, in order
   and equal to the sync `Encoder`'s samples, and a `DecoderPool` of the
   32 samples to YUY2 (equal to the sync `Decoder`) and to BGRA (equal to
   `decode_batch_device`), 6 launches of each decoder merge form a batch
   taken and no frame falling back; it prints the batch sizes, the
   sync ms/frame (medians of 3 runs after a warm-up), the pools'
   frames/s over the window from the first submission to the last
   harvest and the decoder pool's peak device memory, each beside the
   card's name and power limit;
10. runs the decoder's other outputs and its reduced resolutions: with
    the launch counts set to 0, the API phase's 8 YUY2 samples decoded on
    the card with `decode_batch_device` to every other output of a 4:2:2
    source (YU64, v210, NV12, the RGB family, WP13, W13A, R408, V408,
    RG24, BGRa, yuyv, the Avid CT family) and its 8 RG48 samples to WP13,
    W13A, BGRA, BGRa and RG24, each with its ms/frame (median of 3 after
    a warm-up), no frame falling back, its peak device memory, frames 0
    and 7 equal to the port's path on the CPU, and each packer's device
    time on one frame's planes against its bound (and the RG24 dither
    table's host build time); every output golden through `api.Decoder`
    on the card; then, counts reset, the YUY2
    samples at full, half, quarter and thumbnail resolution on both
    routes (equal, frames 0 and 7 equal to the CPU path), with the parts
    of the device route (header walk, upload, entropy decode, inverse,
    download) and the band rows it decoded, and the half and quarter
    goldens through `api.Decoder`; it fails unless each decoder merge
    form ran once a band row class decoded (none at thumbnail);
11. runs the decoder's geometry stage: with the launch counts set to 0,
    the API phase's 8 YUY2 samples through `api.Decoder` at 1280x720 and
    3840x2160 to YUY2, b64a and RG48 (the YU64 decode Lanczos-scaled on
    the card, `ops.scaler`), with ms/frame, peak device memory and the
    scaling stage's device time on one frame against its bound; 1080p
    lens samples (sphere_stack, planar_rotate, and sphere_stack with
    LFIL=1) decoded to YUY2 through the WP13 detour, to RG48 and to BGRA
    (`models.lens`, `ops.warp`), with ms/frame, each mesh's host build
    time, the apply's device time against its bound and the fill
    recurrences' device times and dispatched ops apart; the GOP phase's
    groups to YU64, v210, RG48 and BGRA (`GopCodec.decode_batch_device_to`)
    and through `api.Decoder` to 1280x720; `ops.scaler.scale_image` of an
    (8, 1080, 1920, 3) float32 batch to 720p (TF32 off in its products)
    and `ops.warp.warp_bilinear` by `mesh_gopro_preset`, against their
    bounds.  Every decode's frames 0 and 7 (a lens sample's only frame)
    must equal the port's CPU path, the float ops within rtol 1e-5, atol
    1e-4; the scaler goldens, the warp `apply_*` goldens (driven from the
    copied cache) and the `gopstream` frame-1 RG48 and YU64 goldens must
    be byte-equal on the card; 0 frames may fall back; each decoder merge
    form must run 6 times a device decode;
12. runs the encoder's other inputs and options: first, not counted, the
    DWT kernels at the phase's new shapes and quantizers against their
    plain versions (`dwt_forward_planes`' three levels of a 1080p R210
    batch of noise, with every chunk_pack and merge call of its encode
    and decode, and of the 4096x2160 DPX0 batch; `dwt_forward_yuy2` and
    `dwt_forward_groups` at the custom quantizers of an all-1 and of the
    largest 16-bit caller table) and the plain unpacks' device times
    against their bounds; then, with the launch counts set to 0, the 13
    320x240 `raw_*` encode goldens through `api.Encoder` on the card (RG24
    at 0.999 of the bytes, the others byte for byte), a batch of 8 1080p
    frames of each of the 13 formats (the probe's raw fill, rolled one row
    a frame) and of 4 4096x2160 DPX0 frames encoded on the card (frames 0
    and the last equal to the CPU path; the overflowed bands, the ratio,
    the encode's device part and host tail a frame, medians of 3 after a
    warm-up) and decoded on the card (no frame falling back; the PSNR
    against the unpacked input); a custom-quantization YUY2 batch (equal
    to the CPU path, smaller than the preset's), LYUV, CV67 and both from
    override.colr, a 12-frame 1080p V210 passthrough series at 0x0404
    (both kinds of frame) through `api.Encoder` on the card and the CPU
    (equal), a batch of 8 interlaced 1080i groups through `GopCodec`
    (equal to the CPU path) and `ilace_320x240_q4_p1.cfhd.f1` re-encoded
    byte for byte through `api.Encoder`; it fails unless that launched
    every kernel;
13. fails if a module of the JAX package was imported.

It uses one card: where more are visible it keeps the first.  It imports
only the port, `cineform_tpu_torch`.
Its last lines are the card (`nvidia-smi`), a JSON line of the kernels,
and `{"ok": true, "device": {...}}`.  Any failure exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1920, 1080
BATCH = 8
GOLDEN, GOLDEN_QUALITY = "s_1920x1080_q6_p1", 6   # yuy2_frame pattern 1
# the RGB path's 320x240 quality-4 goldens: each encode golden's input
# format, and the decode goldens' sources with the format that decodes them
RGB_ENCODE_GOLDENS = (("RG48", "rg48_320x240_q4_p1"),
                      ("B64A", "b64a_320x240_q4_p1"), ("RG64", "raw_RG64"))
RGB_DECODE_GOLDENS = (("RG48", "rgb444_320x240_q4"),
                      ("B64A", "rgba4444_320x240_q4"))
RGB_OUTPUTS = (("RG48", "rg48out"), ("b64a", "b64aout"))
# the 4:2:2 10-bit and Bayer phase's 320x240 quality-4 encode goldens (each
# input format's pattern 1 of its test frame, BYR5 the raw fill), and its
# decode goldens: (source format, sample, output, extension)
NEW_ENCODE_GOLDENS = (("UYVY", "uyvy_320x240_q4_p1"),
                      ("V210", "v210_320x240_q4_p1"),
                      ("YU64", "yu64_320x240_q4_p1"),
                      ("BYR4", "byr4_320x240_q4_p1"), ("BYR5", "raw_BYR5"))
NEW_DECODE_GOLDENS = (("YUY2", "s_320x240_q4_p1", "BGRA", "bgraout"),
                      ("BYR4", "byr4_320x240_q4_p1", "BYR4", "byr4out"))
# the Bayer RGB phase's 320x240 API decode goldens: (sample, the API's
# output format, extension)
BAYER_API_GOLDENS = (
    *(("byr4_320x240_q4_p1", fmt, ext) for fmt, ext in (
        ("RG48", "rg48out"), ("B64A", "b64aout"), ("WP13", "wp13out"),
        ("W13A", "w13aout"), ("YUY2", "yuy2out"), ("UYVY", "2vuyout"),
        ("BYR2", "byr2out"), ("BYR4", "byr4out"))),
    ("byr4_colm_320x240_q4", "RG48", "rg48out"),
    ("byr4_wbal_320x240_q4", "RG48", "rg48out"),
    ("byr4_wbal_320x240_q4", "YUY2", "yuy2out"),
    ("byr4_wbal2_320x240_q4", "RG48", "rg48out"),
    ("byr4_satexp_320x240_q4", "RG48", "rg48out"))
# the Bayer batch: a 4K UHD mosaic, four 1920x1080 planes
BAYER_WIDTH, BAYER_HEIGHT = 3840, 2160
ALL_PATHS = ("yuy2", "rgb", "yuv10", "bayer")
# the GOP phase's 320x240 quality-4 goldens: name, the yuy2_frame patterns
# of frames 0 and 1
GOP_GOLDENS = (("gop_320x240_q4_p1", 1, 2), ("gop2_320x240_q4_p100", 100, 100))
# the outputs phase's API decode goldens: (sample, the API's output format,
# extension); the two 8-bit outputs of the RGB source round to nearest
# where the reference dithers, within +/-1 of the golden (NEAR_GOLDENS)
OUTPUT_GOLDENS = (
    *(("s_320x240_q4_p1", fmt, ext) for fmt, ext in (
        ("YU64", "yu64out"), ("V210", "v210out"), ("R408", "r408out"),
        ("V408", "v408out"), ("RG24", "rg24out"), ("WP13", "wp13out"),
        ("W13A", "w13aout"), ("YUYV", "yuyvout"), ("CT_SHORT", "av16out"),
        ("CT_USHORT_10_6", "a106out"), ("CT_SHORT_2_14", "a214out"),
        ("CT_10BIT_2_8", "av28out"), ("BGRa", "bgra_sdout"))),
    *(("s_128x96_q4_p1", fmt, ext) for fmt, ext in (
        ("RG48", "rg48out"), ("B64A", "b64aout"), ("R210", "r210out"),
        ("DPX0", "dpx0out"), ("RG30", "rg30out"))),
    ("s_144x96_q4_p1", "V210", "v210out"),
    ("s_144x96_q4_p1", "YU64", "yu64out"),
    ("rg48_320x240_q4_p1", "WP13", "wp13out"),
    ("rg48_320x240_q4_p1", "W13A", "w13aout"),
    ("rg48_320x240_q4_p1", "RG24", "rg24out"),
    ("rg48_320x240_q4_p1", "BGRa", "bgra_sdout"),
    ("yu64_320x240_q4_p1", "RG48", "rg48out"))
NEAR_GOLDENS = (("rg48_320x240_q4_p1", "RG24"), ("rg48_320x240_q4_p1", "BGRa"))
# the reduced-resolution goldens: (sample, resolution, extension); the
# port's quarter decode is the JAX package's truncated two-level inverse,
# which differs from the reference's quarter path (ROADMAP Queue 3), so
# the quarter goldens are held against the port's CPU path only
SCALED_GOLDENS = tuple((name, res, ext) for name in ("s_320x240_q4_p1",
                                                     "s_640x360_q5_p1")
                       for res, ext in ((2, "half.yuy2"),
                                        (3, "quarter.yuy2")))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden", "samples")
# the warp goldens' cases (tests/test_warp_geomesh.py's): name -> (mesh
# width, mesh height, the transform stack); the `apply_*` goldens (case,
# format, backgroundfill), the two fill goldens last, in the order that
# generated them from one rand stream
WARP_CASES = {
    "defish_pos": (39, 29, [("defish", (60.0,))]),
    "repoint_h4_h4": (39, 29, [("repoint_src_to_dst",
                                (0.9, 0.2, -0.1, 0.05, 4, 4))]),
    "scale_out": (39, 29, [("scale", (0.6, 0.6))]),
}
WARP_APPLY = (*(("defish_pos", fmt, 0) for fmt in ("yuy2", "bgra", "rg48",
                                                    "b64a", "wp13", "w13a")),
              ("repoint_h4_h4", "yuy2", 0), ("repoint_h4_h4", "rg48", 0),
              ("scale_out", "yuy2", 0), ("scale_out", "rg48", 0),
              ("scale_out", "yuy2", 1), ("scale_out", "bgra", 1))
WARP_FORMATS = {"yuy2": "FORMAT_YUY2", "bgra": "FORMAT_32BGRA",
                "b64a": "FORMAT_64ARGB", "rg48": "FORMAT_RG48",
                "wp13": "FORMAT_WP13", "w13a": "FORMAT_W13A"}
# the encoder inputs phase: the 320x240 raw_* encode goldens (input
# format, golden, bytes a pixel), each the probe's raw fill pattern 1; the
# film-scan batch (DPX0); the custom quantization tables whose quantizers
# the DWT kernels are held at (all 1, and the largest a 16-bit caller entry
# gives)
RAW_GOLDENS = (("R210", "raw_r210", 4), ("DPX0", "raw_DPX0", 4),
               ("RG30", "raw_RG30", 4), ("AB10", "raw_AB10", 4),
               ("AR10", "raw_AR10", 4), ("BGRA", "raw_BGRA", 4),
               ("BGRa", "raw_BGRa", 4), ("RG24", "raw_RG24", 3),
               ("CT_UCHAR", "raw_avu8", 2), ("CT_10BIT_2_8", "raw_av28", 2.5),
               ("CT_SHORT_2_14", "raw_a214", 4),
               ("CT_USHORT_10_6", "raw_a106", 4), ("CT_SHORT", "raw_av16", 4))
SCAN_WIDTH, SCAN_HEIGHT, SCAN_BATCH = 4096, 2160, 4
CUSTOM_TABLES = {"all 1": [1] * 17, "largest": [0xFFFF] * 17}
# BENCH_r05.json's content figures for this batch (1080p, batch 8,
# quality 4, cap_bits 8): the codec is integer, so the port repeats them
OVERFLOWED_BANDS, PSNR_DB, RATIO = 57, 47.26, 2.93
# the card's published peaks (H100 SXM data sheet, at 700 W): memory, and
# float32 outside the tensor cores, the nearest listed rate for the kernels'
# 32-bit integer operations
PEAK_BYTES_PER_S, PEAK_OPS_PER_S = 3.35e12, 67e12
# the spin kernel in front of a call that `device_ms` times: 10^7 cycles,
# about 5 ms at the card's clock, far longer than any timed call's host path
SPIN_CYCLES = 10_000_000


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """Median milliseconds of `fn` on the current stream, after a warm-up,
    by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, reps: int = 5) -> float:
    """Median device milliseconds of one call of `fn`, without the host
    path around it: CUDA events around the call, queued behind a spin
    kernel that keeps the card busy until the host has queued the whole
    call, so that the card runs the call's work back to back.
    (torch.profiler's traces of such calls lost kernel records on the
    H100, more of them the later in a long run.)"""
    fn()
    torch.cuda.synchronize()
    times = []
    cycles = SPIN_CYCLES
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        queued_in_time = not start.query()
        end.synchronize()
        if queued_in_time:
            times.append(start.elapsed_time(end))
        elif cycles >= 64 * SPIN_CYCLES:
            raise AssertionError("device_ms: the host queues the call more "
                                 "slowly than the card spins")
        else:
            cycles *= 2
    return statistics.median(times)


def sync_calls(torch, fn) -> int:
    """How many synchronizing CUDA calls one call of `fn` makes, after a
    warm-up (torch's sync debug mode)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def queue_ms(torch, fn, reps: int = 3) -> tuple[float, bool]:
    """(median host milliseconds to queue one call of `fn` behind a spin
    kernel that keeps the card busy, whether the card's launch queue
    filled and held the host until the spin ended in any of the calls)."""
    fn()
    torch.cuda.synchronize()
    times, full = [], False
    for _ in range(reps):
        torch.cuda._sleep(64 * SPIN_CYCLES)
        spun = torch.cuda.Event()
        spun.record()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        full |= spun.query()
        torch.cuda.synchronize()
    return statistics.median(times), full


def flat(tree) -> tuple:
    """The tensors of nested tuples, in order."""
    if isinstance(tree, (tuple, list)):
        return tuple(t for part in tree for t in flat(part))
    return (tree,)


def max_abs_err(torch, got, want) -> int:
    """Largest difference between two tuples of integer tensors, words
    compared as int32 bit patterns."""
    err = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"kernel output {tuple(g.shape)} {g.dtype} "
                                 f"vs plain {tuple(w.shape)} {w.dtype}")
        if g.numel():
            d = (g.to(torch.int64) - w.to(torch.int64)).abs().max()
            err = max(err, int(d))
    return err


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(nbytes_moved: int, ops: int) -> tuple[float, str]:
    """The least time the card could take: (ms, what bounds it)."""
    by_bytes = nbytes_moved / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def host_ms(torch, fn):
    """(result, milliseconds) of `fn`, ended by a device synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / mse)) if mse > 0 else 99.0


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    return smi.splitlines()[0] if smi else "nvidia-smi: no output"


def warp_test_image(w: int, h: int, fmt: str) -> np.ndarray:
    """The warp goldens' source frame (seed 12345) as (1, bytes) uint8."""
    rng = np.random.default_rng(12345)
    if fmt in ("yuy2", "bgra"):
        a = rng.integers(0, 256, (h, (2 if fmt == "yuy2" else 4) * w),
                         np.uint8)
    elif fmt in ("rg48", "b64a"):
        a = rng.integers(0, 65536, (h, (3 if fmt == "rg48" else 4) * w),
                         np.uint16).astype("<u2")
    else:
        a = rng.integers(-1024, 8192, (h, (3 if fmt == "wp13" else 4) * w),
                         np.int16).astype("<i2")
    return a.view(np.uint8).reshape(1, -1)


def golden(ext: str, name: str = GOLDEN) -> bytes:
    with open(os.path.join(GOLDEN_DIR, f"{name}.{ext}"), "rb") as f:
        return f.read()


def main() -> int:
    # one card: the first of those visible, before torch initialises CUDA
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    os.environ["CUDA_VISIBLE_DEVICES"] = visible
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke run "
                         "needs one card")
    if not os.path.isdir(os.path.join(ROOT, "cineform_tpu_torch")):
        raise SystemExit("chip_smoke: run it from the root of a checkout")
    sys.path.insert(0, ROOT)

    from cineform_tpu_torch import _build, api
    from cineform_tpu_torch.entropy import device as edev
    from cineform_tpu_torch.entropy import device_decode as ddec
    from cineform_tpu_torch.models.gop import GopCodec
    from cineform_tpu_torch.models.intra import IntraCodec, sample_metadata
    from cineform_tpu_torch.models import lens
    from cineform_tpu_torch.models.intra_host import EncoderMetadata
    from cineform_tpu_torch.models.stereo import (decode_batch_device_3d,
                                                  encode_batch_3d, split_3d)
    from cineform_tpu_torch.ops import demosaic as dmops
    from cineform_tpu_torch.ops import intra_transform as ops
    from cineform_tpu_torch.ops import scaler as scaler_ops
    from cineform_tpu_torch.ops import warp as warp_ops
    from cineform_tpu_torch.ops import yuv_output
    from cineform_tpu_torch.pool import DecoderPool
    from cineform_tpu_torch.ref.demosaic import (bayer_yuyv_parity,
                                                 curve2linear_lut,
                                                 linear2curve_lut)
    from cineform_tpu_torch.ref import geomesh
    from cineform_tpu_torch.ref.intra import rg24_dither
    from cineform_tpu_torch.spec.production import custom_quant_tables
    from cineform_tpu_torch.ops.chunk_pack import chunk_pack
    from cineform_tpu_torch.ops import dwt_forward as dwt
    from cineform_tpu_torch.ops.dwt_forward import (
        dwt_forward_groups, dwt_forward_level, dwt_forward_planes,
        dwt_forward_yuy2)
    from cineform_tpu_torch.ops import merge_network as merges
    from cineform_tpu_torch.ops.merge_network import (
        merge_network, merge_network_highfirst, merge_network_tgt)
    from cineform_tpu_torch.testframes import (b64a_frame, byr4_frame,
                                               raw_fill, rg48_frame,
                                               uyvy_frame, v210_frame,
                                               yu64_frame, yuy2_frame)
    from torch.utils._python_dispatch import TorchDispatchMode

    if torch.cuda.device_count() != 1:
        raise AssertionError(f"expected one visible card, found "
                             f"{torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    # --- 1. build -------------------------------------------------------------
    merge_src = "cineform_tpu_torch/csrc/merge_network.cu"
    merge_tpu = "cineform_tpu/ops/pallas_merge.py:88"
    encode_calls = f"every call of one batch-{BATCH} 1080p encode"
    decode_calls = (f"every call of one batch-{BATCH} 1080p decode (6 band "
                    "row classes)")
    # ops: 32-bit integer operations per input element, counted from the
    # plain versions' arithmetic (the DWT's two 2-6 filters, saturation and
    # quantization; chunk_pack's 8 merge levels; one placement for each
    # merge form, the encoder's with its segmented OR)
    dwt_src = "cineform_tpu_torch/csrc/dwt_forward.cu"
    dwt_library = ("none: no PyTorch call does the 2-6 filter pair with "
                   "prescale rounding, int16 saturation and dead-zone "
                   "quantization")
    # paths: the main paths that launch the kernel: YUY2, the RGB formats,
    # the 10-bit 4:2:2 formats (UYVY, YU64, V210) and Bayer (BYR4, BYR5)
    kernels = {
        "dwt_forward_yuy2": dict(
            wrapper=dwt_forward_yuy2, route="cuda", source=dwt_src,
            replaces="cineform_tpu/ops/pallas_dwt2.py:99",
            also_replaces="cineform_tpu/ops/pallas_dwt.py:151",
            mode="level 1 from the YUY2 bytes (the unpack fused), Y, V, U "
                 "in one launch, bands in the entropy coder's layout",
            ops_per_elem=40, paths=("yuy2", "encoder_inputs"),
            library_note=dwt_library),
        "dwt_forward_groups": dict(
            wrapper=dwt_forward_groups, route="cuda", source=dwt_src,
            replaces="cineform_tpu/ops/pallas_dwt2.py:99",
            also_replaces="cineform_tpu/ops/pallas_dwt.py:151",
            mode="Y, V, U in one launch a level, bands in the entropy "
                 "coder's layout: levels 2 and 3 of every 4:2:2 format, "
                 "level 1 of UYVY, YU64 and V210 from the group buffers the "
                 "plain unpack builds", ops_per_elem=40,
            paths=("yuy2", "yuv10", "encoder_inputs"),
            library_note=dwt_library,
            ms_covers=f"levels 2 and 3 of one batch-{BATCH} 1080p YUY2 "
                      "encode"),
        "dwt_forward_planes": dict(
            wrapper=dwt_forward_planes, route="cuda", source=dwt_src,
            replaces="cineform_tpu/ops/pallas_dwt2.py:99",
            also_replaces="cineform_tpu/ops/pallas_dwt.py:151",
            mode="every level of the RGB and Bayer formats: the 3 (RGB) or "
                 "4 (RGBA, Bayer) equal-size int32 planes in one launch a "
                 "level, level 1 from the planes the plain unpack builds, "
                 "bands in the entropy coder's layout", ops_per_elem=40,
            paths=("rgb", "bayer", "encoder_inputs"),
            library_note=dwt_library,
            ms_covers=f"the 3 levels of one batch-{BATCH} 1080p RG48 "
                      "encode"),
        "chunk_pack": dict(
            wrapper=chunk_pack, route="cuda",
            source="cineform_tpu_torch/csrc/chunk_pack.cu",
            replaces="cineform_tpu/ops/pallas_pack.py:135",
            ops_per_elem=8 * 16, paths=ALL_PATHS + ("encoder_inputs",)),
        "merge_network": dict(
            wrapper=merge_network, route="cuda", source=merge_src,
            replaces=merge_tpu,
            mode="low-bit-first (encoder concat): guarded OR placement, "
                 "network on flagged rows", ops_per_elem=20,
            paths=ALL_PATHS + ("encoder_inputs",)),
        "merge_network_tgt": dict(
            wrapper=merge_network_tgt, route="cuda", source=merge_src,
            replaces=merge_tpu,
            also_replaces="cineform_tpu/entropy/device_decode.py:435",
            mode="low-bit-first with tgt merged by max (decoder "
                 "compact_rows): guarded one-pass placement, network on "
                 "flagged rows", ms_covers=decode_calls, ops_per_elem=16,
            paths=ALL_PATHS + ("bayer_rgb", "outputs", "scaled",
                               "geometry", "encoder_inputs")),
        "merge_network_highfirst": dict(
            wrapper=merge_network_highfirst, route="cuda", source=merge_src,
            replaces=merge_tpu,
            mode="high-bit-first (decoder spread_rows, on mirrored rows): "
                 "guarded one-pass placement, network on flagged rows",
            ms_covers=decode_calls, ops_per_elem=12,
            paths=ALL_PATHS + ("bayer_rgb", "outputs", "scaled",
                               "geometry", "encoder_inputs")),
    }
    t0 = time.perf_counter()
    sources = sorted({os.path.splitext(os.path.basename(k["source"]))[0]
                      for k in kernels.values()})
    with ThreadPoolExecutor(len(sources)) as pool:
        paths = dict(zip(sources, pool.map(_build.library_path, sources)))
    for src, path in paths.items():
        with open(path + ".log") as f:
            ptxas = " | ".join(line.strip() for line in f
                               if "registers" in line or "spill" in line
                               or "smem" in line)
        log(f"built {src}: {os.path.relpath(path, ROOT)}; ptxas: {ptxas}")
    log(f"build seconds: {time.perf_counter() - t0:.3f}")

    # --- 2. each kernel against its plain version at the main path's shapes -
    codec = IntraCodec(WIDTH, HEIGHT, 4, device=dev)
    base = np.frombuffer(yuy2_frame(WIDTH, HEIGHT, 1), np.uint8).reshape(
        HEIGHT, 2 * WIDTH)
    frames = np.stack([np.roll(base, i, axis=0) for i in range(BATCH)])
    check = frames.copy()
    check[-1] = np.random.default_rng(0).integers(0, 256, base.shape,
                                                  dtype=np.uint8)
    tables = codec.tables()
    for k in kernels.values():
        k.update(max_abs_err=0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                 library_ms=None)
    for name in ("dwt_forward_yuy2", "dwt_forward_groups",
                 "dwt_forward_planes"):
        kernels[name].update(device_ms=0.0, bytes=0)

    def compare(name, call, plain, what, inputs, ops=None, library=None,
                tally=True, timed=True, device=False, book=None):
        """Kernel against plain version on `inputs`, both timed unless not
        `timed`; the bound counts each input read and each output written
        once (chunk_pack writes every chunk's whole capacity of words, the
        zeros past its bit length included), and `ops` (default: the
        kernel's ops per input element).
        With `tally`, the times and the bound add to the kernel's line;
        with `book`, they and the device time add to the kernel's entry
        `book` (another path's figures) instead.
        The device time (`device_ms`) is taken for the kernels that
        report one, and for any with `device` or `book`."""
        got, want = call(), plain()
        torch.cuda.synchronize()
        got, want = flat(got), flat(want)
        err = max_abs_err(torch, got, want)
        k = kernels[name]
        if not timed:
            log(f"  {name} {what}: max_abs_err {err}")
            if err:
                raise AssertionError(f"{name} {what}: kernel disagrees with "
                                     f"its plain version (max abs err "
                                     f"{err})")
            return got
        ms, plain_ms = cuda_ms(torch, call), cuda_ms(torch, plain)
        if ops is None:
            ops = k["ops_per_elem"] * inputs[0].numel()
        moved = nbytes(inputs) + nbytes(got)
        bound, by = bound_ms(moved, ops)
        k["max_abs_err"] = max(k["max_abs_err"], err)
        extra = ""
        if tally:
            k["bound_by"] = by
            k["ms"] += ms
            k["plain_ms"] += plain_ms
            k["bound_ms"] += bound
        if "device_ms" in k or device or book:
            dms = device_ms(torch, call)
            extra += (f", device {dms:.4f} ms (the bound is "
                      f"{100 * bound / dms:.1f}% of it)")
            if tally and "device_ms" in k:
                k["device_ms"] += dms
                k["bytes"] += moved
        if book:
            b = k.setdefault(book, dict(ms=0.0, plain_ms=0.0, device_ms=0.0,
                                        bound_ms=0.0, bytes=0, calls=0))
            for key, v in (("ms", ms), ("plain_ms", plain_ms),
                           ("device_ms", dms), ("bound_ms", bound),
                           ("bytes", moved), ("calls", 1)):
                b[key] += v
        if library is not None:
            lib_ms = cuda_ms(torch, library)
            if tally:
                k["library_ms"] = (k["library_ms"] or 0.0) + lib_ms
            if book:
                k[book]["library_ms"] = k[book].get("library_ms", 0.0) \
                    + lib_ms
            extra += f", library call {lib_ms:.4f} ms"
        log(f"  {name} {what}: max_abs_err {err}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms{extra}")
        if err:
            raise AssertionError(f"{name} {what}: kernel disagrees with its "
                                 f"plain version (max abs err {err})")
        return got

    log(f"kernel checks, batch {BATCH} at {WIDTH}x{HEIGHT} q4 "
        "(tolerance 0; times are CUDA-event medians of 5, device times "
        "`device_ms` medians of 5)")

    def dwt_levels(c, frames_dev, what, tally):
        """The DWT's three launches on `frames_dev`, each against its plain
        version; returns the kernels' levels."""
        t = c.tables()
        precision = c.params.precision

        def quants(lev):
            return [t.band_quant[ch][lev] for ch in range(3)]

        levels = [compare(
            "dwt_forward_yuy2",
            lambda: dwt_forward_yuy2(frames_dev, precision, t.prescale[0],
                                     quants(0)),
            lambda: dwt.plain_groups(ops.unpack_yuy2(frames_dev, precision),
                                     t.prescale[0], quants(0)),
            f"{what} level 1 {tuple(frames_dev.shape)} quants {quants(0)}",
            (frames_dev,), tally=tally)]
        for lev in (1, 2):
            y, c2 = levels[-1][:2]
            ps = t.prescale[lev]
            out = compare(
                "dwt_forward_groups",
                lambda: dwt_forward_groups((y, c2), ps, quants(lev)),
                lambda: dwt.plain_groups((y[:, 0], c2[:, 0], c2[:, 1]), ps,
                                         quants(lev)),
                f"{what} level {lev + 1} {tuple(y.shape)} + "
                f"{tuple(c2.shape)} prescale {ps} quants {quants(lev)}",
                (y, c2), ops=40 * (y.numel() + c2.numel()), tally=tally)
            levels.append(out)
        return [(out[:2], out[2:]) for out in levels]

    x = codec._upload(check)
    levels = dwt_levels(codec, x, f"batch {BATCH}", True)
    gx = codec._upload(base[None])
    dwt_levels(IntraCodec(WIDTH, HEIGHT, GOLDEN_QUALITY, device=dev), gx,
               f"{GOLDEN} frame", False)
    # the single-plane entry point (the same device code, off the main
    # path) on the batch's luma
    ll = ops.unpack_yuy2(x, codec.params.precision)[0].contiguous()
    for lev in range(3):
        ps, q = tables.prescale[lev], tables.band_quant[0][lev]
        got = flat(dwt_forward_level(ll, ps, q))
        err = max_abs_err(torch, got, flat(ops.dwt2d_forward(ll, ps, q)))
        log(f"  dwt_forward_level luma level {lev + 1} {tuple(ll.shape)}: "
            f"max_abs_err {err}")
        if err:
            raise AssertionError(f"dwt_forward_level luma level {lev + 1}: "
                                 f"kernel disagrees with its plain version "
                                 f"(max abs err {err})")
        ll = got[0]
    for name in ("dwt_forward_yuy2", "dwt_forward_groups"):
        k = kernels[name]
        log(f"  {name}, a batch: kernel {k['ms']:.4f} ms (CUDA events), "
            f"device {k['device_ms']:.4f} ms (device_ms), bound "
            f"{k['bound_ms']:.4f} ms ({k['bytes']} bytes, "
            f"{100 * k['bound_ms'] / k['device_ms']:.1f}% of the device "
            f"time), {1 if name == 'dwt_forward_yuy2' else 2} launches")

    def counted(counter, fn) -> int:
        """What one call of `fn` adds to a device counter."""
        counter.zero_()
        fn()
        return int(counter.item())

    codes = edev.encode_tables(17)

    def encode_checks(c, levels, **opts):
        """chunk_pack and merge_network against their plain versions on
        every band group of `levels` (`c.forward_levels`' output), with the
        counts of chunks taking the tree and rows failing the guard; `opts`
        go to `compare`.  Returns (a chunk overflowed, tree chunks, flagged
        rows)."""
        any_chunk_ovf, tree_total, flagged_total = False, 0, 0
        for lev in range(3):
            for grp, bands in zip(c.groups, levels[lev][1]):
                bits, sizes = edev.chunk_codes(c.group_bands(bands), codes)
                what = f"level {lev + 1} channels {grp}"
                tree = counted(chunk_pack.tree_chunks.setdefault(
                    dev, torch.zeros(1, dtype=torch.int32, device=dev)),
                    lambda: chunk_pack(bits, sizes))
                want_tree = int((~edev._pack_fits(
                    sizes, cap_bits_per_elem=12)).sum())
                packed = compare(
                    "chunk_pack", lambda: chunk_pack(bits, sizes),
                    lambda: edev.tree_pack(bits, sizes,
                                           cap_bits_per_elem=12),
                    f"{what} {tuple(bits.shape)}", (bits, sizes), **opts)
                log(f"  chunk_pack {what}: {tree} of "
                    f"{sizes.shape[:-1].numel()} chunks took the tree path "
                    f"({want_tree} do not fit)")
                if tree != want_tree:
                    raise AssertionError(f"chunk_pack {what}: {tree} chunks "
                                         f"took the tree, {want_tree} do "
                                         "not fit")
                any_chunk_ovf |= bool(packed[2].any())
                tree_total += tree
                val, rem, _ = edev._concat_slots(packed[0], packed[1])
                merges.reset_counts()
                flagged = counted(merge_network.flagged.setdefault(
                    dev, torch.zeros(1, dtype=torch.int32, device=dev)),
                    lambda: merge_network(val, rem))
                guard = edev._concat_guard(rem)
                branches = dict(merge_network.branch_launches)
                log(f"  merge_network {what}: {flagged} of {guard.numel()} "
                    f"rows flagged ({int((~guard).sum())} fail "
                    f"_concat_guard), branch launches {branches}")
                if flagged != int((~guard).sum()) or \
                        set(branches.values()) != {1}:
                    raise AssertionError(f"merge_network {what}: {flagged} "
                                         "rows flagged, branch launches "
                                         f"{branches}")
                flagged_total += flagged
                # the same function as one PyTorch call on the rows that
                # pass the guard, where the words' bits are disjoint and a
                # sum is an OR: a scatter_add_ into a zeroed row with a
                # spare column for the slots that fall off, its index built
                # here, outside the timed window
                n = val.shape[-1]
                ok_val, ok_rem = val[guard], rem[guard]
                dest = torch.arange(n, dtype=torch.int32, device=dev) - ok_rem
                index = torch.where(dest >= 0, dest, n).long()

                def library():
                    return torch.zeros((ok_val.shape[0], n + 1),
                                       dtype=torch.int32, device=dev
                                       ).scatter_add_(-1, index, ok_val)

                got = compare("merge_network",
                              lambda: merge_network(val, rem),
                              lambda: edev._settle_network(val, rem),
                              f"{what} {tuple(val.shape)}", (val, rem),
                              library=library if guard.any() else None,
                              **opts)
                if not torch.equal(library()[:, :n], got[0][guard]):
                    raise AssertionError(f"merge_network {what}: the library "
                                         "yardstick computes another "
                                         "function")
        return any_chunk_ovf, tree_total, flagged_total

    any_chunk_ovf, tree_total, flagged_total = encode_checks(codec, levels)
    if not any_chunk_ovf or not tree_total:
        raise AssertionError("no chunk overflowed: the tree path of "
                             "chunk_pack was not checked")
    if not flagged_total:
        raise AssertionError("no encoder row failed the guard: the network "
                             "branch of merge_network was not checked")
    del x, gx, ll, levels

    def decode_checks(c, samples, **opts):
        """The two decoder merge forms against their plain versions on
        every band row class of `samples`; `opts` go to `compare`.
        Returns class 0's rows (val, rem, tgt, spread val, spread rem)."""
        rows = c._decode_rows_args(samples)
        if rows[-1]:
            raise AssertionError(f"frames {sorted(rows[-1])} left the device "
                                 "route")
        for ci, (lev, planes) in enumerate(c._DECODE_CLASSES):
            bh, _, pitch = c._class_dims(lev, planes)
            nout = bh * pitch
            pay = rows[0][ci]
            slots = ddec.band_slots(pay, rows[1][ci], rows[2][ci],
                                    rows[3][ci], nout)
            val, rem, tgt = ddec.compact_inputs(*slots[:3])
            what = (f"class {ci} ({bh}x{pitch} bands of planes {planes}), "
                    f"payload {tuple(pay.shape)}")
            comp = compare("merge_network_tgt",
                           lambda: merge_network_tgt(val, rem, tgt),
                           lambda: edev._settle_network_tgt(val, rem, tgt),
                           f"{what}, slots {tuple(val.shape)}",
                           (val, rem, tgt), **opts)
            varr, darr = ddec.spread_inputs(comp[2], comp[0], nout)
            # the same function as one PyTorch call: a scatter into a zeroed
            # row with a spare column for the slots that fall off, its index
            # built here, outside the timed window
            m = darr.shape[-1]
            dest = torch.arange(m, dtype=torch.int32, device=dev) - darr
            index = torch.where(dest >= 0, dest, m).long()
            compare("merge_network_highfirst",
                    lambda: merge_network_highfirst(varr, darr),
                    lambda: edev._settle_network_highfirst(varr, darr),
                    f"{what}, spread rows {tuple(varr.shape)}", (varr, darr),
                    library=lambda: torch.zeros(
                        (darr.shape[0], m + 1), dtype=torch.int32,
                        device=dev).scatter_(-1, index, varr), **opts)
            if ci == 0:
                first = (val, rem, tgt, varr, darr)
        return first

    # decode shapes: the band row classes of the main path's batch
    guard_rows = decode_checks(codec, codec.encode_batch_device(frames))

    # the network branch: rows of the level-1 luma class that break the
    # guards, among rows that keep them, in one call of each form
    val, rem, tgt, varr, darr = (t.clone() for t in guard_rows)
    bad = (0, 5, 11)
    for r in bad:
        i = rem.shape[-1] // 2 + r
        rem[r, i:] += 2                  # a step of 2: not a compaction row
        darr[r, i] = darr[r, i - 1] + 1  # an increase: not a spread row
    for name, wrapper, call, plain, what in (
            ("merge_network_tgt", merge_network_tgt,
             lambda: merge_network_tgt(val, rem, tgt),
             lambda: edev._settle_network_tgt(val, rem, tgt),
             f"slots {tuple(val.shape)}"),
            ("merge_network_highfirst", merge_network_highfirst,
             lambda: merge_network_highfirst(varr, darr),
             lambda: edev._settle_network_highfirst(varr, darr),
             f"spread rows {tuple(varr.shape)}")):
        merges.reset_counts()
        got, want = call(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        flagged = int(wrapper.flagged[dev].item())
        ms = cuda_ms(torch, call, reps=1)
        log(f"  {name} guard-breaking rows {list(bad)} of level-1 luma "
            f"{what}: max_abs_err {err}, flagged rows {flagged}, branch "
            f"launches {wrapper.branch_launches}, kernel {ms:.4f} ms")
        if err or flagged != len(bad):
            raise AssertionError(f"{name}: on guard-breaking rows the "
                                 f"network branch gave max abs err {err} "
                                 f"and flagged {flagged} rows, not "
                                 f"{len(bad)}")
    del guard_rows, val, rem, tgt, varr, darr, got, want

    # --- 3. the main path -------------------------------------------------------
    def reset_counts():
        """Every launch count and device counter to 0."""
        for k in kernels.values():
            k["wrapper"].launches = 0
        dwt_forward_level.launches = 0
        merges.reset_counts()
        chunk_pack.tree_chunks[dev].zero_()

    def path_launches(path, encodes, dwt_name):
        """The launch counts since `reset_counts`; fails unless every
        kernel of `path` was launched, the DWT entry point `dwt_name` 3
        times for each of the `encodes`, and no other DWT entry point."""
        got = {n: k["wrapper"].launches for n, k in kernels.items()}
        dwts = {n: got[n] for n in ("dwt_forward_yuy2", "dwt_forward_groups",
                                    "dwt_forward_planes")}
        want = {n: 3 * encodes if n == dwt_name else 0 for n in dwts}
        if not all(got[n] for n, k in kernels.items() if path in k["paths"]) \
                or dwts != want or dwt_forward_level.launches:
            raise AssertionError(
                f"the {path} path's {encodes} encodes launched {got} and the "
                f"single-plane level {dwt_forward_level.launches}: expected "
                f"every kernel of the path, {dwt_name} 3 times an encode and "
                "no other DWT entry point")
        return got

    reset_counts()

    gold = golden("cfhd")
    golden_codec = IntraCodec(WIDTH, HEIGHT, GOLDEN_QUALITY, device=dev)
    got = golden_codec.encode_batch_device(base[None], 1,
                                           sample_metadata(gold))
    if got[0] != gold:
        raise AssertionError(f"1080p encode differs from {GOLDEN}.cfhd")
    log(f"golden encode: byte-equal to {GOLDEN}.cfhd ({len(gold)} bytes)")
    out = golden_codec.decode_batch([gold])
    if out.tobytes() != golden("yuy2"):
        raise AssertionError(f"1080p decode differs from {GOLDEN}.yuy2")
    log(f"golden decode: byte-equal to {GOLDEN}.yuy2; PSNR vs the source "
        f"{psnr(out, base[None]):.4f} dB")
    out, fallback = golden_codec.decode_batch_device([gold])
    if fallback or out.tobytes() != golden("yuy2"):
        raise AssertionError(f"1080p device decode differs from {GOLDEN}."
                             f"yuy2 (host fallback frames {fallback})")
    log(f"golden device decode: byte-equal to {GOLDEN}.yuy2")

    before = {n: k["wrapper"].launches for n, k in kernels.items()}
    enc_dev, enc_host, dec_host, dec_dev = [], [], [], []
    for it in range(4):
        packed, ms = host_ms(torch, lambda: codec.forward_packed(
            codec._upload(frames)))
        enc_dev.append(ms)
        t0 = time.perf_counter()
        samples = codec.write_samples(frames, packed)
        enc_host.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        co = codec.host_entropy_decode(samples)
        torch.cuda.synchronize()
        dec_host.append((time.perf_counter() - t0) * 1e3)
        decoded, ms = host_ms(torch, lambda: codec.inverse(co).cpu().numpy())
        dec_dev.append(ms)
        if it == 0:
            first = (packed, samples, decoded)
    packed, samples, decoded = first

    parts = ("header walk and fill", "upload", "device entropy decode",
             "inverse with pack", "download")
    dev_parts = {p: [] for p in parts}
    for it in range(4):
        if it == 0:
            base_bytes = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        host_rows = codec._decode_rows_host(samples)
        dev_parts["header walk and fill"].append(
            (time.perf_counter() - t0) * 1e3)
        dev_rows, ms = host_ms(torch, lambda: codec._upload_rows(host_rows))
        dev_parts["upload"].append(ms)
        (co, ovf), ms = host_ms(torch, lambda: codec.decode_coefficients(
            *dev_rows[:5]))
        dev_parts["device entropy decode"].append(ms)
        yuy2, ms = host_ms(torch, lambda: codec.inverse(co))
        dev_parts["inverse with pack"].append(ms)
        dev_decoded, ms = host_ms(torch, lambda: yuy2.cpu().numpy())
        dev_parts["download"].append(ms)
        if it == 0:
            peak_bytes = torch.cuda.max_memory_allocated()
        if dev_rows[-1] or bool(ovf.any()):
            raise AssertionError(f"device decode left frames "
                                 f"{sorted(dev_rows[-1])} to the host; "
                                 f"overflow {ovf.tolist()}")
        if dev_decoded.tobytes() != decoded.tobytes():
            raise AssertionError("batch device decode differs from the "
                                 "host-entropy decode")
    del host_rows, dev_rows, co, ovf, yuy2
    api_decoded, fallback = codec.decode_batch_device(samples)
    if fallback or api_decoded.tobytes() != decoded.tobytes():
        raise AssertionError(f"decode_batch_device: host fallback frames "
                             f"{fallback}, or frames differing from the "
                             "host-entropy decode")
    overflowed = sum(int(o.sum()) for _, levels in packed
                     for _, _, o, _ in levels)
    nbands = BATCH * 3 * 9
    nbits = sum(int(n.sum()) for _, levels in packed
                for _, n, _, _ in levels)
    lowpass_bytes = sum(2 * (HEIGHT >> 3) * ((WIDTH if c == 0 else WIDTH // 2)
                                             >> 3) for c in range(3))
    bench_ratio = (2 * WIDTH * HEIGHT) / (nbits / BATCH / 8 + lowpass_bytes
                                         + 1024)
    sample_ratio = BATCH * 2 * WIDTH * HEIGHT / sum(len(s) for s in samples)
    rt_psnr = psnr(decoded, frames)
    rose = {n: k["wrapper"].launches - before[n] for n, k in kernels.items()}
    launches = {n: k["wrapper"].launches for n, k in kernels.items()}
    yuy2_path = [n for n, k in kernels.items() if "yuy2" in k["paths"]]
    if not all(rose[n] for n in yuy2_path) \
            or not all(launches[n] for n in yuy2_path):
        raise AssertionError(f"a kernel was not launched by the main path: "
                             f"{launches} (batch phase {rose})")
    if (rose["dwt_forward_yuy2"], rose["dwt_forward_groups"],
            dwt_forward_level.launches, launches["dwt_forward_planes"]) \
            != (4, 8, 0, 0):
        raise AssertionError(f"the 4 batches launched the DWT {rose} times "
                             f"and the single-plane level "
                             f"{dwt_forward_level.launches}: expected 3 "
                             "launches a batch, none of the single-plane "
                             "level or of the RGB formats' entry point")
    guarded = {w.__name__: (dict(w.branch_launches),
                            int(w.flagged[dev].item()))
               for w in (merge_network, merge_network_tgt,
                         merge_network_highfirst)}
    for name, (branches, flagged) in guarded.items():
        if branches["placement"] != launches[name] \
                or branches["network"] != launches[name] \
                or (flagged and name != "merge_network"):
            raise AssertionError(f"{name}: branch launches {branches} for "
                                 f"{launches[name]} calls, {flagged} "
                                 "decoder rows failed the guard")
    tree_chunks = int(chunk_pack.tree_chunks[dev].item())

    # --- 4. the batch against the plain path and BENCH_r05 ----------------------
    if decoded.shape != frames.shape or decoded.dtype != np.uint8:
        raise AssertionError(f"decoded {decoded.shape} {decoded.dtype}")
    if (overflowed, round(rt_psnr, 2), round(bench_ratio, 2)) != (
            OVERFLOWED_BANDS, PSNR_DB, RATIO):
        raise AssertionError(
            f"{overflowed} bands overflowed, PSNR {rt_psnr}, ratio "
            f"{bench_ratio}: BENCH_r05 has {OVERFLOWED_BANDS}, {PSNR_DB}, "
            f"{RATIO}")
    picks = [0, BATCH - 1]
    t0 = time.perf_counter()
    cpu_codec = IntraCodec(WIDTH, HEIGHT, 4, device=torch.device("cpu"))
    want = cpu_codec.encode_batch_device(
        frames[picks], frame_numbers=[1 + i for i in picks])
    want_decoded = cpu_codec.decode_batch(want)
    for j, i in enumerate(picks):
        if samples[i] != want[j]:
            raise AssertionError(f"batch frame {i}: the card's sample "
                                 "differs from the plain path's")
        if decoded[i].tobytes() != want_decoded[j].tobytes():
            raise AssertionError(f"batch frame {i}: the card's decode "
                                 "differs from the plain path's")
    log(f"plain path on the CPU, frames {picks}: samples and decodes "
        f"byte-equal to the card's ({time.perf_counter() - t0:.3f} s)")

    med = statistics.median
    log(f"batch {BATCH} at {WIDTH}x{HEIGHT} q4 (bench.py content): "
        f"{overflowed} of {nbands} bands overflowed at cap_bits 8; "
        f"round-trip PSNR {rt_psnr:.4f} dB; ratio {bench_ratio:.4f} "
        f"(bench.py estimate) {sample_ratio:.4f} (sample bytes)")
    log(f"per frame, medians of 4 batches: encode device "
        f"{med(enc_dev) / BATCH:.4f} ms (upload + transform + entropy "
        f"pack), encode host tail {med(enc_host) / BATCH:.4f} ms (fetch, "
        f"band-end, overflow re-encode, sample write); decode host tail "
        f"{med(dec_host) / BATCH:.4f} ms (parse + C++ entropy decode + "
        f"upload), decode device {med(dec_dev) / BATCH:.4f} ms (inverse "
        f"DWT + YUY2 pack + download)")
    log(f"device decode, all {BATCH} frames byte-equal to the host-entropy "
        f"decode, 0 fallback frames; per frame, medians of 4 batches: "
        + ", ".join(f"{p} {med(v) / BATCH:.4f} ms" for p, v in
                    dev_parts.items())
        + f"; total {sum(med(v) for v in dev_parts.values()) / BATCH:.4f} "
        f"ms; peak device memory {peak_bytes} bytes "
        f"({peak_bytes / 2**30:.3f} GiB, max_memory_allocated over the "
        f"batch's first device decode; {base_bytes} bytes were allocated "
        "before it)")
    log(f"launches during the main path: {launches} (batch phase {rose})")
    log("merge forms during the main path: " + "; ".join(
        f"{n} branch launches {b}, rows that failed the guard {f}"
        for n, (b, f) in guarded.items()))
    log(f"chunk_pack during the main path: {tree_chunks} chunks took the "
        "tree path")

    # --- 5. the RGB formats: kernels at the 1080p batch's shapes -------------
    def rolled(make, c):
        """BATCH frames of `make` pattern 1 at the codec's size, rolled one
        row a frame."""
        one = np.frombuffer(make(c.width, c.height, 1), np.uint8).reshape(
            c.height, c.row_bytes)
        return np.stack([np.roll(one, i, axis=0) for i in range(BATCH)])

    def unpack_timed(fmt, c, up):
        """The plain unpack that builds level 1's input, its device time
        against its bound; returns that input."""
        x = c.level1_input(up)
        moved = nbytes((up, *flat(x)))
        dms = device_ms(torch, lambda: c.level1_input(up))
        bound = bound_ms(moved, 0)[0]
        log(f"  plain unpack {fmt} {tuple(up.shape)} -> "
            + " + ".join(str(tuple(t.shape)) for t in flat(x))
            + f": device {dms:.4f} ms (device_ms), events "
            f"{cuda_ms(torch, lambda: c.level1_input(up)):.4f} ms; {moved} "
            f"bytes read and written, bound {bound:.4f} ms "
            f"({100 * bound / dms:.1f}% of the device time)")
        return x

    rgb = {}
    for fmt, make in (("RG48", rg48_frame), ("B64A", b64a_frame)):
        t0 = time.perf_counter()
        c = IntraCodec(WIDTH, HEIGHT, 4, device=dev, input_format=fmt)
        rgb[fmt] = (c, rolled(make, c))
        log(f"{fmt} batch: {BATCH} frames of {make.__name__} pattern 1 "
            f"rolled one row a frame ({time.perf_counter() - t0:.3f} s)")
    log(f"kernel checks, RGB formats, batch {BATCH} at {WIDTH}x{HEIGHT} q4 "
        "(tolerance 0; RG48 timed as above, B64A checked only)")
    for fmt, (c, rgb_frames) in rgb.items():
        timed = fmt == "RG48"
        t = c.tables()
        up = c._upload(rgb_frames)
        x = unpack_timed(fmt, c, up) if timed else c.level1_input(up)
        levels = []
        for lev in range(3):
            q = [t.band_quant[ch][lev] for ch in range(c.num_channels)]
            ps = t.prescale[lev]
            ll, highs = compare(
                "dwt_forward_planes", lambda: dwt_forward_planes(x, ps, q),
                lambda: dwt.plain_planes(x, ps, q),
                f"{fmt} level {lev + 1} {tuple(x.shape)} prescale {ps} "
                f"quants {q}", (x,), tally=timed, timed=timed)
            levels.append(((ll,), (highs,)))
            x = ll
        if timed:
            k = kernels["dwt_forward_planes"]
            log(f"  dwt_forward_planes, a batch: kernel {k['ms']:.4f} ms "
                f"(CUDA events), device {k['device_ms']:.4f} ms "
                f"(device_ms), bound {k['bound_ms']:.4f} ms ({k['bytes']} "
                f"bytes, {100 * k['bound_ms'] / k['device_ms']:.1f}% of the "
                "device time), 3 launches")
        encode_checks(c, levels, tally=False, timed=timed, device=timed)
        del up, x, levels, ll, highs
        decode_checks(c, c.encode_batch_device(rgb_frames), tally=False,
                      timed=timed, device=timed)

    # --- 5. the RGB formats: the main path ----------------------------------
    # the 320x240 goldens' frames: each format's test frame, the raw
    # formats the probe's raw fill
    small = {"RG48": rg48_frame, "B64A": b64a_frame,
             "RG64": lambda w, h, p: raw_fill(w * h * 8, p),
             "UYVY": uyvy_frame, "V210": v210_frame, "YU64": yu64_frame,
             "BYR4": byr4_frame,
             "BYR5": lambda w, h, p: raw_fill(w * h * 3 // 2, p)}

    def golden_encodes(goldens) -> int:
        """The 320x240 encode goldens (input format, name), both routes,
        byte for byte; returns the encodes run."""
        n = 0
        for fmt, name in goldens:
            gold = golden("cfhd", name)
            c = IntraCodec(320, 240, 4, device=dev, input_format=fmt)
            one = np.frombuffer(small[fmt](320, 240, 1), np.uint8).reshape(
                1, 240, c.row_bytes)
            for route in (c.encode_batch_device, c.encode_batch):
                if route(one, 1, sample_metadata(gold))[0] != gold:
                    raise AssertionError(f"{fmt} encode ({route.__name__}) "
                                         f"differs from {name}.cfhd")
                n += 1
            log(f"golden encode {fmt}: encode_batch_device and encode_batch "
                f"byte-equal to {name}.cfhd ({len(gold)} bytes)")
        return n

    def golden_decode(fmt, name, output, ext):
        """A 320x240 decode golden of a `fmt` source to `output`, both
        routes, byte for byte, no frame falling back."""
        sample, want = golden("cfhd", name), golden(ext, name)
        c = IntraCodec(320, 240, 4, device=dev, input_format=fmt)
        out = c.decode_batch([sample], output=output)
        dev_out, fallback = c.decode_batch_device([sample], output=output)
        if out.tobytes() != want or fallback or dev_out.tobytes() != want:
            raise AssertionError(f"{name} decoded to {output} differs from "
                                 f"{name}.{ext} (host fallback frames of "
                                 f"the device route {fallback})")
        log(f"golden decode {name} to {output}: decode_batch and "
            f"decode_batch_device byte-equal to {name}.{ext}")

    def timed_batch(c, frames_, outputs):
        """The batch encoded both ways (the device route 4 times, timed)
        and decoded both ways to each of `outputs` (4 times each, timed);
        fails unless the routes agree with no frame falling back.  Returns
        (samples, the decodes by output, a figures line, encodes run)."""
        enc_dev, enc_host = [], []
        for it in range(4):
            packed, ms = host_ms(torch, lambda: c.forward_packed(
                c._upload(frames_)))
            enc_dev.append(ms)
            t0 = time.perf_counter()
            samples = c.write_samples(frames_, packed)
            enc_host.append((time.perf_counter() - t0) * 1e3)
            if it == 0:
                first = (packed, samples)
        packed, samples = first
        if c.encode_batch(frames_) != samples:
            raise AssertionError(f"{c.input_format} batch: "
                                 "encode_batch_device differs from "
                                 "encode_batch")
        overflowed = sum(int(o.sum()) for _, levels in packed
                         for _, _, o, _ in levels)
        del first, packed
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        decoded, dec_ms = {}, []
        for output in outputs:
            host_t, dev_t = [], []
            for it in range(4):
                out, ms = host_ms(torch, lambda: c.decode_batch(
                    samples, output=output))
                host_t.append(ms)
                (dev_out, fallback), ms = host_ms(
                    torch, lambda: c.decode_batch_device(samples,
                                                         output=output))
                dev_t.append(ms)
                if fallback or dev_out.tobytes() != out.tobytes():
                    raise AssertionError(
                        f"{c.input_format} batch to {output}: "
                        "decode_batch_device differs from decode_batch "
                        f"(host fallback frames {fallback})")
            decoded[output] = out
            dec_ms.append(f"to {output}: decode_batch "
                          f"{med(host_t[1:]) / BATCH:.4f} ms, "
                          f"decode_batch_device {med(dev_t[1:]) / BATCH:.4f} "
                          "ms")
        peak_bytes = torch.cuda.max_memory_allocated()
        line = (
            f"{c.input_format} batch {BATCH} at {c.width}x{c.height} q4: "
            f"device encode byte-equal to encode_batch; {overflowed} of "
            f"{BATCH * c.num_channels * 9} bands overflowed at cap_bits 8; "
            f"ratio {frames_.nbytes / sum(len(x) for x in samples):.4f} "
            "(sample bytes); decode_batch_device equal to decode_batch on "
            f"all {BATCH} frames, 0 fallback frames. Per frame, medians of "
            f"3 batches after a warm-up: encode device "
            f"{med(enc_dev[1:]) / BATCH:.4f} ms (upload + unpack + "
            f"transform + entropy pack), encode host tail "
            f"{med(enc_host[1:]) / BATCH:.4f} ms; " + "; ".join(dec_ms)
            + f"; peak device memory over the decodes {peak_bytes} bytes "
            f"({peak_bytes / 2**30:.3f} GiB; {base_bytes} allocated before)")
        return samples, decoded, line, 5

    reset_counts()
    encodes = golden_encodes(RGB_ENCODE_GOLDENS)
    for fmt, name in RGB_DECODE_GOLDENS:
        for output, ext in RGB_OUTPUTS:
            golden_decode(fmt, name, output, ext)

    rgb_lines = []
    for fmt, (c, rgb_frames) in rgb.items():
        output = c.decode_output(None)
        samples, decoded, line, n = timed_batch(c, rgb_frames, (output,))
        encodes += n
        decoded = decoded[output]
        src = rgb_frames.view("<u2").reshape(decoded.shape[0], HEIGHT,
                                              WIDTH, -1)
        out = decoded.reshape(src.shape[0], HEIGHT, WIDTH, -1)
        colour = (src, out) if fmt == "RG48" else (src[..., 1:], out[..., 1:])
        mse = np.mean((colour[0].astype(np.float64) - colour[1]) ** 2)
        if decoded.shape != (BATCH, HEIGHT, WIDTH * out.shape[-1]) \
                or decoded.dtype != np.uint16 or not mse > 0:
            raise AssertionError(f"{fmt} batch decoded to {decoded.shape} "
                                 f"{decoded.dtype}, mse {mse}")
        rgb_lines += [line, f"{fmt} batch: round-trip PSNR of the colour "
                      f"channels {10 * np.log10(65535.0 ** 2 / mse):.4f} dB "
                      "(16-bit peak)"]
        del samples, decoded, out, src
    launches_rgb = path_launches("rgb", encodes, "dwt_forward_planes")
    for line in rgb_lines:
        log(line)
    def log_path(path, encodes, got):
        log(f"launches during the {path} path ({encodes} encodes): {got}")
        log(f"merge forms during the {path} path: " + "; ".join(
            f"{w.__name__} branch launches {dict(w.branch_launches)}, rows "
            f"that failed the guard {int(w.flagged[dev].item())}"
            for w in (merge_network, merge_network_tgt,
                      merge_network_highfirst)))
        log(f"chunk_pack during the {path} path: "
            f"{int(chunk_pack.tree_chunks[dev].item())} chunks took the "
            "tree path")

    log_path("RGB", encodes, launches_rgb)

    # --- 6. 4:2:2 10-bit and Bayer: kernels at the batches' shapes ----------
    t0 = time.perf_counter()
    yuv10 = {}
    for fmt, make in (("V210", v210_frame), ("UYVY", uyvy_frame),
                      ("YU64", yu64_frame)):
        c = IntraCodec(WIDTH, HEIGHT, 4, device=dev, input_format=fmt)
        yuv10[fmt] = (c, rolled(make, c))
    bayer = IntraCodec(BAYER_WIDTH, BAYER_HEIGHT, 4, device=dev,
                       input_format="BYR4")
    bayer_frames = rolled(byr4_frame, bayer)
    log(f"4:2:2 10-bit batches ({', '.join(yuv10)}) at {WIDTH}x{HEIGHT} and "
        f"the BYR4 batch at {BAYER_WIDTH}x{BAYER_HEIGHT}: {BATCH} frames of "
        "each format's test frame pattern 1 rolled one row a frame "
        f"({time.perf_counter() - t0:.3f} s)")

    log(f"kernel checks, 4:2:2 10-bit and Bayer, batch {BATCH} (tolerance 0; "
        "the V210 level 1 and the BYR4 levels timed as above, the rest "
        "checked only)")
    for fmt, (c, frames_) in yuv10.items():
        timed = fmt == "V210"
        up = c._upload(frames_)
        x = unpack_timed(fmt, c, up) if timed else c.level1_input(up)
        t = c.tables()
        levels = []
        for lev in range(3):
            q = [t.band_quant[ch][lev] for ch in range(3)]
            ps = t.prescale[lev]
            out = compare(
                "dwt_forward_groups", lambda: dwt_forward_groups(x, ps, q),
                lambda: dwt.plain_groups((x[0][:, 0], x[1][:, 0],
                                          x[1][:, 1]), ps, q),
                f"{fmt} level {lev + 1} {tuple(x[0].shape)} + "
                f"{tuple(x[1].shape)} prescale {ps} quants {q}", x,
                ops=40 * (x[0].numel() + x[1].numel()), tally=False,
                timed=timed and lev == 0, device=True)
            levels.append((out[:2], out[2:]))
            x = out[:2]
        if timed:
            encode_checks(c, levels, tally=False, timed=False)
        del up, x, levels, out
        if timed:
            decode_checks(c, c.encode_batch_device(frames_), tally=False,
                          timed=False)
    up = bayer._upload(bayer_frames)
    x = unpack_timed("BYR4", bayer, up)
    t = bayer.tables()
    levels = []
    for lev in range(3):
        q = [t.band_quant[ch][lev] for ch in range(4)]
        ps = t.prescale[lev]
        ll, highs = compare(
            "dwt_forward_planes", lambda: dwt_forward_planes(x, ps, q),
            lambda: dwt.plain_planes(x, ps, q),
            f"BYR4 level {lev + 1} {tuple(x.shape)} prescale {ps} quants "
            f"{q}", (x,), tally=False)
        levels.append(((ll,), (highs,)))
        x = ll
    encode_checks(bayer, levels, tally=False, timed=False)
    del up, x, levels, ll, highs
    decode_checks(bayer, bayer.encode_batch_device(bayer_frames), tally=False,
                  timed=False)

    # --- 6. 4:2:2 10-bit and Bayer: the main path --------------------------
    reset_counts()
    encodes = golden_encodes(NEW_ENCODE_GOLDENS[:3])
    golden_decode(*NEW_DECODE_GOLDENS[0])
    c, frames_ = yuv10["V210"]
    samples, decoded, line, n = timed_batch(c, frames_, ("YUY2", "BGRA"))
    encodes += n
    if decoded["YUY2"].shape != (BATCH, HEIGHT, 2 * WIDTH) \
            or decoded["BGRA"].shape != (BATCH, HEIGHT, WIDTH, 4) \
            or decoded["YUY2"].dtype != np.uint8 \
            or len(np.unique(decoded["YUY2"][0])) < 64:
        raise AssertionError(f"V210 batch decoded to {decoded['YUY2'].shape}"
                             f" and {decoded['BGRA'].shape}")
    yuv10_lines = [line]
    # the transform round trip (bench.py): the codec's decode without the
    # entropy coding
    rt, ms = host_ms(torch, lambda: c.inverse(c.dequantize(c.forward(
        c._upload(frames_)))).cpu().numpy())
    encodes += 1
    if rt.tobytes() != decoded["YUY2"].tobytes():
        raise AssertionError("V210 batch: inverse(dequantize(forward)) "
                             "differs from decode_batch")
    yuv10_lines.append(f"V210 batch: inverse(dequantize(forward(frames))) "
                       f"byte-equal to decode_batch ({ms / BATCH:.4f} ms a "
                       "frame, one run)")
    del samples, decoded, rt
    for fmt in ("UYVY", "YU64"):
        c, frames_ = yuv10[fmt]
        if c.encode_batch_device(frames_) != c.encode_batch(frames_):
            raise AssertionError(f"{fmt} batch: encode_batch_device differs "
                                 "from encode_batch")
        encodes += 2
        yuv10_lines.append(f"{fmt} batch {BATCH} at {WIDTH}x{HEIGHT} q4: "
                           "device encode byte-equal to encode_batch")
    launches_yuv10 = path_launches("yuv10", encodes, "dwt_forward_groups")
    for line in yuv10_lines:
        log(line)
    log_path("4:2:2 10-bit", encodes, launches_yuv10)

    reset_counts()
    encodes = golden_encodes(NEW_ENCODE_GOLDENS[3:])
    golden_decode(*NEW_DECODE_GOLDENS[1])
    samples, decoded, line, n = timed_batch(bayer, bayer_frames, ("BYR4",))
    encodes += n
    out = decoded["BYR4"]
    src = bayer_frames.view("<u2")
    if out.shape != src.shape or out.dtype != np.uint16:
        raise AssertionError(f"BYR4 batch decoded to {out.shape} {out.dtype}")
    mse = np.mean((out[0].astype(np.float64) - src[0]) ** 2)
    launches_bayer = path_launches("bayer", encodes, "dwt_forward_planes")
    log(line)
    psnr16 = 10 * np.log10(65535.0 ** 2 / mse)
    log(f"BYR4 batch: frame 0's round-trip PSNR {psnr16:.4f} dB (16-bit "
        "peak, through the LOG-90 curve and back)")
    log_path("Bayer", encodes, launches_bayer)
    bayer_samples = samples
    del samples, decoded, out, src

    # --- 7b. Bayer to RGB: the demosaic and the develop ---------------------
    t_phase = time.perf_counter()
    reset_counts()
    for name, fmt, ext in BAYER_API_GOLDENS:
        sample = golden("cfhd", name)
        dec = api.Decoder(dev)
        dec.prepare_to_decode(0, 0, api.PixelFormat[fmt], sample=sample)
        if dec.decode_sample(sample).tobytes() != golden(ext, name) \
                or dec.fallback_frames:
            raise AssertionError(f"api.Decoder: {name} to {fmt} differs "
                                 f"from {name}.{ext}, or fell back")
    log(f"Bayer API goldens: {len(BAYER_API_GOLDENS)} decodes through "
        "api.Decoder on the card byte-equal to "
        + ", ".join(f"{n[5:-3]}.{e}" for n, _, e in BAYER_API_GOLDENS))
    wbal = api.bayer_develop(golden("cfhd", "byr4_wbal_320x240_q4"), None,
                             "RG48")
    wbal_batch = np.stack([wbal] * BATCH)
    rgb_cases = [(o, None) for o in ("RG48", "b64a", "WP13", "YUY2")] + [
        ("RG48", wbal_batch)]
    picks = [0, BATCH - 1]
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rgb_ms, rgb_picks = [], []
    for output, develop in rgb_cases:
        host_t, dev_t = [], []
        for it in range(3):
            out, ms = host_ms(torch, lambda: bayer.decode_batch(
                bayer_samples, output=output, develop=develop))
            host_t.append(ms)
            (dev_out, fallback), ms = host_ms(
                torch, lambda: bayer.decode_batch_device(
                    bayer_samples, output=output, develop=develop))
            dev_t.append(ms)
            if fallback or dev_out.tobytes() != out.tobytes():
                raise AssertionError(
                    f"BYR4 batch to {output}: decode_batch_device differs "
                    f"from decode_batch (host fallback frames {fallback})")
        label = output + (" (WBAL matrix)" if develop is not None else "")
        rgb_ms.append(f"to {label} {tuple(out.shape)} {out.dtype}: "
                      f"decode_batch {med(host_t[1:]) / BATCH:.4f} ms, "
                      f"decode_batch_device {med(dev_t[1:]) / BATCH:.4f} ms")
        rgb_picks.append(out[picks])
        del out, dev_out
    rgb_peak = torch.cuda.max_memory_allocated()
    launches_bayer_rgb = path_launches("bayer_rgb", 0, "dwt_forward_planes")
    t0 = time.perf_counter()
    cpu_bayer = IntraCodec(BAYER_WIDTH, BAYER_HEIGHT, 4,
                           device=torch.device("cpu"), input_format="BYR4")
    for (output, develop), want in zip(rgb_cases, rgb_picks):
        got = cpu_bayer.decode_batch(
            [bayer_samples[i] for i in picks], output=output,
            develop=None if develop is None else develop[picks])
        if got.tobytes() != want.tobytes():
            raise AssertionError(f"BYR4 batch to {output}: frames {picks} "
                                 "differ from the port's path on the CPU")
    log(f"plain path on the CPU, BYR4 batch frames {picks}: the "
        f"{len(rgb_cases)} RGB decodes byte-equal to the card's "
        f"({time.perf_counter() - t0:.3f} s)")
    # the chain's parts, on one frame's planes on the card
    co = bayer.host_entropy_decode(bayer_samples[:1])
    planes = bayer._row16u_planes(co)
    c2l = torch.from_numpy(curve2linear_lut().astype(np.int32)).to(dev)
    l2c = torch.from_numpy(linear2curve_lut().astype(np.int32)).to(dev)
    lcm = dmops.develop_matrix_lcm(wbal[None], dev)
    parity = torch.from_numpy(bayer_yuyv_parity(BAYER_HEIGHT)).to(dev)
    rgb16 = dmops.demosaic_raw(*planes)
    bilinear = dmops.demosaic_bilinear_rgb(*planes)
    whole = {o: bayer.inverse_bayer_rgb(co, o) for o in ("RG48", "YUY2")}
    parts = (
        ("inverse_bayer_rgb to RG48 (the whole chain from the "
         "coefficients)", lambda: bayer.inverse_bayer_rgb(co, "RG48"),
         flat(co), (whole["RG48"],)),
        ("inverse_bayer_rgb to RG48 through the WBAL matrix",
         lambda: bayer.inverse_bayer_rgb(co, "RG48", wbal[None]), flat(co),
         (whole["RG48"],)),
        ("inverse_bayer_rgb to YUY2", lambda: bayer.inverse_bayer_rgb(
            co, "YUY2"), flat(co), (whole["YUY2"],)),
        ("Row16u planes (the whole inverse DWT)",
         lambda: bayer._row16u_planes(co), flat(co), planes),
        ("demosaic_raw", lambda: dmops.demosaic_raw(*planes), planes,
         (rgb16,)),
        ("develop_1d", lambda: dmops.develop_1d(rgb16, lcm, c2l, l2c),
         (rgb16,), (rgb16,)),
        ("demosaic_bilinear_rgb", lambda: dmops.demosaic_bilinear_rgb(
            *planes), planes, (bilinear,)),
        ("convert_rgb16_to_yuyv", lambda: dmops.convert_rgb16_to_yuyv(
            bilinear, parity), (bilinear,),
         (torch.empty((1, BAYER_HEIGHT, 2 * BAYER_WIDTH),
                      dtype=torch.uint8),)))
    # the earlier phases leave the allocator's cache near the card's size;
    # a call that must free cached blocks to allocate synchronizes
    torch.cuda.empty_cache()
    part_lines, chain_syncs = [], []
    for what, fn, ins, outs in parts:
        bound = bound_ms(nbytes((*ins, *outs)), 0)[0]
        syncs = sync_calls(torch, fn)
        if syncs and what.startswith("inverse_bayer_rgb"):
            chain_syncs.append(f"{what}: {syncs}")
        qms, queue_full = queue_ms(torch, fn)
        host = (f"host queues it in {qms:.4f} ms" if not queue_full else
                f"the launch queue filled while the host queued it "
                f"({qms:.4f} ms)")
        try:
            dms = device_ms(torch, fn, reps=3)
        except AssertionError:
            ems = cuda_ms(torch, fn, reps=3)
            part_lines.append(f"{what}: device_ms refused; events "
                              f"{ems:.4f} ms (bound {bound:.4f} ms); {host};"
                              f" {syncs} synchronizing calls")
            continue
        part_lines.append(f"{what} {dms:.4f} ms (bound {bound:.4f} ms, "
                          f"{100 * bound / dms:.2f}%); {host}; {syncs} "
                          "synchronizing calls")
    if chain_syncs:
        raise AssertionError("inverse_bayer_rgb synchronizes the host: "
                             + "; ".join(chain_syncs))
    del co, planes, rgb16, bilinear, rgb_picks, whole
    log(f"BYR4 batch {BATCH} at {BAYER_WIDTH}x{BAYER_HEIGHT} to RGB: "
        "decode_batch_device equal to decode_batch on all frames, 0 "
        "fallback frames. Per frame, medians of 2 batches after a warm-up: "
        + "; ".join(rgb_ms) + f"; peak device memory over the decodes "
        f"{rgb_peak} bytes ({rgb_peak / 2**30:.3f} GiB; {base_bytes} "
        f"allocated before) ({card()})")
    log("Bayer RGB chain, one frame's parts on the card (device_ms, "
        "medians of 3; bound: the parts' inputs read and outputs written "
        "once over the memory rate; the host's queueing time behind a "
        "spin kernel, median of 3; the synchronizing calls of one call, "
        "after a warm-up, none allowed in inverse_bayer_rgb): "
        + "; ".join(part_lines)
        + f" ({card()})")
    log_path("Bayer RGB", 0, launches_bayer_rgb)
    log(f"Bayer RGB phase {time.perf_counter() - t_phase:.3f} s")

    # --- 8. the two-frame GOP: kernels at the 1080p batch's shapes ----------
    t0 = time.perf_counter()
    gop = GopCodec(WIDTH, HEIGHT, 4, device=dev)
    gop_f0, gop_f1 = (np.stack([np.roll(base, j, axis=0)
                                for j in range(f, 2 * BATCH, 2)])
                      for f in (0, 1))
    log(f"GOP batch: {BATCH} groups of yuy2_frame({WIDTH}, {HEIGHT}, 1) "
        f"pairs, rolled one row a frame ({time.perf_counter() - t0:.3f} s)")
    log(f"kernel checks, GOP, batch {BATCH} at {WIDTH}x{HEIGHT} q4 "
        "(tolerance 0; times as above, the 5 DWT launches of an encode and "
        "the decoder merge forms of a device decode booked as the GOP path's)")

    def gop_level1(c, up, k, **opts):
        q = c._quants(k)
        out = compare("dwt_forward_yuy2",
                      lambda: dwt_forward_yuy2(up, 10, 0, q),
                      lambda: dwt.plain_groups(ops.unpack_yuy2(up, 10), 0, q),
                      f"GOP {c.width}x{c.height} frame {k} level 1 "
                      f"{tuple(up.shape)} quants {q}", (up,), **opts)
        return out[:2]

    def gop_spatial(c, k, x, ps, carry, **opts):
        """w3, w4 or w5 of the groups `x` (the Y and V, U buffers) against
        `plain_groups`; returns the kernel's lowpass buffers."""
        q = c._quants(k)
        carried = tuple(t for t in carry if t is not None)
        out = compare(
            "dwt_forward_groups", lambda: dwt_forward_groups(x, ps, q, carry),
            lambda: dwt.plain_groups((x[0][:, 0], x[1][:, 0], x[1][:, 1]),
                                     ps, q, carry),
            f"GOP {c.width}x{c.height} w{k} {tuple(x[0].shape)} + "
            f"{tuple(x[1].shape)} prescale {ps} quants {q}"
            + (f", row-0 carry of {len(carried)} group(s)" if carried
               else ""), (*x, *carried),
            ops=40 * (x[0].numel() + x[1].numel()), **opts)
        return out[:2]

    def temporal_pair(l0, l1):
        return (tuple(ops.sat16(a + b) for a, b in zip(l0, l1)),
                tuple(ops.sat16(b - a) for a, b in zip(l0, l1)))

    def gop_levels(c, f0, f1, **opts):
        """The 5 DWT launches of `c`'s encode, each against its plain
        version; returns the carries w3 took and level 1's lowpass
        buffers."""
        l0, l1 = (gop_level1(c, c._upload(f), k, **opts)
                  for k, f in ((0, f0), (1, f1)))
        tlow, thigh = temporal_pair(l0, l1)
        carry = c.row0_carry(tlow, thigh)
        gop_spatial(c, 3, thigh, 0, carry, **opts)
        ll4 = gop_spatial(c, 4, tlow, 2, (None, None), **opts)
        gop_spatial(c, 5, ll4, 0, (None, None), **opts)
        return carry, l0, l1

    _, l0, l1 = gop_levels(gop, gop_f0, gop_f1, tally=False, book="gop")
    # the temporal pair between them (plain PyTorch, no kernel)
    moved = nbytes(l0 + l1) * 2
    dms = device_ms(torch, lambda: temporal_pair(l0, l1))
    log(f"  temporal pair sat16(ll0 + ll1), sat16(ll1 - ll0) (plain "
        f"PyTorch) on {tuple(l0[0].shape)} + {tuple(l0[1].shape)}: device "
        f"{dms:.4f} ms (device_ms), {moved} bytes read and written, bound "
        f"{bound_ms(moved, 0)[0]:.4f} ms")
    del l0, l1
    booked = [kernels[n]["gop"] for n in ("dwt_forward_yuy2",
                                          "dwt_forward_groups")]
    gop_device = sum(b["device_ms"] for b in booked)
    gop_bound = sum(b["bound_ms"] for b in booked)
    log(f"  the GOP encode's 5 DWT launches, a batch: device "
        f"{gop_device:.4f} ms (device_ms), bound {gop_bound:.4f} ms "
        f"({sum(b['bytes'] for b in booked)} bytes, "
        f"{100 * gop_bound / gop_device:.1f}% of the device time)")
    # the narrow case: chroma's temporal high, 16 wide, takes the carry
    narrow = GopCodec(64, 48, 4, device=dev)
    nb = np.frombuffer(yuy2_frame(64, 48, 1), np.uint8).reshape(48, 128)
    n0, n1 = (np.stack([np.roll(nb, j, axis=0)
                        for j in range(f, 2 * BATCH, 2)]) for f in (0, 1))
    if gop_levels(narrow, n0, n1, tally=False, timed=False)[0][1] is None:
        raise AssertionError("64x48 GOP: chroma's w3 took no row-0 carry")
    got = narrow.forward(narrow._upload(n0), narrow._upload(n1))
    want = GopCodec(64, 48, 4, device=torch.device("cpu")).forward(
        torch.from_numpy(n0), torch.from_numpy(n1))
    err = max_abs_err(torch, [t.cpu() for t in flat([
        (lp, *[t for k_ in sorted(b) for t in b[k_]]) for lp, b in got])],
        flat([(lp, *[t for k_ in sorted(b) for t in b[k_]])
              for lp, b in want]))
    log(f"  GopCodec(64, 48).forward on the card against its plain version "
        f"on the CPU, batch {BATCH}: max_abs_err {err}")
    if err:
        raise AssertionError("64x48 GOP forward: the card disagrees with the "
                             "plain version")
    gop_samples = gop.encode_batch(gop_f0, gop_f1)
    decode_checks(gop, gop_samples, tally=False, book="gop")
    del got, want

    # --- 8. the two-frame GOP: the main path --------------------------------
    reset_counts()
    encodes = dev_decodes = 0
    for name, p0, p1 in GOP_GOLDENS:
        gold = golden("cfhd.f1", name)
        c = GopCodec(320, 240, 4, device=dev)
        f0, f1 = (np.frombuffer(yuy2_frame(320, 240, p), np.uint8).reshape(
            1, 240, 640) for p in (p0, p1))
        if c.encode_batch(f0, f1, 1, sample_metadata(gold)) != [gold]:
            raise AssertionError(f"GOP encode differs from {name}.cfhd.f1")
        want = [golden(f"f{f}.yuy2", name) for f in (0, 1)]
        host = [f.tobytes() for f in c.decode_batch([gold])]
        *dev_out, fallback = c.decode_batch_device([gold])
        if host != want or fallback or [f.tobytes() for f in dev_out] \
                != want:
            raise AssertionError(f"{name} decoded differs from its .f0/.f1 "
                                 f"goldens (host fallback frames of the "
                                 f"device route {fallback})")
        encodes += 1
        dev_decodes += 1
        log(f"golden GOP {name}: encode_batch byte-equal to .cfhd.f1 "
            f"({len(gold)} bytes); decode_batch and decode_batch_device "
            "byte-equal to .f0.yuy2 and .f1.yuy2")
    enc_dev, enc_host, enc_down = [], [], []
    for it in range(4):
        lv, ms = host_ms(torch, lambda: gop.forward_levels(
            gop._upload(gop_f0), gop._upload(gop_f1)))
        enc_dev.append(ms)
        _, ms = host_ms(torch, lambda: [t.cpu() for t in flat(list(
            lv.values()))])
        enc_down.append(ms)
        t0 = time.perf_counter()
        samples = gop.write_groups(lv)
        enc_host.append((time.perf_counter() - t0) * 1e3)
        encodes += 1
        if samples != gop_samples:
            raise AssertionError("GOP batch: two encodes of the batch differ")
    del lv
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    dec_ms = []
    for rc in (True, False):
        host_t, dev_t = [], []
        for it in range(4):
            host, ms = host_ms(torch, lambda: gop.decode_batch(samples, rc))
            host_t.append(ms)
            (*dev_out, fallback), ms = host_ms(
                torch, lambda: gop.decode_batch_device(samples, rc))
            dev_t.append(ms)
            dev_decodes += 1
            if fallback or any(a.tobytes() != b.tobytes()
                               for a, b in zip(host, dev_out, strict=True)):
                raise AssertionError(
                    f"GOP batch (reference_compatible={rc}): "
                    "decode_batch_device differs from decode_batch (host "
                    f"fallback frames {fallback})")
        dec_ms.append(f"reference_compatible={rc}: decode_batch "
                      f"{med(host_t[1:]) / BATCH:.4f} ms, decode_batch_device "
                      f"{med(dev_t[1:]) / BATCH:.4f} ms")
        if rc:
            rc_frames = host
    peak_bytes = torch.cuda.max_memory_allocated()
    # the device route's parts (reference_compatible), as it runs them
    parts = ("header walk and fill", "upload", "device entropy decode",
             "inverse with pack", "download")
    gop_parts = {p: [] for p in parts}
    for it in range(4):
        t0 = time.perf_counter()
        host_rows = gop._decode_rows_host(samples)
        gop_parts["header walk and fill"].append(
            (time.perf_counter() - t0) * 1e3)
        dev_rows, ms = host_ms(torch, lambda: gop._upload_rows(host_rows))
        gop_parts["upload"].append(ms)
        (co, ovf), ms = host_ms(torch, lambda: gop.decode_coefficients(
            *dev_rows[:-1]))
        gop_parts["device entropy decode"].append(ms)
        pair, ms = host_ms(torch, lambda: gop.inverse(co))
        gop_parts["inverse with pack"].append(ms)
        got, ms = host_ms(torch, lambda: [f.cpu().numpy() for f in pair])
        gop_parts["download"].append(ms)
        dev_decodes += 1
        if dev_rows[-1] or bool(ovf.any()) or any(
                a.tobytes() != b.tobytes() for a, b in zip(got, rc_frames)):
            raise AssertionError("GOP batch: the device route's parts "
                                 "differ from decode_batch")
    del host_rows, dev_rows, co, ovf, pair, got
    launches_gop = {n: kk["wrapper"].launches for n, kk in kernels.items()}
    want_gop = {n: 0 for n in kernels}
    want_gop.update(dwt_forward_yuy2=2 * encodes,
                    dwt_forward_groups=3 * encodes,
                    merge_network_tgt=6 * dev_decodes,
                    merge_network_highfirst=6 * dev_decodes)
    if launches_gop != want_gop or dwt_forward_level.launches:
        raise AssertionError(f"the GOP path's {encodes} encodes and "
                             f"{dev_decodes} device decodes launched "
                             f"{launches_gop} and the single-plane level "
                             f"{dwt_forward_level.launches}: expected "
                             f"{want_gop}")
    gop_psnr = psnr(rc_frames[0], gop_f0)
    log(f"GOP batch {BATCH} groups at {WIDTH}x{HEIGHT} q4: "
        f"{sum(len(x) for x in samples)} bytes, ratio "
        f"{(gop_f0.nbytes + gop_f1.nbytes) / sum(len(x) for x in samples):.4f}"
        f"; frame 0's round-trip PSNR {gop_psnr:.4f} dB; decode_batch_device "
        f"equal to decode_batch on all {2 * BATCH} frames in both reference "
        "modes, 0 fallback frames. Per group, medians of 3 batches after a "
        f"warm-up: encode device {med(enc_dev[1:]) / BATCH:.4f} ms (upload + "
        "5 DWT launches + temporal pair), encode host tail "
        f"{med(enc_host[1:]) / BATCH:.4f} ms (download + C++ band coding + "
        f"GROUP writer; the download alone {med(enc_down[1:]) / BATCH:.4f} "
        "ms); " + "; ".join(dec_ms)
        + "; decode_batch_device's parts: " + ", ".join(
            f"{p} {med(v[1:]) / BATCH:.4f} ms" for p, v in gop_parts.items())
        + f"; peak device memory over the decodes {peak_bytes} bytes "
        f"({peak_bytes / 2**30:.3f} GiB; {base_bytes} allocated before)")
    log(f"launches during the GOP path ({encodes} encodes, {dev_decodes} "
        f"device decodes): {launches_gop}")
    del samples, host, dev_out, rc_frames

    reset_counts()
    stereo_samples = encode_batch_3d(codec, gop_f0, gop_f1)
    for eye in (0, 1):
        out, fallback = decode_batch_device_3d(stereo_samples, eye, codec)
        want = codec.decode_batch([split_3d(x)[eye] for x in stereo_samples])
        if fallback or out.tobytes() != want.tobytes():
            raise AssertionError(f"stereo eye {eye}: decode_batch_device_3d "
                                 "differs from decode_batch of the split "
                                 f"eyes (host fallback frames {fallback})")
    launches_stereo = {n: kk["wrapper"].launches
                       for n, kk in kernels.items()}
    if not (launches_stereo["merge_network_tgt"]
            and launches_stereo["merge_network_highfirst"]):
        raise AssertionError(f"the stereo decode launched {launches_stereo}")
    log(f"stereo batch: {BATCH} 3D samples of {WIDTH}x{HEIGHT} eyes (the GOP "
        "batch's frames 0 and 1 as left and right); both "
        "eyes' decode_batch_device_3d byte-equal to decode_batch of the "
        f"split eyes, 0 fallback frames; launches {launches_stereo}")
    del stereo_samples, out, want

    # --- 9. the public API and the pools -----------------------------------
    meta = EncoderMetadata()            # fixed metadata on both sides
    the_card = card()
    numbers = list(range(1, BATCH + 1))
    dwt_names = ("dwt_forward_yuy2", "dwt_forward_groups",
                 "dwt_forward_planes")
    launches_api = dict.fromkeys(kernels, 0)
    launches_pool = dict.fromkeys(kernels, 0)

    def counts():
        return {n: k["wrapper"].launches for n, k in kernels.items()}

    def book(into):
        """Add the launch counts since `reset_counts` to a path's."""
        for n, v in counts().items():
            into[n] += v

    def sync_encode(fmt, frames_, dwt_want):
        """The sync Encoder on `frames_`, one call each, 4 runs (a warm-up
        and 3 timed); fails unless every run's samples equal
        encode_batch_device's of the same frames and frame numbers, and
        the DWT entry points ran `dwt_want` times a frame.  Returns
        (samples, median ms/frame, the median ms of encode_batch_device
        on one frame)."""
        c = IntraCodec(WIDTH, HEIGHT, 4, device=dev, input_format=fmt)
        want = c.encode_batch_device(frames_, metadata=meta,
                                     frame_numbers=numbers)
        alone = [host_ms(torch, lambda: c.encode_batch_device(
            frames_[:1], metadata=meta))[1] for _ in range(4)]
        reset_counts()
        times = []
        for it in range(4):
            enc = api.Encoder(dev)
            enc.prepare_to_encode(WIDTH, HEIGHT, api.PixelFormat[fmt])
            enc.attach_metadata(meta)
            got = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for f in frames_:
                enc.encode_sample(f)
                got.append(enc.get_sample_data())
            times.append((time.perf_counter() - t0) * 1e3 / BATCH)
            if got != want:
                raise AssertionError(f"api.Encoder {fmt} run {it}: samples "
                                     "differ from encode_batch_device's")
        got = counts()
        want_dwt = {n: 4 * BATCH * dwt_want.get(n, 0) for n in dwt_names}
        if {n: got[n] for n in dwt_names} != want_dwt \
                or dwt_forward_level.launches:
            raise AssertionError(f"api.Encoder {fmt}: {4 * BATCH} encodes "
                                 f"launched {got}: expected {want_dwt}")
        book(launches_api)
        return want, med(times[1:]), med(alone[1:])

    def sync_decode(samples_, fmt, pf, output):
        """The sync Decoder on `samples_` to `pf`, 4 runs (a warm-up and 3
        timed); fails unless each run equals decode_batch_device's frames
        (`output`; UYVY: YUY2 repacked) with no frame falling back.
        Returns (the median ms/frame, the median ms of
        decode_batch_device on one sample)."""
        c = IntraCodec(WIDTH, HEIGHT, 4, device=dev, input_format=fmt)
        want, fallback = c.decode_batch_device(samples_, output=output)
        if pf == api.PixelFormat.UYVY:
            want = want.reshape(BATCH, -1, 4)[..., [1, 0, 3, 2]]
        if fallback:
            raise AssertionError(f"decode_batch_device {fmt}: fallback "
                                 f"frames {fallback}")
        alone = [host_ms(torch, lambda: c.decode_batch_device(
            samples_[:1], output=output))[1] for _ in range(4)]
        reset_counts()
        times = []
        for it in range(4):
            dec = api.Decoder(dev)
            dec.prepare_to_decode(0, 0, pf, sample=samples_[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = [dec.decode_sample(x) for x in samples_]
            times.append((time.perf_counter() - t0) * 1e3 / BATCH)
            if dec.fallback_frames or any(
                    a.tobytes() != b.tobytes() for a, b in zip(got, want)):
                raise AssertionError(
                    f"api.Decoder {fmt} to {pf.name} run {it}: frames differ "
                    "from decode_batch_device's, or fell back "
                    f"({dec.fallback_frames})")
        book(launches_api)
        return med(times[1:]), med(alone[1:])

    t_phase = time.perf_counter()
    rg48_c = IntraCodec(WIDTH, HEIGHT, 4, device=dev, input_format="RG48")
    v210_c = IntraCodec(WIDTH, HEIGHT, 4, device=dev, input_format="V210")
    yuy2_samples, *enc_yuy2 = sync_encode(
        "YUY2", frames, {"dwt_forward_yuy2": 1, "dwt_forward_groups": 2})
    rg48_samples, *enc_rg48 = sync_encode(
        "RG48", rolled(rg48_frame, rg48_c), {"dwt_forward_planes": 3})
    _, *enc_v210 = sync_encode("V210", rolled(v210_frame, v210_c),
                               {"dwt_forward_groups": 3})
    dec_yuy2 = sync_decode(yuy2_samples, "YUY2", api.PixelFormat.YUY2,
                           "YUY2")
    dec_uyvy = sync_decode(yuy2_samples, "YUY2", api.PixelFormat.UYVY,
                           "YUY2")
    dec_rg48 = sync_decode(rg48_samples, "RG48", api.PixelFormat.RG48,
                           "RG48")
    log(f"api sync at {WIDTH}x{HEIGHT} q4, {BATCH} frames a run, each a "
        "call, byte-equal to encode_batch_device and decode_batch_device "
        "with 0 fallback frames; ms/frame, medians of 3 runs after a "
        "warm-up, and in brackets the codec's own call on one frame "
        "(medians of 3 after a warm-up): " + "; ".join(
            f"{what} {fmt} {t[0]:.4f} [{t[1]:.4f}]"
            for what, fmt, t in (
                ("encode", "YUY2", enc_yuy2), ("encode", "RG48", enc_rg48),
                ("encode", "V210", enc_v210), ("decode", "YUY2", dec_yuy2),
                ("decode", "UYVY", dec_uyvy), ("decode", "RG48", dec_rg48)))
        + f" ({the_card})")

    # the 320x240 API goldens on the card
    reset_counts()
    stream = [golden(f"s{i}", "gopstream_320x240_q4") for i in range(6)]
    enc = api.Encoder(dev)
    enc.prepare_to_encode(320, 240, api.PixelFormat.YUY2,
                          encoding_flags=api.EncodingFlags.YUV_2FRAME_GOP)
    for i, want in enumerate(stream):
        enc.attach_metadata(sample_metadata(stream[i | 1]))
        enc.encode_sample(yuy2_frame(320, 240, 1 + i))
        if enc.get_sample_data() != want:
            raise AssertionError(f"api.Encoder GOP stream: sample {i} "
                                 "differs from gopstream_320x240_q4")
    dec = api.Decoder(dev)
    dec.prepare_to_decode(320, 240, sample=stream[1])
    names = [None, "f0", "f1true", "f2", "f3true", "f4"]
    for i, name in enumerate(names):
        got = dec.decode_sample(stream[i])
        want = None if name is None else golden(f"{name}.yuy2",
                                                "gopstream_320x240_q4")
        if (got is None) != (want is None) or (
                got is not None and got.tobytes() != want):
            raise AssertionError(f"api.Decoder GOP stream: sample {i} "
                                 f"differs from {name}")
    if dec.fallback_frames:
        raise AssertionError(f"GOP stream: {dec.fallback_frames} frames "
                             "fell back")
    for q, base_name in ((5, "fs2_320x240"), (6, "fs3_320x240")):
        series = [golden(f"cfhd.f{f}", base_name) for f in range(4)]
        enc = api.Encoder(dev)
        enc.prepare_to_encode(320, 240, api.PixelFormat.YUY2,
                              quality=api.EncodingQuality(q))
        enc.attach_metadata(sample_metadata(series[0]))
        for f, want in enumerate(series):
            enc.encode_sample(yuy2_frame(320, 240, f + 1))
            if enc.get_sample_data() != want:
                raise AssertionError(f"api.Encoder {base_name} frame {f} "
                                     "differs from its golden")
    stereo_enc = api.StereoEncoder(dev)
    stereo_enc.prepare_to_encode(320, 240, api.PixelFormat.YUY2)
    pair = stereo_enc.encode_sample(yuy2_frame(320, 240, 1),
                                    yuy2_frame(320, 240, 2))
    codec320 = IntraCodec(320, 240, 4, device=dev)
    for mask in (1, 2):
        dec = api.Decoder(dev)
        dec.prepare_to_decode(320, 240)
        dec.set_channels_active(mask)
        want = codec320.decode_batch([split_3d(pair)[mask - 1]])
        if dec.decode_sample(pair).tobytes() != want.tobytes() \
                or dec.fallback_frames:
            raise AssertionError(f"api.Decoder stereo eye {mask}: differs "
                                 "from decode_batch of the split eye")
    book(launches_api)
    log("api goldens on the card: the gopstream_320x240_q4 encode (6 "
        "samples) and decode series, fs2_320x240 and fs3_320x240 (4 frames "
        "each) byte-equal; StereoEncoder at 320x240, eyes 1 and 2 equal to "
        "decode_batch of the split eyes; 0 fallback frames")
    if not all(launches_api.values()):
        raise AssertionError(f"the api path launched {launches_api}")

    # the pools: 32 YUY2 frames
    frames32 = np.stack([np.roll(base, i, axis=0) for i in range(4 * BATCH)])
    enc = api.Encoder(dev)
    enc.prepare_to_encode(WIDTH, HEIGHT, api.PixelFormat.YUY2)
    enc.attach_metadata(meta)
    want32 = []
    for f in frames32:
        enc.encode_sample(f)
        want32.append(enc.get_sample_data())

    def pool_run(p, submit, harvest, n):
        """Submit n items, then harvest them; -> (items, seconds from the
        first submission to the last harvest)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            submit(i + 1, i)
        got = [harvest(timeout=600) for _ in range(n)]
        window = time.perf_counter() - t0
        p.stop()
        if [b.frame_number for b in got] != list(range(1, n + 1)):
            raise AssertionError("a pool delivered out of order: "
                                 f"{[b.frame_number for b in got]}")
        return got, window

    def pool_counts(what, p, jobs, want):
        """Fails unless the pool took its `jobs` jobs in batches of at
        most 8 and launched `want` (launches a batch) per batch taken."""
        if sum(p.batches) != jobs or max(p.batches) > BATCH:
            raise AssertionError(f"{what}: batches {p.batches} for {jobs} "
                                 "jobs")
        got = counts()
        full = dict.fromkeys(kernels, 0)
        full.update({n: v * len(p.batches) for n, v in want.items()})
        if got != full or dwt_forward_level.launches:
            raise AssertionError(f"{what}: batches {p.batches} launched "
                                 f"{got}: expected {full}")
        book(launches_pool)

    reset_counts()
    p = api.CFHD_CreateEncoderPool(1, 4 * BATCH, device=dev)
    p.prepare_to_encode(WIDTH, HEIGHT, api.PixelFormat.YUY2)
    p.attach_metadata(meta)
    p.start()
    got, enc_window = pool_run(
        p, lambda n, i: p.encode_async_sample(n, frames32[i]),
        p.wait_for_sample, 4 * BATCH)
    if [b.get_encoded_sample() for b in got] != want32:
        raise AssertionError("EncoderPool: samples differ from the sync "
                             "Encoder's")
    enc_batches = p.batches
    pool_counts("EncoderPool", p, 4 * BATCH, {
        "dwt_forward_yuy2": 1, "dwt_forward_groups": 2, "chunk_pack": 6,
        "merge_network": 6})

    frames16 = np.stack([gop_f0, gop_f1], axis=1).reshape(
        2 * BATCH, HEIGHT, 2 * WIDTH)
    want16 = []
    enc = api.Encoder(dev)
    enc.prepare_to_encode(WIDTH, HEIGHT, api.PixelFormat.YUY2,
                          encoding_flags=api.EncodingFlags.YUV_2FRAME_GOP)
    enc.attach_metadata(meta)
    for f in frames16:
        enc.encode_sample(f)
        want16.append(enc.get_sample_data())
    reset_counts()
    p = api.CFHD_CreateEncoderPool(1, 2 * BATCH, device=dev)
    p.prepare_to_encode(WIDTH, HEIGHT, api.PixelFormat.YUY2,
                        encoding_flags=api.EncodingFlags.YUV_2FRAME_GOP)
    p.attach_metadata(meta)
    p.start()
    got, gop_window = pool_run(
        p, lambda n, i: p.encode_async_sample(n, frames16[i]),
        p.wait_for_sample, 2 * BATCH)
    if [b.get_encoded_sample() for b in got] != want16:
        raise AssertionError("EncoderPool GOP: samples differ from the "
                             "sync Encoder's")
    gop_batches = p.batches
    pool_counts("EncoderPool GOP", p, BATCH, {"dwt_forward_yuy2": 2,
                                              "dwt_forward_groups": 3})

    dec = api.Decoder(dev)
    dec.prepare_to_decode(WIDTH, HEIGHT)
    want_yuy2 = [dec.decode_sample(x).tobytes() for x in want32]
    want_bgra = []
    for i in range(0, 4 * BATCH, BATCH):
        out, fallback = codec.decode_batch_device(want32[i:i + BATCH],
                                                  output="BGRA")
        if fallback:
            raise AssertionError(f"BGRA batch {i}: fallback {fallback}")
        want_bgra += [o.tobytes() for o in out]
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dec_windows, dec_batches = {}, {}
    for pf, want in ((api.PixelFormat.YUY2, want_yuy2),
                     (api.PixelFormat.BGRA, want_bgra)):
        reset_counts()
        p = DecoderPool(2, 4 * BATCH, device=dev)
        p.prepare_to_decode(WIDTH, HEIGHT, pf)
        p.start()
        got, dec_windows[pf.name] = pool_run(
            p, lambda n, i: p.decode_async_sample(n, want32[i]),
            p.wait_for_frame, 4 * BATCH)
        if [b.data.tobytes() for b in got] != want or p.fallback_frames:
            raise AssertionError(
                f"DecoderPool {pf.name}: frames differ from the sync route's"
                f", or {p.fallback_frames} fell back")
        dec_batches[pf.name] = p.batches
        pool_counts(f"DecoderPool {pf.name}", p, 4 * BATCH, {
            "merge_network_tgt": 6, "merge_network_highfirst": 6})
    pool_peak = torch.cuda.max_memory_allocated()
    log(f"EncoderPool at {WIDTH}x{HEIGHT} q4: {4 * BATCH} YUY2 frames in "
        f"batches {enc_batches}, {4 * BATCH / enc_window:.4f} frames/s "
        f"({enc_window:.4f} s from the first submission to the last "
        f"harvest); 8 GOP pairs in batches {gop_batches}, "
        f"{2 * BATCH / gop_window:.4f} frames/s ({gop_window:.4f} s); "
        f"in order and byte-equal to the sync Encoder ({the_card})")
    log(f"DecoderPool at {WIDTH}x{HEIGHT}: the {4 * BATCH} samples, " +
        ", ".join(f"to {n} in batches {dec_batches[n]} "
                  f"{4 * BATCH / w:.4f} frames/s ({w:.4f} s)"
                  for n, w in dec_windows.items())
        + "; YUY2 byte-equal to the sync Decoder, BGRA to "
        "decode_batch_device, in order, 0 fallback frames; peak device "
        f"memory over the two pool decodes {pool_peak} bytes "
        f"({pool_peak / 2**30:.3f} GiB; {base_bytes} allocated before) "
        f"({the_card})")
    log(f"launches of the api path {launches_api}; of the pools "
        f"{launches_pool}; phase {time.perf_counter() - t_phase:.3f} s")
    del frames32, frames16, want32, want16, want_yuy2, want_bgra, got

    # --- 10. the decoder's other outputs and reduced resolutions -----------
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    picks = [0, BATCH - 1]
    outputs_422 = (*yuv_output.OUTPUTS_422, "BGRa", "yuyv")
    rgb_outputs = ("WP13", "W13A", "BGRA", "BGRa", "RG24")
    launches_outputs = dict.fromkeys(kernels, 0)
    launches_scaled = dict.fromkeys(kernels, 0)

    def decode_runs(c, samples_, output, resolution=1):
        """decode_batch_device of `samples_`, 4 runs (a warm-up and 3
        timed): fails on a fallback frame or a run that differs from the
        first.  -> (frames, median ms/frame, peak device bytes of the
        first run above what was allocated before it)."""
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times, first = [], None
        for it in range(4):
            (out, fallback), ms = host_ms(torch, lambda: c.decode_batch_device(
                samples_, output=output, resolution=resolution))
            if it == 0:
                peak = torch.cuda.max_memory_allocated() - before
                first = out
            else:
                times.append(ms / len(samples_))
            if fallback or out.tobytes() != first.tobytes():
                raise AssertionError(f"{output} at resolution {resolution}: "
                                     f"fallback {fallback}, or run {it} "
                                     "differs from the first")
        return first, med(times), peak

    def against_cpu(c_cpu, samples_, out, output, resolution=1):
        """Frames 0 and 7 of the card's `out` against the port's path on
        the CPU, byte for byte."""
        want = c_cpu.decode_batch([samples_[i] for i in picks],
                                  output=output, resolution=resolution)
        for j, i in enumerate(picks):
            if out[i].tobytes() != want[j].tobytes():
                raise AssertionError(f"{output} at resolution {resolution}, "
                                     f"frame {i}: the card's decode differs "
                                     "from the CPU path's")

    def packer_ms(name, fn, planes):
        """A packer's device time on one frame's planes, and its bound:
        its int32 planes read and its bytes written once; fails if it
        makes a synchronizing call (`device_ms` could not time it)."""
        out = fn()
        moved = nbytes(planes) + out.numel() * out.element_size()
        syncs = sync_calls(torch, fn)
        if syncs:
            raise AssertionError(f"the {name} packer made {syncs} "
                                 "synchronizing calls")
        return [device_ms(torch, fn), bound_ms(moved, 0)[0]]

    reset_counts()
    yuy2_cpu = IntraCodec(WIDTH, HEIGHT, 4, device=cpu)
    rg48_cpu = IntraCodec(WIDTH, HEIGHT, 4, device=cpu, input_format="RG48")
    rows = {}
    for c, c_cpu, samples_, outs in (
            (codec, yuy2_cpu, yuy2_samples, outputs_422),
            (rg48_c, rg48_cpu, rg48_samples, rgb_outputs)):
        for output in outs:
            out, ms, peak = decode_runs(c, samples_, output)
            against_cpu(c_cpu, samples_, out, output)
            rows[(c.input_format, output)] = [ms, peak]
    for name, fmt, ext in OUTPUT_GOLDENS:
        sample = golden("cfhd", name)
        dec = api.Decoder(dev)
        dec.prepare_to_decode(0, 0, api.PixelFormat[fmt], sample=sample)
        got = dec.decode_sample(sample).tobytes()
        want = golden(ext, name)
        if (name, fmt) in NEAR_GOLDENS:
            cpu_dec = api.Decoder(cpu)
            cpu_dec.prepare_to_decode(0, 0, api.PixelFormat[fmt],
                                      sample=sample)
            d = np.abs(np.frombuffer(got, np.uint8).astype(int)
                       - np.frombuffer(want, np.uint8).astype(int))
            ok = got == cpu_dec.decode_sample(sample).tobytes() \
                and d.max() <= 1 and (d > 0).mean() < 0.2
        else:
            ok = got == want
        if not ok or dec.fallback_frames:
            raise AssertionError(f"api.Decoder {name} to {fmt}: differs "
                                 f"from {ext}, or fell back")
    book(launches_outputs)
    # each decoder merge form once a band row class of each device decode
    n_yuv, n_rgb = len(codec.decode_classes()), len(rg48_c.decode_classes())
    want_each = (4 * len(outputs_422) * n_yuv + 4 * len(rgb_outputs) * n_rgb
                 + sum(n_rgb if name.startswith("rg48") else n_yuv
                       for name, _, _ in OUTPUT_GOLDENS))
    if (launches_outputs["merge_network_tgt"],
            launches_outputs["merge_network_highfirst"]) != (want_each,) * 2:
        raise AssertionError(f"the outputs path launched {launches_outputs}:"
                             f" expected each decoder merge form {want_each}"
                             " times, once a band row class")

    # each packer on the first frame's planes
    co1, _ = codec.decode_coefficients(*codec._decode_rows_args(
        yuy2_samples[:1])[:5])
    deep = codec._row16u_planes(co1, True)
    default = codec._row16u_planes(co1, False)
    t0 = time.perf_counter()
    dither = torch.from_numpy(rg24_dither(WIDTH, HEIGHT)).to(dev)
    rg24_table_s = time.perf_counter() - t0
    for output in yuv_output.OUTPUTS_422:
        planes = deep if output in yuv_output.DEEP_YUV else default
        rows[("YUY2", output)] += packer_ms(output, lambda: yuv_output.pack(
            output, *planes, rg24_dither=dither), planes)
    rg1, _ = rg48_c.decode_coefficients(*rg48_c._decode_rows_args(
        rg48_samples[:1])[:5])
    rgb1 = rg48_c.inverse_rg48(rg1).unflatten(-1, (-1, 3))
    rgb_planes = rgb1.unbind(-1)
    for output in rgb_outputs:
        rows[("RG48", output)] += packer_ms(
            output, (lambda: yuv_output.wp13_pack(rgb1 >> 3, output))
            if output in ("WP13", "W13A") else
            (lambda: yuv_output.rgb16_to_8bit(*rgb_planes, output)),
            rgb_planes)
    del co1, deep, default, dither, rg1, rgb1, rgb_planes
    log(f"outputs at {WIDTH}x{HEIGHT} q4, batch {BATCH}: decode_batch_device"
        " of the YUY2 and the RG48 samples to each output, 0 fallback "
        "frames, frames 0 and 7 byte-equal to the CPU path; ms/frame "
        "(median of 3 after a warm-up), peak device bytes above those "
        "allocated before, and the packer's device ms on one frame's planes"
        " (device_ms) against its bound: " + "; ".join(
            f"{fmt} to {o} {r[0]:.4f} ms, {r[1]} B"
            + (f", packer {r[2]:.4f} ms bound {r[3]:.4f} ms"
               if len(r) > 2 else "") for (fmt, o), r in rows.items())
        + f"; peak {max(r[1] for r in rows.values())} B; the RG24 dither "
        f"table ({WIDTH * HEIGHT} glibc draws, built once a size on the "
        f"host) {rg24_table_s:.3f} s; the "
        f"{len(OUTPUT_GOLDENS)} output goldens through api.Decoder on the "
        f"card; launches {launches_outputs} ({the_card})")

    # the reduced resolutions, full resolution the yardstick
    reset_counts()
    scaled = {}
    for res in (1, 2, 3, 4):
        before = counts()
        out, ms, peak = decode_runs(codec, yuy2_samples, "YUY2", res)
        ran = {n: v - before[n] for n, v in counts().items()}
        if codec.decode_batch(yuy2_samples,
                              resolution=res).tobytes() != out.tobytes():
            raise AssertionError(f"resolution {res}: the device route "
                                 "differs from the host-entropy route")
        against_cpu(yuy2_cpu, yuy2_samples, out, "YUY2", res)
        kept = len(codec.decode_classes(res))
        if (ran["merge_network_tgt"], ran["merge_network_highfirst"]) != \
                (4 * kept, 4 * kept):
            raise AssertionError(f"resolution {res}: launches {ran} for 4 "
                                 f"decodes of {kept} band row classes")
        parts = {p: [] for p in ("header walk and fill", "upload",
                                 "entropy decode", "inverse", "download")}
        for _ in range(3):
            t0 = time.perf_counter()
            host_rows = codec._decode_rows_host(yuy2_samples,
                                                resolution=res)
            parts["header walk and fill"].append(
                (time.perf_counter() - t0) * 1e3)
            dev_rows, t = host_ms(torch, lambda: codec._upload_rows(
                host_rows))
            parts["upload"].append(t)
            (co, _), t = host_ms(torch, lambda: codec.decode_coefficients(
                *dev_rows[:5], res))
            parts["entropy decode"].append(t)
            yuy2, t = host_ms(torch, lambda: codec.inverse_output(
                co, resolution=res))
            parts["inverse"].append(t)
            _, t = host_ms(torch, lambda: yuy2.cpu().numpy())
            parts["download"].append(t)
        scaled[res] = (ms, peak, sum(p.shape[0] for p in host_rows[0]),
                       kept, {p: med(v) / BATCH for p, v in parts.items()})
    del host_rows, dev_rows, co, yuy2
    for name, res, ext in SCALED_GOLDENS:
        sample = golden("cfhd", name)
        got = []
        for d in (dev, cpu):
            dec = api.Decoder(d)
            dec.prepare_to_decode(0, 0, resolution=api.DecodedResolution(res),
                                  sample=sample)
            got.append(dec.decode_sample(sample).tobytes())
            if dec.fallback_frames:
                raise AssertionError(f"api.Decoder {name} {ext}: fell back")
        if got[0] != got[1] or (res == 2 and got[0] != golden(ext, name)):
            raise AssertionError(f"api.Decoder {name} at resolution {res}: "
                                 f"differs from the CPU path or from {ext}")
    book(launches_scaled)
    names = {1: "full", 2: "half", 3: "quarter", 4: "thumbnail"}
    log(f"resolutions at {WIDTH}x{HEIGHT} q4, batch {BATCH}: "
        "decode_batch_device equal to decode_batch, frames 0 and 7 to the "
        "CPU path, 0 fallback frames; ms/frame (median of 3 after a "
        "warm-up), peak device bytes, band rows and classes decoded, and "
        "the device route's parts in ms a frame (medians of 3): " + "; ".join(
            f"{names[r]} {v[0]:.4f} ms, {v[1]} B, {v[2]} rows in {v[3]} "
            "classes (" + ", ".join(f"{p} {t:.4f}" for p, t in v[4].items())
            + ")" for r, v in scaled.items())
        + "; the half goldens byte-equal through api.Decoder on the card, "
        f"the quarter goldens equal to the CPU path; launches "
        f"{launches_scaled}; phase {time.perf_counter() - t_phase:.3f} s "
        f"({the_card})")
    if not all(launches_outputs[n] and launches_scaled[n]
               for n, k in kernels.items() if "outputs" in k["paths"]):
        raise AssertionError(f"the outputs path launched {launches_outputs},"
                             f" the scaled path {launches_scaled}")

    # --- 11. the geometry stage: other sizes, the lens warp, GOP outputs ---
    t_phase = time.perf_counter()
    launches_geometry = dict.fromkeys(kernels, 0)
    geo_lines = []
    # device decodes of the phase: each runs the 6 band row classes of a
    # 1080p or 320x240 4:2:2 frame or group once, so each decoder merge
    # form 6 times
    geo_decodes = [0]

    def geo_log(msg):
        geo_lines.append(msg)
        log(f"{msg} ({the_card})")

    def as_i32(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))

    def as_bytes(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint8))

    def equal_frames(what, got, want):
        if got.tobytes() != want.tobytes():
            raise AssertionError(f"{what}: the card's bytes differ from the "
                                 "CPU path's")

    def api_decodes(samples_, fmt, size, what, warm=None):
        """One api.Decoder on the card over `samples_` after a warm-up
        decode of `warm` in a decoder of its own: (the frames, median
        ms/frame, peak device bytes above those allocated before); fails
        on a fallback frame."""
        if warm is not None:
            dec = api.Decoder(dev)
            dec.prepare_to_decode(*size, api.PixelFormat[fmt], sample=warm)
            dec.decode_sample(warm)
            geo_decodes[0] += 1
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dec = api.Decoder(dev)
        dec.prepare_to_decode(*size, api.PixelFormat[fmt], sample=samples_[0])
        frames_, times = [], []
        for s in samples_:
            out, ms = host_ms(torch, lambda: dec.decode_sample(s))
            frames_.append(out)
            times.append(ms)
        geo_decodes[0] += len(samples_)
        if dec.fallback_frames:
            raise AssertionError(f"{what}: {dec.fallback_frames} frames "
                                 "fell back")
        return frames_, med(times), torch.cuda.max_memory_allocated() - before

    def stage_ms(name, fn, inputs):
        """A stage's device time (`device_ms`) and its bytes' bound: its
        inputs read and its output written once; fails if it makes a
        synchronizing call."""
        out = fn()
        syncs = sync_calls(torch, fn)
        if syncs:
            raise AssertionError(f"{name} made {syncs} synchronizing calls")
        moved = nbytes(inputs) + out.numel() * out.element_size()
        return device_ms(torch, fn), bound_ms(moved, 0)[0]

    reset_counts()

    # the scaled decode: the API samples at 1280x720 and 3840x2160
    yu64_ref = as_i32(yuy2_cpu.decode_batch([yuy2_samples[i] for i in picks],
                                            output="YU64"))
    co1, _ = codec.decode_coefficients(*codec._decode_rows_args(
        yuy2_samples[:1])[:5])
    geo_decodes[0] += 1
    yu64_dev = codec.inverse_output(co1, output="YU64")
    del co1
    sized = []
    for w, h in ((1280, 720), (3840, 2160)):
        for fmt, fourcc in (("YUY2", "YUY2"), ("B64A", "b64a"),
                            ("RG48", "RG48")):
            what = f"{fmt} at {w}x{h}"
            got, ms, peak = api_decodes(yuy2_samples, fmt, (w, h), what,
                                        warm=yuy2_samples[0])
            want = scaler_ops.scale_yu64_to(yu64_ref, WIDTH, HEIGHT, w, h,
                                            fourcc)
            for j, i in enumerate(picks):
                equal_frames(f"{what}, frame {i}", got[i], want[j].numpy())
            dev_ms, bnd = stage_ms(
                what, lambda: scaler_ops.scale_yu64_to(
                    yu64_dev.to(torch.int32) & 0xFFFF, WIDTH, HEIGHT, w, h,
                    fourcc), [yu64_dev])
            sized.append(f"{what} {ms:.4f} ms/frame, peak {peak} B, the "
                         f"scaling stage {dev_ms:.4f} ms (bound {bnd:.4f})")
    taps = max(scaler_ops.tap_table(a, b, 3, dev)[0].shape[1]
               for a, b in ((1920, 1280), (960, 1280), (1080, 720),
                            (1920, 3840), (960, 3840), (1080, 2160)))
    del yu64_ref
    geo_log(f"decode to another size, api.Decoder on the {BATCH} 1080p YUY2 "
            "samples (batch 1, median of 8 after a warm-up; frames 0 and 7 "
            "byte-equal to the CPU path's YU64 decode and scale, 0 fallback "
            "frames; the scaling stage's device_ms on one frame's YU64 "
            f"against its bytes' bound; the widest tap table {taps} taps): "
            + "; ".join(sized))

    # the lens warp: 1080p lens samples through api.Decoder
    @dataclasses.dataclass
    class LensMetadata(EncoderMetadata):
        extra: bytes = b""

        def block(self) -> bytes:
            return super().block() + self.extra

    def lens_tuple(name, value):
        payload = (value.to_bytes(4, "little") if isinstance(value, int)
                   else np.float32(value).tobytes())
        return (name.encode() + len(payload).to_bytes(3, "little")
                + (b"L" if isinstance(value, int) else b"f") + payload)

    sphere = {"LSPH": 1, "ZOOM": 1.2, "OFFX": 0.1, "OFFY": -0.05,
              "OFFR": 0.1}
    lens_cases = {"sphere_stack": sphere, "planar_rotate": {"OFFR": 0.2},
                  "sphere_stack LFIL=1": {**sphere, "LFIL": 1}}
    lens_samples = {}
    book(launches_geometry)             # the encodes below are not booked
    for name, tags_ in lens_cases.items():
        enc = api.Encoder(dev)
        enc.prepare_to_encode(WIDTH, HEIGHT, api.PixelFormat.YUY2)
        enc.attach_metadata(LensMetadata(extra=b"".join(
            lens_tuple(t, v) for t, v in tags_.items())))
        enc.encode_sample(base)
        lens_samples[name] = enc.get_sample_data()
    reset_counts()
    warps = []
    for name, fmt in (("sphere_stack", "YUY2"), ("sphere_stack", "RG48"),
                      ("sphere_stack", "BGRA"), ("planar_rotate", "YUY2"),
                      ("planar_rotate", "RG48"), ("planar_rotate", "BGRA"),
                      ("sphere_stack LFIL=1", "YUY2")):
        sample = lens_samples[name]
        params = lens.parse_lens_metadata(sample)
        what = f"{name} to {fmt}"
        got, ms, peak = api_decodes([sample] * 3, fmt, (0, 0), what,
                                    warm=sample)
        # the CPU path: the host-entropy decode of the direct or WP13
        # output, warped on the CPU
        if fmt == "YUY2":
            want = lens.warp_decode(params, as_bytes(yuy2_cpu.decode_batch(
                [sample], output="WP13")), WIDTH, HEIGHT, "YUY2", {})
        else:
            want = lens.warp_output(params, as_bytes(yuy2_cpu.decode_batch(
                [sample], output=fmt)), WIDTH, HEIGHT, fmt, {})
        equal_frames(what, got[0], want[0].numpy())
        if any(g.tobytes() != got[0].tobytes() for g in got):
            raise AssertionError(f"{what}: repeated decodes differ")
        warps.append(f"{what} {ms:.4f} ms/frame, peak {peak} B")
    # the mesh builds, the apply and the recurrences, on the WP13 frame
    wp13 = as_bytes(yuy2_cpu.decode_batch([lens_samples["sphere_stack"]],
                                          output="WP13")).to(dev)
    parts = []

    class OpCount(TorchDispatchMode):
        """Counts the ops one call dispatches, views excluded: each one
        kernel launch or more."""

        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 0 if func.is_view else 1
            return func(*args, **(kwargs or {}))

    for name in lens_cases:
        params = lens.parse_lens_metadata(lens_samples[name])
        t0 = time.perf_counter()
        mesh = lens.build_mesh(params, WIDTH, HEIGHT, 6 * WIDTH, "WP13")
        build_s = time.perf_counter() - t0
        dm = warp_ops.upload(mesh, dev)
        plain = dataclasses.replace(dm, blend_columns=[])
        apply_ms, apply_bound = stage_ms(
            f"the apply of {name}", lambda: warp_ops.apply_bilinear(plain,
                                                                    wp13),
            [wp13])
        part = (f"{name}: mesh build {build_s:.3f} s (host), apply "
                f"{apply_ms:.4f} ms (bound {apply_bound:.4f})")
        if params.lens_fill:
            # the recurrences' steps are a few small launches each, queued
            # more slowly than the card runs them: CUDA events around the
            # whole call (`cuda_ms`) time them, the host's queueing in
            warped = warp_ops.apply_bilinear(dm, wp13)
            calls = (lambda: warp_ops.apply_bilinear(dm, wp13),
                     lambda: warp_ops.apply_bilinear(plain, wp13),
                     lambda: warp_ops.blur_vertical(dm, warped))
            events, op_counts = [], []
            for fn in calls:
                events.append(cuda_ms(torch, fn))
                with OpCount() as c:
                    fn()
                op_counts.append(c.n)
            part += (f", the fill recurrences apart (CUDA events around a "
                     f"call): the apply with the blend's "
                     f"{len(dm.blend_columns)} column steps {events[0]:.4f} "
                     f"ms against {events[1]:.4f} ms without, "
                     f"{op_counts[0] - op_counts[1]} ops more; the blur's "
                     f"{dm.recurrence_steps['blur_rows']} row steps "
                     f"{events[2]:.4f} ms and {op_counts[2]} ops")
        parts.append(part)
    del wp13, dm, plain
    geo_log("the lens warp, api.Decoder on 1080p YUY2 lens samples (median "
            "of 3 decodes after a warm-up, which builds the mesh; byte-equal "
            "to the CPU path's host-entropy decode warped on the CPU, 0 "
            "fallback frames): " + "; ".join(warps) + "; on one frame's WP13 "
            "(the apply by device_ms against the bytes' bound; ops "
            "dispatched, views excluded, each one kernel launch or more): "
            + "; ".join(parts))

    # the GOP outputs: the GOP phase's groups
    gop_cpu = GopCodec(WIDTH, HEIGHT, 4, device=cpu)
    gop_picks = [gop_samples[i] for i in picks]
    gops = []
    for output, frame in (("YU64", 0), ("v210", 0), ("RG48", 0),
                          ("BGRA", 0), ("RG48", 1)):
        times = []
        for it in range(3):
            (got, fallback), ms = host_ms(
                torch, lambda: gop.decode_batch_device_to(gop_samples,
                                                          output, frame))
            geo_decodes[0] += 1
            if fallback:
                raise AssertionError(f"GOP to {output}: fallback {fallback}")
            times.append(ms / BATCH)
        want = gop_cpu.decode_batch_to(gop_picks, output, frame)
        for j, i in enumerate(picks):
            equal_frames(f"GOP frame {frame} to {output}, group {i}",
                         got[i], want[j])
        gops.append(f"frame {frame} to {output} {med(times[1:]):.4f}")
    got, ms, peak = api_decodes(gop_samples, "YUY2", (1280, 720),
                                "GOP to 1280x720", warm=gop_samples[0])
    want = scaler_ops.scale_yu64_to(as_i32(gop_cpu.decode_batch_to(
        gop_picks, "YU64")), WIDTH, HEIGHT, 1280, 720, "YUY2")
    for j, i in enumerate(picks):
        equal_frames(f"GOP to 1280x720, group {i}", got[i], want[j].numpy())
    del gop_cpu, want
    geo_log(f"GOP outputs, the {BATCH} 1080p groups: decode_batch_device_to "
            "ms a group (median of 2 after a warm-up, 0 fallback; groups 0 "
            "and 7 byte-equal to the CPU path's host-entropy route): "
            + "; ".join(gops) + f"; api.Decoder to YUY2 at 1280x720 "
            f"{ms:.4f} ms a group (median of 8), peak {peak} B")

    # the float image ops
    img = torch.rand((BATCH, HEIGHT, WIDTH, 3), device=dev,
                     generator=torch.Generator(dev).manual_seed(0))
    tf32 = []
    einsum = torch.einsum

    def spy(*args, **kwargs):
        tf32.append(torch.backends.cuda.matmul.allow_tf32)
        return einsum(*args, **kwargs)

    torch.backends.cuda.matmul.allow_tf32 = True    # a caller's setting
    torch.einsum = spy
    try:
        scaled_img = scaler_ops.scale_image(img, 720, 1280)
    finally:
        torch.einsum = einsum
    if not tf32 or any(tf32) or not torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError(f"scale_image ran its products with TF32 "
                             f"{tf32}, or lost the caller's setting")
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh_t = torch.from_numpy(warp_ops.mesh_gopro_preset(HEIGHT,
                                                         WIDTH)).to(dev)
    warped_img = warp_ops.warp_bilinear(img, mesh_t)
    floats = []
    for what, got, fn, cpu_fn, inputs, ops_n in (
            ("scale_image to 720p", scaled_img,
             lambda: scaler_ops.scale_image(img, 720, 1280),
             lambda x: scaler_ops.scale_image(x, 720, 1280), [img],
             2 * 720 * HEIGHT * WIDTH * 3 * BATCH
             + 2 * 1280 * WIDTH * 720 * 3 * BATCH),
            ("warp_bilinear by mesh_gopro_preset", warped_img,
             lambda: warp_ops.warp_bilinear(img, mesh_t),
             lambda x: warp_ops.warp_bilinear(x, mesh_t.cpu()),
             [img, mesh_t], 9 * img.numel())):
        want = cpu_fn(img[picks].cpu())
        err = float((got[picks].cpu() - want).abs().max())
        if not torch.allclose(got[picks].cpu(), want, rtol=1e-5, atol=1e-4):
            raise AssertionError(f"{what}: differs from the CPU by {err}")
        ms = device_ms(torch, fn)
        moved = nbytes(inputs) + got.numel() * got.element_size()
        bound, by = bound_ms(moved, ops_n)
        floats.append(f"{what} {ms:.4f} ms (bound {bound:.4f}, {by}; max "
                      f"difference from the CPU {err:.3g})")
    del img, scaled_img, warped_img, mesh_t
    geo_log(f"float image ops on ({BATCH}, {HEIGHT}, {WIDTH}, 3) float32, "
            "device_ms, frames 0 and 7 within rtol 1e-5, atol 1e-4 of the "
            "CPU's; TF32 off in scale_image's products though the caller "
            "had it on: " + "; ".join(floats))

    # the goldens on the card
    def scaler_golden(name):
        with open(os.path.join(ROOT, "tests", "golden", "scaler", name),
                  "rb") as f:
            return f.read()

    yu = as_i32(np.frombuffer(golden("yu64out", "s_320x240_q4_p1"),
                              "<u2").reshape(1, 240, 640)).to(dev)
    argb = as_i32(np.frombuffer(golden("b64aout", "s_128x96_q4_p1"),
                                ">u2").reshape(1, 96, 128, 4)).to(dev)
    checks = [(f"scale_yu64_{w}x{h}.bgra64",
               lambda w=w, h=h: scaler_ops.scale_yu64_to_bgra64(
                   yu, 320, 240, w, h))
              for w, h in ((200, 150), (480, 360), (211, 157), (200, 240))]
    checks += [(f"scale_b64a_{w}x{h}.b64a",
                lambda w=w, h=h: scaler_ops.scale_b64a_to_b64a(
                    argb, 128, 96, w, h))
               for w, h in ((80, 60), (200, 150), (81, 63))]
    checks += [(f"scale_bgra_{w}x{h}.bgra",
                lambda w=w, h=h: scaler_ops.scale_b64a_to_bgra(
                    argb, 128, 96, w, h)) for w, h in ((80, 60), (81, 63))]
    for name, fn in checks:
        if fn().cpu().numpy().tobytes() != scaler_golden(name):
            raise AssertionError(f"the scaler on the card differs from {name}")
    rand = geomesh.GlibcRand()
    for name, fmt, fill in WARP_APPLY:
        w, h = (320, 240) if fmt == "yuy2" else (128, 96)
        mw, mh, steps = WARP_CASES[name]
        f = getattr(geomesh, WARP_FORMATS[fmt])
        bpp = geomesh._FMTINFO[f][0]
        mesh = geomesh.GeoMesh(mw, mh)
        mesh.init(w, h, w * bpp, f, w, h, w * bpp, f, fill)
        for t, args in steps:
            getattr(mesh, "transform_" + t)(*args)
        # the fill goldens were generated back to back: one rand stream
        mesh.cache_init_bilinear_range(0, h, rand if fill else
                                       geomesh.GlibcRand())
        got = warp_ops.apply_bilinear(warp_ops.upload(mesh, dev),
                                      torch.from_numpy(warp_test_image(
                                          w, h, fmt)).to(dev))
        with open(os.path.join(ROOT, "tests", "golden", "warp",
                               f"apply_{name}_{fmt}_{w}x{h}_f{fill}.bin"),
                  "rb") as fh:
            if got.cpu().numpy().tobytes() != fh.read():
                raise AssertionError(f"the warp on the card differs from "
                                     f"apply_{name}_{fmt}_{w}x{h}_f{fill}")
    small_gop = GopCodec(320, 240, 4, device=dev)
    for output, ext in (("RG48", "rg48out"), ("YU64", "yu64out")):
        got, fallback = small_gop.decode_batch_device_to(
            [golden("s1", "gopstream_320x240_q4")], output, 1)
        geo_decodes[0] += 1
        if fallback or got.tobytes() != golden(f"f1true.{ext}",
                                               "gopstream_320x240_q4"):
            raise AssertionError(f"GOP frame 1 to {output}: differs from "
                                 f"gopstream_320x240_q4.f1true.{ext}")
    del yu, argb
    book(launches_geometry)
    want_each = 6 * geo_decodes[0]
    if (launches_geometry["merge_network_tgt"],
            launches_geometry["merge_network_highfirst"]) != (want_each,) * 2:
        raise AssertionError(f"the geometry path launched {launches_geometry}:"
                             f" expected each decoder merge form {want_each} "
                             f"times, 6 for each of {geo_decodes[0]} device "
                             "decodes")
    geo_log(f"geometry goldens on the card: {len(checks)} scaler, "
            f"{len(WARP_APPLY)} warp apply and the 2 gopstream frame-1 deep "
            f"outputs byte-equal; launches {launches_geometry} "
            f"({geo_decodes[0]} device decodes); phase "
            f"{time.perf_counter() - t_phase:.3f} s")
    if not all(launches_geometry[n]
               for n, k in kernels.items() if "geometry" in k["paths"]):
        raise AssertionError(f"the geometry path launched {launches_geometry}")

    # --- 12. the encoder inputs: the other formats and the encoder options --
    t_phase = time.perf_counter()
    launches_inputs = dict.fromkeys(kernels, 0)
    in_lines = []

    def in_log(msg):
        in_lines.append(msg)
        log(f"{msg} ({the_card})")

    # the probe's raw fill at the film-scan size; its prefix is the fill
    # of any smaller frame
    t0 = time.perf_counter()
    fill = np.frombuffer(raw_fill(SCAN_WIDTH * SCAN_HEIGHT * 4, 1), np.uint8)
    log(f"raw fill of {fill.nbytes} bytes ({time.perf_counter() - t0:.3f} s)")

    def raw_frames(c, n):
        """n frames of the raw fill at the codec's size, rolled one row a
        frame."""
        one = fill[:c.height * c.row_bytes].reshape(c.height, c.row_bytes)
        return np.stack([np.roll(one, i, axis=0) for i in range(n)])

    # kernel checks at the phase's new shapes and quantizers (not counted)
    log("kernel checks, encoder inputs (tolerance 0)")
    scan = IntraCodec(SCAN_WIDTH, SCAN_HEIGHT, 4, device=dev,
                      input_format="DPX0")
    scan_frames = raw_frames(scan, SCAN_BATCH)
    for fmt, c, frames_ in (("R210", IntraCodec(WIDTH, HEIGHT, 4, device=dev,
                                                input_format="R210"), None),
                            ("DPX0", scan, scan_frames)):
        up = c._upload(raw_frames(c, BATCH) if frames_ is None else frames_)
        x = unpack_timed(fmt, c, up)
        t = c.tables()
        levels = []
        for lev in range(3):
            q = [t.band_quant[ch][lev] for ch in range(3)]
            ps = t.prescale[lev]
            ll, highs = compare(
                "dwt_forward_planes", lambda: dwt_forward_planes(x, ps, q),
                lambda: dwt.plain_planes(x, ps, q),
                f"{fmt} level {lev + 1} {tuple(x.shape)} prescale {ps} "
                f"quants {q}", (x,), tally=False, timed=False)
            levels.append(((ll,), (highs,)))
            x = ll
        if fmt == "R210":
            # noise: chunks that take chunk_pack's tree, rows that take
            # merge_network's network
            encode_checks(c, levels, tally=False, timed=False)
            decode_checks(c, c.encode_batch_device(
                raw_frames(c, BATCH)), tally=False, timed=False)
        del up, x, levels, ll, highs
    for fmt in ("BGRA", "RG24", "CT_SHORT_2_14", "CT_10BIT_2_8"):
        c = IntraCodec(WIDTH, HEIGHT, 4, device=dev, input_format=fmt)
        unpack_timed(fmt, c, c._upload(raw_frames(c, BATCH)))
    yuy2_frames = frames
    for name, table in CUSTOM_TABLES.items():
        tables_ = tuple(map(tuple, custom_quant_tables(table, table, 10)))
        t = IntraCodec(WIDTH, HEIGHT, 4, device=dev,
                       custom_quant=tables_).tables()
        up = torch.from_numpy(yuy2_frames).to(dev)
        q = [t.band_quant[ch][0] for ch in range(3)]
        x = compare("dwt_forward_yuy2",
                    lambda: dwt_forward_yuy2(up, 10, 0, q),
                    lambda: dwt.plain_groups(ops.unpack_yuy2(up), 0, q),
                    f"custom quantization {name} level 1 quants {q}", (up,),
                    tally=False, timed=False)[:2]
        for lev in (1, 2):
            q = [t.band_quant[ch][lev] for ch in range(3)]
            ps = t.prescale[lev]
            x = compare(
                "dwt_forward_groups", lambda: dwt_forward_groups(x, ps, q),
                lambda: dwt.plain_groups((x[0][:, 0], x[1][:, 0],
                                          x[1][:, 1]), ps, q),
                f"custom quantization {name} level {lev + 1} quants {q}", x,
                tally=False, timed=False)[:2]
        del up, x
    reset_counts()

    # the 320x240 raw_* goldens through api.Encoder on the card
    near = []
    for fmt, name, bpp in RAW_GOLDENS:
        gold = golden("cfhd", name)
        enc = api.Encoder(dev)
        enc.prepare_to_encode(320, 240, api.PixelFormat[fmt])
        enc.attach_metadata(sample_metadata(gold))
        enc.encode_sample(fill[:int(320 * 240 * bpp)].tobytes())
        got = enc.get_sample_data()
        same = sum(a == b for a, b in zip(got, gold)) / min(len(got),
                                                             len(gold))
        if got != gold and (fmt != "RG24" or not same > 0.999):
            raise AssertionError(f"{fmt} through api.Encoder differs from "
                                 f"{name}.cfhd ({same:.6f} of the bytes)")
        if got != gold:
            near.append(f"{fmt} {same:.6f}")
    in_log(f"the {len(RAW_GOLDENS)} raw_* encode goldens through "
           f"api.Encoder on the card: byte-equal but "
           f"{', '.join(near) or 'none'} of the bytes (bound 0.999)")

    def input_batch(fmt, w, h, n, per_decode):
        """n raw-fill frames of `fmt` at w x h encoded on the card 4 times
        (a warm-up and 3 timed, the device part and the host tail apart),
        frames 0 and n-1 equal to the port's CPU path, decoded on the card
        `per_decode` frames a call with no frame falling back; logs a
        figures line."""
        c = IntraCodec(w, h, 4, device=dev, input_format=fmt)
        frames_ = raw_frames(c, n)
        enc_dev, enc_host = [], []
        for it in range(4):
            packed, ms = host_ms(torch, lambda: c.forward_packed(
                c._upload(frames_)))
            enc_dev.append(ms)
            t0 = time.perf_counter()
            samples = c.write_samples(frames_, packed)
            enc_host.append((time.perf_counter() - t0) * 1e3)
            if it == 0:
                first = samples
                overflowed = sum(int(o.sum()) for _, levels in packed
                                 for _, _, o, _ in levels)
            elif samples != first:
                raise AssertionError(f"{fmt}: the encodes differ")
            del packed
        ends = [0, n - 1]
        want = IntraCodec(w, h, 4, device=cpu, input_format=fmt).encode_batch(
            frames_[ends], frame_numbers=[1, n])
        if [samples[i] for i in ends] != want:
            raise AssertionError(f"{fmt}: frames 0 and {n - 1} differ from "
                                 "the CPU path")
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out, dec_ms = [], 0.0
        for i in range(0, n, per_decode):
            part = samples[i:i + per_decode]
            (part, fallback), ms = host_ms(
                torch, lambda: c.decode_batch_device(part))
            if fallback:
                raise AssertionError(f"{fmt}: frames {fallback} of "
                                     f"{i}..{i + per_decode - 1} fell back")
            out.append(part)
            dec_ms += ms
        out = np.concatenate(out)
        peak = torch.cuda.max_memory_allocated() - before
        # PSNR of the decode against the unpacked input, frames 0 and n-1,
        # at the codec's precision: 12-bit RGB (RG48 >> 4), 10-bit 4:2:2
        src = c._unpack(torch.from_numpy(frames_[ends]))
        if c.encoded == "RGB":
            back = ops.unpack_rg48(torch.from_numpy(
                np.ascontiguousarray(out[ends]).view(np.uint8)))
            peak_value = 4095.0
        else:
            back = ops.unpack_yuy2(torch.from_numpy(out[ends]))
            peak_value = 1023.0
        mse = np.mean([np.mean((a.numpy().astype(np.float64)
                                - b.numpy()) ** 2)
                       for a, b in zip(src, back)])
        ratio = frames_.nbytes / sum(len(s) for s in samples)
        in_log(f"{fmt} {w}x{h} batch {n}: {overflowed} of "
               f"{n * c.num_channels * 9} bands overflowed, ratio "
               f"{ratio:.4f}, PSNR {10 * np.log10(peak_value ** 2 / mse):.4f}"
               f" dB ({int(peak_value) + 1} levels), encode device "
               f"{med(enc_dev[1:]) / n:.4f} ms/frame, host tail "
               f"{med(enc_host[1:]) / n:.4f} ms/frame, decode_batch_device "
               f"{dec_ms / n:.4f} ms/frame ({per_decode} frames a call), "
               f"peak {peak} B")

    log("the new input formats, raw fill rolled one row a frame, q4, on "
        "the card (encode: medians of 3 after a warm-up; frames 0 and the "
        "last equal to the CPU path; decode: one run, 0 fallback frames)")
    for fmt, _, _ in RAW_GOLDENS:
        input_batch(fmt, WIDTH, HEIGHT, BATCH, BATCH)
    # the film-scan batch's noise needs more than the card's 80 GB decoded
    # in one call: two frames a call
    input_batch("DPX0", SCAN_WIDTH, SCAN_HEIGHT, SCAN_BATCH, 2)

    # the encoder options at 1080p
    yuy2_c = IntraCodec(WIDTH, HEIGHT, 4, device=dev)
    preset = yuy2_c.encode_batch_device(yuy2_frames, metadata=meta)
    coarse = tuple(map(tuple, custom_quant_tables(*[[4] + [40] * 16] * 2,
                                                  10)))
    custom_c = IntraCodec(WIDTH, HEIGHT, 4, device=dev, custom_quant=coarse)
    custom, ms = host_ms(torch, lambda: custom_c.encode_batch_device(
        yuy2_frames, metadata=meta))
    want = IntraCodec(WIDTH, HEIGHT, 4, device=cpu,
                      custom_quant=coarse).encode_batch(
        yuy2_frames[[0, BATCH - 1]], metadata=meta,
        frame_numbers=[1, BATCH])
    if [custom[0], custom[-1]] != want or not all(
            len(a) < len(b) for a, b in zip(custom, preset)):
        raise AssertionError("custom quantization: differs from the CPU path "
                             "or is not smaller than the preset's samples")
    in_log(f"custom quantization [4] + [40] * 16, batch {BATCH}: frames 0 "
           f"and {BATCH - 1} equal to the CPU path, {sum(map(len, custom))} "
           "bytes "
           f"against the preset's {sum(map(len, preset))}, "
           f"{ms / BATCH:.4f} ms/frame")

    def api_both(fmt, w, h, frames_, quality=4, flags=0, metadata=None):
        """The frames through api.Encoder on the card and on the CPU: the
        card's samples, equal to the CPU's, and their ms/frame."""
        out, times = [], []
        for d in (dev, cpu):
            enc = api.Encoder(d)
            enc.prepare_to_encode(w, h, api.PixelFormat[fmt],
                                  encoding_flags=api.EncodingFlags(flags),
                                  quality=quality)
            enc.attach_metadata(metadata)
            samples = []
            for f in frames_:
                _, ms = host_ms(torch, lambda: enc.encode_sample(f))
                samples.append(enc.get_sample_data())
                if d == dev:
                    times.append(ms)
            out.append(samples)
        if out[0] != out[1]:
            raise AssertionError(f"api.Encoder {fmt} quality {quality:#x} "
                                 f"flags {flags}: the card differs from the "
                                 "CPU")
        return out[0], med(times)

    override_dir = tempfile.mkdtemp()
    os.environ["CINEFORM_OVERRIDE_PATH"] = override_dir
    os.environ["CINEFORM_LUT_PATH"] = override_dir
    ov_lines = []
    for tags_ in ((b"LYUV",), (b"CV67",), (b"LYUV", b"CV67")):
        with open(os.path.join(override_dir, "override.colr"), "wb") as f:
            f.write(b"".join(t + (4).to_bytes(3, "little") + b"H"
                             + (1).to_bytes(4, "little") for t in tags_))
        got, ms = api_both("YUY2", WIDTH, HEIGHT, yuy2_frames[:2],
                           metadata=meta)
        if got[0] == preset[0]:
            raise AssertionError(f"{tags_}: the override changed nothing")
        ov_lines.append(f"{'+'.join(t.decode() for t in tags_)} "
                        f"{ms:.4f} ms/frame")
    os.remove(os.path.join(override_dir, "override.colr"))
    os.rmdir(override_dir)
    del os.environ["CINEFORM_OVERRIDE_PATH"], os.environ["CINEFORM_LUT_PATH"]
    in_log("LYUV/CV67 from override.colr through api.Encoder, 2 frames "
           "each, equal to the CPU: " + "; ".join(ov_lines))

    v210_c = IntraCodec(WIDTH, HEIGHT, 4, device=dev, input_format="V210")
    v210_series = [np.roll(np.frombuffer(v210_frame(WIDTH, HEIGHT, 1),
                                         np.uint8).reshape(HEIGHT, -1),
                           i, axis=0) for i in range(12)]
    unc, ms = api_both("V210", WIDTH, HEIGHT, v210_series, 0x0404,
                       metadata=meta)
    raw = [len(s) > HEIGHT * v210_c.row_bytes for s in unc]
    if all(raw) or not any(raw):
        raise AssertionError(f"V210 passthrough: decisions {raw}")
    in_log(f"V210 passthrough 0x0404, 12 frames through api.Encoder, equal "
           f"to the CPU: decisions {''.join('U' if r else 'C' for r in raw)}"
           f" (U raw, C compressed at q5 labelled 6), {ms:.4f} ms/frame")

    ilace = GopCodec(WIDTH, HEIGHT, 4, device=dev, progressive=False)
    ilace_f1 = np.stack([np.roll(f, 1, axis=0) for f in yuy2_frames])
    groups, ms = host_ms(torch, lambda: ilace.encode_batch(
        yuy2_frames, ilace_f1, metadata=meta))
    want = GopCodec(WIDTH, HEIGHT, 4, device=cpu,
                    progressive=False).encode_batch(
        yuy2_frames[[0, BATCH - 1]], ilace_f1[[0, BATCH - 1]],
        metadata=meta, frame_numbers=[1, BATCH])
    if [groups[0], groups[-1]] != want:
        raise AssertionError("interlaced groups: differ from the CPU path")
    gold = golden("cfhd.f1", "ilace_320x240_q4_p1")
    enc = api.Encoder(dev)
    enc.prepare_to_encode(320, 240, api.PixelFormat.YUY2,
                          encoding_flags=api.EncodingFlags(3))
    enc.attach_metadata(sample_metadata(gold))
    for p in (1, 2):
        enc.encode_sample(yuy2_frame(320, 240, p))
    if enc.get_sample_data() != gold:
        raise AssertionError("interlaced group differs from "
                             "ilace_320x240_q4_p1.cfhd.f1")
    in_log(f"interlaced GOP, {BATCH} {HEIGHT}i pairs through GopCodec: "
           f"groups 0 and {BATCH - 1} equal to the CPU path, "
           f"{ms / BATCH:.4f} ms/group; "
           "ilace_320x240_q4_p1.cfhd.f1 byte-equal through api.Encoder")
    book(launches_inputs)
    if not all(launches_inputs[n]
               for n, k in kernels.items() if "encoder_inputs" in k["paths"]):
        raise AssertionError(f"the encoder inputs path launched "
                             f"{launches_inputs}")
    in_log(f"launches during the encoder inputs path: {launches_inputs}; "
           f"phase {time.perf_counter() - t_phase:.3f} s")

    jax_modules = sorted(m for m in sys.modules
                         if m.split(".")[0] in ("cineform_tpu", "jax"))
    if jax_modules:
        raise AssertionError(f"modules of the JAX package were imported: "
                             f"{jax_modules[:10]}")
    log("sys.modules holds no module of cineform_tpu or jax")

    log(card())
    by_path = {"yuy2": launches, "rgb": launches_rgb, "yuv10": launches_yuv10,
               "bayer": launches_bayer, "bayer_rgb": launches_bayer_rgb,
               "gop": launches_gop,
               "stereo": launches_stereo, "api": launches_api,
               "pool": launches_pool, "outputs": launches_outputs,
               "scaled": launches_scaled, "geometry": launches_geometry,
               "encoder_inputs": launches_inputs}
    log(json.dumps({"kernels": [
        {"name": n, "route": k["route"], "source": k["source"],
         "replaces": k["replaces"],
         **{key: k[key] for key in ("also_replaces", "mode", "device_ms",
                                    "library_note", "gop") if key in k},
         "launches": sum(by[n] for by in by_path.values()),
         "launches_by_path": {path: by[n] for path, by in by_path.items()},
         "max_abs_err": k["max_abs_err"],
         "ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
         "library_ms": k["library_ms"],
         "ms_covers": k.get("ms_covers", encode_calls)}
        for n, k in kernels.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
