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
   from torch.profiler, apart from the wrapper's host path;
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
7. fails if a module of the JAX package was imported.

It uses one card: where more are visible it keeps the first.  It imports
only the port, `cineform_tpu_torch`.
Its last lines are the card (`nvidia-smi`), a JSON line of the kernels,
and `{"ok": true, "device": {...}}`.  Any failure exits non-zero.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
import statistics
import subprocess
import sys
import tempfile
import time

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
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden", "samples")
# BENCH_r05.json's content figures for this batch (1080p, batch 8,
# quality 4, cap_bits 8): the codec is integer, so the port repeats them
OVERFLOWED_BANDS, PSNR_DB, RATIO = 57, 47.26, 2.93
# the card's published peaks (H100 SXM data sheet, at 700 W): memory, and
# float32 outside the tensor cores, the nearest listed rate for the kernels'
# 32-bit integer operations
PEAK_BYTES_PER_S, PEAK_OPS_PER_S = 3.35e12, 67e12


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


def device_ms(torch, fn, tmp_dir: str, reps: int = 5) -> float:
    """Mean device milliseconds of one call of `fn`: the durations of the
    kernels, memsets and copies it ran, from torch.profiler over `reps`
    calls after a warm-up, without the host path around them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=tmp_dir) as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return sum(e["dur"] for e in events if e.get("cat") in (
        "kernel", "gpu_memset", "gpu_memcpy")) / 1e3 / reps


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


def golden(ext: str, name: str = GOLDEN) -> bytes:
    with open(os.path.join(GOLDEN_DIR, f"{name}.{ext}"), "rb") as f:
        return f.read()


def raw_fill(nbytes: int, pattern: int) -> bytes:
    """The reference probe's xorshift32 fill of a raw frame
    (tools/probe_sample.c do_encode_raw), the content of raw_RG64.cfhd."""
    out = np.empty(nbytes // 4, dtype="<u4")
    x = 0x77777 + pattern
    for i in range(len(out)):
        x ^= (x << 13) & 0xFFFFFFFF
        x ^= x >> 17
        x ^= (x << 5) & 0xFFFFFFFF
        out[i] = x
    return out.tobytes()


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

    from cineform_tpu_torch import _build
    from cineform_tpu_torch.entropy import device as edev
    from cineform_tpu_torch.entropy import device_decode as ddec
    from cineform_tpu_torch.models.intra import IntraCodec, sample_metadata
    from cineform_tpu_torch.ops import intra_transform as ops
    from cineform_tpu_torch.ops.chunk_pack import chunk_pack
    from cineform_tpu_torch.ops import dwt_forward as dwt
    from cineform_tpu_torch.ops.dwt_forward import (
        dwt_forward_groups, dwt_forward_level, dwt_forward_planes,
        dwt_forward_yuy2)
    from cineform_tpu_torch.ops import merge_network as merges
    from cineform_tpu_torch.ops.merge_network import (
        merge_network, merge_network_highfirst, merge_network_tgt)
    from cineform_tpu_torch.testframes import (b64a_frame, rg48_frame,
                                               yuy2_frame)

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
    # paths: the main paths that launch the kernel, YUY2 and the RGB
    # formats'
    kernels = {
        "dwt_forward_yuy2": dict(
            wrapper=dwt_forward_yuy2, route="cuda", source=dwt_src,
            replaces="cineform_tpu/ops/pallas_dwt2.py:99",
            also_replaces="cineform_tpu/ops/pallas_dwt.py:151",
            mode="level 1 from the YUY2 bytes (the unpack fused), Y, V, U "
                 "in one launch, bands in the entropy coder's layout",
            ops_per_elem=40, paths=("yuy2",), library_note=dwt_library),
        "dwt_forward_groups": dict(
            wrapper=dwt_forward_groups, route="cuda", source=dwt_src,
            replaces="cineform_tpu/ops/pallas_dwt2.py:99",
            also_replaces="cineform_tpu/ops/pallas_dwt.py:151",
            mode="levels 2 and 3, Y, V, U in one launch a level, bands in "
                 "the entropy coder's layout", ops_per_elem=40,
            paths=("yuy2",), library_note=dwt_library),
        "dwt_forward_planes": dict(
            wrapper=dwt_forward_planes, route="cuda", source=dwt_src,
            replaces="cineform_tpu/ops/pallas_dwt2.py:99",
            also_replaces="cineform_tpu/ops/pallas_dwt.py:151",
            mode="every level of the RGB formats: the 3 (RGB) or 4 (RGBA) "
                 "full-width int32 planes in one launch a level, level 1 "
                 "from the planes the plain unpack builds, bands in the "
                 "entropy coder's layout", ops_per_elem=40, paths=("rgb",),
            library_note=dwt_library,
            ms_covers=f"the 3 levels of one batch-{BATCH} 1080p RG48 "
                      "encode"),
        "chunk_pack": dict(
            wrapper=chunk_pack, route="cuda",
            source="cineform_tpu_torch/csrc/chunk_pack.cu",
            replaces="cineform_tpu/ops/pallas_pack.py:135",
            ops_per_elem=8 * 16, paths=("yuy2", "rgb")),
        "merge_network": dict(
            wrapper=merge_network, route="cuda", source=merge_src,
            replaces=merge_tpu,
            mode="low-bit-first (encoder concat): guarded OR placement, "
                 "network on flagged rows", ops_per_elem=20,
            paths=("yuy2", "rgb")),
        "merge_network_tgt": dict(
            wrapper=merge_network_tgt, route="cuda", source=merge_src,
            replaces=merge_tpu,
            also_replaces="cineform_tpu/entropy/device_decode.py:435",
            mode="low-bit-first with tgt merged by max (decoder "
                 "compact_rows): guarded one-pass placement, network on "
                 "flagged rows", ms_covers=decode_calls, ops_per_elem=16,
            paths=("yuy2", "rgb")),
        "merge_network_highfirst": dict(
            wrapper=merge_network_highfirst, route="cuda", source=merge_src,
            replaces=merge_tpu,
            mode="high-bit-first (decoder spread_rows, on mirrored rows): "
                 "guarded one-pass placement, network on flagged rows",
            ms_covers=decode_calls, ops_per_elem=12, paths=("yuy2", "rgb")),
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
                tally=True, timed=True, device=False):
        """Kernel against plain version on `inputs`, both timed unless not
        `timed`; the bound counts each input read and each output written
        once, and `ops` (default: the kernel's ops per input element).
        With `tally`, the times and the bound add to the kernel's line.
        The device time (torch.profiler) is taken for the kernels that
        report one, and for any with `device`."""
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
        if "device_ms" in k or device:
            dms = device_ms(torch, call, _build.BUILD_DIR)
            extra += (f", device {dms:.4f} ms (the bound is "
                      f"{100 * bound / dms:.1f}% of it)")
            if tally and "device_ms" in k:
                k["device_ms"] += dms
                k["bytes"] += moved
        if library is not None:
            lib_ms = cuda_ms(torch, library)
            k["library_ms"] = (k["library_ms"] or 0.0) + lib_ms
            extra += f", library call {lib_ms:.4f} ms"
        log(f"  {name} {what}: max_abs_err {err}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms{extra}")
        if err:
            raise AssertionError(f"{name} {what}: kernel disagrees with its "
                                 f"plain version (max abs err {err})")
        return got

    log(f"kernel checks, batch {BATCH} at {WIDTH}x{HEIGHT} q4 "
        "(tolerance 0; times are CUDA-event medians of 5, device times "
        "torch.profiler means of 5)")

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
            f"device {k['device_ms']:.4f} ms (profiler), bound "
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
            what = (f"class {ci} (level {lev + 1}, planes {planes}), payload "
                    f"{tuple(pay.shape)}")
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
    for k in kernels.values():
        k["wrapper"].launches = 0
    dwt_forward_level.launches = 0
    merges.reset_counts()
    chunk_pack.tree_chunks[dev].zero_()

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
    rgb = {}
    for fmt, make in (("RG48", rg48_frame), ("B64A", b64a_frame)):
        t0 = time.perf_counter()
        c = IntraCodec(WIDTH, HEIGHT, 4, device=dev, input_format=fmt)
        rgb_base = np.frombuffer(make(WIDTH, HEIGHT, 1), np.uint8).reshape(
            HEIGHT, c.row_bytes)
        rgb[fmt] = (c, np.stack([np.roll(rgb_base, i, axis=0)
                                 for i in range(BATCH)]))
        log(f"{fmt} batch: {BATCH} frames of {make.__name__} pattern 1 "
            f"rolled one row a frame ({time.perf_counter() - t0:.3f} s)")
    del rgb_base
    log(f"kernel checks, RGB formats, batch {BATCH} at {WIDTH}x{HEIGHT} q4 "
        "(tolerance 0; RG48 timed as above, B64A checked only)")
    for fmt, (c, rgb_frames) in rgb.items():
        timed = fmt == "RG48"
        t = c.tables()
        up = c._upload(rgb_frames)
        x = torch.stack(c._unpack(up), dim=1)
        if timed:
            def unpack():
                return torch.stack(c._unpack(up), dim=1)

            unpack_bytes = nbytes((up, x))
            log(f"  plain unpack {fmt} {tuple(up.shape)} -> {tuple(x.shape)}: "
                f"device {device_ms(torch, unpack, _build.BUILD_DIR):.4f} "
                f"ms (torch.profiler), events {cuda_ms(torch, unpack):.4f} "
                f"ms; {unpack_bytes} bytes read and written, bound "
                f"{bound_ms(unpack_bytes, 0)[0]:.4f} ms")
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
                f"(profiler), bound {k['bound_ms']:.4f} ms ({k['bytes']} "
                f"bytes, {100 * k['bound_ms'] / k['device_ms']:.1f}% of the "
                "device time), 3 launches")
        encode_checks(c, levels, tally=False, timed=timed, device=timed)
        del up, x, levels, ll, highs
        decode_checks(c, c.encode_batch_device(rgb_frames), tally=False,
                      timed=timed, device=timed)

    # --- 5. the RGB formats: the main path ----------------------------------
    for k in kernels.values():
        k["wrapper"].launches = 0
    dwt_forward_level.launches = 0
    merges.reset_counts()
    chunk_pack.tree_chunks[dev].zero_()
    encodes = 0
    small = {"RG48": lambda: rg48_frame(320, 240, 1),
             "B64A": lambda: b64a_frame(320, 240, 1),
             "RG64": lambda: raw_fill(320 * 240 * 8, 1)}
    for fmt, name in RGB_ENCODE_GOLDENS:
        gold = golden("cfhd", name)
        c = IntraCodec(320, 240, 4, device=dev, input_format=fmt)
        small_frames = np.frombuffer(small[fmt](), np.uint8).reshape(
            1, 240, c.row_bytes)
        for route in (c.encode_batch_device, c.encode_batch):
            if route(small_frames, 1, sample_metadata(gold))[0] != gold:
                raise AssertionError(f"{fmt} encode ({route.__name__}) "
                                     f"differs from {name}.cfhd")
            encodes += 1
        log(f"golden encode {fmt}: encode_batch_device and encode_batch "
            f"byte-equal to {name}.cfhd ({len(gold)} bytes)")
    for fmt, name in RGB_DECODE_GOLDENS:
        sample = golden("cfhd", name)
        c = IntraCodec(320, 240, 4, device=dev, input_format=fmt)
        for output, ext in RGB_OUTPUTS:
            want = golden(ext, name)
            out = c.decode_batch([sample], output=output)
            dev_out, fallback = c.decode_batch_device([sample], output=output)
            if out.tobytes() != want or fallback \
                    or dev_out.tobytes() != want:
                raise AssertionError(f"{name} decoded to {output} differs "
                                     f"from {name}.{ext} (host fallback "
                                     f"frames of the device route "
                                     f"{fallback})")
        log(f"golden decode {name}: decode_batch and decode_batch_device "
            f"byte-equal to {name}.rg48out and {name}.b64aout")

    rgb_lines = []
    for fmt, (c, rgb_frames) in rgb.items():
        enc_dev, enc_host, dec_host, dec_dev = [], [], [], []
        for it in range(4):
            packed, ms = host_ms(torch, lambda: c.forward_packed(
                c._upload(rgb_frames)))
            enc_dev.append(ms)
            t0 = time.perf_counter()
            samples = c.write_samples(rgb_frames, packed)
            enc_host.append((time.perf_counter() - t0) * 1e3)
            encodes += 1
            if it == 0:
                first = (packed, samples)
        packed, samples = first
        host_samples = c.encode_batch(rgb_frames)
        encodes += 1
        if host_samples != samples:
            raise AssertionError(f"{fmt} batch: encode_batch_device differs "
                                 "from encode_batch")
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        for it in range(4):
            decoded, ms = host_ms(torch, lambda: c.decode_batch(samples))
            dec_host.append(ms)
            (dev_decoded, fallback), ms = host_ms(
                torch, lambda: c.decode_batch_device(samples))
            dec_dev.append(ms)
            if fallback or dev_decoded.tobytes() != decoded.tobytes():
                raise AssertionError(f"{fmt} batch: decode_batch_device "
                                     f"differs from decode_batch (host "
                                     f"fallback frames {fallback})")
        peak_bytes = torch.cuda.max_memory_allocated()
        src = rgb_frames.view("<u2").reshape(decoded.shape[0], HEIGHT,
                                              WIDTH, -1)
        out = decoded.reshape(src.shape[0], HEIGHT, WIDTH, -1)
        colour = (src, out) if fmt == "RG48" else (src[..., 1:], out[..., 1:])
        mse = np.mean((colour[0].astype(np.float64) - colour[1]) ** 2)
        overflowed = sum(int(o.sum()) for _, levels in packed
                         for _, _, o, _ in levels)
        ratio = rgb_frames.nbytes / sum(len(x) for x in samples)
        med3 = [statistics.median(v[1:]) / BATCH
                for v in (enc_dev, enc_host, dec_host, dec_dev)]
        if decoded.shape != (BATCH, HEIGHT, WIDTH * out.shape[-1]) \
                or decoded.dtype != np.uint16 or not mse > 0:
            raise AssertionError(f"{fmt} batch decoded to {decoded.shape} "
                                 f"{decoded.dtype}, mse {mse}")
        rgb_lines += [
            f"{fmt} batch {BATCH} at {WIDTH}x{HEIGHT} q4: device encode "
            f"byte-equal to encode_batch; {overflowed} of "
            f"{BATCH * c.num_channels * 9} bands overflowed at cap_bits 8; "
            f"ratio {ratio:.4f} (sample bytes); round-trip PSNR of the "
            f"colour channels {10 * np.log10(65535.0 ** 2 / mse):.4f} dB "
            f"(16-bit peak); decode_batch_device equal to decode_batch on "
            f"all {BATCH} frames, 0 fallback frames",
            f"{fmt} per frame, medians of 3 batches after a warm-up: encode "
            f"device {med3[0]:.4f} ms (upload + unpack + transform + entropy "
            f"pack), encode host tail {med3[1]:.4f} ms (fetch, band-end, "
            f"overflow re-encode, sample write); decode_batch "
            f"{med3[2]:.4f} ms (parse + C++ entropy decode + upload + "
            f"inverse + download), decode_batch_device {med3[3]:.4f} ms; "
            f"peak device memory over the 8 decodes {peak_bytes} bytes "
            f"({peak_bytes / 2**30:.3f} GiB; {base_bytes} allocated before)"]
        del first, packed, samples, host_samples, decoded, dev_decoded
    launches_rgb = {n: k["wrapper"].launches for n, k in kernels.items()}
    rgb_path = [n for n, k in kernels.items() if "rgb" in k["paths"]]
    if not all(launches_rgb[n] for n in rgb_path):
        raise AssertionError(f"a kernel was not launched by the RGB path: "
                             f"{launches_rgb}")
    if (launches_rgb["dwt_forward_planes"], launches_rgb["dwt_forward_yuy2"],
            launches_rgb["dwt_forward_groups"], dwt_forward_level.launches) \
            != (3 * encodes, 0, 0, 0):
        raise AssertionError(f"the RGB path's {encodes} encodes launched "
                             f"{launches_rgb} and the single-plane level "
                             f"{dwt_forward_level.launches}: expected 3 "
                             "launches of dwt_forward_planes an encode, none "
                             "of the YUY2 entry points")
    for line in rgb_lines:
        log(line)
    log(f"launches during the RGB path ({encodes} encodes): {launches_rgb}")
    log("merge forms during the RGB path: " + "; ".join(
        f"{w.__name__} branch launches {dict(w.branch_launches)}, rows that "
        f"failed the guard {int(w.flagged[dev].item())}"
        for w in (merge_network, merge_network_tgt, merge_network_highfirst)))
    log(f"chunk_pack during the RGB path: "
        f"{int(chunk_pack.tree_chunks[dev].item())} chunks took the tree "
        "path")

    jax_modules = sorted(m for m in sys.modules
                         if m.split(".")[0] in ("cineform_tpu", "jax"))
    if jax_modules:
        raise AssertionError(f"modules of the JAX package were imported: "
                             f"{jax_modules[:10]}")
    log("sys.modules holds no module of cineform_tpu or jax")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    log(json.dumps({"kernels": [
        {"name": n, "route": k["route"], "source": k["source"],
         "replaces": k["replaces"],
         **{key: k[key] for key in ("also_replaces", "mode", "device_ms",
                                    "library_note") if key in k},
         "launches": launches[n] + launches_rgb[n],
         "launches_by_path": {"yuy2": launches[n], "rgb": launches_rgb[n]},
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
