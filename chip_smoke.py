#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`cineform_tpu_torch`) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
(sm_90a) and the CUDA toolkit.  It

1. builds the three CUDA kernels from `cineform_tpu_torch/csrc/`;
2. holds each kernel against its plain PyTorch version, on the card, at
   the shapes of a batch-8 1080p encode (every forward DWT level of luma
   and chroma; every chunk_pack and merge_network call of the band
   groups, one frame being seeded noise so that chunks overflow), and
   times both with CUDA events;
3. drives the main path through `IntraCodec`: the 1080p golden sample
   (`tests/golden/samples/s_1920x1080_q6_p1`) encoded and decoded byte for
   byte, then a batch of 8 1080p frames at quality 4 (the content of
   `bench.py`) encoded and decoded, with the round-trip PSNR, the
   compression ratio, the overflowed band count and the per-frame times;
4. fails unless every kernel was launched by that main-path run;
5. holds frames 0 and 7 of the batch, encoded and decoded, against the
   port's own plain path on the CPU (the plain PyTorch versions of the
   kernels), byte for byte, and the batch's overflow count, PSNR and ratio
   against the content figures of BENCH_r05.json.

It uses one card: where more are visible it keeps the first.  It imports
only the port, `cineform_tpu_torch`.
Its last lines are the card (`nvidia-smi`), a JSON line of the kernels,
and `{"ok": true, "device": {...}}`.  Any failure exits non-zero.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1920, 1080
BATCH = 8
GOLDEN, GOLDEN_QUALITY = "s_1920x1080_q6_p1", 6   # yuy2_frame pattern 1
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden", "samples")
# BENCH_r05.json's content figures for this batch (1080p, batch 8,
# quality 4, cap_bits 8): the codec is integer, so the port repeats them
OVERFLOWED_BANDS, PSNR_DB, RATIO = 57, 47.26, 2.93


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


def golden(ext: str) -> bytes:
    with open(os.path.join(GOLDEN_DIR, f"{GOLDEN}.{ext}"), "rb") as f:
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

    from cineform_tpu_torch import _build
    from cineform_tpu_torch.entropy import device as edev
    from cineform_tpu_torch.models.intra import IntraCodec, sample_metadata
    from cineform_tpu_torch.ops import intra_transform as ops
    from cineform_tpu_torch.ops.chunk_pack import chunk_pack
    from cineform_tpu_torch.ops.dwt_forward import dwt_forward_level
    from cineform_tpu_torch.ops.merge_network import merge_network
    from cineform_tpu_torch.testframes import yuy2_frame

    if torch.cuda.device_count() != 1:
        raise AssertionError(f"expected one visible card, found "
                             f"{torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    # --- 1. build -------------------------------------------------------------
    kernels = {
        "dwt_forward_level": dict(
            wrapper=dwt_forward_level, route="cuda",
            source="cineform_tpu_torch/csrc/dwt_forward.cu",
            replaces="cineform_tpu/ops/pallas_dwt2.py:99",
            also_replaces="cineform_tpu/ops/pallas_dwt.py:151"),
        "chunk_pack": dict(
            wrapper=chunk_pack, route="cuda",
            source="cineform_tpu_torch/csrc/chunk_pack.cu",
            replaces="cineform_tpu/ops/pallas_pack.py:135"),
        "merge_network": dict(
            wrapper=merge_network, route="cuda",
            source="cineform_tpu_torch/csrc/merge_network.cu",
            replaces="cineform_tpu/ops/pallas_merge.py:88"),
    }
    t0 = time.perf_counter()
    for name, k in kernels.items():
        src = os.path.splitext(os.path.basename(k["source"]))[0]
        path = _build.library_path(src)
        with open(path + ".log") as f:
            ptxas = " | ".join(line.strip() for line in f
                               if "registers" in line or "spill" in line)
        log(f"built {name}: {os.path.relpath(path, ROOT)}; ptxas: {ptxas}")
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
        k.update(max_abs_err=0, ms=0.0, plain_ms=0.0)

    def compare(name, call, plain, what):
        got, want = call(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        ms, plain_ms = cuda_ms(torch, call), cuda_ms(torch, plain)
        k = kernels[name]
        k["max_abs_err"] = max(k["max_abs_err"], err)
        k["ms"] += ms
        k["plain_ms"] += plain_ms
        log(f"  {name} {what}: max_abs_err {err}, kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
        if err:
            raise AssertionError(f"{name} {what}: kernel disagrees with its "
                                 f"plain version (max abs err {err})")
        return got

    log(f"kernel checks, batch {BATCH} at {WIDTH}x{HEIGHT} q4 "
        "(tolerance 0; times are CUDA-event medians of 5)")
    x = codec._upload(check)
    coeffs = []
    for ch, plane in enumerate(ops.unpack_yuy2(x, codec.params.precision)):
        ll, bands = plane.contiguous(), []
        for lev in range(3):
            ps, q = tables.prescale[lev], tables.band_quant[ch][lev]

            def level(fn):
                low, highs = fn(ll, ps, q)
                return (low, *highs)

            out = compare("dwt_forward_level", lambda: level(dwt_forward_level),
                          lambda: level(ops.dwt2d_forward),
                          f"ch{ch} level {lev + 1} {tuple(ll.shape)} "
                          f"prescale {ps} quant {q}")
            ll, bands = out[0], bands + [out[1:]]
        coeffs.append((ll, bands))

    codes = edev.encode_tables(17)
    any_chunk_ovf = False
    for lev in range(3):
        for grp in codec._band_groups(coeffs):
            bits, sizes = edev.chunk_codes(
                codec.group_bands(coeffs, lev, grp), codes)
            packed = compare(
                "chunk_pack", lambda: chunk_pack(bits, sizes),
                lambda: edev.tree_pack(bits, sizes, cap_bits_per_elem=12),
                f"level {lev + 1} channels {grp} {tuple(bits.shape)}")
            any_chunk_ovf |= bool(packed[2].any())
            val, rem, _ = edev._concat_slots(packed[0], packed[1])
            compare("merge_network", lambda: merge_network(val, rem),
                    lambda: edev._settle_network(val, rem),
                    f"level {lev + 1} channels {grp} {tuple(val.shape)}")
    if not any_chunk_ovf:
        raise AssertionError("no chunk overflowed: the overflow path of "
                             "chunk_pack was not checked")
    del x, coeffs, bits, sizes, packed, val, rem

    # --- 3. the main path -------------------------------------------------------
    for k in kernels.values():
        k["wrapper"].launches = 0

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
    overflowed = sum(int(o.sum()) for _, levels in packed
                     for _, _, o in levels)
    nbands = BATCH * 3 * 9
    nbits = sum(int(n.sum()) for _, levels in packed for _, n, _ in levels)
    lowpass_bytes = sum(2 * (HEIGHT >> 3) * ((WIDTH if c == 0 else WIDTH // 2)
                                             >> 3) for c in range(3))
    bench_ratio = (2 * WIDTH * HEIGHT) / (nbits / BATCH / 8 + lowpass_bytes
                                         + 1024)
    sample_ratio = BATCH * 2 * WIDTH * HEIGHT / sum(len(s) for s in samples)
    rt_psnr = psnr(decoded, frames)
    rose = {n: k["wrapper"].launches - before[n] for n, k in kernels.items()}
    launches = {n: k["wrapper"].launches for n, k in kernels.items()}
    if not all(rose.values()) or not all(launches.values()):
        raise AssertionError(f"a kernel was not launched by the main path: "
                             f"{launches} (batch phase {rose})")

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
    log(f"launches during the main path: {launches} (batch phase {rose})")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    log(json.dumps({"kernels": [
        {"name": n, "route": k["route"], "source": k["source"],
         "replaces": k["replaces"],
         **({"also_replaces": k["also_replaces"]}
            if "also_replaces" in k else {}),
         "launches": launches[n], "max_abs_err": k["max_abs_err"],
         "ms": k["ms"], "plain_ms": k["plain_ms"],
         "ms_covers": f"every call of one batch-{BATCH} 1080p encode"}
        for n, k in kernels.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
