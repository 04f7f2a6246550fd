"""The reference Lanczos scaler's coefficients, on the host.

A copy of the pieces of the JAX package's `ref/scaler.py` that the port's
scaled decode needs: the coefficient generator `lanczos_coeff`
(`_LanczosCoeff`, ConvertLib/ImageScaler.cpp:236-489), whose float32 and
float64 mix must stay bit-identical to the reference, the row and column
factor wrappers and `decoded_scale`.  `tap_table` lays one (input, output)
pair's taps out as the padded tables the device scaler (`ops.scaler`)
gathers with.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

_PI = 3.1415926535  # ImageScaler.h:29 — truncated constant, not math.pi


def _f32(v) -> float:
    """Round a value through IEEE binary32 (C float store)."""
    return float(np.float32(v))


def lanczos_coeff(inputsize: int, outputsize: int, line: int,
                  changefielddominance: bool = False,
                  interlaced: bool = False, ilobes: int = 3):
    """Lanczos coefficients for one output line: list of (srcline, mixval).

    Exact mirror of _LanczosCoeff; mixvals are 8.8 fixed point summing
    to 256 (the largest tap absorbs any rounding residue).
    """
    lobes = _f32(ilobes)
    inputsizefield = inputsize

    if outputsize >= inputsize:
        # Upscale branch (ImageScaler.cpp:245-356).
        inv_step = _f32(np.float32(inputsize) / np.float32(outputsize))
        dst_pos = _f32(line)
        if interlaced:
            dst_pos = _f32(np.float32(dst_pos) / np.float32(2.0))
            if changefielddominance:
                if not (line & 1):
                    dst_pos = _f32(np.float32(dst_pos)
                                   - np.float32(inv_step) * np.float32(0.5))
            else:
                if line & 1:
                    dst_pos = _f32(np.float32(dst_pos)
                                   - np.float32(inv_step) * np.float32(0.5))
            inputsizefield >>= 1

        src_1st = _f32(np.float32(inv_step)
                       * (np.float32(dst_pos) - np.float32(lobes)))
        src_1st_whole = _f32(math.floor(src_1st))
        if src_1st > 0:
            dst_offset = _f32(np.float32(src_1st) - np.float32(src_1st_whole))
        else:
            dst_offset = _f32(abs(np.float32(src_1st_whole)
                                  - np.float32(src_1st)))

        x0 = _f32((np.float32(dst_pos) - np.float32(lobes))
                  - np.float32(dst_offset))
        bound = _f32(np.float32(dst_pos) + np.float32(lobes))
        step = 1.0
        scaleinput = 1
    else:
        # Downscale branch (ImageScaler.cpp:357-489).  Extreme ratios are
        # first reduced by powers of two (srclines multiplied back at the
        # end).
        scaleinput = 1
        while inputsize // outputsize > 4:
            scaleinput *= 2
            inputsize //= 2
            inputsizefield //= 2

        stepf = _f32(np.float32(outputsize) / np.float32(inputsize))
        inv_step = _f32(np.float32(inputsize) / np.float32(outputsize))
        dst_pos = _f32(line)
        if interlaced:
            dst_pos = _f32(np.float32(dst_pos) / np.float32(2.0))
            if changefielddominance:
                if not (line & 1):
                    dst_pos = _f32(np.float32(dst_pos)
                                   - np.float32(stepf) * np.float32(0.5))
            else:
                if line & 1:
                    dst_pos = _f32(np.float32(dst_pos)
                                   - np.float32(stepf) * np.float32(0.5))
            inputsizefield >>= 1

        src_1st = _f32(np.float32(inv_step)
                       * (np.float32(dst_pos) - np.float32(lobes)))
        src_1st_whole = _f32(math.floor(src_1st))
        if src_1st > 0:
            dst_offset = _f32((np.float32(src_1st) - np.float32(src_1st_whole))
                              * np.float32(stepf))
        else:
            dst_offset = _f32(abs(np.float32(src_1st_whole)
                                  - np.float32(src_1st)) * np.float32(stepf))

        x0 = _f32((np.float32(dst_pos) - np.float32(lobes))
                  - np.float32(dst_offset))
        bound = _f32(np.float32(dst_pos) + np.float32(lobes))
        step = stepf

    upscale = outputsize >= inputsize

    # First pass: accumulate the (double) normalisation t and the float
    # sinc values in iteration order.
    t = 0.0
    sincxval = []
    x = x0
    while x < bound:
        sincx = _f32(x - dst_pos)
        if -lobes <= sincx <= lobes:
            if sincx == 0.0:
                y = 1.0
            else:
                y = ((math.sin(sincx * _PI) / (sincx * _PI))
                     * (math.sin(sincx * _PI / lobes) / (sincx * _PI / lobes)))
            if upscale:
                srcline = int(math.floor(
                    _f32(np.float32(np.float32(dst_pos) * np.float32(inv_step))
                         + np.float32(sincx)) + 0.5))
            else:
                srcline = int(math.floor(x * inv_step + 0.5))
            if 0 <= srcline < inputsizefield:
                t += y
                sincxval.append(_f32(y))
        x += step

    # Second pass: quantise to 8.8 fixed point.
    samples = []
    tt = 0
    pos = 0
    x = x0
    while x < bound:
        sincx = _f32(x - dst_pos)
        if -lobes <= sincx <= lobes:
            if upscale:
                srcline = int(math.floor(
                    _f32(np.float32(np.float32(dst_pos) * np.float32(inv_step))
                         + np.float32(sincx)) + 0.5))
            else:
                srcline = int(math.floor(x * inv_step + 0.5))
            if 0 <= srcline < inputsizefield:
                y = (sincxval[pos] * 256.0) / t
                pos += 1
                if y > 0.5:
                    y += 0.5
                else:
                    y -= 0.5
                val = int(y)  # C cast: truncation toward zero
                if val != 0:
                    samples.append([srcline, val])
                tt += val
        x += step

    # Residue correction: the largest tap absorbs 256-tt.
    if tt != 256 and samples:
        maxpos = 0
        maxval = 0
        for j, (_, mix) in enumerate(samples):
            if mix > maxval:
                maxval = mix
                maxpos = j
        samples[maxpos][1] += 256 - tt

    if scaleinput > 1:
        for s in samples:
            s[0] *= scaleinput

    if interlaced and upscale:
        # ComputeColumnScaleFactors doubles srclines for field rendering.
        pass

    return [(s[0], s[1]) for s in samples]


def row_scale_factors(input_width: int, output_width: int, lobes: int = 3):
    """Per-destination-column taps: {dstx: [(srcx, mixval), ...]}."""
    return {x: lanczos_coeff(input_width, output_width, x, False, False, lobes)
            for x in range(output_width)}


def column_scale_factors(row: int, input_height: int, output_height: int,
                         render_field_type: int = 0, lobes: int = 3):
    """Column taps for one output row (empty when heights match)."""
    if input_height == output_height:
        return []
    if render_field_type == 0:
        return lanczos_coeff(input_height, output_height, row,
                             False, False, lobes)
    taps = lanczos_coeff(input_height, output_height, row, False, True, lobes)
    return [(s * 2 + (row & 1), m) for s, m in taps]


@lru_cache(maxsize=None)
def _host_table(inputsize: int, outputsize: int, lobes: int):
    taps = [lanczos_coeff(inputsize, outputsize, line, False, False, lobes)
            for line in range(outputsize)]
    width = max(1, max(len(t) for t in taps))
    index = np.zeros((outputsize, width), np.int64)
    mix = np.zeros((outputsize, width), np.int64)
    for line, t in enumerate(taps):
        for j, (src, m) in enumerate(t):
            index[line, j] = src
            mix[line, j] = m
    return index, mix


#: the largest 8.8 mix sum of absolute values for which every partial sum
#: of 16-bit values fits int32
_INT32_MIX = (2 ** 31 - 1) // 65535


@lru_cache(maxsize=None)
def tap_table(inputsize: int, outputsize: int, lobes: int,
              device: torch.device):
    """The taps of every output line of an `inputsize` -> `outputsize`
    scale (`lanczos_coeff`, progressive) as padded (outputsize, T) tables
    on `device`: source indices (int64) and 8.8 mixes, the padding index 0
    with mix 0.  The mixes are int32 where 65535 times a line's sum of
    absolute mixes fits int32 (so does every partial sum of a mix of
    16-bit values), int64 otherwise.  Built once a size and device."""
    index, mix = _host_table(inputsize, outputsize, lobes)
    fits = int(np.abs(mix).sum(axis=1).max()) <= _INT32_MIX
    return (torch.from_numpy(index).to(device),
            torch.from_numpy(mix.astype(np.int32 if fits else np.int64))
            .to(device))


def decoded_scale(input_width: int, input_height: int,
                  output_width: int, output_height: int):
    """DecodedScale (Codec/decoder.c:17437): pick the smallest half-step
    decode resolution still >= the output size (at most quarter)."""
    dw, dh = input_width, input_height
    output_height = abs(output_height)
    reduction = 0
    while dw > output_width and dh > output_height and reduction < 2:
        rw, rh = dw // 2, dh // 2
        if rw >= output_width and rh >= output_height:
            dw, dh = rw, rh
            reduction += 1
        else:
            break
    return dw, dh
