"""The Bayer decode's host tables and develop matrix, on the host.

Copies of the pieces of the JAX package's `ref/demosaic.py` that the
port's Bayer outputs need: the BYR4 decode's log-to-linear table, the 1D
develop's curve tables (float32 on the host, as the reference builds
them), the develop matrix composition, the YUY2 output's row parity and
its RGB->YUV coefficients; and the develop stages' tables: the gamma and
contrast tweak table, the BLSH sharpening weights and coefficients, the
built-in Protune look, and the functions that build the LOOK RawCube and
test its separability.  `vignette_geometry` builds the vignette's
per-pixel factors from the reference model's own float32 arithmetic.
The device stages that use them are in `ops.demosaic`.
"""

from __future__ import annotations

import numpy as np

from cineform_tpu_torch.ref.intra import byr4_log90_curve

#: the LOG-90 curve's base, the one curve the decoder's tables take
CURVE_BASE = 90.0


def log2lin_lut() -> np.ndarray:
    """BYR4LinearRestore: 16384-entry log-to-linear LUT of the LOG-90
    curve (decoder.c:10742-10785 with CURVE_LOG2LIN's float truncation)."""
    j = np.arange(16384, dtype=np.float64)
    i32 = (j.astype(np.float32) / np.float32(16384.0)).astype(np.float64)
    lin = (np.power(CURVE_BASE, i32) - 1.0) / (CURVE_BASE - 1.0)
    val = (lin.astype(np.float32) * np.float32(65535.0)).astype(np.float32)
    return np.clip(np.trunc(val).astype(np.int64), 0, 65535).astype(np.uint16)


def curve2linear_lut() -> np.ndarray:
    """decoder->Curve2Linear (Build1DCurves2Linear, bayer.c:5196-5262):
    49152-entry signed 13-bit curve-to-linear table over [-2, +4)."""
    k = np.arange(-16384, 32768, dtype=np.float64)
    i32 = (k.astype(np.float32) / np.float32(8192.0)).astype(np.float64)
    lin = (np.power(CURVE_BASE, i32) - 1.0) / (CURVE_BASE - 1.0)
    val = (lin.astype(np.float32) * np.float32(8192.0)).astype(np.float32)
    return np.clip(np.trunc(val).astype(np.int64), -16384, 32767)


def linear2curve_lut() -> np.ndarray:
    """decoder->Linear2CurveRed (Build1DLinear2Curves, bayer.c:5289-5527,
    cg-unity branch): 65536-entry signed 13-bit linear-to-curve table
    over [-2, +6)."""
    j = np.arange(65536, dtype=np.float64)
    intensity = (j - 16384.0).astype(np.float32)
    x = (intensity / np.float32(8192.0)).astype(np.float64)
    x = x.astype(np.float32).astype(np.float64)
    b = CURVE_BASE
    pos = np.log10(np.maximum(x, 0) * (b - 1.0) + 1.0) / np.log10(b)
    neg = -np.log10(np.maximum(-x, 0) * (b - 1.0) + 1.0) / np.log10(b)
    cur = np.where(x >= 0.0, pos, neg).astype(np.float32)
    val = (cur * np.float32(8192.0)).astype(np.float32)
    return np.clip(np.trunc(val).astype(np.int64), -16384, 32767)


def normalize_white_balance(wb) -> np.ndarray:
    """The reference's white-balance conditioning (bayer.c:4395-4427):
    floor gains at 0.4 and cap at 10.0 (the renormalize-below-1.0 block
    is compiled out with `#if 0`)."""
    wb = np.maximum(np.asarray(wb, np.float64)[:3], 0.4)
    return np.minimum(wb, 10.0)


def compose_develop_matrix(colm=None, saturation: float = 1.0,
                           exposure: float = 1.0, wb=None) -> np.ndarray:
    """NeedCube's linear matrix composition (bayer.c:4431-4530), float32:

    - start from COLM (use_base_matrix defaults to the custom matrix) or
      identity
    - saturation blends toward the desat / fullsat matrices
      (sat = SATU payload; <1 desaturates, >1 amplifies via
      ((sat-1)/3)*fullsat + ((4-sat)/3)*m)
    - exposure scales every column
    - white balance scales column j by wb[j] and the offset of row j by
      wb[j]
    """
    m = np.eye(3, 4, dtype=np.float32) if colm is None else \
        np.asarray(colm, np.float32).reshape(3, 4).copy()
    sat = np.float32(saturation)
    if sat != np.float32(1.0):
        desat = np.array([[0.309, 0.609, 0.082]] * 3, np.float32)
        fullsat = np.array([[4.042, -2.681, -0.361],
                            [-1.358, 2.719, -0.361],
                            [-1.358, -2.681, 5.039]], np.float32)
        if sat < 1.0:
            m[:, :3] = ((np.float32(1.0) - sat) * desat
                        + sat * m[:, :3]).astype(np.float32)
        else:
            m[:, :3] = (((sat - np.float32(1.0)) / np.float32(3.0)) * fullsat
                        + ((np.float32(4.0) - sat) / np.float32(3.0))
                        * m[:, :3]).astype(np.float32)
    exp = np.float32(exposure)
    if exp != np.float32(1.0):
        m = (m * exp).astype(np.float32)
    if wb is not None:
        wbn = normalize_white_balance(wb).astype(np.float32)
        m[:, :3] = (m[:, :3] * wbn[None, :]).astype(np.float32)
        m[:, 3] = (m[:, 3] * wbn).astype(np.float32)
    return m.astype(np.float64)


# RGB -> YUV coefficient tables (bayer.c:446-469), 1.15 fixed point
_RGB2YUV_709 = ((0.183, 0.614, 0.062), (-0.101, -0.338, 0.439),
                (0.439, -0.399, -0.040))
_RGB2YUV_VS709 = ((0.213, 0.715, 0.072), (-0.117, -0.394, 0.511),
                  (0.511, -0.464, -0.047))


def bayer_yuyv_parity(height: int) -> np.ndarray:
    """Output-row dither parity for the Bayer YUY2 path: DemosaicRAW
    calls ConvertLinesToOutput(width*2, 2, y) once per MOSAIC row, so
    output row t uses lines = y + (t & 1) -> parity (t//2 + t%2) & 1."""
    t = np.arange(height)
    return ((t // 2) + (t & 1)) & 1


def log90_inverse_lut() -> np.ndarray:
    """The inverse of the LOG-90 encode curve on 12-bit values, as the JAX
    package's `intra_host.decode_sample_bayer` builds it: for each 12-bit
    curve value the largest 12-bit linear value that maps to it."""
    curve = byr4_log90_curve()
    inv = np.zeros(4096, np.int64)
    np.maximum.at(inv, np.clip(curve, 0, 4095), np.arange(1 << 14) >> 2)
    return inv


def gamma_contrast_lut(gamma: float = 1.0,
                       contrast: float = 1.0) -> np.ndarray:
    """decoder->GammaContrastRed/Grn/Blu (Build1DLinear2Curves cg branch,
    bayer.c:5322-5345): 65536-entry signed 13-bit gamma tweak table —
    lin2gam (exponent 1.0/(double)(float)g, linear negative extension),
    then calc_contrast when contrast != 1, *8192 float truncation."""
    gf = float(np.float32(gamma))
    j = np.arange(65536, dtype=np.float64)
    intensity = (j - 16384.0).astype(np.float32)
    x = (intensity / np.float32(8192.0)).astype(np.float64)
    exponent = np.float64(np.float32(1.0 / gf))
    v = np.where(x >= 0, np.power(np.maximum(x, 0), exponent),
                 x * 100.0 * np.power(0.01, exponent)).astype(np.float32)
    if contrast != 1.0:
        v = _calc_contrast(v, contrast)
    val = (v.astype(np.float32) * np.float32(8192.0)).astype(np.float32)
    return np.clip(np.trunc(val).astype(np.int64), -16384, 32767)


def _sharpen_wp13_weights(sharpness: float) -> tuple[int, np.ndarray]:
    """Per-row FIR size and weights for FastSharpeningBlurVWP13 at full
    resolution, mono (taps=5, BLEND_NONE; `Codec/DemoasicFrames.cpp:1361`).

    Returns (FIRsize, weights) where weights spans the FIR symmetrically:
    FIRsize 5 -> [af, bf, cf, bf, af] over rows (y-2, y-1, y, y+1, y+2);
    FIRsize 7 -> [af, bf*5.., af]; FIRsize 9 -> [af, bf*7.., af].  All
    arithmetic float32, matching the C expressions exactly."""
    f32 = np.float32
    s = f32(sharpness)
    if s >= 0:
        s5 = s * f32(5.0)
        diff = f32(s5 - f32(int(s5)))
        adiff = f32(f32(1.0) - diff)
        table = {
            0: (f32(0.000) * adiff - f32(0.0625) * diff,
                f32(0.000) * adiff + f32(0.2500) * diff,
                f32(1.000) * adiff + f32(0.6250) * diff),
            1: (f32(-0.0625) * adiff - f32(0.1250) * diff,
                f32(0.2500) * adiff + f32(0.2500) * diff,
                f32(0.6250) * adiff + f32(0.7500) * diff),
            2: (f32(-0.1250) * adiff - f32(0.2500) * diff,
                f32(0.2500) * adiff + f32(0.2500) * diff,
                f32(0.7500) * adiff + f32(1.0000) * diff),
            3: (f32(-0.2500) * adiff - f32(0.5000) * diff,
                f32(0.2500) * adiff + f32(0.5000) * diff,
                f32(1.0000) * adiff + f32(1.0000) * diff),
            4: (f32(-0.5000) * adiff - f32(0.5000) * diff,
                f32(0.5000) * adiff + f32(0.0000) * diff,
                f32(1.0000) * adiff + f32(2.0000) * diff),
            5: (f32(-0.5000), f32(0.0000), f32(2.0000)),
        }
        af, bf, cf = table[min(int(s5), 5)]
        return 5, np.array([af, bf, cf, bf, af], f32)
    # blur branch (sharpness < 0), taps == 5
    s4 = -s * f32(4.0)
    case = -1 + int(s * f32(4.0))
    diff = f32(s4 - f32(int(s4)))
    adiff = f32(f32(1.0) - diff)
    if case <= -4:  # FIRsize 9 (case -5 sets diff=1 and falls through)
        if case == -5:
            diff = f32(1.0)
        af = f32(f32(1.0) / f32(9.0) * diff)
        bf = f32((f32(1.0) - af * f32(2.0)) / f32(7.0))
        return 9, np.array([af] + [bf] * 7 + [af], f32)
    if case == -3:  # FIRsize 7
        af = f32(f32(1.0) / f32(7.0) * diff)
        bf = f32((f32(1.0) - af * f32(2.0)) / f32(5.0))
        return 7, np.array([af] + [bf] * 5 + [af], f32)
    if case == -2:
        af = f32(0.125) * diff
        bf = f32(0.25) * adiff + f32(0.25) * diff
        cf = f32(0.50) * adiff + f32(0.25) * diff
    else:  # case -1 (default)
        af = f32(0.0)
        bf = f32(0.25) * diff
        cf = f32(1.00) * adiff + f32(0.50) * diff
    return 5, np.array([af, bf, cf, bf, af], f32)


def _sharpen_h_coeffs(sharpness: float) -> tuple[int, int, int, int]:
    """(A, B, C, shift) for FastSharpeningBlurHinplaceWP13 at full
    resolution (taps=5, pixelsize 6; `Codec/DemoasicFrames.cpp:996-1076`).
    diff = (int)(256 * frac(sharpness*5)) for the positive branch."""
    f32 = np.float32
    s = f32(sharpness)
    s5 = s * f32(5.0)
    diff = int(f32(256.0) * f32(s5 - f32(int(s5))))
    adiff = 256 - diff
    case = int(s5)
    table = {
        -5: (2 * adiff + 2 * diff, 4 * adiff + 4 * diff,
             4 * adiff + 4 * diff, 12),
        -4: (2 * adiff + 2 * diff, 4 * adiff + 4 * diff,
             4 * adiff + 4 * diff, 12),
        -3: (0 * adiff + 2 * diff, 4 * adiff + 4 * diff,
             8 * adiff + 4 * diff, 12),
        -2: (0 * adiff + 2 * diff, 4 * adiff + 4 * diff,
             8 * adiff + 4 * diff, 12),
        -1: (0, 0 * adiff + 4 * diff, 16 * adiff + 8 * diff, 12),
        0: (0 * adiff - 1 * diff, 0 * adiff + 4 * diff,
            16 * adiff + 10 * diff, 12),
        1: (-1 * adiff - 2 * diff, 4 * adiff + 4 * diff,
            10 * adiff + 12 * diff, 12),
        2: (-2 * adiff - 4 * diff, 4 * adiff + 4 * diff,
            12 * adiff + 16 * diff, 12),
        3: (-4 * adiff - 8 * diff, 4 * adiff + 8 * diff,
            16 * adiff + 16 * diff, 12),
        4: (-8 * adiff - 8 * diff, 8 * adiff + 0 * diff,
            16 * adiff + 32 * diff, 12),
        5: (-8, 0, 32, 4),
    }
    return table[max(-5, min(case, 5))]


# Protune preview 1D curve, built into the decoder for LOOK CRC
# 0x3f6f5788 (`Codec/DemoasicFrames.cpp:5017-5092`): expanded to a
# separable 32^3 float LUT with entry (b,g,r) -> (curve[b],curve[g],
# curve[r]) in the build order, which the (b*32^2+g*32+r) reader then
# sees as out_c = curve[coord_c].
PROTUNE_LOOK_CRC = 0x3F6F5788
_PROTUNE_CURVE = np.array([
    0.000000, 0.002565, 0.010235, 0.022930, 0.040521, 0.062827,
    0.089618, 0.120621, 0.155517, 0.193947, 0.235518, 0.279803,
    0.326347, 0.374674, 0.424286, 0.474675, 0.525325, 0.575714,
    0.625326, 0.673653, 0.720197, 0.764482, 0.806053, 0.844483,
    0.879379, 0.910382, 0.937173, 0.959479, 0.977070, 0.989765,
    0.997435, 1.000000], np.float32)


def protune_look_lut() -> tuple[np.ndarray, int]:
    """(LUT, size): float32 (size^3, 3) array indexed
    (b*size^2 + g*size + r) like LoadCube64_3DLUT's flat layout."""
    size = 32
    c = _PROTUNE_CURVE
    # build order r,g,b with entries (curve[b], curve[g], curve[r]);
    # flat index r*size^2 + g*size + b
    lut = np.empty((size, size, size, 3), np.float32)
    r = np.arange(size)
    lut[..., 0] = c[r][None, None, :]            # reader's red = curve[r]
    lut[..., 1] = c[r][None, :, None]            # green = curve[g]
    lut[..., 2] = c[r][:, None, None]            # blue = curve[b]
    # reader indexes (b,g,r) over the build loops' (r,g,b) order; for this
    # separable fill both orders agree, so store in reader order (b,g,r)
    return lut.reshape(-1, 3), size


def build_raw_cube(lut: np.ndarray, lutsize: int,
                   cube_base: int = 6) -> np.ndarray:
    """BuildCube for the no-develop-change case (`Codec/bayer.c:4720`,
    `change == 0` branch): lattice coords rf = r/cube_depth (float32),
    trilinear float sample of the look LUT (LUTscale = size-1-1e-5,
    truncated source index, mix clamped to [-1, 4]), scaled by 8192.0f
    and truncated to int16.  Returns ((depth+1)^3, 3) int16 in
    (b, g, r) raster order (stride depth+1)."""
    f32 = np.float32
    depth = 1 << cube_base
    n = depth + 1
    coord = (np.arange(n, dtype=np.int32).astype(f32) / f32(depth))
    scale = f32(f32(lutsize - 1) - f32(0.00001))
    s = coord * scale
    src = s.astype(np.int32)
    src = np.clip(src, 0, lutsize - 2)
    mix = np.clip(s - src.astype(f32), f32(-1.0), f32(4.0))
    b_i, g_i, r_i = np.meshgrid(np.arange(n), np.arange(n), np.arange(n),
                                indexing='ij')
    rs, gs, bs = src[r_i], src[g_i], src[b_i]
    rm, gm, bm = mix[r_i], mix[g_i], mix[b_i]
    L = lut.reshape(lutsize, lutsize, lutsize, 3)

    def at(db, dg, dr):
        return L[bs + db, gs + dg, rs + dr]

    rm = rm[..., None]
    gm = gm[..., None]
    bm = bm[..., None]
    one = f32(1.0)
    val = (((at(0, 0, 0) * (one - rm) + at(0, 0, 1) * rm) * (one - gm)
            + (at(0, 1, 0) * (one - rm) + at(0, 1, 1) * rm) * gm)
           * (one - bm)
           + ((at(1, 0, 0) * (one - rm) + at(1, 0, 1) * rm) * (one - gm)
              + (at(1, 1, 0) * (one - rm) + at(1, 1, 1) * rm) * gm) * bm
           ).astype(f32)
    q = np.trunc(val * f32(8192.0)).astype(np.int64)
    return np.clip(q, -32768, 32767).astype(np.int16).reshape(-1, 3)


def cube_is_separable(cube: np.ndarray, cube_base: int = 6) -> bool:
    """TestCubeFor1Dness (`Codec/bayer.c:5555`): the cube is treated as
    three 1D curves when, over all interior cells, the red channel is
    constant along g/b, green along r/b, and blue along r/g."""
    depth = (1 << cube_base) + 1
    c = cube.reshape(depth, depth, depth, 3)
    r_ok = (c[:-1, :-1, :-1, 0] == c[:-1, 1:, :-1, 0]).all() and \
           (c[:-1, :-1, :-1, 0] == c[1:, :-1, :-1, 0]).all() and \
           (c[:-1, :-1, :-1, 0] == c[1:, 1:, :-1, 0]).all()
    g_ok = (c[:-1, :-1, :-1, 1] == c[:-1, :-1, 1:, 1]).all() and \
           (c[:-1, :-1, :-1, 1] == c[1:, :-1, :-1, 1]).all() and \
           (c[:-1, :-1, :-1, 1] == c[1:, :-1, 1:, 1]).all()
    b_ok = (c[:-1, :-1, :-1, 2] == c[:-1, :-1, 1:, 2]).all() and \
           (c[:-1, :-1, :-1, 2] == c[:-1, 1:, :-1, 2]).all() and \
           (c[:-1, :-1, :-1, 2] == c[:-1, 1:, 1:, 2]).all()
    return bool(r_ok and g_ok and b_ok)


def _curve2lin_table(base: float = 90.0, depth: int = 64) -> np.ndarray:
    """ComputeCube's float curve2lin table (`Codec/bayer.c:6228-6268`):
    curve2lin[k] = log2lin(k/(depth-1), base) for k in 0..depth."""
    k = np.arange(depth + 1, dtype=np.float64)
    i = (k.astype(np.float32) / np.float32(depth - 1)).astype(np.float64)
    return ((np.power(base, i) - 1.0) / (base - 1.0)).astype(np.float32)


def _lin2curve_table(base: float = 90.0) -> np.ndarray:
    """lin2curve[j+512] = lin2log(j/512, base) for j in -512..2048
    (`bayer.c:6274-6310`), float32."""
    j = np.arange(-512, 2049, dtype=np.float64)
    i = (j.astype(np.float32) / np.float32(512.0)).astype(np.float64)
    with np.errstate(invalid="ignore"):
        pos = np.log10(i * (base - 1.0) + 1.0) / np.log10(base)
        neg = -np.log10(-i * (base - 1.0) + 1.0) / np.log10(base)
    return np.where(i >= 0.0, pos, neg).astype(np.float32)


def _calc_contrast(i: np.ndarray, cntrst: float) -> np.ndarray:
    """calc_contrast (`Common/AVIExtendedHeader.h:178`), double math."""
    i = i.astype(np.float64)
    p = (cntrst - 1.0) * 3.0 + 1.0 if cntrst >= 1.0 else cntrst
    b6 = np.float32(np.power(0.5, p)).astype(np.float64)
    b7 = np.float32(0.5 / b6).astype(np.float64)
    b8 = np.float32(1.0 - 1.0 / p if p > 1.0 else 1.0).astype(np.float64)
    neg = i * 100.0 * ((0.01 * (1 - b8)) + b8 * (np.power(0.01, p) * b7))
    lo = (i * (1 - b8)) + b8 * (np.power(np.abs(i), p) * b7)
    hi = (i * (1 - b8)) + b8 * (1 - np.power(np.abs(1 - i), p) * b7)
    above = 1 + (i - 1) * 100.0 * (
        1 - ((0.99 * (1 - b8)) + b8 * (1 - np.power(0.01, p) * b7)))
    out = np.where(i < 0.0, neg,
                   np.where(i < 0.5, lo, np.where(i <= 1.0, hi, above)))
    return out.astype(np.float32)


def _gammatweak_table(gamma: float, contrast: float = 1.0) -> np.ndarray:
    """BuildLUTCurves (`Codec/bayer.c:4746-4810`): per-channel gamma +
    contrast float table over j = -512..2048 (j/512 = -1..+4), values
    clamped to [-1, 4]; lin2gam uses the float-cast exponent and the
    linear negative extension (`AVIExtendedHeader.h:168`)."""
    j = np.arange(-512, 2049, dtype=np.float64) / 512.0
    exponent = np.float64(np.float32(1.0 / gamma))
    pos = np.power(np.abs(j), exponent)
    neg = j * 100.0 * np.power(0.01, exponent)
    v = np.where(j >= 0.0, pos, neg).astype(np.float32)
    if contrast != 1.0:
        v = _calc_contrast(v, contrast)
    return np.clip(v, -1.0, 4.0).astype(np.float32)


def _lerp512(table: np.ndarray, v: np.ndarray) -> np.ndarray:
    """BuildCube's table interpolation: entry = (int)(v*512)+512 (trunc
    toward zero), mix = v*512+512 - entry, lerp table[entry..entry+1]."""
    f32 = np.float32
    s = (v * f32(512.0)).astype(np.float32)
    entry = np.trunc(s).astype(np.int64) + 512
    mix = ((s + f32(512.0)) - entry.astype(np.float32)).astype(np.float32)
    entry = np.clip(entry, 0, table.size - 2)
    return (table[entry] * (f32(1.0) - mix)
            + table[entry + 1] * mix).astype(np.float32)


def build_raw_cube_developed(m: np.ndarray | None,
                             rgb_gamma=(1.0, 1.0, 1.0),
                             contrast: float = 1.0,
                             lut: np.ndarray | None = None,
                             lutsize: int = 0,
                             curve_base: float = 90.0,
                             cube_base: int = 6) -> np.ndarray:
    """BuildCube's change==1 branch (`Codec/bayer.c:4720-5177`): fold
    the linear develop matrix, per-channel gamma/contrast tweaks, the
    encode/decode curves and the LOOK LUT into one RawCube.

    Per lattice point (float32 unless noted):
    - matrix non-unity: rs = curve2lin[idx] * (1 - 2/cube_depth); the
      negative-cross-term blend guards (`bayer.c:4818-4847`); rf =
      m[row] . (rs,gs,bs) + off.  Matrix unity: rf = curve2lin[idx].
    - clamp [-1, 4]; per-channel gammatweak 512-entry lerp when gamma
      or contrast non-unity; clamp; restore curve via the lin2curve
      512-entry lerp; optional LOOK LUT float trilinear
      (LUTscale = size-1-1e-5); RawCube = trunc(rf*8192) to int16."""
    f32 = np.float32
    depth = 1 << cube_base
    n = depth + 1
    c2l = _curve2lin_table(curve_base, depth)
    l2c = _lin2curve_table(curve_base)
    lin_non_unity = m is not None and (
        np.any(np.asarray(m, np.float32)[:, :3] != np.eye(3, dtype=np.float32))
        or np.any(np.asarray(m, np.float32)[:, 3]))
    cg_non_unity = (tuple(rgb_gamma) != (1.0, 1.0, 1.0)) or contrast != 1.0

    b_i, g_i, r_i = np.meshgrid(np.arange(n), np.arange(n), np.arange(n),
                                indexing='ij')
    if lin_non_unity:
        mtx = np.asarray(m, np.float32).reshape(3, 4)
        scale = f32(f32(1.0) - f32(2.0) / f32(depth))
        rs = (c2l[r_i] * scale).astype(f32)
        gs = (c2l[g_i] * scale).astype(f32)
        bs = (c2l[b_i] * scale).astype(f32)

        def row(ri_, w0, w1, w2, off, own, other1, other2):
            full = (w0 * rs + w1 * gs + w2 * bs + off).astype(f32)
            # negative-cross-term guard: blend toward the diagonal-only
            # result when the cross terms push below -1 on a hot channel
            cross = {0: w1 * gs + w2 * bs, 1: w0 * rs + w2 * bs,
                     2: w0 * rs + w1 * gs}[ri_]
            ownv = (rs, gs, bs)[ri_]
            diag = ((w0, w1, w2)[ri_] * ownv + off).astype(f32)
            weight = ((f32(-1.0) - cross) * (ownv - f32(0.8))
                      * f32(5.0)).astype(f32)
            weight = np.minimum(weight, f32(1.0))
            guard = (cross < -1.0) & (ownv > f32(0.8))
            blend = (diag * weight + full * (f32(1.0) - weight)).astype(f32)
            return np.where(guard, blend, full).astype(f32)

        rf = row(0, mtx[0, 0], mtx[0, 1], mtx[0, 2], mtx[0, 3], rs, gs, bs)
        gf = row(1, mtx[1, 0], mtx[1, 1], mtx[1, 2], mtx[1, 3], gs, rs, bs)
        bf = row(2, mtx[2, 0], mtx[2, 1], mtx[2, 2], mtx[2, 3], bs, rs, gs)
    else:
        rf, gf, bf = c2l[r_i], c2l[g_i], c2l[b_i]

    rf = np.clip(rf, f32(-1.0), f32(4.0))
    gf = np.clip(gf, f32(-1.0), f32(4.0))
    bf = np.clip(bf, f32(-1.0), f32(4.0))

    if cg_non_unity:
        # per-channel guard: a unity-gamma channel SKIPS its lerp
        # entirely (`bayer.c:4953-4972`; its tweak table is never built)
        chans = [rf, gf, bf]
        for ci, g in enumerate(rgb_gamma):
            if g != 1.0 or contrast != 1.0:
                chans[ci] = _lerp512(_gammatweak_table(g, contrast),
                                     chans[ci])
        rf, gf, bf = chans

    rf = np.clip(rf, f32(-1.0), f32(4.0))
    gf = np.clip(gf, f32(-1.0), f32(4.0))
    bf = np.clip(bf, f32(-1.0), f32(4.0))
    rf = _lerp512(l2c, rf)
    gf = _lerp512(l2c, gf)
    bf = _lerp512(l2c, bf)

    if lut is not None:
        L = lut.reshape(lutsize, lutsize, lutsize, 3)
        scale = f32(f32(lutsize - 1) - f32(0.00001))

        def coord(v):
            s = (v * scale).astype(f32)
            src = np.clip(np.trunc(s).astype(np.int64), 0, lutsize - 2)
            mix = np.clip((s - src.astype(f32)).astype(f32),
                          f32(-1.0), f32(4.0))
            return src, mix

        rsrc, rm = coord(rf)
        gsrc, gm = coord(gf)
        bsrc, bm = coord(bf)
        one = f32(1.0)

        def at(db, dg, dr, ch):
            return L[bsrc + db, gsrc + dg, rsrc + dr, ch]

        out_ch = []
        for ch in range(3):
            val = (((at(0, 0, 0, ch) * (one - rm) + at(0, 0, 1, ch) * rm)
                    * (one - gm)
                    + (at(0, 1, 0, ch) * (one - rm) + at(0, 1, 1, ch) * rm)
                    * gm) * (one - bm)
                   + ((at(1, 0, 0, ch) * (one - rm) + at(1, 0, 1, ch) * rm)
                      * (one - gm)
                      + (at(1, 1, 0, ch) * (one - rm)
                         + at(1, 1, 1, ch) * rm) * gm) * bm).astype(f32)
            out_ch.append(val)
        rf, gf, bf = out_ch

    cube = np.stack([rf, gf, bf], axis=-1)
    q = np.trunc(cube.astype(f32) * f32(8192.0)).astype(np.int64)
    return np.clip(q, -32768, 32767).astype(np.int16).reshape(-1, 3)


def vignette_geometry(width: int, height: int, vgn_start: float,
                      vgn_end: float, vgn_gain: float):
    """The per-pixel factors of `fast_vignette_wp13` over a (height,
    width) frame, by its own float32 arithmetic, for every row at once:
    the sequential xpos sum, each row's ring (the columns from both edges
    inward before the first with r <= r1) and its Af values.  Returns (af
    (height, width) float32, ring (height, width) bool): a ring pixel v
    becomes sign(v) * trunc(sqrt(v*v*af)), the others stay.  Where gain
    is 0 the factor outside r2 is 0, which zeroes the pixel as the
    reference's zeroing does."""
    f32 = np.float32
    h, w = height, width
    diag = np.sqrt(f32(1.0) + (f32(h) / f32(w)) * (f32(h) / f32(w)),
                   dtype=f32)
    r1 = (f32(vgn_start) + f32(1.0)) * diag
    r2 = (f32(vgn_end) + f32(1.0)) * diag
    r1, r2 = r1 * r1, r2 * r2
    gain = f32(vgn_gain)
    xstep = f32(2.0) / f32(w)
    xpos = np.empty(w // 2, f32)
    v = f32(-1.0)
    for i in range(w // 2):
        xpos[i] = v
        v = f32(v + xstep)
    ypos = f32(2.0) * (h // 2 - np.arange(h)).astype(f32) / f32(w)
    ypos = ypos * ypos
    r = xpos[None, :] * xpos[None, :] + ypos[:, None]
    inside = r <= r1
    nproc = np.where(inside.any(axis=1), inside.argmax(axis=1), w // 2)
    with np.errstate(divide="ignore", invalid="ignore"):
        af = (r2 - r) / (r2 - r1)
        af = (af - f32(0.5)) * f32(2.0)
        af = af / (f32(1.0) + np.abs(af))
        af = af + f32(0.5)
        af = af * (f32(1.0) - gain) + gain
    af = np.where(r2 < r, gain, af).astype(f32)
    col = np.arange(w)
    k = np.where(col < w // 2, col, w - 1 - col)
    edge = (col < w // 2) | (col >= w - w // 2)
    ring = edge[None, :] & (k[None, :] < nproc[:, None])
    return af[:, np.minimum(k, w // 2 - 1)], ring
