"""The reference WarpLib GeoMesh engine's mesh and cache, on the host.

A copy of the JAX package's `ref/geomesh.py` without its apply stage:
`WarpLib/GeoMesh.c`, `GeoMeshTransform.c`, `GeoMeshInterp.c` and
`GeoMeshCache.c` with the reference's exact float32 semantics: every C
`float` expression is evaluated in IEEE single precision in the same
order, `double`-promoted subexpressions (the unsuffixed PI constants,
`fabs`, DEG2RAD/RAD2DEG macros) are computed in float64 and cast back
where the C casts, and the libm trig calls (`sinf`/`cosf`/...) go through
ctypes to glibc, so the mesh node values are bit-identical and the integer
bilinear cache is too.  The equirect straddle of `interp_bilinear` and the
cache's clamps stay here, in that arithmetic.

The decoder's lens-correction path (`WarpFrame`, Codec/decoder.c:9133)
drives this engine: create -> init -> transform stack ->
cache_init_bilinear_range; the port's `ops.warp` applies the cache on the
device (GeoMeshApply.c).

Reference quirk kept: `dstlens == FISHEYE` in repoint leaves phi
uninitialized in the reference (stack garbage), modeled as 0.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

from cineform_tpu_torch.utils.glibc_random import glibc_rand_sequence

f4 = np.float32
f8 = np.float64

# double-precision constants (GeoMeshTransform.c:32-35 — unsuffixed)
PI_D = 3.14159265359
HPI_D = 1.5707963268
TWOPI_D = 6.28318530718

# lens model ids (GeoMesh.h:176-183)
RECTILINEAR = 0
FISHEYE = 1
HERO3BLACK = 2
HERO3PLUSBLACK = 3
HERO4 = 4
EQUIRECT = 32
CUSTOM_LENS = 33

# WARPLIB_FORMAT_* (GeoMesh.h:61-68)
FORMAT_2VUY = 0x32767579
FORMAT_YUY2 = 0x59555932
FORMAT_422YPCBCR8 = 2
FORMAT_32BGRA = 3
FORMAT_64ARGB = 4
FORMAT_WP13 = 0x57503133
FORMAT_W13A = 0x57313341
FORMAT_RG48 = 0x52473438

_SUBSAMPLED = {FORMAT_YUY2, FORMAT_2VUY, FORMAT_422YPCBCR8}
# format -> (bytes per pixel, channels, signed16)
_FMTINFO = {
    FORMAT_YUY2: (2, 3, False),
    FORMAT_2VUY: (2, 3, False),
    FORMAT_422YPCBCR8: (2, 3, False),
    FORMAT_32BGRA: (4, 4, False),
    FORMAT_64ARGB: (8, 4, False),
    FORMAT_RG48: (6, 3, False),
    FORMAT_WP13: (6, 3, True),
    FORMAT_W13A: (8, 4, True),
}

# --- glibc libm single-precision trig (bit-identical to the reference) ---

_libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
for _n in ("sinf", "cosf", "tanf", "atanf", "acosf", "asinf"):
    _f = getattr(_libm, _n)
    _f.restype = ctypes.c_float
    _f.argtypes = [ctypes.c_float]
_libm.atan2f.restype = ctypes.c_float
_libm.atan2f.argtypes = [ctypes.c_float, ctypes.c_float]
_libm.hypotf.restype = ctypes.c_float
_libm.hypotf.argtypes = [ctypes.c_float, ctypes.c_float]


def _vec1(cfn):
    def call(a):
        a = np.asarray(a, f4)
        out = np.empty(a.shape, f4)
        fo, fi = out.ravel(), a.ravel()
        for i in range(fi.size):
            fo[i] = cfn(float(fi[i]))
        return out if a.shape else f4(out[()])
    return call


def _vec2(cfn):
    def call(a, b):
        a = np.asarray(a, f4)
        b = np.broadcast_to(np.asarray(b, f4), a.shape)
        out = np.empty(a.shape, f4)
        fo, fa, fb = out.ravel(), a.ravel(), b.ravel()
        for i in range(fa.size):
            fo[i] = cfn(float(fa[i]), float(fb[i]))
        return out if a.shape else f4(out[()])
    return call


sinf = _vec1(_libm.sinf)
cosf = _vec1(_libm.cosf)
tanf = _vec1(_libm.tanf)
atanf = _vec1(_libm.atanf)
acosf = _vec1(_libm.acosf)
asinf = _vec1(_libm.asinf)
atan2f = _vec2(_libm.atan2f)
hypotf = _vec2(_libm.hypotf)


def sqrtf(a):
    # IEEE-correctly-rounded in both glibc and numpy
    return np.sqrt(np.asarray(a, f4), dtype=f4)


def _as4(a):
    return np.asarray(a, f4)


def _as8(a):
    return np.asarray(a, f8)


def _trunc_i(x):
    """C `(int)` cast of a float: truncate toward zero."""
    with np.errstate(invalid="ignore"):
        return np.trunc(np.nan_to_num(np.asarray(x, f8), nan=0.0,
                                      posinf=2**31 - 1,
                                      neginf=-2**31)).astype(np.int64)


def _cdiv(n: int, d: int) -> int:
    """C integer division: truncate toward zero."""
    q = abs(n) // abs(d)
    return -q if (n < 0) != (d < 0) else q


class GlibcRand:
    """Sequential glibc rand() stream (for the backgroundfill draws,
    GeoMeshCache.c:238-241)."""

    def __init__(self, seed: int = 1, prefetch: int = 4096):
        self._seq = glibc_rand_sequence(prefetch, seed)
        self._seed = seed
        self._n = prefetch
        self._i = 0

    def next(self) -> int:
        if self._i >= self._n:
            self._n *= 2
            self._seq = glibc_rand_sequence(self._n, self._seed)
        v = int(self._seq[self._i])
        self._i += 1
        return v


class GeoMesh:
    """geomesh_t equivalent (GeoMeshPrivate.h): a sparse float32 mesh of
    source coordinates indexed by destination position."""

    def __init__(self, meshwidth: int, meshheight: int):
        self.meshwidth = meshwidth
        self.meshheight = meshheight
        self.meshx = np.zeros((meshheight, meshwidth), f4)
        self.meshy = np.zeros((meshheight, meshwidth), f4)
        self.cache: np.ndarray | None = None
        self.lens_custom_src = np.zeros(6, f4)
        self.lens_custom_dst = np.zeros(6, f4)

    # -- geomesh_init (GeoMesh.c:249-376) --------------------------------

    def init(self, srcwidth, srcheight, srcstride, srcformat,
             destwidth, destheight, deststride, destformat,
             backgroundfill=0):
        self.srcformat, self.destformat = srcformat, destformat
        self.srcwidth, self.srcheight = srcwidth, srcheight
        self.destwidth, self.destheight = destwidth, destheight
        self.backgroundfill = backgroundfill
        self.srcbpp, self.srcchannels, self.srcsigned = _FMTINFO[srcformat]
        self.destbpp, self.destchannels, _ = _FMTINFO[destformat]
        self.srcsubsampled = 1 if srcformat in _SUBSAMPLED else 0
        self.destsubsampled = 1 if destformat in _SUBSAMPLED else 0
        self.srcstride = srcstride if srcstride else srcwidth * self.srcbpp
        self.deststride = (deststride if deststride
                           else destwidth * self.destbpp)
        self.xstep = f4(srcwidth) / f4(self.meshwidth - 1)
        self.ystep = f4(srcheight) / f4(self.meshheight - 1)
        # identity grid accumulated in float32 (x += xstep), GeoMesh.c:361
        xs = np.zeros(self.meshwidth, f4)
        np.add.accumulate(np.full(self.meshwidth - 1, self.xstep, f4),
                          out=xs[1:], dtype=f4)
        ys = np.zeros(self.meshheight, f4)
        np.add.accumulate(np.full(self.meshheight - 1, self.ystep, f4),
                          out=ys[1:], dtype=f4)
        self.meshx[:] = xs[None, :]
        self.meshy[:] = ys[:, None]
        return self

    def _centers(self):
        return f4(self.srcwidth) / f4(2), f4(self.srcheight) / f4(2)

    def _dest_maxradius(self):
        return sqrtf(f4(self.destwidth * self.destwidth
                        + self.destheight * self.destheight) / f4(4))

    # -- transforms (GeoMeshTransform.c) ---------------------------------

    def transform_scale(self, rowscale, colscale):
        cx, cy = self._centers()
        x = self.meshx - cx
        y = self.meshy - cy
        self.meshx = (x / f4(colscale)) + cx
        self.meshy = (y / f4(rowscale)) + cy

    def transform_pan(self, left, top):
        self.meshx = self.meshx + f4(left)
        self.meshy = self.meshy + f4(top)

    def transform_rotate(self, angle_degrees):
        ar = f4(PI_D * f8(f4(angle_degrees)) / f8(f4(180.0)))
        s, c = sinf(ar), cosf(ar)
        cx, cy = self._centers()
        x = self.meshx - cx
        y = self.meshy - cy
        self.meshx = (x * c - y * s) + cx
        self.meshy = (x * s + y * c) + cy

    def transform_fisheye(self, max_theta_degrees):
        if f4(max_theta_degrees) == f4(0):
            return
        mtr = f4(PI_D * abs(f8(f4(max_theta_degrees))) / 180.0)
        maxradius = self._dest_maxradius()
        f = maxradius / tanf(mtr)
        cx, cy = self._centers()
        x = self.meshx - cx
        y = self.meshy - cy
        radius = sqrtf(x * x + y * y)
        theta = atanf(radius / f)
        with np.errstate(invalid="ignore", divide="ignore"):
            if max_theta_degrees < 0:
                newradius = f * theta
            else:
                newradius = radius
                radius = f * theta
            self.meshx = x * newradius / radius + cx
            self.meshy = y * newradius / radius + cy

    @staticmethod
    def _quadrant_theta(x, y, double_pi=True):
        """The repeated atan quadrant block: fabs and the division in
        double, atanf of the float-cast ratio.  In defish and
        gopro_to_rectilinear the x<0 branch is `(float)(PI - atanf(...))`
        — a DOUBLE subtraction (GeoMeshTransform.c:350) — while repoint
        writes `(float)PI - atanf(...)` — a FLOAT one
        (GeoMeshTransform.c:726); `double_pi` selects which."""
        with np.errstate(invalid="ignore", divide="ignore"):
            t = atanf(_as4(np.abs(_as8(y)) / np.abs(_as8(x))))
        pos = y >= f4(0)
        if double_pi:
            neg_lo = _as4(PI_D - _as8(t))
            neg_hi = _as4(PI_D + _as8(t))
        else:
            neg_lo = f4(PI_D) - t
            neg_hi = f4(PI_D) + t
        theta = np.where(x > f4(0), np.where(pos, t, -t), f4(0))
        theta = np.where(x == f4(0),
                         np.where(pos, f4(HPI_D), f4(-HPI_D)), theta)
        theta = np.where(x < f4(0), np.where(pos, neg_lo, neg_hi), theta)
        return _as4(theta)

    def transform_gopro_to_rectilinear(self, sensorcrop):
        sc = f4(sensorcrop)
        maxradius = self._dest_maxradius()
        cx, cy = self._centers()
        x = self.meshx - cx
        y = self.meshy - cy
        radius = sqrtf(x * x + y * y)
        r = (radius / maxradius) * sc
        rd = _as8(r)
        # HERO3+/4 lens-to-sphere polynomial in double (unsuffixed
        # constants, GeoMeshTransform.c:248), cast to float
        phi = _as4(PI_D * (-10.28871 * rd * rd + 84.878 * rd) / 180.0)
        theta = self._quadrant_theta(x, y)
        nr = atanf((phi / sc) * f4(0.75))
        radius = maxradius * nr
        self.meshx = cosf(theta) * radius + cx
        self.meshy = sinf(theta) * radius + cy

    def transform_defish(self, fov):
        fov = f4(fov)
        if fov > 0:
            maxradius = (f4(0.5) * f4(self.srcheight) * fov
                         / (f4(57.2958) * atanf(tanf(f4(0.785398) * fov
                                                     / f4(45)))))
        else:
            maxradius = sqrtf(f4(self.srcwidth * self.srcwidth
                                 + self.srcheight * self.srcheight) / f4(4))
        cx, cy = self._centers()
        x = self.meshx - cx
        y = self.meshy - cy
        theta = self._quadrant_theta(x, y)
        radius = sqrtf(x * x + y * y)
        if fov > 0:
            radius = (maxradius * f4(57.2958)
                      * atanf((radius / maxradius)
                              * tanf(f4(0.785398) * fov / f4(45))) / fov)
        else:
            k = f4(0.785398) * (-fov) / f4(45)
            # wrap guard compares in double (the 1.57 literal)
            wrap = _as8((radius / maxradius) * k) >= 1.57
            radius = _as4(np.where(wrap, f4(1.57) * maxradius / k, radius))
            radius = maxradius * tanf((radius / maxradius) * k) / tanf(k)
        self.meshx = cosf(theta) * radius + cx
        self.meshy = sinf(theta) * radius + cy

    def transform_orthographic(self, max_theta_degrees):
        self._ortho_stereo(max_theta_degrees, stereographic=False)

    def transform_stereographic(self, max_theta_degrees):
        self._ortho_stereo(max_theta_degrees, stereographic=True)

    def _ortho_stereo(self, max_theta_degrees, stereographic):
        if f4(max_theta_degrees) == f4(0):
            return
        mtr = f4(PI_D * abs(f8(f4(max_theta_degrees))) / 180.0)
        maxradius = self._dest_maxradius()
        f = maxradius / tanf(mtr)
        cx, cy = self._centers()
        x = self.meshx - cx
        y = self.meshy - cy
        radius = sqrtf(x * x + y * y)
        theta = atanf(radius / f)
        newradius = radius
        if stereographic:
            radius = f4(2) * f * tanf(theta / f4(2))
        else:
            radius = f * sinf(theta)
        with np.errstate(invalid="ignore", divide="ignore"):
            self.meshx = x * newradius / radius + cx
            self.meshy = y * newradius / radius + cy

    def transform_flip_horz(self):
        cx = f4(self.srcwidth) / f4(2)
        self.meshx = cx - (self.meshx - cx)

    def transform_flip_vert(self):
        cy = f4(self.srcheight) / f4(2)
        self.meshy = cy - (self.meshy - cy)

    def transform_horizontal_stretch_poly(self, a, b, c):
        a, b, c = f4(a), f4(b), f4(c)
        x, y = self.meshx, self.meshy
        xn = x / f4(self.srcwidth)
        yn = y / f4(self.srcheight) - f4(0.5)
        self.meshx = x - f4(self.srcwidth) * (f4(2) * xn - f4(1)) \
            * (a * yn * yn + b * yn + c)

    def set_custom_lens(self, src_params, dst_params):
        self.lens_custom_src[:] = np.asarray(src_params, f4)
        self.lens_custom_dst[:] = np.asarray(dst_params, f4)

    # -- repoint (GeoMeshTransform.c:628-871) ----------------------------

    @staticmethod
    def _estimate_normalized_radius(dphi, k6, k5, k4, k3, k2, k1,
                                    accuracy):
        """EstimateNormalizedRadius (GeoMeshTransform.c:569-614),
        vectorized: every element follows the scalar float32 iteration,
        frozen on its own break."""
        dphi = _as4(dphi)
        k6, k5, k4, k3, k2, k1 = (f4(k6), f4(k5), f4(k4), f4(k3),
                                  f4(k2), f4(k1))
        acc = f4(accuracy)

        def poly(r):
            return (k6 * r * r * r * r * r * r + k5 * r * r * r * r * r
                    + k4 * r * r * r * r + k3 * r * r * r + k2 * r * r
                    + k1 * r)

        r = np.zeros(dphi.shape, f4)
        last = poly(r)
        step = np.full(dphi.shape, f4(0.1))
        r = r + step
        active = np.ones(dphi.shape, bool)
        for _ in range(100):
            est = poly(r)
            brk = active & (est < dphi) & (est + acc > dphi)
            active &= ~brk
            if not active.any():
                break
            c12 = (((last < dphi) & (dphi < est)) |
                   ((last > dphi) & (dphi > est)))
            c34 = (~c12) & (((last < dphi) & (est < last)) |
                            ((last > dphi) & (est > last)))
            nstep = -step * f4(0.75)
            # c12: r += old step, then step = -step*0.75
            # c34: step = -step*0.75 first, then r += new step
            r_new = _as4(np.where(c34, r + nstep, r + step))
            step_new = _as4(np.where(c12 | c34, nstep, step))
            r = _as4(np.where(active, r_new, r))
            step = _as4(np.where(active, step_new, step))
            last = _as4(np.where(active, est, last))
        return np.maximum(r, f4(0))

    @staticmethod
    def _roll_spherical_axis(plane, axis):
        x = sinf(plane) * sinf(axis)
        y = sinf(plane) * cosf(axis)
        z = cosf(plane)
        return acosf(y), atan2f(z, x)

    def transform_repoint_src_to_dst(self, sensorcrop, newphi, newtheta,
                                     newphi2, srclens, dstlens):
        sc = f4(sensorcrop)
        newphi, newtheta, newphi2 = f4(newphi), f4(newtheta), f4(newphi2)
        gw, gh = self.srcwidth, self.srcheight
        maxradius = sqrtf(f4(gw * gw + gh * gh) / f4(4))
        cx, cy = self._centers()

        if srclens == EQUIRECT and dstlens == EQUIRECT:
            newphi = newphi + f4(PI_D)
            newtheta = newtheta + f4(HPI_D)

        x = self.meshx - cx
        y = self.meshy - cy
        radius = sqrtf(x * x + y * y)
        r = (radius / maxradius) * sc
        rd = _as8(r)

        if dstlens == RECTILINEAR:
            phi = atanf(r * f4(1.65))
        elif dstlens == HERO3BLACK:
            inner = (-f4(12.047899) * r * r * r + f4(5.3339) * r * r
                     + f4(80.560545) * r)
            phi = _as4(PI_D * _as8(inner) / 180.0)
        elif dstlens in (HERO3PLUSBLACK, HERO4):
            # float-suffixed constants promoted to double inside the
            # DEG2RAD argument (GeoMeshTransform.c:679-688)
            p_hi = np.full(r.shape, f4(PI_D * f8(f4(179.0)) / 180.0), f4)
            p_mid = _as4(PI_D * (f8(f4(175.17264)) * (2.0 - rd * 0.25)
                                 + 179.0 * (rd * 0.25 - 1.0)) / 180.0)
            inner_lo = -f4(10.28871) * r * r + f4(84.948) * r
            p_lo = _as4(PI_D * _as8(inner_lo) / 180.0)
            inner_in = (r * r * r * r * f4(7.5297980142)
                        - r * r * r * f4(17.983822059)
                        + r * r * f4(3.7166235179)
                        + r * f4(81.396558116))
            p_in = _as4(PI_D * _as8(inner_in) / 180.0)
            phi = _as4(np.where(rd > 8.0, p_hi,
                                np.where(rd > 4.0, p_mid,
                                         np.where(rd > 1.0, p_lo, p_in))))
        elif dstlens == EQUIRECT:
            theta = ((f4(1) - ((x + cx) / f4(self.destwidth)))
                     * f4(2) * f4(PI_D))
            phi = ((y + cy) / f4(self.destheight)) * f4(PI_D)
            theta = theta + f4(HPI_D)
            theta = _as4(np.where(theta > f4(2) * f4(PI_D),
                                  theta - f4(2) * f4(PI_D), theta))
        elif dstlens == CUSTOM_LENS:
            d = self.lens_custom_dst
            inner = (d[0] * r + d[1] * r * r + d[2] * r * r * r
                     + d[3] * r * r * r * r + d[4] * r * r * r * r * r)
            phi = _as4(PI_D * _as8(inner) / 180.0)
        elif dstlens == FISHEYE:
            # the reference leaves phi uninitialized here (stack garbage)
            phi = np.zeros(r.shape, f4)
        else:
            raise ValueError(f"unsupported dstlens {dstlens}")

        if dstlens != EQUIRECT:
            theta = self._quadrant_theta(x, y, double_pi=False)

        if newtheta != f4(0) or newphi != f4(0) or newphi2 != f4(0):
            yz, xaxis = self._roll_spherical_axis(phi, theta)
            xaxis = xaxis + newtheta
            xz, yaxis = self._roll_spherical_axis(yz, xaxis)
            yaxis = yaxis + newphi
            phi, theta = self._roll_spherical_axis(xz, yaxis)
            theta = theta + newphi2

        if srclens in (RECTILINEAR, FISHEYE):
            if srclens == RECTILINEAR:
                # (float)(RAD2DEG(phi)/180.0f): all double, single cast
                nr = _as4(180.0 * _as8(phi) / PI_D / f8(f4(180.0)))
            else:
                # (float)RAD2DEG(phi)/180.0f: cast THEN float division
                nr = _as4(180.0 * _as8(phi) / PI_D) / f4(180.0)
            radius = (maxradius * nr) / sc
            x = cosf(theta) * radius + cx
            y = sinf(theta) * radius + cy
        elif srclens == HERO3BLACK:
            dphi = _as4(180.0 * _as8(phi) / PI_D)
            nr = self._estimate_normalized_radius(
                dphi, 0, 0, 0, -12.047899, 5.3339, 80.560545, 0.001)
            radius = (maxradius * nr) / sc
            x = cosf(theta) * radius + cx
            y = sinf(theta) * radius + cy
        elif srclens in (HERO3PLUSBLACK, HERO4):
            dphi = _as4(180.0 * _as8(phi) / PI_D)
            nr = self._estimate_normalized_radius(
                dphi, 0, 0, 7.5297980142, -17.983822059, 3.7166235179,
                81.396558116, 0.001)
            radius = (maxradius * nr) / sc
            x = cosf(theta) * radius + cx
            y = sinf(theta) * radius + cy
        elif srclens == EQUIRECT:
            xx = sinf(phi) * sinf(theta)
            yy = sinf(phi) * cosf(theta)
            zz = cosf(phi)
            hyp = hypotf(yy, zz)
            u = -atan2f(zz, yy) / f4(TWOPI_D) + f4(0.5)
            v = atan2f(xx, hyp) / f4(PI_D) + f4(0.5)
            x = u * f4(gw) + f4(gw // 4)   # srcwidth/4 is int division
            x = _as4(np.where(x > f4(gw), x - f4(gw), x))
            y = v * f4(gh)
        elif srclens == CUSTOM_LENS:
            s = self.lens_custom_src
            dphi = _as4(180.0 * _as8(phi) / PI_D)
            nr = self._estimate_normalized_radius(
                dphi, 0.0, s[4], s[3], s[2], s[1], s[0], 0.001)
            radius = (maxradius * nr) / sc
            x = cosf(theta) * radius + cx
            y = sinf(theta) * radius + cy
        else:
            raise ValueError(f"unsupported srclens {srclens}")

        self.meshx = _as4(x)
        self.meshy = _as4(y)

        if dstlens == CUSTOM_LENS:
            self.transform_pan(self.lens_custom_src[5] * f4(gw),
                               self.lens_custom_dst[5] * f4(gh))

    # -- mesh interpolation (GeoMeshInterp.c:28-235) ---------------------

    def interp_bilinear(self, rows, cols):
        """Vectorized geomesh_interp_bilinear over float32 (row, col)
        arrays; returns (x, y) float32 source coordinates."""
        rows = _as4(rows)
        cols = _as4(cols)
        rowidx = rows / f4(self.destheight) * f4(self.meshheight - 1)
        colidx = cols / f4(self.destwidth) * f4(self.meshwidth - 1)
        mr0 = _trunc_i(rowidx)
        mc0 = _trunc_i(colidx)
        ylever = rowidx - mr0.astype(f4)
        xlever = colidx - mc0.astype(f4)
        ylever = np.where(mr0 < 0, f4(0), ylever)
        mr0 = np.maximum(mr0, 0)
        ylever = np.where(mr0 >= self.meshheight - 1, f4(1), ylever)
        mr0 = np.minimum(mr0, self.meshheight - 2)
        xlever = np.where(mc0 < 0, f4(0), xlever)
        mc0 = np.maximum(mc0, 0)
        xlever = np.where(mc0 >= self.meshwidth - 1, f4(1), xlever)
        mc0 = np.minimum(mc0, self.meshwidth - 2)
        ylever = _as4(ylever)
        xlever = _as4(xlever)

        x00 = self.meshx[mr0, mc0]
        x01 = self.meshx[mr0, mc0 + 1]
        x10 = self.meshx[mr0 + 1, mc0]
        x11 = self.meshx[mr0 + 1, mc0 + 1]
        y00 = self.meshy[mr0, mc0]
        y01 = self.meshy[mr0, mc0 + 1]
        y10 = self.meshy[mr0 + 1, mc0]
        y11 = self.meshy[mr0 + 1, mc0 + 1]

        w00 = (f4(1) - ylever) * (f4(1) - xlever)
        w01 = (f4(1) - ylever) * xlever
        w10 = ylever * (f4(1) - xlever)
        w11 = ylever * xlever

        y = y00 * w00 + y01 * w01 + y10 * w10 + y11 * w11
        x = x00 * w00 + x01 * w01 + x10 * w10 + x11 * w11

        # horizontal edge-straddle handling (equirect wrap),
        # GeoMeshInterp.c:84-161 — fabs in double vs (float)srcwidth
        sw = f8(self.srcwidth)
        straddle = (
            (np.abs(_as8(x11 - x00)) * 2.0 > sw) |
            (np.abs(_as8(x11 - x10)) * 2.0 > sw) |
            (np.abs(_as8(x11 - x01)) * 2.0 > sw) |
            (np.abs(_as8(x01 - x10)) * 2.0 > sw) |
            (np.abs(_as8(x01 - x00)) * 2.0 > sw) |
            (np.abs(_as8(x10 - x00)) * 2.0 > sw))
        if straddle.any():
            half = f4(self.srcwidth >> 1)
            wf = f4(self.srcwidth)

            def lohi(v):
                lo = _as4(np.where(v < half, v, -(wf - v)))
                hi = _as4(np.where(v < half, wf + v, v))
                return lo, hi

            x00l, x00h = lohi(x00)
            x01l, x01h = lohi(x01)
            x10l, x10h = lohi(x10)
            x11l, x11h = lohi(x11)
            xxl = x00l * w00 + x01l * w01 + x10l * w10 + x11l * w11
            xxh = x00h * w00 + x01h * w01 + x10h * w10 + x11h * w11
            # xxl >= 0 ? xxl : xxh <= srcwidth-1.0 ? xxh : nearer edge
            pick = np.where(
                (-_as8(xxl)) > (_as8(xxh) - (sw - 1.0)),
                f4(sw - f8(f4(1.0))), f4(0))
            xs = np.where(xxl >= f4(0), xxl,
                          np.where(_as8(xxh) <= sw - 1.0, xxh, pick))
            x = np.where(straddle, xs, x)
        return _as4(x), _as4(y)

    # -- bilinear cache (GeoMeshCache.c) ---------------------------------

    @property
    def num_elements(self):
        return 3 + self.srcsubsampled + (1 if self.backgroundfill else 0)

    def alloc_cache(self):
        self.cache = np.zeros(
            (self.destheight, self.destwidth, self.num_elements), np.int64)
        return self

    def _levers(self, x, y):
        xlever = _trunc_i((x - _trunc_i(x).astype(f4)) * f4(256) + f4(0.5))
        ylever = _trunc_i((y - _trunc_i(y).astype(f4)) * f4(256) + f4(0.5))
        return xlever, ylever

    def cache_init_bilinear_range(self, row_start, row_stop,
                                  rand: GlibcRand | None = None):
        """geomesh_cache_init_bilinear_range (GeoMeshCache.c:204-284),
        the decoder WarpFrame cache path.  With backgroundfill the
        out-of-range draws consume `rand` in row-major order (the
        reference is only deterministic here when driven
        single-threaded; this builds in one thread)."""
        if self.cache is None:
            self.alloc_cache()
        fill = 0 if self.backgroundfill else -1
        equirect = self.srcwidth == self.srcheight * 2
        h, w = self.srcheight, self.srcwidth
        stride, bpp = self.srcstride, self.srcbpp

        rows = np.arange(row_start, row_stop, dtype=np.int64)
        cols = np.arange(self.destwidth, dtype=np.int64)
        rr = np.broadcast_to(rows[:, None].astype(f4),
                             (rows.size, cols.size))
        cc = np.broadcast_to(cols[None, :].astype(f4), rr.shape)
        x, y = self.interp_bilinear(rr, cc)

        oor_x = (x < f4(0)) | (x >= f4(w - 1))
        oor = (oor_x & (not equirect)) | (y < f4(0)) | (y >= f4(h - 1))

        alpha = np.zeros(x.shape, np.int64)
        limit = stride * (h - 1) - bpp
        if fill >= 0:
            if rand is None:
                rand = GlibcRand()
            xf = x.copy()
            yf = y.copy()
            oi, oj = np.nonzero(oor)
            for k in np.argsort(oi * self.destwidth + oj):
                i, j = int(oi[k]), int(oj[k])
                xv, yv = f4(xf[i, j]), f4(yf[i, j])
                a = 0
                if xv < 0.0 and not equirect:
                    a = int(f4(1) - (xv * f4(256)) / f4(w))
                    q = _cdiv((rand.next() & 0xFFFF) * int(-xv * f4(4)),
                              0xFFFF)
                    yv = f4(yv + (f4(q) + xv))
                    xv = f4(0)
                if xv > f4(w - 1) and not equirect:
                    a = int(f4(1) + ((xv - f4(w)) * f4(256)) / f4(w))
                    d = xv - f4(w - 1)
                    q = _cdiv((rand.next() & 0xFFFF) * int(-d * f4(4)),
                              0xFFFF)
                    yv = f4(yv + (f4(q) + d))
                    xv = f4(w - 1)
                if yv < 0.0:
                    a = int(f4(1) - (yv * f4(256)) / f4(h))
                    q = _cdiv((rand.next() & 0xFFFF) * int(-yv * f4(4)),
                              0xFFFF)
                    xv = f4(xv + (f4(q) + yv))
                    yv = f4(0)
                if yv > f4(h - 1):
                    a = int(f4(1) + ((yv - f4(h)) * f4(256)) / f4(h))
                    d = yv - f4(h - 1)
                    q = _cdiv((rand.next() & 0xFFFF) * int(-d * f4(4)),
                              0xFFFF)
                    xv = f4(xv + (f4(q) + d))
                    yv = f4(h - 1)
                if xv < 0.0 and not equirect:
                    xv = f4(0)
                if xv > f4(w - 1) and not equirect:
                    xv = f4(w - 1)
                if yv < 0.0:
                    yv = f4(0)
                if yv > f4(h - 1):
                    yv = f4(h - 1)
                xf[i, j] = xv
                yf[i, j] = yv
                alpha[i, j] = a
            yoffset = _trunc_i(yf) * stride + _trunc_i(xf) * bpp
            # the in-range branch's bottom clamp (GeoMeshCache.c:257)
            yoffset = np.where(~oor & (yoffset >= limit), fill, yoffset)
            x, y = xf, yf
        else:
            yoffset = _trunc_i(y) * stride + _trunc_i(x) * bpp
            yoffset = np.where(yoffset >= limit, fill, yoffset)
            yoffset = np.where(oor, fill, yoffset)

        xlever, ylever = self._levers(x, y)
        ylever = np.where(y >= f4(h - 2), 0, ylever)

        view = self.cache[row_start:row_stop]
        e = 0
        view[..., e] = yoffset
        e += 1
        if self.srcsubsampled:
            uvoffset = yoffset + 1
            ix = _trunc_i(x)
            uvoffset = np.where((cols[None, :] & 1) != (ix & 1),
                                uvoffset + 2, uvoffset)
            uvoffset = np.where(ix >= self.destwidth - 3,
                                uvoffset - 4, uvoffset)
            view[..., e] = uvoffset
            e += 1
        view[..., e] = xlever
        view[..., e + 1] = ylever
        if self.backgroundfill:
            view[..., e + 2] = alpha
        return self

    def cache_init_bilinear(self):
        """geomesh_cache_init_bilinear (GeoMeshCache.c:121-199): the
        public single-call variant (no alpha element is ever written on
        this path, so it is only coherent without backgroundfill)."""
        assert not self.backgroundfill
        self.alloc_cache()
        h, w = self.srcheight, self.srcwidth
        stride, bpp = self.srcstride, self.srcbpp
        equirect = w == h * 2
        rows = np.arange(self.destheight, dtype=np.int64)
        cols = np.arange(self.destwidth, dtype=np.int64)
        rr = np.broadcast_to(rows[:, None].astype(f4),
                             (rows.size, cols.size))
        cc = np.broadcast_to(cols[None, :].astype(f4), rr.shape)
        x, y = self.interp_bilinear(rr, cc)
        if equirect and not self.srcsubsampled:
            oor = (y < f4(0)) | (y >= f4(h - 2))
        else:
            oor = ((x < f4(0)) | (x >= f4(w - 1)) |
                   (y < f4(0)) | (y >= f4(h - 2)))
        yoffset = np.where(oor, -1,
                           _trunc_i(y) * stride + _trunc_i(x) * bpp)
        xlever, ylever = self._levers(x, y)
        e = 0
        self.cache[..., e] = yoffset
        e += 1
        if self.srcsubsampled:
            uvoffset = yoffset + 1
            uvoffset = np.where((cols[None, :] & 1) != (_trunc_i(x) & 1),
                                uvoffset + 2, uvoffset)
            uvoffset = np.where(cols[None, :] >= self.destwidth - 1,
                                uvoffset - 4, uvoffset)
            self.cache[..., e] = uvoffset
            e += 1
        self.cache[..., e] = xlever
        self.cache[..., e + 1] = ylever
        return self
