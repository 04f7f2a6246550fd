"""The lens-correction warp on a torch device: the reference's bilinear
mesh apply, and the JAX package's float resampler.

Port of the JAX package's `ref/geomesh.py` apply stage and of its
`ops/warp.py`:

- `upload` puts a `ref.geomesh.GeoMesh`'s integer bilinear cache (built on
  the host, `cache_init_bilinear_range`) on the device once, with the
  blend structure of its fill pixels; `apply_bilinear` warps a batch of
  frames through it byte for byte (`geomesh_apply_bilinear`,
  WarpLib/GeoMeshApply.c): YUY2 with bilinear Y and vertical-only UV,
  and the packed formats (BGRA, b64a, RG48, WP13, W13A) per channel with
  the single-line path where the row lever is 0; `blur_vertical` softens
  the fill border (`geomesh_blur_vertical_range`, GeoMeshCache.c:288-378);
- the mesh builders `mesh_*` and `GOPRO_PRESETS` (numpy, on the host) and
  `warp_bilinear`, a float32 bilinear resample by such a mesh.

The fill blends and the vertical blur are recurrences: each blended
output reads a neighbour that was already written.  The packed formats'
blend reads the pixel to its left in the same row, so it runs as a loop
over the columns that hold a blended pixel, every row at once; the blur
reads the row above or below, so it loops over the rows that hold a
blended pixel, every column at once.  The YUY2 blend reads the previous
bytes of the whole frame, across rows, so its chains can run as long as
the fill region; its values are bytes, so each blended pixel is a map of
256 entries from its predecessor's value to its own, and the chains are
solved by composing these maps in a doubling scan (Hillis-Steele), a
pixel whose predecessor is not blended starting from a constant map.
Which pixels blend is known on the host from the cache, so the loops'
steps and the scan's chains are laid out at upload.

Plain PyTorch: no kernel, so every function runs on any device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from cineform_tpu_torch.ref import geomesh as gm

# ---------------------------------------------------------------------------
# The integer bilinear apply (geomesh_apply_bilinear)
# ---------------------------------------------------------------------------

#: packed formats: (channels, bytes per channel, signed, the value of a
#: pixel with no source)
_PACKED = {
    gm.FORMAT_32BGRA: (4, 1, False, (0, 0, 0, 255)),
    gm.FORMAT_64ARGB: (4, 2, False, (0, 0, 0, 65535)),
    gm.FORMAT_RG48: (3, 2, False, (0, 0, 0)),
    gm.FORMAT_WP13: (3, 2, True, (0, 0, 0)),
    gm.FORMAT_W13A: (4, 2, True, (0, 0, 0, 8191)),
}
_YUY2 = (gm.FORMAT_YUY2, gm.FORMAT_422YPCBCR8)


def _blend_weight(alpha: np.ndarray) -> np.ndarray:
    """The fill blends' weight of the previous value: alpha * 32, at most
    200 (of 256)."""
    return np.minimum(alpha * 32, 200)


def _chain(order: np.ndarray, linked: np.ndarray, device: torch.device):
    """A recurrence's chains in scan order: (the pixels, whether each reads
    the previous entry's value, the number of doubling rounds that solve
    the longest chain)."""
    longest, run = 0, 0
    for link in linked:
        run = run + 1 if link else 1
        longest = max(longest, run)
    rounds = math.ceil(math.log2(longest)) if longest > 1 else 0
    return (torch.from_numpy(order).to(device),
            torch.from_numpy(linked).to(device), rounds)


@dataclass
class DeviceMesh:
    """A GeoMesh's bilinear cache on the device, the per-pixel arrays in
    the raster order of the destination, and the fill blends' layout."""

    fmt: int
    width: int
    height: int
    srcbytes: int
    destbytes: int
    bpp: int
    backgroundfill: bool
    ok: torch.Tensor                 # (N,) bool: the pixel has a source
    weights: torch.Tensor            # (4, N) bilinear weights of 65536
    levers: torch.Tensor             # (2, N) column and row levers, of 256
    fast: torch.Tensor               # (N,) bool: the row lever is 0
    taps: torch.Tensor               # (T, N) source offsets of the taps
    fill: torch.Tensor | None = None         # (nch,) a sourceless pixel
    # the fill blends (where backgroundfill)
    weight: torch.Tensor | None = None      # (N,) min(alpha * 32, 200)
    blend: torch.Tensor | None = None       # (H, W) bool
    blend_columns: list = field(default_factory=list)
    blur_rows: tuple = ((), ())
    y_chain: tuple | None = None
    uv_chain: tuple | None = None

    @property
    def recurrence_steps(self) -> dict:
        """The sequential steps of the fill's recurrences: the packed
        blend's columns, the YUY2 blend's doubling rounds (Y, UV), the
        blur's rows (its two passes)."""
        return {"blend_columns": len(self.blend_columns),
                "blend_rounds": (0 if self.y_chain is None else
                                 self.y_chain[2] + self.uv_chain[2]),
                "blur_rows": sum(len(r) for r in self.blur_rows)}


def upload(mesh: gm.GeoMesh, device: torch.device | str) -> DeviceMesh:
    """`mesh`'s bilinear cache (`cache_init_bilinear_range` over the whole
    frame) -> a `DeviceMesh` on `device`: the taps' source offsets clamped
    to the source buffer, the weights, and, with backgroundfill, the
    blends' columns, rows and chains."""
    device = torch.device(device)
    if mesh.srcformat != mesh.destformat or \
            mesh.deststride != mesh.destwidth * mesh.destbpp:
        raise ValueError("the apply takes one format and packed rows")
    h, w = mesh.destheight, mesh.destwidth
    n = h * w
    cache = mesh.cache.reshape(n, mesh.num_elements)
    yidx = cache[:, 0]
    xl, yl = cache[:, -3 if mesh.backgroundfill else -2], \
        cache[:, -2 if mesh.backgroundfill else -1]
    alpha = cache[:, -1] if mesh.backgroundfill else np.zeros(n, np.int64)
    ok = yidx >= 0
    last_row = (np.arange(n) // w) >= h - 1
    srcbytes = mesh.srcstride * mesh.srcheight
    if mesh.srcformat in _YUY2:
        stride = np.where(last_row, 0, mesh.srcstride)
        yi = np.where(ok, yidx, 0)
        ui = np.where(ok, cache[:, 1], 0)
        offsets = [yi, yi + 2, yi + stride, yi + stride + 2, ui,
                   ui + stride]
        taps = np.clip(np.stack(offsets), 0, srcbytes - 1)
    else:
        nch, item, _, _ = _PACKED[mesh.srcformat]
        nxtln = np.where(last_row, 0, mesh.srcstride // item)
        base = np.where(ok, yidx, 0) // item
        taps = np.stack([base, base + nch, base + nxtln,
                         base + nxtln + nch])
    weights = np.stack([(256 - xl) * (256 - yl), xl * (256 - yl),
                        (256 - xl) * yl, xl * yl])

    def put(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device) if dtype is None else t.to(device, dtype)

    dm = DeviceMesh(
        fmt=mesh.srcformat, width=w, height=h, srcbytes=srcbytes,
        destbytes=mesh.deststride * h, bpp=mesh.destbpp,
        backgroundfill=bool(mesh.backgroundfill), ok=put(ok),
        weights=put(weights), levers=put(np.stack([xl, yl])),
        fast=put(yl == 0), taps=put(taps),
        fill=None if mesh.srcformat in _YUY2 else put(np.asarray(
            _PACKED[mesh.srcformat][3], np.int64)))
    if not mesh.backgroundfill:
        return dm
    a = _blend_weight(alpha)
    blend = ok & (alpha > 0)
    dm.weight = put(a)
    grid = a.reshape(h, w) > 0
    # geomesh_blur_vertical_range's two passes over the rows that hold a
    # pixel to soften: h/2 down to 1, then h/2 up to h - 2
    dm.blur_rows = ([r for r in range(h // 2, 0, -1) if grid[r].any()],
                    [r for r in range(h // 2, h - 1) if grid[r].any()])
    if mesh.srcformat in _YUY2:
        # pixel k reads the Y byte of pixel k - 1 and the UV byte of pixel
        # k - 2, in the flat buffer: across rows
        k = np.nonzero(blend)[0]
        prev = np.concatenate([[False], blend[:-1]])
        dm.y_chain = _chain(k, prev[k], device)
        k = k[np.argsort(k & 1, kind="stable")]
        prev = np.concatenate([[False, False], blend[:-2]])
        dm.uv_chain = _chain(k, prev[k], device)
    else:
        # the packed blend skips column 0, and reads the pixel to its left
        blend = blend & (np.arange(n) % w > 0)
        dm.blend = put(blend.reshape(h, w))
        dm.blend_columns = sorted(set((np.nonzero(blend)[0] % w).tolist()))
    return dm


def _scan_bytes(cur: torch.Tensor, weight: torch.Tensor, start: torch.Tensor,
                linked: torch.Tensor, rounds: int) -> torch.Tensor:
    """Solve the byte recurrence v[i] = (cur[i] * (256 - a[i]) + in[i] * a[i]
    + 128) >> 8, where in[i] = v[i - 1] for a linked entry and start[i]
    otherwise: (B, n) values.  Each entry is a 256-entry map from its input
    to its value (a constant map where the input is known); `rounds`
    doublings compose every map with its predecessors'."""
    x = torch.arange(256, device=cur.device)
    a = weight[None, :, None]
    inputs = torch.where(linked[None, :, None], x, start[..., None])
    maps = (cur[..., None] * (256 - a) + inputs * a + 128) >> 8
    d = 1
    for _ in range(rounds):
        maps = torch.cat([maps[:, :d],
                          torch.gather(maps[:, d:], 2, maps[:, :-d])], dim=1)
        d *= 2
    return maps[..., 0]


def _apply_yuy2(dm: DeviceMesh, s: torch.Tensor) -> torch.Tensor:
    """geomesh_apply_bilinear_yuy2 (GeoMeshApply.c:106-222) on (B,
    srcbytes) uint8 -> (B, destbytes) uint8: bilinear Y, vertical-only UV,
    and the fill blend against the previous output bytes."""
    v = s.to(torch.int32)[:, dm.taps]               # (B, 6, N)
    w00, w01, w10, w11 = dm.weights
    yl = dm.levers[1]
    yv = (v[:, 0] * w00 + v[:, 1] * w01 + v[:, 2] * w10 + v[:, 3] * w11) >> 16
    uvv = (v[:, 4] * (256 - yl) + v[:, 5] * yl) >> 8
    y = torch.where(dm.ok, yv & 0xFF, 0)
    uv = torch.where(dm.ok, uvv & 0xFF, 128)
    if dm.y_chain is not None:
        # the blends read the previous values, the first bytes read 0
        zero = torch.zeros_like(y[:, :2])
        for out, lag, (k, linked, rounds) in ((y, 1, dm.y_chain),
                                              (uv, 2, dm.uv_chain)):
            before = torch.cat([zero[:, :lag], out[:, :-lag]], dim=1)
            out[:, k] = _scan_bytes(out[:, k], dm.weight[k], before[:, k],
                                    linked, rounds).to(out.dtype)
    return torch.stack([y, uv], dim=-1).flatten(1).to(torch.uint8)


def _packed_values(s: torch.Tensor, item: int, signed: bool) -> torch.Tensor:
    """(B, bytes) uint8 -> (B, bytes / item) the elements' values: bytes,
    or little-endian 16-bit words, signed where `signed`."""
    if item == 1:
        return s.to(torch.int32)
    v = s.reshape(s.shape[0], -1, 2).to(torch.int32)
    v = v[..., 0] | (v[..., 1] << 8)
    return torch.where(v >= 32768, v - 65536, v) if signed else v


def _apply_packed(dm: DeviceMesh, s: torch.Tensor) -> torch.Tensor:
    """geomesh_apply_bilinear_{32BGRA,64ARGB,RG48,WP13,W13A}: per-channel
    bilinear with the single-line path where the row lever is 0, then the
    fill blend, which reads the previous pixel's channel 0 for every
    channel on the full-bilinear path (`oT` is not advanced in that block)
    and the matching channel on the single-line path: the reference's
    behaviour, kept bit for bit."""
    nch, item, signed, _ = _PACKED[dm.fmt]
    bits = 8 * item
    mask = (1 << bits) - 1
    wide = torch.int64 if item == 2 else torch.int32
    vals = _packed_values(s, item, signed).to(wide)
    ne = vals.shape[1]
    ch = torch.arange(nch, device=s.device)
    idx = (dm.taps[..., None] + ch).clamp(0, ne - 1)    # (4, N, nch)
    v00, v01, v10, v11 = vals[:, idx].unbind(1)        # each (B, N, nch)
    w = dm.weights.to(wide)[..., None]
    xl = dm.levers[0].to(wide)[:, None]
    full = (v00 * w[0] + v01 * w[1] + v10 * w[2] + v11 * w[3]) >> 16
    line = (v00 * (256 - xl) + v01 * xl) >> 8
    out = torch.where(dm.fast[:, None], line, full)
    out = torch.where(dm.ok[:, None], out, dm.fill.to(wide)) & mask
    if dm.blend_columns:
        if signed:
            out = torch.where(out >= 1 << (bits - 1), out - (1 << bits), out)
        grid = out.reshape(out.shape[0], dm.height, dm.width, nch)
        a = dm.weight.reshape(dm.height, dm.width, 1).to(wide)
        fast = dm.fast.reshape(dm.height, dm.width, 1)
        for c in dm.blend_columns:
            prev = grid[:, :, c - 1]
            prev = torch.where(fast[:, c], prev, prev[..., :1])
            new = (grid[:, :, c] * (256 - a[:, c]) + prev * a[:, c]
                   + 128) >> 8 & mask
            if signed:
                new = torch.where(new >= 1 << (bits - 1), new - (1 << bits),
                                  new)
            grid[:, :, c] = torch.where(dm.blend[:, c, None], new,
                                        grid[:, :, c])
        out = grid.reshape(out.shape) & mask
    if item == 1:
        return out.flatten(1).to(torch.uint8)
    return torch.stack([out & 0xFF, out >> 8], dim=-1).flatten(1) \
        .to(torch.uint8)


def apply_bilinear(dm: DeviceMesh, src: torch.Tensor) -> torch.Tensor:
    """geomesh_apply_bilinear over whole frames: (B, srcbytes) uint8 frames
    on the mesh's device -> (B, destbytes) uint8 warped frames."""
    src = src.reshape(src.shape[0], -1)
    if src.shape[1] != dm.srcbytes:
        raise ValueError(f"frames of {src.shape[1]} bytes: the mesh warps "
                         f"{dm.srcbytes}")
    if dm.fmt in _YUY2:
        return _apply_yuy2(dm, src)
    return _apply_packed(dm, src)


def blur_vertical(dm: DeviceMesh, out: torch.Tensor) -> torch.Tensor:
    """geomesh_blur_vertical_range (GeoMeshCache.c:288-378) on (B,
    destbytes) uint8 warped frames: soften the fill border vertically,
    byte by byte.  Channels 0 and 1 (bytes) blend against the row below in
    the top half's pass (h/2 down to 1) and the row above in the second
    (h/2 up to h - 2); the other channels (2, and 3 where there are four)
    against the row above in both, as the reference indexes them; YUY2
    blends its two bytes only."""
    h, w, bpp = dm.height, dm.width, dm.bpp
    rows = out.reshape(out.shape[0], h, w, bpp).to(torch.int32)
    nch = 2 if dm.fmt in _YUY2 else _PACKED[dm.fmt][0]
    a = dm.weight.reshape(h, w, 1).to(torch.int32)
    for r0, rs in ((1, dm.blur_rows[0]), (-1, dm.blur_rows[1])):
        for r in rs:
            cur = rows[:, r, :, :nch]
            ar = a[r]
            nb = torch.cat([rows[:, r + r0, :, :2], rows[:, r - 1, :, 2:nch]],
                           dim=-1)
            new = (cur * (256 - ar) + nb * ar + 128) >> 8
            rows[:, r, :, :nch] = torch.where(ar > 0, new, cur)
    return rows.flatten(1).to(torch.uint8)


# ---------------------------------------------------------------------------
# Mesh builders for the float resampler (numpy, on the host; the JAX
# package's `geomesh_transform_*` stand-ins of ops/warp.py)
# ---------------------------------------------------------------------------

def mesh_identity(h: int, w: int) -> np.ndarray:
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    return np.stack([yy, xx], axis=-1)


def mesh_rotate(h: int, w: int, degrees: float) -> np.ndarray:
    """In-plane rotation about the image center (geomesh_transform_rotate)."""
    t = math.radians(degrees)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    m = mesh_identity(h, w)
    y = m[..., 0] - cy
    x = m[..., 1] - cx
    ys = y * math.cos(t) - x * math.sin(t) + cy
    xs = y * math.sin(t) + x * math.cos(t) + cx
    return np.stack([ys, xs], axis=-1).astype(np.float32)


def mesh_defish(h: int, w: int, fov_degrees: float = 120.0,
                strength: float = 1.0) -> np.ndarray:
    """Fisheye -> rectilinear correction (geomesh_transform_defish,
    `WarpLib/GeoMeshTransform.c`): map each rectilinear destination ray back
    to the equidistant-fisheye source radius."""
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    half_fov = math.radians(fov_degrees) / 2.0
    m = mesh_identity(h, w)
    y = (m[..., 0] - cy) / cx
    x = (m[..., 1] - cx) / cx
    r = np.sqrt(x * x + y * y)
    r = np.where(r < 1e-6, 1e-6, r)
    theta = np.arctan(r * math.tan(half_fov))      # rectilinear ray angle
    r_src = theta / half_fov                        # equidistant fisheye
    scale = 1.0 + strength * (r_src / r - 1.0)
    ys = y * scale * cx + cy
    xs = x * scale * cx + cx
    return np.stack([ys, xs], axis=-1).astype(np.float32)


def mesh_repoint_equirect(h: int, w: int, yaw: float = 0.0,
                          pitch: float = 0.0) -> np.ndarray:
    """Equirectangular repointing (geomesh_transform_repoint): rotate the
    viewing sphere by yaw/pitch degrees."""
    yawr, pitchr = math.radians(yaw), math.radians(pitch)
    m = mesh_identity(h, w)
    lon = (m[..., 1] / (w - 1) - 0.5) * 2 * math.pi
    lat = (0.5 - m[..., 0] / (h - 1)) * math.pi
    # unit vector
    cx = np.cos(lat) * np.sin(lon)
    cyv = np.sin(lat)
    cz = np.cos(lat) * np.cos(lon)
    # pitch about x then yaw about y
    y2 = cyv * math.cos(pitchr) - cz * math.sin(pitchr)
    z2 = cyv * math.sin(pitchr) + cz * math.cos(pitchr)
    x3 = cx * math.cos(yawr) + z2 * math.sin(yawr)
    z3 = -cx * math.sin(yawr) + z2 * math.cos(yawr)
    lon2 = np.arctan2(x3, z3)
    lat2 = np.arcsin(np.clip(y2, -1, 1))
    ys = (0.5 - lat2 / math.pi) * (h - 1)
    xs = (lon2 / (2 * math.pi) + 0.5) * (w - 1)
    return np.stack([ys, xs], axis=-1).astype(np.float32)


def _center_radius(mesh: np.ndarray, h: int, w: int):
    cy, cx = h / 2.0, w / 2.0
    y = mesh[..., 0] - cy
    x = mesh[..., 1] - cx
    r = np.sqrt(x * x + y * y)
    return y, x, np.where(r < 1e-6, 1e-6, r), cy, cx


def _radial(mesh: np.ndarray, h: int, w: int, fn) -> np.ndarray:
    """Apply a radial source-radius remapping r -> fn(r) about the center
    (the shared shape of the reference's radial transforms)."""
    y, x, r, cy, cx = _center_radius(mesh, h, w)
    s = fn(r) / r
    return np.stack([y * s + cy, x * s + cx], axis=-1).astype(np.float32)


def mesh_scale(mesh: np.ndarray, rowscale: float, colscale: float) -> np.ndarray:
    """geomesh_transform_scale: scale source coords about the center."""
    h, w = mesh.shape[:2]
    y, x, _, cy, cx = _center_radius(mesh, h, w)
    return np.stack([y * rowscale + cy, x * colscale + cx], -1).astype(np.float32)


def mesh_pan(mesh: np.ndarray, left: float, top: float) -> np.ndarray:
    """geomesh_transform_pan: shift source coordinates."""
    out = np.array(mesh, copy=True)
    out[..., 0] += top
    out[..., 1] += left
    return out


def mesh_flip(mesh: np.ndarray, horizontal: bool = True) -> np.ndarray:
    """geomesh_transform_flip_horz / _vert."""
    h, w = mesh.shape[:2]
    out = np.array(mesh, copy=True)
    if horizontal:
        out[..., 1] = (w - 1) - out[..., 1]
    else:
        out[..., 0] = (h - 1) - out[..., 0]
    return out


def mesh_fisheye(h: int, w: int, max_theta_degrees: float) -> np.ndarray:
    """Rectilinear -> equidistant fisheye (geomesh_transform_fisheye):
    destination radius maps to theta = atan(r/f), source r = f*theta-scaled."""
    f = math.sqrt(w * w + h * h) / 2.0 / math.tan(math.radians(max_theta_degrees))
    return _radial(mesh_identity(h, w), h, w, lambda r: f * np.arctan(r / f))


def mesh_orthographic(h: int, w: int, max_theta_degrees: float) -> np.ndarray:
    """geomesh_transform_orthographic: source r = f*sin(atan(r/f))."""
    f = math.sqrt(w * w + h * h) / 2.0 / math.tan(math.radians(max_theta_degrees))
    return _radial(mesh_identity(h, w), h, w,
                   lambda r: f * np.sin(np.arctan(r / f)))


def mesh_stereographic(h: int, w: int, max_theta_degrees: float) -> np.ndarray:
    """geomesh_transform_stereographic: source r = 2f*tan(atan(r/f)/2)."""
    f = math.sqrt(w * w + h * h) / 2.0 / math.tan(math.radians(max_theta_degrees))
    return _radial(mesh_identity(h, w), h, w,
                   lambda r: 2 * f * np.tan(np.arctan(r / f) / 2))


def mesh_gopro_to_rectilinear(h: int, w: int,
                              sensorcrop: float = 1.0) -> np.ndarray:
    """geomesh_transform_gopro_to_rectilinear: the GoPro cubic lens model
    theta(r) = -12.0479 r^3 + 5.3339 r^2 + 80.5605 r degrees (r normalized
    to the half-diagonal and scaled by the sensor crop), mapped back to a
    rectilinear destination (`WarpLib/GeoMeshTransform.c:215`)."""
    maxradius = math.sqrt(w * w + h * h) / 2.0

    def fn(r):
        rn = (r / maxradius) * sensorcrop
        theta = np.where(rn < 1.0,
                         -12.047899 * rn ** 3 + 5.3339 * rn ** 2 + 80.560545 * rn,
                         -8.94 * rn ** 2 + 70.92 * rn + 11.85)
        # destination rectilinear radius for this ray angle
        return np.tan(np.radians(np.clip(theta, 0, 89.0))) \
            / math.tan(math.radians(80.560545 * sensorcrop)) * maxradius

    # invert numerically: sample the forward curve and interpolate
    rr = np.linspace(0, maxradius * 1.5, 2048)
    dd = fn(rr)
    y, x, r, cy, cx = _center_radius(mesh_identity(h, w), h, w)
    rsrc = np.interp(r, dd, rr)
    s = rsrc / r
    return np.stack([y * s + cy, x * s + cx], axis=-1).astype(np.float32)


def mesh_horizontal_stretch_poly(mesh: np.ndarray, a: float, b: float,
                                 c: float) -> np.ndarray:
    """geomesh_transform_horizontal_stretch_poly: per-row horizontal
    stretch x -= W*(2x/W-1)*(a*yn^2 + b*yn + c) (GoPro SuperView-style
    anamorphic corrector, `GeoMeshTransform.c:528`)."""
    h, w = mesh.shape[:2]
    out = np.array(mesh, copy=True)
    xn = out[..., 1] / w
    yn = out[..., 0] / h - 0.5
    out[..., 1] = out[..., 1] - w * (2 * xn - 1) * (a * yn * yn + b * yn + c)
    return out


# GoPro camera presets: (sensorcrop, stretch a) per (product, fov) family —
# a compact functional stand-in for the per-resolution calibration tables in
# `WarpLib/GeoMeshGoPro.c` (wide/medium/narrow crops; SuperView stretch).
GOPRO_PRESETS = {
    ("hero3", "wide"): {"sensorcrop": 1.0},
    ("hero3", "medium"): {"sensorcrop": 0.75},
    ("hero3", "narrow"): {"sensorcrop": 0.5},
    ("hero4", "superview"): {"sensorcrop": 1.0,
                             "stretch": (0.21, 0.0, 0.0)},
}


def mesh_gopro_preset(h: int, w: int, product: str = "hero3",
                      fov: str = "wide") -> np.ndarray:
    p = GOPRO_PRESETS[(product, fov)]
    mesh = mesh_gopro_to_rectilinear(h, w, p["sensorcrop"])
    if "stretch" in p:
        mesh = mesh_horizontal_stretch_poly(mesh, *p["stretch"])
    return mesh


# ---------------------------------------------------------------------------
# The float resampler (the JAX package's ops/warp.py)
# ---------------------------------------------------------------------------


def warp_bilinear(image: torch.Tensor, mesh: torch.Tensor,
                  wrap_x: bool = False) -> torch.Tensor:
    """Bilinear resample in float32: image (..., H, W, C) by mesh (H', W',
    2) source coordinates (y, x) -> (..., H', W', C); wrap_x wraps
    horizontally (360 content), else the taps clamp to the edges."""
    h, w = image.shape[-3], image.shape[-2]
    ys, xs = mesh[..., 0], mesh[..., 1]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    fy = (ys - y0)[..., None]
    fx = (xs - x0)[..., None]
    y0 = y0.to(torch.int64).clamp(0, h - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x0i = x0.to(torch.int64)
    if wrap_x:
        x0i = torch.remainder(x0i, w)
        x1 = torch.remainder(x0i + 1, w)
    else:
        x0i = x0i.clamp(0, w - 1)
        x1 = (x0i + 1).clamp(0, w - 1)
    p00 = image[..., y0, x0i, :]
    p01 = image[..., y0, x1, :]
    p10 = image[..., y1, x0i, :]
    p11 = image[..., y1, x1, :]
    top = p00 * (1 - fx) + p01 * fx
    bot = p10 * (1 - fx) + p11 * fx
    return top * (1 - fy) + bot * fy
