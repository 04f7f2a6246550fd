"""Image scaling on a torch device: the reference's fixed-point Lanczos
scaler, and the JAX package's float resamplers.

Port of the JAX package's `ref/scaler.py` device half and of its
`ops/scaler.py`:

- the 8.8 fixed-point Lanczos engine of the reference's `CLanczosScaler`
  (ConvertLib/ImageScaler.cpp), byte for byte: `scale_yu64_triples`
  (ScaleRowLuma/ScaleRowChroma, then the column taps, each stage >> 8 and
  clamped to [0, 65535]), `scale_yu64_to` and `scale_yu64_to_bgra64`
  (ConvertToBGRA64's float32 YUV->RGB with C truncation, then each
  output's packing), `scale_b64a_to_b64a` and `scale_b64a_to_bgra`.  The
  taps come from the host (`ref.scaler.tap_table`, built once a size and
  device); each mix is a gather over the table's columns and an integer
  sum, int32 where the table's builder found that it fits;
- the float resamplers `scale_image` (two float32 products, TF32 off)
  and `scale_bilinear`, with `resample_matrix`, their host weights.

Frames are batched: (B, H, ...) tensors.  The 16-bit inputs are int32
tensors of uint16 values; the packed outputs are (B, H, row_bytes) uint8.
Plain PyTorch: no kernel, so every function runs on any device.
"""

from __future__ import annotations

import contextlib
from functools import lru_cache

import numpy as np
import torch

from cineform_tpu_torch.ops.yuv_output import _le_bytes
from cineform_tpu_torch.ref.scaler import tap_table

#: ConvertToBGRA64's coefficients (ImageConverter.cpp:183-262)
_BT601_CS = dict(luma_offset=16, ymult=1.164, r_vmult=1.596,
                 g_vmult=0.813, g_umult=0.391, b_umult=2.018)
_CS709_CS = dict(luma_offset=16, ymult=1.164, r_vmult=1.793,
                 g_vmult=0.534, g_umult=0.213, b_umult=2.115)
#: the Lanczos window of every CLanczosScaler stage
LOBES = 3
#: the outputs `scale_yu64_to` packs
OUTPUTS = ("b64a", "YUY2", "2vuy", "YU64", "v210", "RG48", "BGRA", "r210",
           "DPX0", "RG30", "AB10", "AR10")


def _mix(values: torch.Tensor, inputsize: int, outputsize: int,
         dim: int) -> torch.Tensor:
    """The 8.8 Lanczos mix of `values` along `dim` (inputsize long) to
    outputsize, >> 8 and clamped to [0, 65535]: for each column of the tap
    table, a gather and a multiply-add."""
    index, mix = tap_table(inputsize, outputsize, LOBES, values.device)
    shape = [1] * values.dim()
    shape[dim] = outputsize
    v = values.to(mix.dtype)
    acc = None
    for t in range(index.shape[1]):
        term = v.index_select(dim, index[:, t]) * mix[:, t].reshape(shape)
        acc = term if acc is None else acc + term
    return (acc >> 8).clamp(0, 65535).to(torch.int32)


def scale_yu64_triples(yu64: torch.Tensor, input_width: int,
                       input_height: int, output_width: int,
                       output_height: int):
    """Lanczos-scale YU64 rows, (B, H, 2W) int32 16-bit slots [y, c1, y,
    c2], to full-lattice 16-bit (Y, U, V) planes (B, out_h, out_w) int32:
    luma on the full lattice, chroma (slots 3 and 1) on the half lattice
    up to the full output width, then the column taps.  U is the slot-3
    chroma (Cb), V the slot-1 chroma (Cr)."""
    data = yu64[..., :input_height, :2 * input_width]
    luma = data[..., 0::2]
    chroma = torch.stack([data[..., 3::4], data[..., 1::4]], dim=-3)
    ys = _mix(luma, input_width, output_width, -1)
    uv = _mix(chroma, input_width >> 1, output_width, -1)
    if input_height != output_height:
        ys = _mix(ys, input_height, output_height, -2)
        uv = _mix(uv, input_height, output_height, -2)
    return ys, uv[..., 0, :, :], uv[..., 1, :, :]


def _yuv_to_rgb16(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  coeffs=_BT601_CS):
    """ConvertToBGRA64's scalar conversion: float32 products and sums, each
    rounded on its own (separate ops, so nothing contracts into an FMA),
    C truncation to int and a [0, 65535] clamp.  `u` is the chroma that
    r_vmult multiplies (the caller passes its V), `v` the one b_umult
    multiplies."""
    f32 = torch.float32
    y1 = (y - (coeffs["luma_offset"] << 8)).to(f32)
    u1 = (u - (128 << 8)).to(f32)
    v1 = (v - (128 << 8)).to(f32)

    def mul(c, x):
        return torch.mul(x, float(np.float32(coeffs[c])))

    base = mul("ymult", y1)
    r = torch.add(base, mul("r_vmult", u1))
    g = torch.sub(torch.sub(base, mul("g_vmult", u1)), mul("g_umult", v1))
    b = torch.add(base, mul("b_umult", v1))
    return tuple(c.to(torch.int64).clamp(0, 65535).to(torch.int32)
                 for c in (r, g, b))


def _interleave(*planes: torch.Tensor) -> torch.Tensor:
    return torch.stack(planes, dim=-1).flatten(-2)


def scale_yu64_to_bgra64(yu64: torch.Tensor, input_width: int,
                         input_height: int, output_width: int,
                         output_height: int, swap_bytes: bool = True,
                         is709: bool = False) -> torch.Tensor:
    """ScaleToBGRA64: Lanczos-scaled YU64 to ARGB16 rows (B, out_h, 8 *
    out_w) uint8, big-endian where `swap_bytes` (the non-Windows
    default)."""
    ys, us, vs = scale_yu64_triples(yu64, input_width, input_height,
                                    output_width, output_height)
    r, g, b = _yuv_to_rgb16(ys, vs, us, _CS709_CS if is709 else _BT601_CS)
    return _le_bytes(_interleave(torch.full_like(r, 65535), r, g, b), 2,
                     swap_bytes)


def _pack_v210(y10: torch.Tensor, u10: torch.Tensor, v10: torch.Tensor,
               width: int) -> torch.Tensor:
    """Full-height 10-bit 4:2:2 planes -> v210 rows (48-pixel groups,
    128-byte rows), the tail zero-filled: the scaler's own packing, Cb in
    slot 0."""
    lead = y10.shape[:-1]
    stream = torch.zeros((*lead, 2 * width), dtype=torch.int64,
                         device=y10.device)
    stream[..., 0::4] = u10
    stream[..., 1::2] = y10
    stream[..., 2::4] = v10
    comp = torch.zeros((*lead, ((2 * width + 5) // 6) * 6),
                       dtype=torch.int64, device=y10.device)
    comp[..., :2 * width] = stream
    words = comp[..., 0::3] | (comp[..., 1::3] << 10) | (comp[..., 2::3] << 20)
    out = torch.zeros((*lead, ((width + 47) // 48) * 32), dtype=torch.int64,
                      device=y10.device)
    out[..., :words.shape[-1]] = words
    return _le_bytes(out, 4)


def scale_yu64_to(yu64: torch.Tensor, input_width: int, input_height: int,
                  output_width: int, output_height: int, fourcc: str,
                  is709: bool = False) -> torch.Tensor:
    """The scaled decode's output: YU64 rows (B, H, 2W) int32 16-bit slots
    Lanczos-scaled to out_w x out_h and packed as `fourcc` (one of
    `OUTPUTS`), (B, out_h, row_bytes) uint8.  The YUV formats take the
    scaled 16-bit triples; the RGB formats go through ConvertToBGRA64's
    float coefficients.  A width the packing cannot lay out (odd for YUY2,
    2vuy, YU64 and v210) raises, as the JAX model's array assignments
    do."""
    if fourcc not in OUTPUTS:
        raise ValueError(f"scaled decode to {fourcc!r} is not supported")
    if fourcc == "b64a":
        return scale_yu64_to_bgra64(yu64, input_width, input_height,
                                    output_width, output_height,
                                    swap_bytes=True, is709=is709)
    ys, us, vs = scale_yu64_triples(yu64, input_width, input_height,
                                    output_width, output_height)
    lead = ys.shape[:-1]
    if fourcc in ("YUY2", "2vuy"):
        y8, u8, v8 = ys >> 8, us[..., 0::2] >> 8, vs[..., 0::2] >> 8
        quad = torch.empty((*lead, output_width // 2, 4), dtype=torch.int32,
                           device=ys.device)
        order = (y8[..., 0::2], u8, y8[..., 1::2], v8)
        if fourcc == "2vuy":
            order = (u8, y8[..., 0::2], v8, y8[..., 1::2])
        for i, part in enumerate(order):
            quad[..., i] = part
        return quad.flatten(-2).to(torch.uint8)
    if fourcc == "YU64":
        row = torch.empty((*lead, 2 * output_width), dtype=torch.int32,
                          device=ys.device)
        row[..., 0::2] = ys
        row[..., 1::4] = vs[..., 0::2]
        row[..., 3::4] = us[..., 0::2]
        return _le_bytes(row, 2)
    if fourcc == "v210":
        return _pack_v210(ys >> 6, us[..., 0::2] >> 6, vs[..., 0::2] >> 6,
                          output_width)
    r, g, b = _yuv_to_rgb16(ys, vs, us, _CS709_CS if is709 else _BT601_CS)
    if fourcc == "RG48":
        return _le_bytes(_interleave(r, g, b), 2)
    if fourcc == "BGRA":
        return _interleave(b >> 8, g >> 8, r >> 8,
                           torch.full_like(r, 255)).to(torch.uint8)
    r10, g10, b10 = (c.to(torch.int64) >> 6 for c in (r, g, b))
    if fourcc == "r210":
        return _le_bytes((r10 << 20) | (g10 << 10) | b10, 4, swap=True)
    if fourcc == "DPX0":
        return _le_bytes((r10 << 22) | (g10 << 12) | (b10 << 2), 4,
                         swap=True)
    if fourcc in ("RG30", "AB10"):
        return _le_bytes((b10 << 20) | (g10 << 10) | r10, 4)
    return _le_bytes((r10 << 20) | (g10 << 10) | b10, 4)     # AR10


def scale_b64a_to_b64a(argb: torch.Tensor, input_width: int,
                       input_height: int, output_width: int,
                       output_height: int,
                       swap_bytes: bool = True) -> torch.Tensor:
    """ScaleToB64A: (B, H, W, 4) int32 ARGB16 values (the native
    little-endian layout's) Lanczos-scaled to (B, out_h, 8 * out_w) uint8
    b64a rows, big-endian where `swap_bytes` (the non-Windows writer)."""
    # CImageScalerB64A::ScaleRowValues, then the column taps
    inter = _mix(argb[..., :input_height, :input_width, :], input_width,
                 output_width, -2)
    if input_height != output_height:
        inter = _mix(inter, input_height, output_height, -3)
    return _le_bytes(inter.flatten(-2), 2, swap_bytes)


def scale_b64a_to_bgra(argb: torch.Tensor, input_width: int,
                       input_height: int, output_width: int,
                       output_height: int) -> torch.Tensor:
    """ScaleToBGRA: (B, H, W, 4) int32 ARGB16 values Lanczos-scaled to
    (B, out_h, out_w, 4) uint8 BGRA.  Keeps the reference's column stride
    quirk: ScaleToBGRAThread walks the 4-value-per-pixel intermediate with
    a stride of out_w * 3 values (ImageScaler.cpp:3597), so the column
    taps read misaligned rows, and a tap whose pixel would end past the
    buffer is skipped."""
    inter = _mix(argb[..., :input_height, :input_width, :], input_width,
                 output_width, -2)
    flat = inter.flatten(-3)
    size = flat.shape[-1]
    stride = output_width * 3
    dev = argb.device
    x4 = 4 * torch.arange(output_width, device=dev)
    lanes = torch.arange(4, device=dev)
    if input_height == output_height:
        base = (stride * torch.arange(output_height, device=dev))[:, None] \
            + x4
        argb_out = flat[..., base[..., None] + lanes]
    else:
        index, mix = tap_table(input_height, output_height, LOBES, dev)
        acc = None
        for t in range(index.shape[1]):
            base = (stride * index[:, t])[:, None] + x4
            ok = (base + 4 <= size)[..., None]
            pos = torch.where(ok, base[..., None] + lanes, 0)
            term = flat[..., pos].to(mix.dtype) * (
                mix[:, t, None, None] * ok)
            acc = term if acc is None else acc + term
        argb_out = (acc >> 8).clamp(0, 65535)
    a, r, g, b = ((argb_out[..., i] >> 8).clamp(max=255) for i in range(4))
    return torch.stack([b, g, r, a], dim=-1).to(torch.uint8)


# ---------------------------------------------------------------------------
# The float resamplers (the JAX package's ops/scaler.py)
# ---------------------------------------------------------------------------

def _lanczos(x: np.ndarray, a: int) -> np.ndarray:
    x = np.abs(x)
    out = np.sinc(x) * np.sinc(x / a)
    return np.where(x < a, out, 0.0)


@lru_cache(maxsize=None)
def resample_matrix(n_in: int, n_out: int, a: int = 3) -> np.ndarray:
    """(n_out, n_in) Lanczos-a polyphase weights, rows normalized; when
    downsampling the kernel is stretched by the scale factor."""
    scale = n_in / n_out
    stretch = max(scale, 1.0)
    centers = (np.arange(n_out) + 0.5) * scale - 0.5
    taps = np.arange(n_in)
    x = (taps[None, :] - centers[:, None]) / stretch
    k = _lanczos(x, a)
    k /= k.sum(axis=1, keepdims=True)
    return k.astype(np.float32)


@lru_cache(maxsize=None)
def _resample_tensor(n_in: int, n_out: int, a: int,
                     device: torch.device) -> torch.Tensor:
    return torch.from_numpy(resample_matrix(n_in, n_out, a)).to(device)


@contextlib.contextmanager
def _full_float32():
    """Products in full float32 for the duration: no TF32 on the card."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _with_channels(image: torch.Tensor):
    has_c = image.dim() >= 3 and image.shape[-1] <= 4
    return has_c, (image if has_c else image[..., None])


def scale_image(image: torch.Tensor, out_h: int, out_w: int,
                a: int = 3) -> torch.Tensor:
    """Lanczos-scale (..., H, W) or (..., H, W, C) float images: out = Ky
    @ img @ Kx^T as two float32 products, with TF32 off."""
    has_c, img = _with_channels(image)
    h, w = img.shape[-3], img.shape[-2]
    ky = _resample_tensor(h, out_h, a, img.device)
    kx = _resample_tensor(w, out_w, a, img.device)
    with _full_float32():
        out = torch.einsum("oh,...hwc->...owc", ky, img.to(torch.float32))
        out = torch.einsum("pw,...owc->...opc", kx, out)
    return out if has_c else out[..., 0]


def _bilinear(img: torch.Tensor, y0, y1, x0, x1, fy, fx) -> torch.Tensor:
    p00 = img[..., y0[:, None], x0[None, :], :]
    p01 = img[..., y0[:, None], x1[None, :], :]
    p10 = img[..., y1[:, None], x0[None, :], :]
    p11 = img[..., y1[:, None], x1[None, :], :]
    top = p00 * (1 - fx) + p01 * fx
    bot = p10 * (1 - fx) + p11 * fx
    return top * (1 - fy) + bot * fy


def scale_bilinear(image: torch.Tensor, out_h: int,
                   out_w: int) -> torch.Tensor:
    """Bilinear resize of (..., H, W) or (..., H, W, C) float images
    (`ConvertLib/Bilinear.cpp`'s fallback): sample centres aligned, edges
    clamped, float32."""
    has_c, img = _with_channels(image)
    h, w = img.shape[-3], img.shape[-2]
    f32 = torch.float32
    ys = (torch.arange(out_h, device=img.device, dtype=f32) + 0.5) \
        * (h / out_h) - 0.5
    xs = (torch.arange(out_w, device=img.device, dtype=f32) + 0.5) \
        * (w / out_w) - 0.5
    y0 = torch.floor(ys).to(torch.int64).clamp(0, h - 1)
    x0 = torch.floor(xs).to(torch.int64).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    fy = (ys - y0).clamp(0, 1)[:, None, None]
    fx = (xs - x0).clamp(0, 1)[None, :, None]
    out = _bilinear(img, y0, y1, x0, x1, fy, fx)
    return out if has_c else out[..., 0]
