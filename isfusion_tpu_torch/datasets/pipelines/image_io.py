"""Images of the data pipeline as numpy arrays: PNG read and write on
``zlib``, and the image operations of ``ImageAug3D`` and of the GT-paste
sampler computed as PIL computes them, so that the port needs no imaging
library (the JAX package uses PIL: ``isfusion_tpu/datasets/pipelines/
{loading,transforms_3d,dbsampler}.py``).

An image is an (H, W, 3) uint8 RGB array.

- ``read_png`` takes 8-bit RGB files, non-interlaced, with any of the
  five row filters (PIL's encoder picks one per row). None, Sub and Up
  rows are undone with whole-row numpy operations; Average and Paeth rows
  need the pixel to their left and are undone byte by byte, which is fine
  for the GT database's small patches.
  ``write_png`` writes every row with the Up filter, so that the port
  reads its own files with whole-row operations.
- ``resize`` is PIL's default resample of an RGB image (bicubic, a = -0.5,
  widened by the scale when shrinking, i.e. with antialias), bit for bit:
  PIL's coefficients rounded to 22-bit fixed point, the horizontal pass
  and then the vertical, each rounded and clipped to uint8. Each pass is a
  product of the pixels with a banded matrix of those coefficients, taken
  in float64 blocks, in which every sum is exact.
- ``crop`` fills with zeros outside the image, ``flip_lr`` mirrors, and
  ``rotate`` is PIL's ``Image.rotate(deg)`` (nearest, about the centre, no
  expand, zero fill) in its 16.16 fixed point, bit for bit.
"""
from __future__ import annotations

import math
import struct
import zlib
from typing import Sequence, Tuple

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_RGB = 2                                      # PNG colour type


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data +
            struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, level: int = 1) -> None:
    """Write an (H, W, 3) uint8 image as PNG, every row with the Up
    filter, zlib at ``level``."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, _ = img.shape
    rows = img.reshape(h, w * 3)
    up = rows.copy()
    up[1:] -= rows[:-1]                               # wraps mod 256
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _RGB,
                                            0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), level)))
        f.write(_chunk(b"IEND", b""))


def _unfilter_slow(kind: int, line: np.ndarray, prior: np.ndarray,
                   bpp: int) -> np.ndarray:
    """Average (3) or Paeth (4) row, byte by byte."""
    out = [0] * len(line)
    f, b = line.tolist(), prior.tolist()
    for x in range(len(f)):
        a = out[x - bpp] if x >= bpp else 0
        if kind == 3:
            pred = (a + b[x]) >> 1
        else:
            c = b[x - bpp] if x >= bpp else 0
            p = a + b[x] - c
            pa, pb, pc = abs(p - a), abs(p - b[x]), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b[x] if pb <= pc else c)
        out[x] = (f[x] + pred) & 255
    return np.asarray(out, np.uint8)


def read_png(path: str) -> np.ndarray:
    """An 8-bit RGB PNG file (non-interlaced) -> (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype != _RGB or interlace:
        raise NotImplementedError(f"{path}: PNG with bit depth {depth}, "
                                  f"colour type {ctype}, interlace "
                                  f"{interlace}")
    bpp = 3
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * bpp)
    kinds, lines = raw[:, 0], raw[:, 1:]
    out = np.empty((h, w * bpp), np.uint8)
    prior = np.zeros(w * bpp, np.uint8)
    for y in range(h):
        kind, line = int(kinds[y]), lines[y]
        if kind == 0:
            out[y] = line
        elif kind == 1:
            out[y] = np.cumsum(line.reshape(w, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif kind == 2:
            np.add(line, prior, out=out[y])
        elif kind in (3, 4):
            out[y] = _unfilter_slow(kind, line, prior, bpp)
        else:
            raise ValueError(f"{path}: row filter {kind}")
        prior = out[y]
    return out.reshape(h, w, bpp)


# ------------------------------------------------------------------ resize
_PRECISION_BITS = 22          # PIL's 8-bit resample: 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    """PIL's bicubic filter (a = -0.5) on float64."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _resample_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float64 matrix of PIL's fixed-point bicubic
    coefficients (``precompute_coeffs`` + ``normalize_coeffs_8bpc``),
    divided by 2**22 (exactly: a power of two)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) cast truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    taps = np.arange(ksize)
    live = taps[None] < xmax[:, None]
    w = _bicubic((taps[None] + xmin[:, None] - center[:, None] + 0.5)
                 * (1.0 / filterscale))
    w = np.where(live, w, 0.0)
    ww = np.zeros((out_size, 1))
    for t in range(ksize):              # summed in C's order
        ww[:, 0] += w[:, t]
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    one = float(1 << _PRECISION_BITS)
    k = np.where(w < 0, np.trunc(-0.5 + w * one), np.trunc(0.5 + w * one))
    mat = np.zeros((out_size, in_size), np.float64)
    cols = np.minimum(xmin[:, None] + taps[None], in_size - 1)
    rows = np.broadcast_to(np.arange(out_size)[:, None], cols.shape)
    np.add.at(mat, (rows[live], cols[live]), k[live])
    return mat * (1.0 / one)


def _resample_pass(x: np.ndarray, mat: np.ndarray,
                   block: int = 8) -> np.ndarray:
    """(out, in) fixed-point matrix / 2**22 @ (in, N) uint8 pixels,
    rounded and clipped as PIL's ``clip8`` does: (sum + 2**21) >> 22 into
    [0, 255]. Every product and partial sum is a multiple of 2**-22 below
    2**9, so float64 holds it exactly, and adding 0.5, clipping to [0,
    255.5] and truncating to uint8 is that floor and clip. Blocks of
    ``block`` outputs multiply only their band of inputs."""
    x = x.astype(np.float64)
    n_out = mat.shape[0]
    out = np.empty((n_out, x.shape[1]), np.float64)
    nz = mat != 0
    for o0 in range(0, n_out, block):
        o1 = min(o0 + block, n_out)
        cols = np.flatnonzero(nz[o0:o1].any(0))
        lo, hi = (cols[0], cols[-1] + 1) if len(cols) else (0, 0)
        np.matmul(mat[o0:o1, lo:hi], x[lo:hi], out=out[o0:o1])
    out += 0.5
    return np.clip(out, 0, 255.5, out=out).astype(np.uint8)


def resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL's ``Image.resize((w, h))`` of an (H, W, C) uint8 image with its
    default filter (bicubic), bit for bit. Like PIL, the horizontal pass
    writes a uint8 image that the vertical pass reads."""
    w_out, h_out = int(size[0]), int(size[1])
    h, w, c = img.shape
    x = np.ascontiguousarray(img, np.uint8)
    if w_out != w:
        x = _resample_pass(
            np.ascontiguousarray(x.transpose(1, 0, 2)).reshape(w, h * c),
            _resample_matrix(w, w_out))
        x = np.ascontiguousarray(x.reshape(w_out, h, c).transpose(1, 0, 2))
    if h_out != h:
        x = _resample_pass(x.reshape(h, w_out * c),
                           _resample_matrix(h, h_out)).reshape(
                               h_out, w_out, c)
    return x.copy() if x is img else x


# ------------------------------------------------- crop, flip and rotate
def crop(img: np.ndarray, box: Sequence[int]) -> np.ndarray:
    """PIL's ``Image.crop((x0, y0, x1, y1))``: zeros outside the image."""
    x0, y0, x1, y1 = (int(v) for v in box)
    h, w = img.shape[:2]
    out = np.zeros((max(y1 - y0, 0), max(x1 - x0, 0)) + img.shape[2:],
                   img.dtype)
    sx0, sy0, sx1, sy1 = max(x0, 0), max(y0, 0), min(x1, w), min(y1, h)
    if sx1 > sx0 and sy1 > sy0:
        out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = img[sy0:sy1, sx0:sx1]
    return out


def flip_lr(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(img[:, ::-1])


def rotate(img: np.ndarray, angle: float) -> np.ndarray:
    """PIL's ``Image.rotate(angle)`` (degrees counter-clockwise, nearest,
    about the centre, same size, zero fill): the inverse affine map of
    ``Image.rotate`` in double, then ``affine_fixed``'s 16.16 fixed point
    (``FIX(v) = floor(v * 65536 + 0.5)``, source index = value >> 16)."""
    angle = angle % 360.0
    if angle == 0:
        return img.copy()
    h, w = img.shape[:2]
    if angle == 180:
        return np.ascontiguousarray(img[::-1, ::-1])
    if angle in (90, 270) and w == h:
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else 3))
    cx, cy = w / 2, h / 2
    rad = -math.radians(angle)
    a, b = round(math.cos(rad), 15), round(math.sin(rad), 15)
    d, e = round(-math.sin(rad), 15), round(math.cos(rad), 15)
    c = a * -cx + b * -cy + 0.0 + cx
    f = d * -cx + e * -cy + 0.0 + cy
    if b == 0 and d == 0:
        raise NotImplementedError("a scaling affine map (PIL's "
                                  "ImagingScaleAffine) is not ported")
    if max(abs(x * a + y * b + c) for x in (0, w) for y in (0, h)) >= \
            32768.0 or max(abs(x * d + y * e + f) for x in (0, w)
                           for y in (0, h)) >= 32768.0:
        raise NotImplementedError("PIL's floating-point affine path")

    def fix(v: float) -> int:
        return math.floor(v * 65536.0 + 0.5)

    a0, a1, a3, a4 = fix(a), fix(b), fix(d), fix(e)
    a2, a5 = fix(c + a * 0.5 + b * 0.5), fix(f + d * 0.5 + e * 0.5)
    ys = np.arange(h, dtype=np.int64)[:, None]
    xs = np.arange(w, dtype=np.int64)[None]
    xin = (a2 + ys * a1 + xs * a0) >> 16
    yin = (a5 + ys * a4 + xs * a3) >> 16
    ok = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    out = np.zeros_like(img)
    out[ok] = img[yin[ok], xin[ok]]
    return out
