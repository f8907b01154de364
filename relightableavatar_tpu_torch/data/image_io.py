"""Image files and resizing for the port's host layer, on ``zlib`` and
numpy: the card's machine has no OpenCV, which the JAX package's dataset and
visualizer call for these.

- :func:`read_png` / :func:`write_png`: gray, gray + alpha, RGB and RGBA
  PNG, 8- and 16-bit on read (every filter type), 8-bit with the Up
  filter on write.
- :func:`read_rgb` / :func:`read_gray` / :func:`write_image`: what
  ``cv2.imread`` (as RGB, or ``IMREAD_GRAYSCALE``) and ``cv2.imwrite`` do
  for the dataset and the visualizer, dispatched on the extension.  JPEG
  and other formats go to OpenCV, imported only then; without it they raise
  :class:`NeedsOpenCV`, which names the file and the setting to use instead.
- :func:`resize`: ``cv2.resize`` of a float32 image with ``INTER_AREA``,
  ``INTER_LINEAR`` (both on OpenCV's coefficients) or, for any dtype,
  ``INTER_NEAREST``.
- :func:`write_hdr`: a Radiance RGBE file, as ``cv2.imwrite`` of ``.hdr``
  encodes each pixel.
"""
from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np

INTER_NEAREST = 0
INTER_LINEAR = 1
INTER_AREA = 3

_PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}      # color type -> samples a pixel
_PNG_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}         # samples a pixel -> color type
PNG_LEVEL = 6                                  # zlib level of written PNGs


class NeedsOpenCV(RuntimeError):
    """A file format or operation that only OpenCV provides, asked for
    where ``cv2`` cannot be imported."""


def import_cv2(path: str, what: str, instead: str):
    """``cv2``, or :class:`NeedsOpenCV` naming ``path``, what needed it and
    the setting to use ``instead``."""
    try:
        import cv2
    except ImportError:
        raise NeedsOpenCV(f"{path}: {what} needs OpenCV (cv2), which cannot be "
                          f"imported here; {instead}") from None
    return cv2


# ------------------------------------------------------------------ PNG
def _paeth_row(raw: bytes, prior: bytes, bpp: int, average: bool) -> bytearray:
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        if average:
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _unfilter(data: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The scanlines of a non-interlaced image, unfiltered: ``stride`` bytes
    a row, ``bpp`` bytes a pixel (a 16-bit sample is two bytes)."""
    rows = np.frombuffer(data, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected {height * (stride + 1)}")
    rows = rows.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        f, raw = int(rows[y, 0]), rows[y, 1:]
        if f == 0:
            cur = raw.copy()
        elif f == 1:
            cur = (np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint64) % 256
                   ).astype(np.uint8).reshape(-1)
        elif f == 2:
            cur = raw + prior
        elif f in (3, 4):
            cur = np.frombuffer(_paeth_row(raw.tobytes(), prior.tobytes(), bpp, f == 3),
                                np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {f}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """(H, W) for gray, (H, W, 2) gray + alpha, (H, W, 3) RGB, (H, W, 4)
    RGBA: uint8 for 8-bit and uint16 for 16-bit (big-endian samples, as
    ``fixtures/golden_relight_512.png`` holds them) non-interlaced PNG."""
    with open(path, 'rb') as f:
        buf = f.read()
    if buf[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(buf):
        n, kind = struct.unpack('>I4s', buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b'IHDR':
            hdr = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = hdr
    if depth not in (8, 16) or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(f"{path}: only 8- and 16-bit, non-interlaced gray, gray + alpha, "
                         f"RGB and RGBA PNGs are read (bit depth {depth}, color type "
                         f"{ctype}, interlace {interlace})")
    ch = _PNG_CHANNELS[ctype]
    bpp = ch * depth // 8
    px = _unfilter(zlib.decompress(b''.join(idat)), height, width * bpp, bpp)
    if depth == 16:
        px = px.view('>u2').astype(np.uint16)
    return px.reshape(height, width) if ch == 1 else px.reshape(height, width, ch)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit PNG of a uint8 image: (H, W) or (H, W, 1) gray, (H, W, 2)
    gray + alpha, (H, W, 3) RGB, (H, W, 4) RGBA."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in _PNG_TYPES:
        raise ValueError(f"cannot write an image of shape {img.shape} as PNG")
    H, W, ch = img.shape
    rows = np.ascontiguousarray(img).reshape(H, W * ch)
    up = rows.copy()
    up[1:] -= rows[:-1]                                    # filter 2 (Up), mod 256
    data = np.concatenate([np.full((H, 1), 2, np.uint8), up], axis=1)
    png = (_PNG_SIGNATURE
           + _chunk(b'IHDR', struct.pack('>IIBBBBB', W, H, 8, _PNG_TYPES[ch], 0, 0, 0))
           + _chunk(b'IDAT', zlib.compress(data.tobytes(), PNG_LEVEL))
           + _chunk(b'IEND', b''))
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        f.write(png)
    os.replace(tmp, path)


def _gray_from_rgb(rgb: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(RGB2GRAY)`` of uint8: 14-bit fixed point weights."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    return ((r * 4899 + g * 9617 + b * 1868 + (1 << 13)) >> 14).astype(np.uint8)


def read_rgb(path: str) -> np.ndarray:
    """uint8 (H, W, 3) RGB, as ``cv2.cvtColor(cv2.imread(path), BGR2RGB)``
    (alpha dropped, gray repeated)."""
    if path.lower().endswith('.png'):
        img = read_png(path)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] in (1, 2):
            return np.repeat(img[..., :1], 3, axis=-1)
        return np.ascontiguousarray(img[..., :3])
    cv2 = import_cv2(path, "decoding this format",
                     "write the dataset's images as PNG (python -m "
                     "relightableavatar_tpu_torch.data.make_synthetic does)")
    img = cv2.imread(path)
    if img is None:
        raise ValueError(f"{path}: cannot be decoded")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def read_gray(path: str) -> np.ndarray:
    """uint8 (H, W), as ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``."""
    if path.lower().endswith('.png'):
        img = read_png(path)
        if img.ndim == 2:
            return img
        if img.shape[-1] == 2:
            return np.ascontiguousarray(img[..., 0])
        return _gray_from_rgb(img)
    cv2 = import_cv2(path, "decoding this format", "store the masks as PNG")
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise ValueError(f"{path}: cannot be decoded")
    return img


def write_image(path: str, img: np.ndarray) -> None:
    """A uint8 image, gray, RGB or RGBA (channels in that order), by the
    file's extension: PNG here, any other format through OpenCV."""
    if path.lower().endswith('.png'):
        write_png(path, img)
        return
    cv2 = import_cv2(path, "encoding this format", "set vis_ext .png")
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] == 4:
        img = img[..., [2, 1, 0, 3]]
    elif img.ndim == 3 and img.shape[-1] == 3:
        img = img[..., ::-1]
    if not cv2.imwrite(path, np.ascontiguousarray(img)):
        raise ValueError(f"{path}: OpenCV could not write it")


# ------------------------------------------------------------------ resize
def _linear_taps(dsize: int, ssize: int, area_mode: bool):
    """OpenCV's 2-tap coefficients: source index and weight of the second
    tap a destination index, clamped at the borders.  The linear weights are
    taken in double precision, as ``cv2.resize`` of an image of more than
    one row gives them (a one-row image goes through ``resizeGeneric``,
    which rounds the source coordinate to float first: up to 2e-6 apart)."""
    inv_scale = dsize / ssize
    scale = 1.0 / inv_scale
    d = np.arange(dsize, dtype=np.float64)
    if not area_mode:
        f = (d + 0.5) * scale - 0.5
        s = np.floor(f).astype(np.int64)
        f = (f - s).astype(np.float32)
    else:
        s = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (s + 1) * inv_scale).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    low = s < 0
    f[low], s[low] = 0, 0
    high = s >= ssize - 1
    f[high], s[high] = 0, ssize - 1
    return s, f


def _area_matrix(dsize: int, ssize: int) -> np.ndarray:
    """(dsize, ssize) weights of OpenCV's ``computeResizeAreaTab`` for a
    downscale by ``ssize / dsize``."""
    scale = ssize / dsize
    m = np.zeros((dsize, ssize), np.float64)
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            m[dx, sx1 - 1] = np.float32((sx1 - fsx1) / cell)
        m[dx, sx1:sx2] = np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            m[dx, sx2] = np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return m


def resize(img: np.ndarray, dsize: tuple, interpolation: int = INTER_LINEAR) -> np.ndarray:
    """``cv2.resize(img, dsize=(W, H), interpolation=...)`` for (H, W) or
    (H, W, C) images; INTER_AREA and INTER_LINEAR take float32 images."""
    W, H = int(dsize[0]), int(dsize[1])
    img = np.asarray(img)
    sH, sW = img.shape[:2]
    if interpolation == INTER_NEAREST:
        ys = np.minimum(np.floor(np.arange(H) * (1.0 / (H / sH))).astype(np.int64), sH - 1)
        xs = np.minimum(np.floor(np.arange(W) * (1.0 / (W / sW))).astype(np.int64), sW - 1)
        return np.ascontiguousarray(img[ys][:, xs])
    if interpolation not in (INTER_LINEAR, INTER_AREA):
        raise ValueError(f"unsupported interpolation {interpolation}")
    if img.dtype != np.float32:
        raise TypeError(f"resize with interpolation {interpolation} takes float32 "
                        f"images, got {img.dtype}")
    scale_x, scale_y = sW / W, sH / H
    if (interpolation == INTER_LINEAR and scale_x == 2 and scale_y == 2):
        interpolation = INTER_AREA              # OpenCV's rule for an exact halving
    x = img if img.ndim == 3 else img[..., None]
    if interpolation == INTER_AREA and scale_x >= 1 and scale_y >= 1:
        out = np.einsum('ys,sxc->yxc', _area_matrix(H, sH),
                        np.einsum('xs,ysc->yxc', _area_matrix(W, sW), x.astype(np.float64)))
        out = out.astype(np.float32)
    else:
        area = interpolation == INTER_AREA
        sx, fx = _linear_taps(W, sW, area)
        sy, fy = _linear_taps(H, sH, area)
        sx1 = np.minimum(sx + 1, sW - 1)
        sy1 = np.minimum(sy + 1, sH - 1)
        one = np.float32(1)
        h = x[:, sx] * (one - fx)[None, :, None] + x[:, sx1] * fx[None, :, None]
        out = h[sy] * (one - fy)[:, None, None] + h[sy1] * fy[:, None, None]
    return out if img.ndim == 3 else out[..., 0]


# ------------------------------------------------------------------ HDR
def _rgbe(rgb: np.ndarray) -> np.ndarray:
    """(N, 3) float32 -> (N, 4) uint8, as OpenCV's ``float2rgbe``."""
    rgb = rgb.astype(np.float32)
    v = rgb.max(axis=1)
    out = np.zeros((len(rgb), 4), np.uint8)
    ok = v >= 1e-32
    m, e = np.frexp(v[ok])
    scale = (m.astype(np.float64) * 256.0 / v[ok]).astype(np.float32)
    out[ok, :3] = np.clip(rgb[ok] * scale[:, None], 0, 255).astype(np.uint8)
    out[ok, 3] = (e + 128).astype(np.uint8)
    return out


def write_hdr(path: str, rgb: np.ndarray) -> None:
    """A Radiance ``.hdr`` file of a float (H, W, 3) RGB image: each
    scanline run-length encoded without runs (dumps of at most 128 bytes a
    component), so every reader takes it as RLE."""
    rgb = np.asarray(rgb, np.float32)
    H, W = rgb.shape[:2]
    px = _rgbe(rgb[..., :3].reshape(-1, 3)).reshape(H, W, 4)
    parts = [b'#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n', f'-Y {H} +X {W}\n'.encode()]
    rle = 8 <= W <= 0x7fff
    for y in range(H):
        if not rle:
            parts.append(px[y].tobytes())
            continue
        parts.append(bytes([2, 2, W >> 8, W & 0xFF]))
        for c in range(4):
            comp = px[y, :, c].tobytes()
            for s in range(0, W, 128):
                seg = comp[s:s + 128]
                parts.append(bytes([len(seg)]) + seg)
    with open(path, 'wb') as f:
        f.write(b''.join(parts))
