"""Spectrogram and generated-image export: viridis colormap, PNG encoding and decoding.

Counterpart of ``spectrogramgenai_tpu/audio/export.py`` without PIL or
matplotlib: the viridis table is a constant here. Every PNG the package
writes goes through the batch encoder of ``data/native_png.py``
(``csrc/png_batch.cpp``: 8-bit RGB, Sub filter, zlib level 3, a C++ thread
pool), as the JAX package's batch writers and server do; the output is
pixel-equal to the JAX package's viridis PNGs (the bytes may differ from its
PIL path). :func:`load_image_grayscale` and :func:`load_image_rgb` are the
NumPy reader (``zlib`` and ``struct``): it reads what ``csrc/png_batch.cpp``
decodes (8-bit, non-interlaced, colour types 0, 2, 3, 4, 6, all five row
filters) and converts as PIL's ``convert("L")`` / ``convert("RGB")`` do, bit
for bit.
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np

from spectrogramgenai_tpu_torch.data.native_png import encode_png_batch_rgb, save_png_batch_rgb

# matplotlib's viridis sampled at i/255 for i = 0 … 255, as uint8 RGB
# ((cm.viridis(np.arange(256) / 255.0) * 255).astype(np.uint8)[:, :3]).
_VIRIDIS_HEX = (
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163471265471466471567471669"
    "47186a48196b481a6c481c6e481d6f481e70482071482172482273482374472575472676472777472878472a79472b7a"
    "472c7b462d7c462f7c46307d46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c893c4d8a3c4e8a3b508a3b518a"
    "3a528b3a538b39548b39558b38568b38578c37588c37598c365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d"
    "32628d32638d31648d31658d31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e277d8e277e8e267f8e26808e"
    "26818e25828e25838d24848d24858d24868d23878d23888d23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c"
    "20908c20918c1f928c1f938b1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a98224aa8225ab8126ac8127ad80"
    "28ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a32b57a33b67935b77836b87738b97639b9763bba753dbb74"
    "3ebc7340bd7242be7144be7045bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d05279d1517cd24f7ed24e81d34c"
    "83d34b86d44988d5478bd5468dd64490d64392d74195d73f97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32"
    "addc30afdc2eb2dd2cb5dd2bb7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51ef6e61ff8e621fae622fde724"
)
VIRIDIS_LUT = np.frombuffer(bytes.fromhex(_VIRIDIS_HEX), dtype=np.uint8).reshape(256, 3)

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def encode_png_rgb(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 → PNG bytes (8-bit RGB, Sub filter, zlib level 3)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    return encode_png_batch_rgb(rgb[None])[0]


def viridis_rgb(imgs_uint8: np.ndarray) -> np.ndarray:
    """uint8 samples (…, H, W) or (…, H, W, 1) → viridis RGB (…, H, W, 3)."""
    imgs = np.asarray(imgs_uint8)
    if imgs.shape[-1] == 1:
        imgs = imgs[..., 0]
    return VIRIDIS_LUT[imgs.astype(np.uint8)]


def generated_png_bytes(imgs_uint8: np.ndarray) -> list[bytes]:
    """A batch of uint8 samples (n, H, W[, 1]) → one viridis PNG each, in one native call."""
    return encode_png_batch_rgb(viridis_rgb(imgs_uint8))


def _write_pngs(rgb: np.ndarray, paths: list[str]) -> None:
    """(n, H, W, 3) uint8 → one PNG file each, in one native call; makes the directories."""
    if len(rgb) != len(paths):
        raise ValueError(f"{len(rgb)} images for {len(paths)} paths")
    for d in {os.path.dirname(p) for p in paths} - {""}:
        os.makedirs(d, exist_ok=True)
    save_png_batch_rgb(rgb, paths)


def save_generated_pngs(imgs_uint8: np.ndarray, paths: list[str]) -> None:
    """Write each uint8 sample of (n, H, W[, 1]) as a viridis PNG to its path."""
    _write_pngs(viridis_rgb(imgs_uint8), paths)


def save_panel_grid(rows: list[list[np.ndarray]], path: str, gap: int = 4) -> None:
    """Write a grid of 2-D float panels as one viridis PNG: each panel scaled
    by its own min and max and drawn with row 0 at the bottom (matplotlib's
    ``imshow(origin="lower")``), enlarged by the largest whole factor that
    fits the grid's cell (the largest panel), centred in it, on white, with
    ``gap`` pixels between cells. The figure has no titles."""
    cell_h = max(p.shape[0] for row in rows for p in row)
    cell_w = max(p.shape[1] for row in rows for p in row)
    n_cols = max(len(row) for row in rows)
    canvas = np.full((len(rows) * (cell_h + gap) - gap, n_cols * (cell_w + gap) - gap, 3), 255, np.uint8)
    for r, row in enumerate(rows):
        for c, panel in enumerate(row):
            panel = np.asarray(panel, np.float64)
            f = max(1, min(cell_h // panel.shape[0], cell_w // panel.shape[1]))
            rgb = spectrogram_rgb(panel[None, ::-1])[0].repeat(f, axis=0).repeat(f, axis=1)
            top = r * (cell_h + gap) + (cell_h - rgb.shape[0]) // 2
            left = c * (cell_w + gap) + (cell_w - rgb.shape[1]) // 2
            canvas[top:top + rgb.shape[0], left:left + rgb.shape[1]] = rgb
    _write_pngs(canvas[None], [path])


def spec_png_name(file_name: str, begin_time: float) -> str:
    """The reference's spectrogram file key, ``{file}_{begin}_{begin}.png``."""
    b = int(begin_time)
    return f"{file_name}_{b}_{b}.png"


def spectrogram_rgb(specs: np.ndarray) -> np.ndarray:
    """(n, H, W) float spectrograms → (n, H, W, 3) viridis uint8, each image
    scaled by its own min and max (matplotlib ``plt.imsave``), LUT index
    ``clip(int(x·256), 0, 255)``."""
    specs = np.asarray(specs)
    lo = specs.min(axis=(1, 2), keepdims=True)
    hi = specs.max(axis=(1, 2), keepdims=True)
    rng = np.where(hi > lo, hi - lo, 1.0)
    img01 = np.where(hi > lo, (specs - lo) / rng, 0.0)
    return VIRIDIS_LUT[np.clip((img01 * 256.0).astype(np.int32), 0, 255)]


def save_confusion_png(cm: np.ndarray, path: str, cell: int | None = None) -> None:
    """A (k, k) confusion matrix → a viridis PNG, ``cell`` × ``cell`` pixels a
    count (by default the largest that keeps the image within 256 pixels),
    row i (true class) at the top and column j (predicted) at the left, with no
    text: the colours of matplotlib's ``imshow(cm, cmap="viridis")``, scaled
    from the matrix's min to its max."""
    cm = np.asarray(cm, np.float64)
    cell = cell or max(1, 256 // max(cm.shape))
    _write_pngs(spectrogram_rgb(cm[None]).repeat(cell, axis=1).repeat(cell, axis=2), [path])


def save_spectrogram_pngs(specs: np.ndarray, paths: list[str]) -> None:
    """Write each (H, W) spectrogram of ``specs`` as a viridis PNG to its path.

    The colormap is one vectorised pass over the batch; the encodes and
    writes are one call into the native encoder's thread pool."""
    _write_pngs(spectrogram_rgb(specs), paths)


_COLOUR_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # gray, RGB, palette, gray + alpha, RGBA


def _rgb_to_l(rgb: np.ndarray) -> np.ndarray:
    """PIL's integer RGB → L: (R·19595 + G·38470 + B·7471 + 0x8000) >> 16."""
    rgb = rgb.astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of (h, 1 + stride) uint8 rows → (h, stride).
    Rows of filters 0 and 1 only (the port's own PNGs are Sub) take one
    vectorised pass."""
    kinds, data = rows[:, 0], rows[:, 1:]
    if not kinds.any():
        return data
    if kinds.max() <= 1:  # Sub: a running sum along the row, per byte of the pixel, mod 256
        h, stride = data.shape
        summed = np.cumsum(data.reshape(h, -1, bpp), axis=1, dtype=np.uint8).reshape(h, stride)
        return np.where(kinds[:, None] == 1, summed, data)
    if kinds.max() > 4:
        raise ValueError(f"unsupported PNG row filter {int(kinds.max())}")
    h, stride = data.shape
    out = np.empty_like(data)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        src, kind = data[y].astype(np.int32), kinds[y]
        if kind == 0:
            cur = src
        elif kind == 1:  # Sub: running sum along the row, per byte of the pixel
            cur = np.cumsum(src.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:  # Up
            cur = (src + prev) & 0xFF
        else:  # Average, Paeth: each pixel needs its reconstructed left neighbour
            cur = np.empty(stride, np.int32)
            left, up_left = np.zeros(bpp, np.int32), np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                up = prev[x:x + bpp]
                pred = (left + up) >> 1 if kind == 3 else _paeth(left, up, up_left)
                left = cur[x:x + bpp] = (src[x:x + bpp] + pred) & 0xFF
                up_left = up
        out[y] = cur
        prev = cur
    return out


def _decode_png(png: bytes) -> tuple[np.ndarray, int, bytes]:
    """PNG bytes → (pixels (H, W, channels) uint8, colour type, PLTE body).
    Raises ValueError on an encoding it does not read."""
    if not png.startswith(_PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    pos, ihdr, palette, idat = 8, None, b"", []
    while pos + 8 <= len(png):
        (length,) = struct.unpack(">I", png[pos:pos + 4])
        kind, body = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, colour, _, _, interlace = ihdr
    if depth != 8 or interlace != 0 or colour not in _COLOUR_CHANNELS:
        raise ValueError(f"unsupported PNG encoding: bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace} (8-bit, non-interlaced, colour types 0/2/3/4/6 only)")
    bpp = _COLOUR_CHANNELS[colour]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (1 + w * bpp):
        raise ValueError(f"PNG data is {len(raw)} bytes, expected {h * (1 + w * bpp)}")
    px = _unfilter(np.frombuffer(raw, np.uint8).reshape(h, 1 + w * bpp), bpp).reshape(h, w, bpp)
    if colour == 3 and len(palette) < 3:
        raise ValueError("palette PNG without a PLTE chunk")
    return px, colour, palette


def _palette_rgb(px: np.ndarray, palette: bytes) -> np.ndarray:
    lut = np.frombuffer(palette[: len(palette) // 3 * 3], np.uint8).reshape(-1, 3)
    idx = px[..., 0].astype(np.int64)
    return lut[np.where(idx < len(lut), idx, 0)]


def decode_png_gray(png: bytes) -> np.ndarray:
    """PNG bytes → (H, W) uint8, as PIL's ``Image.open(…).convert("L")``.
    Raises ValueError on an encoding it does not read."""
    px, colour, palette = _decode_png(png)
    if colour in (0, 4):  # gray, gray + alpha: L is the gray byte
        return px[..., 0].astype(np.uint8)
    if colour == 3:
        return _rgb_to_l(_palette_rgb(px, palette))
    return _rgb_to_l(px[..., :3])


def decode_png_rgb(png: bytes) -> np.ndarray:
    """PNG bytes → (H, W, 3) uint8, as PIL's ``Image.open(…).convert("RGB")``:
    gray is repeated over the channels, the palette looked up, alpha dropped."""
    px, colour, palette = _decode_png(png)
    if colour in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    if colour == 3:
        return _palette_rgb(px, palette)
    return np.ascontiguousarray(px[..., :3])


def load_image_rgb(path: str) -> np.ndarray:
    """A PNG file → (H, W, 3) uint8, as PIL's ``Image.open(path).convert("RGB")``."""
    with open(path, "rb") as f:
        return decode_png_rgb(f.read())


def load_generated_spec_uint8(path: str) -> np.ndarray:
    """The exact inverse of the viridis colormap of a generated PNG: viridis
    RGB → the original uint8 values, equal to the JAX function of the same
    name. Each pixel takes the nearest LUT entry by squared distance, the
    first on a tie. A pixel of a LUT colour is looked up (distance 0, the
    first entry of that colour); only the others are searched, in blocks of
    32 rows as JAX searches them all. ``convert("L")`` is not this inverse:
    its luminance warps values by up to 41/255, non-monotonically."""
    rgb = load_image_rgb(path).astype(np.int32)
    lut = VIRIDIS_LUT.astype(np.int32)  # (256, 3)
    keys, first = np.unique((lut[:, 0] << 16) | (lut[:, 1] << 8) | lut[:, 2], return_index=True)
    px = (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]
    pos = np.minimum(np.searchsorted(keys, px), len(keys) - 1)
    exact = keys[pos] == px
    out = first[pos].astype(np.uint8)
    for lo in range(0, rgb.shape[0], 32):  # row blocks bound the temporary to ~8 MB
        miss = ~exact[lo : lo + 32]
        if miss.any():
            block = rgb[lo : lo + 32][miss]
            d = ((block[:, None, :] - lut[None, :, :]) ** 2).sum(-1)
            out[lo : lo + 32][miss] = d.argmin(-1).astype(np.uint8)
    return out


# PIL's resampling of 8-bit images (libImaging/Resample.c): a separable
# convolution, horizontal pass first, with the filter's support widened by the
# scale on a downscale, its weights normalised in float64 and then rounded to
# fixed point with 22 fraction bits, and each pass rounded to uint8.
_PRECISION_BITS = 32 - 8 - 2


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


def _resample_coeffs(in_size: int, out_size: int, kind: str) -> tuple[np.ndarray, np.ndarray]:
    """(source index (out, k), fixed-point weight (out, k)) of one axis, as
    PIL's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` make them."""
    filt, support = _FILTERS[kind]
    scale = filterscale = in_size / out_size
    filterscale = max(filterscale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)  # C's (int) truncates
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)
    w = filt((x[None, :] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(x[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):  # the C loop's order of summation
        ww = ww + w[:, j]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    fixed = np.where(w < 0, -0.5 + w * (1 << _PRECISION_BITS), 0.5 + w * (1 << _PRECISION_BITS))
    return np.minimum(xmin[:, None] + x[None, :], in_size - 1), np.trunc(fixed).astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int, kind: str) -> np.ndarray:
    idx, k = _resample_coeffs(img.shape[axis], out_size, kind)
    taken = np.take(img.astype(np.int64), idx, axis=axis)  # the axis becomes (out, k)
    shape = [1] * taken.ndim
    shape[axis], shape[axis + 1] = k.shape
    acc = (taken * k.reshape(shape)).sum(axis=axis + 1) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def pil_resize(img: np.ndarray, size: tuple[int, int], kind: str = "bicubic") -> np.ndarray:
    """uint8 (H, W) or (H, W, C) → (height, width[, C]) with ``size`` =
    (width, height), bit-equal to PIL's ``Image.resize(size, BILINEAR or
    BICUBIC)`` of an L or RGB image (``bicubic`` is PIL's default filter)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"expected uint8, got {img.dtype}")
    width, height = size
    if img.shape[1] != width:
        img = _resample_axis(img, width, 1, kind)
    if img.shape[0] != height:
        img = _resample_axis(img, height, 0, kind)
    return img


def load_image_grayscale(path: str) -> np.ndarray:
    """An image file → (H, W) float32 in [0, 1]: a PNG as PIL's ``convert("L")``
    / 255, or a ``.npy`` spectrogram scaled by its own min and max."""
    if path.endswith(".npy"):
        spec = np.load(path).astype(np.float32)
        lo, hi = spec.min(), spec.max()
        return (spec - lo) / (hi - lo) if hi > lo else np.zeros_like(spec)
    with open(path, "rb") as f:
        return decode_png_gray(f.read()).astype(np.float32) / 255.0


def image_hw(path: str) -> tuple[int, int]:
    """(height, width) of a PNG (from its IHDR) or a .npy array, without decoding it."""
    if path.endswith(".npy"):
        arr = np.load(path, mmap_mode="r")
        return int(arr.shape[0]), int(arr.shape[1])
    with open(path, "rb") as f:
        head = f.read(24)
    if not head.startswith(_PNG_SIGNATURE) or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def save_spectrogram_npy(spec: np.ndarray, path: str) -> None:
    """The exact float32 spectrogram beside its PNG."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, np.asarray(spec, np.float32))
