"""Spectrogram and generated-image export: viridis colormap, PNG encoding and decoding.

Counterpart of ``spectrogramgenai_tpu/audio/export.py`` without PIL or
matplotlib: the viridis table is a constant here, and the PNG encoder and
reader are the standard library's ``zlib`` and ``struct`` with NumPy. Output
is 8-bit RGB, pixel-equal to the JAX package's viridis PNGs (the bytes may
differ). :func:`load_image_grayscale` reads what ``native/png_batch.cpp``
reads (8-bit, non-interlaced, colour types 0, 2, 3, 4, 6, all five row
filters) and converts as PIL's ``convert("L")`` does, bit for bit.
"""

from __future__ import annotations

import concurrent.futures
import os
import struct
import zlib

import numpy as np

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
ENCODE_THREADS = 8  # PNG encodes of a spectrogram batch in flight (the JAX package's default)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png_rgb(rgb: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 3) uint8 → PNG bytes (8-bit RGB, no filtering, zlib ``level``)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape} {rgb.dtype}")
    h, w, _ = rgb.shape
    rows = np.zeros((h, 1 + 3 * w), dtype=np.uint8)  # filter byte 0 before each row
    rows[:, 1:] = rgb.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit truecolour
    return (_PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def viridis_rgb(imgs_uint8: np.ndarray) -> np.ndarray:
    """uint8 samples (…, H, W) or (…, H, W, 1) → viridis RGB (…, H, W, 3)."""
    imgs = np.asarray(imgs_uint8)
    if imgs.shape[-1] == 1:
        imgs = imgs[..., 0]
    return VIRIDIS_LUT[imgs.astype(np.uint8)]


def generated_png_bytes(imgs_uint8: np.ndarray) -> list[bytes]:
    """A batch of uint8 samples (n, H, W[, 1]) → one viridis PNG each."""
    return [encode_png_rgb(rgb) for rgb in viridis_rgb(imgs_uint8)]


def _write_png(rgb: np.ndarray, path: str) -> None:
    data = encode_png_rgb(rgb)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def save_generated_pngs(imgs_uint8: np.ndarray, paths: list[str]) -> None:
    """Write each uint8 sample of (n, H, W[, 1]) as a viridis PNG to its path."""
    for rgb, path in zip(viridis_rgb(imgs_uint8), paths, strict=True):
        _write_png(rgb, path)


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
    _write_png(canvas, path)


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


def save_spectrogram_pngs(specs: np.ndarray, paths: list[str]) -> None:
    """Write each (H, W) spectrogram of ``specs`` as a viridis PNG to its path.

    The colormap is one vectorised pass over the batch; the zlib encodes and
    writes run in a thread pool (``zlib.compress`` releases the GIL)."""
    rgb = spectrogram_rgb(specs)
    if len(rgb) != len(paths):
        raise ValueError(f"{len(rgb)} spectrograms for {len(paths)} paths")
    with concurrent.futures.ThreadPoolExecutor(max_workers=ENCODE_THREADS) as pool:
        futures = [pool.submit(_write_png, im, p) for im, p in zip(rgb, paths)]
        for fut in futures:
            fut.result()


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
    Rows of filter 0 (the port's own PNGs) take one vectorised pass."""
    kinds, data = rows[:, 0], rows[:, 1:]
    if not kinds.any():
        return data
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


def decode_png_gray(png: bytes) -> np.ndarray:
    """PNG bytes → (H, W) uint8, as PIL's ``Image.open(…).convert("L")``.
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
    if colour in (0, 4):  # gray, gray + alpha: L is the gray byte
        return px[..., 0].astype(np.uint8)
    if colour == 3:
        if len(palette) < 3:
            raise ValueError("palette PNG without a PLTE chunk")
        lut = np.frombuffer(palette[: len(palette) // 3 * 3], np.uint8).reshape(-1, 3)
        idx = px[..., 0].astype(np.int64)
        return _rgb_to_l(lut[np.where(idx < len(lut), idx, 0)])
    return _rgb_to_l(px[..., :3])


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
