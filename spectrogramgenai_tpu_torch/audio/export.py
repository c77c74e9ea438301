"""Generated-image export: viridis colormap and PNG encoding.

Counterpart of the generated-sample half of ``spectrogramgenai_tpu/audio/export.py``
without PIL or matplotlib: the viridis table is a constant here, and the PNG
encoder is the standard library's ``zlib`` and ``struct``. Output is 8-bit
RGB, pixel-equal to the JAX package's viridis PNGs.
"""

from __future__ import annotations

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


def save_generated_pngs(imgs_uint8: np.ndarray, paths: list[str]) -> None:
    """Write each uint8 sample of (n, H, W[, 1]) as a viridis PNG to its path."""
    for png, path in zip(generated_png_bytes(imgs_uint8), paths, strict=True):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            f.write(png)
