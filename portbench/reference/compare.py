"""The comparisons that decide ``correct`` for generated images, and a
plain PNG reader for served responses (zlib and the five PNG filters; 8-bit
RGB only, which is what the server sends)."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np
import torch

# matplotlib's viridis at i/255, i = 0 … 255, as uint8 RGB (the served colour map)
VIRIDIS = np.frombuffer(bytes.fromhex((Path(__file__).parent / "viridis.hex").read_text().strip()),
                        np.uint8).reshape(256, 3)


def latent_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst sample's ‖prog − ref‖ / ‖ref‖ over (n, …) latents."""
    p, r = prog.double().flatten(1), ref.double().flatten(1)
    return float(((p - r).norm(dim=1) / r.norm(dim=1).clamp_min(1e-30)).max())


def image_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst sample's mean |prog − ref| over (n, …) uint8 images, as a share of 255."""
    d = (prog.to(ref.device).float() - ref.float()).abs().flatten(1).mean(dim=1) / 255.0
    return float(d.max())


def png_rgb(data: bytes) -> np.ndarray:
    """An 8-bit RGB, non-interlaced PNG → (H, W, 3) uint8."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) != struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError("bad chunk CRC")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, colour, _, _, interlace = hdr
    if (depth, colour, interlace) != (8, 2, 0):
        raise ValueError(f"unsupported PNG: depth {depth}, colour type {colour}, interlace {interlace}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    out = np.zeros((h, 3 * w), np.int32)
    prev = np.zeros(3 * w, np.int32)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 2:
            cur = (line + prev) & 255
        else:  # Sub, Average, Paeth run left to right
            cur = np.zeros_like(line)
            for x in range(3 * w):
                a = cur[x - 3] if x >= 3 else 0
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + prev[x]) // 2
                elif f == 4:
                    b, c = prev[x], prev[x - 3] if x >= 3 else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                else:
                    raise ValueError(f"bad filter {f}")
                cur[x] = (line[x] + pred) & 255
        out[y] = cur
        prev = cur
    return out.reshape(h, w, 3).astype(np.uint8)
