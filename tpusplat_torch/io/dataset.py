"""Image output (counterpart of ``save_png`` in ``tpusplat/io/dataset.py``;
the dataset readers are not ported yet)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def save_png(path, img) -> None:
    """Write [H, W, 3] floats in [0, 1] (a tensor on any device, or an
    array) as an 8-bit RGB PNG, with no dependencies."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    arr = np.round(np.clip(np.asarray(img), 0.0, 1.0) * 255.0).astype(np.uint8)
    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag, body):
        out = struct.pack(">I", len(body)) + tag + body
        return out + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)

    png = b"\x89PNG\r\n\x1a\n"
    png += chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
    png += chunk(b"IDAT", zlib.compress(raw, 6))
    png += chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(png)
