"""PPM (P3 ASCII) read/write, as ``raytpu.io.ppm``.

``write_ppm`` is byte-identical to ``raytpu``'s: a header, then one
"r g b" int triplet per line, rows top-down. ``read_ppm`` is its reader
(``raytpu``'s C++ fast path gives the same values); numpy parses the
samples, so a 4096x2048 sky (25 M numbers) reads in seconds.
"""

from __future__ import annotations

import re

import numpy as np


def write_ppm(path: str, canvas: np.ndarray) -> None:
    """canvas: (H, W, 3) ints in 0..255, row 0 = top."""
    h, w, _ = canvas.shape
    flat = canvas.reshape(-1).astype(np.int64).tolist()
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        f.write(("%d %d %d\n" * (h * w)) % tuple(flat))


def read_ppm(path: str, bottom_up: bool = True) -> np.ndarray:
    """Read ASCII P3 -> (H, W, 3) float32 in [0, 1], samples scaled as
    ``n * f32(1/maxval)``. ``bottom_up`` stores rows bottom-up (row 0 =
    image bottom), the layout pixel ids and textures index."""
    with open(path, "rb") as f:
        data = f.read()
    if b"#" in data:      # comments run to the end of the line
        data = re.sub(rb"#[^\n\r]*", b" ", data)
    tokens = data.split(maxsplit=4)    # magic, width, height, maxval, samples
    if not tokens or tokens[0] != b"P3":
        raise ValueError(f"{path}: not an ASCII P3 PPM "
                         f"(got {tokens[0] if tokens else b''!r})")
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    n = w * h * 3
    body = tokens[4] if len(tokens) > 4 else b""
    vals = np.fromstring(body, dtype=np.float32, sep=" ")[:n]
    if vals.size != n:
        raise ValueError(f"{path}: expected {n} samples, got {vals.size}")
    img = vals.reshape(h, w, 3) * np.float32(1.0 / maxval)
    if bottom_up:
        img = img[::-1]
    return np.ascontiguousarray(img)
