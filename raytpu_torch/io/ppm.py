"""PPM (P3 ASCII) output, byte-identical to ``raytpu.io.ppm.write_ppm``:
a header, then one "r g b" int triplet per line, rows top-down."""

from __future__ import annotations

import numpy as np


def write_ppm(path: str, canvas: np.ndarray) -> None:
    """canvas: (H, W, 3) ints in 0..255, row 0 = top."""
    h, w, _ = canvas.shape
    flat = canvas.reshape(-1, 3).astype(np.int64)
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        np.savetxt(f, flat, fmt="%d")
