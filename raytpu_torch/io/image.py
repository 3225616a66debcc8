"""Image loading for training targets (``raytpu.io.image.load_rgb``).

Only ASCII PPM is read: ``raytpu`` reads PNG through PIL, which the CUDA
card's machine does not have, so a PNG path raises and says so. Rows are
bottom-up (row 0 = image bottom), like pixel ids.
"""

from __future__ import annotations

import numpy as np

from raytpu_torch.io.ppm import read_ppm


def load_rgb(path: str) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1], bottom-up rows, from a ``.ppm``."""
    if path.lower().endswith(".ppm"):
        return read_ppm(path, bottom_up=True)
    raise ValueError(
        f"{path}: raytpu_torch reads only ASCII .ppm images (PNG needs PIL, "
        "which the port does not depend on); convert the target to P3 PPM"
    )
