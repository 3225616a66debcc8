"""Image loading for training targets and mesh textures.

Port of ``raytpu/io/image.py``'s PPM route (``load_rgb``, ``load_gray``,
``load_texture_pair``). Only ASCII PPM is read: ``raytpu`` reads PNG
through PIL, which the CUDA card's machine does not have, so a PNG path
raises and says so. Rows are bottom-up (row 0 = image bottom), like pixel
ids and texture v; samples are ``n * f32(1/maxval)``.
"""

from __future__ import annotations

import os

import numpy as np

from raytpu_torch.io.ppm import read_ppm


def _ppm_only(path: str) -> None:
    raise ValueError(
        f"{path}: raytpu_torch reads only ASCII .ppm images (PNG needs PIL, "
        "which the port does not depend on); convert it to P3 PPM"
    )


def load_rgb(path: str) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1], bottom-up rows, from a ``.ppm``."""
    if path.lower().endswith(".ppm"):
        return read_ppm(path, bottom_up=True)
    _ppm_only(path)


def load_gray(path: str) -> np.ndarray:
    """(H, W) float32: the first channel of a ``.ppm`` (the reference
    reads an alpha companion as ``"%lf %*lf %*lf"``, texture.h:237)."""
    if path.lower().endswith(".ppm"):
        return read_ppm(path, bottom_up=True)[..., 0]
    _ppm_only(path)


def load_texture_pair(mtl_png_path: str) -> tuple[np.ndarray, np.ndarray]:
    """A MTL ``map_Kd`` path -> (rgb (H, W, 3), alpha (H, W)), the
    reference's resolution (texture.h:180-227): ``<base>.ppm`` beside the
    named file, with ``<base>_alpha.ppm`` as alpha (first channel) or fully
    opaque without one."""
    base, _ = os.path.splitext(mtl_png_path)
    ppm, alpha_ppm = base + ".ppm", base + "_alpha.ppm"
    if not os.path.exists(ppm):
        if os.path.exists(mtl_png_path):
            _ppm_only(mtl_png_path)
        raise FileNotFoundError(f"texture not found: {mtl_png_path} (nor {ppm})")
    rgb = load_rgb(ppm)
    if os.path.exists(alpha_ppm):
        return rgb, load_gray(alpha_ppm)
    return rgb, np.ones(rgb.shape[:2], np.float32)
