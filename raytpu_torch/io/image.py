"""Image loading for training targets and mesh textures: ASCII PPM and PNG.

Port of ``raytpu/io/image.py`` (``load_rgb``, ``load_gray``,
``load_png_alpha``, ``load_texture_pair``). PPM is read by ``io.ppm``;
any other file (PNG) through PIL, imported only when such a file is
asked for. PIL is optional: the CUDA card's machine has none, so PPM is
the format there, and a PNG without PIL raises an ``ImportError`` that
says to convert it to P3 PPM. Rows are bottom-up (row 0 = image bottom),
like pixel ids and texture v; samples are ``n * f32(1/maxval)``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from raytpu_torch.io.ppm import read_ppm


def pil_image(path: str):
    """PIL's ``Image`` module, or an ``ImportError`` naming PIL and the
    ``.ppm`` alternative."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{path}: reading or writing a non-PPM image needs PIL (Pillow), "
            "which is not installed; convert it to an ASCII P3 .ppm, which "
            "raytpu_torch reads without it") from e
    return Image


def _u8(arr) -> np.ndarray:
    """u8 samples as ``n * f32(1/255)``, rows flipped to bottom-up (PIL
    is top-down)."""
    arr = np.asarray(arr, np.float32) * np.float32(1.0 / 255.0)
    return np.ascontiguousarray(arr[::-1])


def load_rgb(path: str) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1], bottom-up rows."""
    if path.lower().endswith(".ppm"):
        return read_ppm(path, bottom_up=True)
    return _u8(pil_image(path).open(path).convert("RGB"))


def load_gray(path: str) -> np.ndarray:
    """(H, W) float32 in [0, 1], bottom-up rows. For a PPM the first
    channel (the reference reads an alpha companion as
    ``"%lf %*lf %*lf"``, texture.h:237), for a PNG its luminance."""
    if path.lower().endswith(".ppm"):
        return read_ppm(path, bottom_up=True)[..., 0]
    return _u8(pil_image(path).open(path).convert("L"))


def load_png_alpha(path: str) -> Optional[np.ndarray]:
    """The alpha channel (H, W) of an RGBA, LA or PA PNG, bottom-up, or
    None for a PNG without one."""
    im = pil_image(path).open(path)
    if im.mode in ("RGBA", "LA", "PA"):
        return _u8(np.asarray(im.convert("RGBA"))[..., 3])
    return None


def load_texture_pair(mtl_png_path: str) -> tuple[np.ndarray, np.ndarray]:
    """A MTL ``map_Kd`` path -> (rgb (H, W, 3), alpha (H, W)).

    The reference's resolution (texture.h:180-227), then ``raytpu``'s:
      1. ``<base>.ppm`` beside the named file, with ``<base>_alpha.ppm``
         as alpha (first channel), else fully opaque;
      2. the named file itself (PNG) with ``<base>_alpha.png`` as alpha;
      3. else the PNG's own alpha channel;
      4. else fully opaque.
    """
    base, ext = os.path.splitext(mtl_png_path)
    ppm, alpha_ppm = base + ".ppm", base + "_alpha.ppm"
    if os.path.exists(ppm):
        rgb = load_rgb(ppm)
        if os.path.exists(alpha_ppm):
            return rgb, load_gray(alpha_ppm)
        return rgb, np.ones(rgb.shape[:2], np.float32)
    if not os.path.exists(mtl_png_path):
        raise FileNotFoundError(f"texture not found: {mtl_png_path} (nor {ppm})")
    rgb = load_rgb(mtl_png_path)
    alpha_png = base + "_alpha.png"
    if os.path.exists(alpha_png):
        return rgb, load_gray(alpha_png)
    a = load_png_alpha(mtl_png_path) if ext.lower() == ".png" else None
    return rgb, a if a is not None else np.ones(rgb.shape[:2], np.float32)
