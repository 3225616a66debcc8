"""Scene representation: SoA dataclasses of tensors.

Port of ``raytpu/core/types.py`` for the sphere-only slice: ``Materials``
and ``Spheres`` keep the JAX package's structure-of-arrays layout, and
``Scene`` holds the spheres plus the two facts the kernel gates read
(triangle count, equirect-sky sphere). ``RenderConfig`` has the same
fields and defaults as ``raytpu.core.types.RenderConfig``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
from torch import Tensor

from raytpu_torch.core.vec3 import Vec3


@dataclass(frozen=True)
class Materials:
    """Material SoA (struct Material): one entry per sphere."""

    diffuse: Vec3
    emission: Vec3
    emission_strength: Tensor
    reflection: Tensor       # in [0, 1]
    alpha: Tensor            # opacity; < refr_alpha_lo cutout, <= refr_alpha_hi refractive
    ior: Tensor              # refractive index


@dataclass(frozen=True)
class Spheres:
    """Sphere SoA (struct Sphere)."""

    center: Vec3   # (S,)
    radius: Tensor  # (S,)
    mat: Materials  # (S,)

    @property
    def count(self) -> int:
        return self.radius.shape[0]


@dataclass(frozen=True)
class Scene:
    """Sphere scene. The render runs on the device of these tensors.

    ``n_triangles`` and ``sky_sphere_index`` carry over what a converted
    ``raytpu`` scene holds beyond spheres; the port renders neither yet, so
    a scene with triangles or an equirect sky is refused by the kernel
    gates (``kernels.trace_spheres.supported``) instead of being rendered
    without them.
    """

    spheres: Spheres
    n_triangles: int = 0
    sky_sphere_index: int = -1   # equirect-sky sphere, or -1

    @property
    def device(self) -> torch.device:
        return self.spheres.radius.device


@dataclass(frozen=True)
class RenderConfig:
    """Static render parameters; fields and defaults mirror
    ``raytpu.core.types.RenderConfig``. Fields that select JAX execution
    paths (``use_pallas``, ``pallas_interpret``, ``sample_chunk``,
    ``use_megakernel``) and the mesh fields are kept for parity and not
    read: the port has one trace path, the K1 wrapper."""

    width: int = 400
    height: int = 300
    spp: int = 100
    max_bounces: int = 5
    use_ao: bool = False
    ao_intensity: float = 2.5
    ao_samples: int = 1
    focus_distance: float = 3.0
    aperture_x: float = 0.0
    aperture_y: float = 0.0
    hsl_l_factor: float = 1.0
    hsl_s_factor: float = 1.0
    bright_boost: float = 1.3
    bright_threshold: float = 0.5
    ao_emission_factor: float = 1.5
    sphere_eps: float = 1e-4
    tri_det_eps: float = 1e-6
    tri_eps: float = 1e-7
    refr_alpha_lo: float = 1e-4
    refr_alpha_hi: float = 0.99
    pixel_tile: int = 16384
    sample_chunk: int = 1
    use_pallas: "bool | None" = None
    pallas_interpret: bool = False
    use_megakernel: bool = False
    bilinear_textures: bool = False
    sky_texture_grads: bool = False
    merge_quads: bool = True
    quad_pairs: "tuple[tuple[int, int, int], ...]" = ()
    quad_aa_rects: tuple = ()
    quad_aa_tris: tuple = ()

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
