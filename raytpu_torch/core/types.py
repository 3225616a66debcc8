"""Scene representation: SoA dataclasses of tensors.

Port of ``raytpu/core/types.py``: ``Materials``, ``Spheres``,
``Triangles``, ``TextureAtlas`` and ``MatTable`` keep the JAX package's
structure-of-arrays layout, and ``Scene`` holds them plus the
equirect ``SkyTexture`` and the index of the sphere it is mapped onto.
``TextureAtlas`` and ``SkyTexture`` have no u8-packed twin: the port
keeps f32 texels, which equal the u8 codes times f32(1/255) that
``raytpu``'s packed fetch rebuilds. ``RenderConfig`` has the same fields
and defaults as ``raytpu.core.types.RenderConfig``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import Tensor

from raytpu_torch.core.vec3 import Vec3


def _f32(a, device) -> Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


@dataclass(frozen=True)
class Materials:
    """Material SoA (struct Material): one entry per sphere."""

    diffuse: Vec3
    emission: Vec3
    emission_strength: Tensor
    reflection: Tensor       # in [0, 1]
    alpha: Tensor            # opacity; < refr_alpha_lo cutout, <= refr_alpha_hi refractive
    ior: Tensor              # refractive index

    @staticmethod
    def zeros(shape, device=None) -> "Materials":
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        v = Vec3(z, z, z)
        return Materials(v, v, z, z, z, z)

    @staticmethod
    def where(mask: Tensor, a: "Materials", b: "Materials") -> "Materials":
        w = lambda x, y: torch.where(mask, x, y)
        return Materials(
            Vec3.where(mask, a.diffuse, b.diffuse),
            Vec3.where(mask, a.emission, b.emission),
            w(a.emission_strength, b.emission_strength),
            w(a.reflection, b.reflection), w(a.alpha, b.alpha), w(a.ior, b.ior),
        )


@dataclass(frozen=True)
class Spheres:
    """Sphere SoA (struct Sphere)."""

    center: Vec3   # (S,)
    radius: Tensor  # (S,)
    mat: Materials  # (S,)

    @property
    def count(self) -> int:
        return self.radius.shape[0]

    @staticmethod
    def empty(device) -> "Spheres":
        z = torch.zeros((0,), device=device)
        return Spheres(Vec3(z, z, z), z, Materials.zeros((0,), device))


@dataclass(frozen=True)
class Triangles:
    """Triangle SoA (struct Triangle): vertices a/b/c, per-vertex UVs and
    the per-triangle material id into the atlas and the ``MatTable``."""

    a: Vec3
    b: Vec3
    c: Vec3
    ua: Tensor
    va: Tensor
    ub: Tensor
    vb: Tensor
    uc: Tensor
    vc: Tensor
    mat_id: Tensor   # (T,) int32

    @property
    def count(self) -> int:
        return self.mat_id.shape[0]

    @staticmethod
    def empty(device) -> "Triangles":
        z = torch.zeros((0,), device=device)
        v = Vec3(z, z, z)
        return Triangles(v, v, v, z, z, z, z, z, z,
                         torch.zeros((0,), dtype=torch.int32, device=device))


@dataclass(frozen=True)
class TextureAtlas:
    """All mesh textures concatenated: flat per-channel f32 planes of
    length M*H*W indexed by mat_id*H*W + y*W + x (rows bottom-up). Every
    texture shares one (H, W)."""

    rgb: Vec3       # (M*H*W,) each channel
    alpha: Tensor   # (M*H*W,)
    width: int = 1
    height: int = 1

    @property
    def count(self) -> int:
        if self.width * self.height == 0:
            return 0
        return self.alpha.shape[0] // (self.width * self.height)

    @staticmethod
    def empty(device) -> "TextureAtlas":
        z = torch.zeros((0,), device=device)
        return TextureAtlas(Vec3(z, z, z), z, 1, 1)


@dataclass(frozen=True)
class MatTable:
    """Per-material-id physics overrides (texture.h:71-88 as data)."""

    emission: Vec3            # (M,) emission colour
    emission_strength: Tensor
    reflection: Tensor
    ior: Tensor
    alpha_const: Tensor       # used where use_alpha_const
    use_alpha_const: Tensor   # (M,) bool: ignore the texel alpha
    emission_from_texture: Tensor   # (M,) bool: emission *= texel colour

    @property
    def count(self) -> int:
        return self.emission_strength.shape[0]

    @staticmethod
    def from_arrays(em, es, rf, io, ac, ua, eft, device) -> "MatTable":
        """From numpy-like (M, 3) emission and (M,) columns."""
        em = np.asarray(em, np.float32).reshape(-1, 3)
        b = lambda a: torch.as_tensor(np.asarray(a, bool), device=device)
        return MatTable(
            emission=Vec3(*(_f32(em[:, i], device) for i in range(3))),
            emission_strength=_f32(es, device), reflection=_f32(rf, device),
            ior=_f32(io, device), alpha_const=_f32(ac, device),
            use_alpha_const=b(ua), emission_from_texture=b(eft),
        )

    @staticmethod
    def default(n: int, device) -> "MatTable":
        return MatTable.from_arrays(
            np.zeros((n, 3)), np.zeros(n), np.zeros(n), np.ones(n),
            np.ones(n), np.zeros(n, bool), np.zeros(n, bool), device)

    @staticmethod
    def reference_overrides(n: int, device) -> "MatTable":
        """The reference's hardcoded table (texture.h:71-88): id 1
        emissive white 1.85 with alpha forced to 1; id 4 water (alpha .6,
        ior 1.33, refl .93); id 3 glass (alpha .1, ior 1.5, refl .3)."""
        em, es, rf = np.zeros((n, 3)), np.zeros(n), np.zeros(n)
        io, ac, ua = np.ones(n), np.ones(n), np.zeros(n, bool)
        if n > 1:
            em[1], es[1], ac[1], ua[1] = 1.0, 1.85, 1.0, True
        if n > 4:
            ac[4], ua[4], io[4], rf[4] = 0.6, True, 1.33, 0.93
        if n > 3:
            ac[3], ua[3], io[3], rf[3] = 0.1, True, 1.50, 0.3
        return MatTable.from_arrays(em, es, rf, io, ac, ua,
                                    np.zeros(n, bool), device)


@dataclass(frozen=True)
class SkyTexture:
    """Equirect sky texture for sphere_uvmapping (texture.h:92-112),
    mapped onto the scene's sky sphere ("derniere sphere = ciel",
    main.c:331): flat per-channel f32 planes of length H*W indexed by
    y*W + x, rows bottom-up as ``io.image.load_rgb`` leaves them."""

    rgb: Vec3       # (H*W,) each channel
    width: int = 1
    height: int = 1

    @staticmethod
    def empty(device) -> "SkyTexture":
        z = torch.zeros((0,), device=device)
        return SkyTexture(Vec3(z, z, z), 1, 1)


@dataclass(frozen=True)
class Scene:
    """Spheres plus a textured triangle mesh. The render runs on the
    device of these tensors.

    ``triangles``, ``atlas``, ``mat_table`` and ``sky`` default to an
    empty mesh, a one-entry default table and no sky texture on the
    spheres' device. ``sky_sphere_index`` names the sphere whose emission
    the sky texel replaces (``sky_index``).
    """

    spheres: Spheres
    triangles: Optional[Triangles] = None
    atlas: Optional[TextureAtlas] = None
    mat_table: Optional[MatTable] = None
    sky_sphere_index: int = -1   # equirect-sky sphere, or -1
    sky: Optional[SkyTexture] = None

    def __post_init__(self):
        dev = self.device
        for name, empty in (("triangles", Triangles.empty),
                            ("atlas", TextureAtlas.empty),
                            ("mat_table", lambda d: MatTable.default(1, d)),
                            ("sky", SkyTexture.empty)):
            if getattr(self, name) is None:
                object.__setattr__(self, name, empty(dev))

    @property
    def device(self) -> torch.device:
        return self.spheres.radius.device

    @property
    def n_triangles(self) -> int:
        return self.triangles.count

    @property
    def sky_index(self) -> int:
        """The sky sphere's index where the equirect sky is on, else -1:
        on exactly when ``raytpu`` turns it on (``_sky_statics``: an index
        and a non-empty texture). Without a texture the sphere is a plain
        emitter."""
        on = self.sky_sphere_index >= 0 and self.sky.rgb.x.shape[0] > 0
        return self.sky_sphere_index if on else -1


@dataclass(frozen=True)
class RenderConfig:
    """Static render parameters; fields and defaults mirror
    ``raytpu.core.types.RenderConfig``.

    Read as in ``raytpu``: ``use_megakernel`` (``render`` takes K1 or K3
    where they serve the scene, the scan path otherwise and without it),
    ``use_pallas`` (the scan path's closest-hit kernel K4: True, False, or
    None for 128 or more triangles on a CUDA device),
    ``bilinear_textures`` and ``sky_texture_grads`` (the sky texels get
    gradients only with it) and the merged-quad fields: with
    ``merge_quads`` on and ``quad_pairs`` detected (``config`` does it at
    load), K3 runs its merged search over ``quad_pairs`` and the
    axis-aligned classes ``quad_aa_rects`` / ``quad_aa_tris``, as
    ``raytpu``'s K3 does; otherwise it searches triangle by triangle. Kept
    for parity and not read: ``pallas_interpret`` and ``sample_chunk``
    (JAX execution details)."""

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


def requires_grad(*trees) -> bool:
    """Whether any tensor leaf of these dataclass trees (or tensors)
    requires grad."""
    for t in trees:
        if isinstance(t, Tensor):
            if t.requires_grad:
                return True
        elif dataclasses.is_dataclass(t):
            if requires_grad(*(getattr(t, f.name)
                               for f in dataclasses.fields(t))):
                return True
    return False
