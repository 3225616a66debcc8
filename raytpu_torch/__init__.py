"""raytpu_torch: the raytpu path tracer in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

The JAX package ``raytpu`` is the reference; this package mirrors its
module names and is tested against it. It imports torch and numpy and
never JAX. It renders sphere scenes through the sphere megakernel
(``kernels/trace_spheres``), differentiates the render through the
index-replay backward (``kernels/trace_scene_bwd``) and fits scene
parameters to a target image (``train``).
"""

from raytpu_torch.camera import make_camera
from raytpu_torch.core.types import RenderConfig, Scene
from raytpu_torch.core.vec3 import Vec3
from raytpu_torch.integrator.render import render, render_image

__all__ = ["Vec3", "Scene", "RenderConfig", "make_camera", "render",
           "render_image"]
