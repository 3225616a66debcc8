"""The yardstick's plain reference: what ``correct`` is decided against.

Plain PyTorch, frozen inside the benchmark so that a change to the
program cannot move it. It imports neither ``jax`` nor ``raytpu`` nor
anything of ``raytpu_torch``, and it takes nothing the program made: it
builds its own scene tables and camera from the configuration file, draws
its own threefry stream from the same keys, traces its own rays and, for
training, differentiates its own forward with autograd and steps its own
Adam.

A configuration's ``scene.kind`` names the module of this package that
holds its reference. The drivers reach the scene only through that
module, which provides:

- ``build(config, device)``: a tuple of the scene's tables, that
  ``render_pixels`` takes first, unpacked;
- ``render_pixels(*built, key, pixel_ids, spp, dtype, max_rays, counts)``:
  the (3, P) f32 radiance sums of the pixels at ``spp`` samples;
- ``train_steps(config, device, keys, spp, target, lr, block, dtype,
  counts)``: Adam steps from the configuration's scene, (each step's loss,
  the first gradient by leaf, each leaf's change);
- ``layer_work(config, rays, counts, counted_rays, train)``: the least
  work of each layer (``work.Work``) of a frame or step of ``rays`` rays,
  from the live pairs and draws in ``counts``.

Modules:

- ``rng``: JAX's threefry2x32 stream (``fold_in``, the uniform draws), the
  stream both sides draw from.
- ``spheres``: the kind ``spheres``: the camera, the sample start (keys
  and camera rays) and the sphere bounce loop, op for op in the forms of
  the program's plain versions, so that on one device the kernels agree
  with it to the bit where their operations are the same. Any pixel and
  any sample can be traced alone, so a check traces a sample of pixels at
  the frame's full sample count.
- ``image``: the frame's means, tone map and quantizer.
- ``train``: the photometric loss, its gradient by autograd and Adam, for
  any kind's differentiable trace.
- ``work``: the card's peaks and the work a layer has to do, which the
  rooflines and the step's share of the peak read.
"""
