"""Command line: ``python -m raytpu_torch.cli render|train <scene> [options]``.

    render cornell|cornell_cuda|cornell_dof_ao|<scene.toml> [--scene S
           --spp N --width W --height H --bounces B --seed S --out x.ppm
           --device cuda|cpu --no-megakernel --pallas --bilinear
           --denoise [bilateral|learned] --aov --checkpoint c.npz
           --flush-every K --preview p.ppm --log-json --profile-dir D]
    train  cornell|cornell_cuda|cornell_dof_ao|<scene.toml> --target t.ppm
           [--steps N --lr LR --out x.ppm --log-every K --spp --width
           --height --bounces --seed --device cuda|cpu --no-megakernel
           --pallas --bilinear]

``render`` renders a built-in sphere scene or a TOML scene spec (spheres
and a textured OBJ mesh, ``config.load_scene_file``; ``--scene`` names it
too) and writes a PPM, by default
``<scene>_<spp>RAYS_<bounces-1>RB_<dd>-<mm>_<HH>h<MM>.ppm``; elapsed
seconds and rays/s go to stderr. Its output path, as ``raytpu``'s:
``--checkpoint`` flushes the sums to a file every ``--flush-every``
samples and resumes from it, bit-identical to an uninterrupted render
(``io/checkpoint``), with a progress line a flush (``--log-json``: one
JSON object a line) and a ``--preview`` PPM of the running mean
(``observe.RenderMonitor``); ``--denoise`` filters the image on the
render's device with the joint bilateral (the flag alone) or the learned
KPCN (``denoise``); ``--aov`` also writes ``<out>_albedo.ppm`` and
``<out>_normal.ppm``; ``--profile-dir`` writes a ``torch.profiler``
trace of the render there. ``train`` fits every float parameter of the
scene (spheres; a mesh's vertices, UVs, texels and
material table) to a target image (ASCII PPM of the configured size) with
Adam on the L2 loss in linear radiance, logs the loss, and writes the
final render. ``--device`` defaults to ``cuda`` and fails when CUDA is
absent; ``--device cpu`` runs the plain PyTorch path.

On ``cuda`` the megakernels (K1, K3) serve the scenes they support and
the scan path the rest, as ``raytpu``'s CLI does on an accelerator;
``--no-megakernel`` (or ``RAYTPU_NO_MEGAKERNEL`` set to anything but
empty or ``0``) asks for the scan path, which ``--device cpu`` takes
always. ``--pallas`` runs the scan path's closest-hit kernel (K4) at any
triangle count; ``--bilinear`` filters textures bilinearly (the
differentiable mode).
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import time


def _parser(prog: str) -> argparse.ArgumentParser:
    from raytpu_torch.scenes import BUILTIN

    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("scene", nargs="?", default="cornell",
                    help=f"{', '.join(sorted(BUILTIN))} or a .toml scene spec")
    ap.add_argument("--spp", type=int)
    ap.add_argument("--bounces", type=int)
    ap.add_argument("--width", type=int)
    ap.add_argument("--height", type=int)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-megakernel", action="store_true",
                    help="trace with the scan path even where a megakernel "
                         "serves the scene (RAYTPU_NO_MEGAKERNEL=1 likewise)")
    ap.add_argument("--pallas", action="store_true",
                    help="the scan path's fused closest-hit kernel (K4) at "
                         "any triangle count")
    ap.add_argument("--bilinear", action="store_true",
                    help="bilinear texture filtering (differentiable mode; "
                         "the reference is nearest)")
    return ap


def no_megakernel(flag: bool) -> bool:
    """``--no-megakernel``, or ``RAYTPU_NO_MEGAKERNEL`` set to any value
    but empty or ``"0"``."""
    return flag or os.environ.get("RAYTPU_NO_MEGAKERNEL", "") not in ("", "0")


def config_overrides(args, dev) -> dict:
    """The ``RenderConfig`` fields the parsed options set on device
    ``dev``: sizes, ``use_pallas``, ``bilinear_textures``, and on ``cuda``
    ``use_megakernel`` unless the user opted out (``raytpu``'s CLI sets it
    on a non-CPU backend; on the CPU both keep the scan path)."""
    over = {k: v for k, v in (("spp", args.spp), ("max_bounces", args.bounces),
                              ("width", args.width), ("height", args.height))
            if v is not None}
    if args.pallas:
        over["use_pallas"] = True
    if args.bilinear:
        over["bilinear_textures"] = True
    if dev.type == "cuda" and not no_megakernel(args.no_megakernel):
        over["use_megakernel"] = True
    return over


def _setup(args):
    """(device, scene, camera, config) for the parsed common options."""
    import torch

    from raytpu_torch.config import load_scene

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("raytpu_torch: --device cuda, but CUDA is not "
                         "available (--device cpu runs the plain path)")
    try:
        scene, cam, cfg = load_scene(args.scene, device=dev)
    except ValueError as e:
        raise SystemExit(f"raytpu_torch: {e}")
    cfg = cfg.replace(**config_overrides(args, dev))
    if dev.type == "cuda":
        # the kernel tiles the batch itself: one tile per frame up to ~1.2 M
        cfg = cfg.replace(pixel_tile=min(cfg.n_pixels, 1200 * 1024))
    return dev, scene, cam, cfg


def _ppm_out(path: str) -> str:
    if not path.endswith(".ppm"):
        raise SystemExit("raytpu_torch: only .ppm output is supported")
    return path


def cmd_render(argv) -> int:
    ap = _parser("raytpu_torch render")
    ap.add_argument("--scene", dest="scene_flag", default=None,
                    help="the scene, in place of the positional argument")
    ap.add_argument("--out", default=None,
                    help="output .ppm; default <scene>_<spp>RAYS_"
                         "<bounces-1>RB_<dd>-<mm>_<HH>h<MM>.ppm")
    ap.add_argument("--denoise", nargs="?", const="bilateral", default=None,
                    choices=["bilateral", "learned"],
                    help="denoise on the render's device: the joint "
                         "bilateral (the flag alone) or the learned KPCN")
    ap.add_argument("--aov", action="store_true",
                    help="also write <out>_albedo.ppm and <out>_normal.ppm")
    ap.add_argument("--checkpoint", default=None,
                    help="flush the sums to this file and resume from it "
                         "(bit-identical) if it exists")
    ap.add_argument("--flush-every", type=int, default=64,
                    help="samples between checkpoint flushes")
    ap.add_argument("--preview", default=None,
                    help="with --checkpoint, write a preview .ppm here at "
                         "every flush")
    ap.add_argument("--log-json", action="store_true",
                    help="progress lines as JSON objects")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the render here")
    args = ap.parse_args(argv)
    args.scene = args.scene_flag or args.scene

    import numpy as np
    import torch

    from raytpu_torch.core.rng import prng_key
    from raytpu_torch.io.ppm import write_ppm
    from raytpu_torch.observe import RenderMonitor, trace_profile

    dev, scene, cam, cfg = _setup(args)
    if args.out is None:
        name = os.path.splitext(os.path.basename(args.scene))[0]
        args.out = (f"{name}_{cfg.spp}RAYS_{cfg.max_bounces - 1}RB_"
                    f"{datetime.datetime.now():%d-%m_%Hh%M}.ppm")
    out_path = _ppm_out(args.out)
    if args.preview:
        _ppm_out(args.preview)
    key = prng_key(args.seed)

    t0 = time.perf_counter()
    with trace_profile(args.profile_dir, dev):
        if args.checkpoint:
            from raytpu_torch.io.checkpoint import render_image_checkpointed

            mon = RenderMonitor(cfg, preview_path=args.preview,
                                preview_every=args.flush_every,
                                structured=args.log_json)

            def log(msg):
                if not args.log_json:   # the monitor prints the JSON lines
                    print(f"[render] {msg}", file=sys.stderr, flush=True)

            out = render_image_checkpointed(
                scene, cam, cfg, key, args.checkpoint,
                flush_every=args.flush_every, log=log, progress=mon.update)
        else:
            from raytpu_torch.integrator.render import render_image

            out = render_image(scene, cam, cfg, key)  # ends in a copy to host
    elapsed = time.perf_counter() - t0

    canvas = out.canvas
    if args.denoise:
        from raytpu_torch.core.color import quantize, tonemap
        from raytpu_torch.core.vec3 import Vec3

        if args.denoise == "learned":
            from raytpu_torch.denoise.learned import denoise_learned as denoise
        else:
            from raytpu_torch.denoise import denoise

        # the images are top-down views with negative strides
        on_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        with torch.no_grad():
            image = denoise(on_dev(out.image), on_dev(out.albedo),
                            on_dev(out.normal))
            canvas = quantize(tonemap(Vec3.from_array(image))).to_array()
        canvas = canvas.cpu().numpy().astype(np.int32)
    write_ppm(out_path, canvas)
    if args.aov:
        base = out_path.removesuffix(".ppm")
        for name, aov in (("albedo", out.albedo), ("normal", out.normal)):
            write_ppm(f"{base}_{name}.ppm",
                      np.clip(np.abs(aov) * 255.0, 0, 255).astype(np.int32))
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rays = cfg.n_pixels * cfg.spp * cfg.max_bounces
    print(f"rendered {cfg.width}x{cfg.height} spp={cfg.spp} "
          f"bounces={cfg.max_bounces} on {where} in {elapsed:.3f}s "
          f"({rays / elapsed / 1e6:.1f} Mrays/s) -> {out_path}",
          file=sys.stderr)
    return 0


def cmd_train(argv) -> int:
    ap = _parser("raytpu_torch train")
    ap.add_argument("--target", required=True, help="target image (.ppm)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--out", default="trained.ppm")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    from raytpu_torch.core.rng import prng_key
    from raytpu_torch.integrator.render import render_image
    from raytpu_torch.io.image import load_rgb
    from raytpu_torch.io.ppm import write_ppm
    from raytpu_torch.train import combine_scene, make_train_step

    dev, scene, cam, cfg = _setup(args)
    out_path = _ppm_out(args.out)
    tgt = load_rgb(args.target)  # (H, W, 3) bottom-up, like pixel ids
    if tgt.shape[:2] != (cfg.height, cfg.width):
        raise SystemExit(f"target is {tgt.shape[1]}x{tgt.shape[0]}, "
                         f"config is {cfg.width}x{cfg.height}")
    # compare in linear space: undo the sqrt tone map
    target = torch.as_tensor(tgt.reshape(-1, 3) ** 2.0, device=dev)

    init_fn, step_fn = make_train_step(cfg, args.lr)
    state, static = init_fn(scene, cam)
    pids = torch.arange(cfg.n_pixels, device=dev)
    t0 = time.perf_counter()
    for step in range(args.steps):
        state, loss = step_fn(state, static, cam, pids, target,
                              prng_key(args.seed + step))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {float(loss):.6f}")
    elapsed = time.perf_counter() - t0

    out = render_image(combine_scene(state.params, static), cam, cfg,
                       prng_key(args.seed))
    write_ppm(out_path, out.canvas)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"trained {args.steps} steps of {cfg.width}x{cfg.height} "
          f"spp={cfg.spp} bounces={cfg.max_bounces} on {where} in "
          f"{elapsed:.3f}s; wrote {out_path}", file=sys.stderr)
    return 0


COMMANDS = {"render": cmd_render, "train": cmd_train}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    if argv[0] not in COMMANDS:
        print(f"unknown command {argv[0]!r}; choose from {sorted(COMMANDS)}",
              file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
