"""Command line: ``python -m raytpu_torch.cli render <scene> [options]``.

    render cornell|cornell_cuda|cornell_dof_ao [--spp N --width W
           --height H --bounces B --seed S --out x.ppm --device cuda|cpu]

Renders a built-in sphere scene and writes a PPM. ``--device`` defaults to
``cuda`` and fails when CUDA is absent; ``--device cpu`` runs the plain
PyTorch path. Elapsed seconds and rays/s go to stderr.
"""

from __future__ import annotations

import argparse
import sys
import time


def cmd_render(argv) -> int:
    from raytpu_torch.scenes import BUILTIN

    ap = argparse.ArgumentParser(prog="raytpu_torch render")
    ap.add_argument("scene", nargs="?", default="cornell", choices=sorted(BUILTIN))
    ap.add_argument("--spp", type=int)
    ap.add_argument("--bounces", type=int)
    ap.add_argument("--width", type=int)
    ap.add_argument("--height", type=int)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="output .ppm; default <scene>_<spp>RAYS_<bounces-1>RB.ppm")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from raytpu_torch.core.rng import prng_key
    from raytpu_torch.integrator.render import render_image
    from raytpu_torch.io.ppm import write_ppm

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("raytpu_torch: --device cuda, but CUDA is not "
                         "available (--device cpu runs the plain path)")
    scene, cam, cfg = BUILTIN[args.scene](device=dev)
    over = {k: v for k, v in (("spp", args.spp), ("max_bounces", args.bounces),
                              ("width", args.width), ("height", args.height))
            if v is not None}
    cfg = cfg.replace(**over)
    if dev.type == "cuda":
        # the kernel tiles the batch itself: one tile per frame up to ~1.2 M
        cfg = cfg.replace(pixel_tile=min(cfg.n_pixels, 1200 * 1024))
    out_path = args.out or (
        f"{args.scene}_{cfg.spp}RAYS_{cfg.max_bounces - 1}RB.ppm"
    )
    if not out_path.endswith(".ppm"):
        raise SystemExit("raytpu_torch: only .ppm output is supported")

    t0 = time.perf_counter()
    out = render_image(scene, cam, cfg, prng_key(args.seed))  # ends in a copy to host
    elapsed = time.perf_counter() - t0
    write_ppm(out_path, out.canvas)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rays = cfg.n_pixels * cfg.spp * cfg.max_bounces
    print(f"rendered {cfg.width}x{cfg.height} spp={cfg.spp} "
          f"bounces={cfg.max_bounces} on {where} in {elapsed:.3f}s "
          f"({rays / elapsed / 1e6:.1f} Mrays/s) -> {out_path}",
          file=sys.stderr)
    return 0


COMMANDS = {"render": cmd_render}


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
