"""Worker process for tests/test_torch_sharding.py: one of N localhost
ranks of the port. Joins the gloo process group, renders a small Cornell
frame over the process-spanning (tiles, samples) grid on the CPU, and
writes the frame to disk.

Run only by the test (configured through the environment); not a pytest
module. Imports no JAX.
"""

import os

import numpy as np


def main() -> None:
    pid = int(os.environ["WORKER_PROCESS_ID"])
    nproc = int(os.environ["WORKER_NUM_PROCESSES"])
    grid = tuple(int(n) for n in os.environ["WORKER_GRID"].split("x"))
    out_path = os.environ["WORKER_OUT"]

    import torch.distributed as dist

    from raytpu_torch.core.rng import prng_key
    from raytpu_torch.scenes import cornell_box
    from raytpu_torch.sharding import (init_distributed, make_global_mesh,
                                       render_image_multihost)

    # coordinator from RAYTPU_COORDINATOR, the rest as arguments
    assert init_distributed(num_processes=nproc, process_id=pid)
    assert dist.get_world_size() == nproc and dist.get_rank() == pid
    scene, cam, cfg = cornell_box("cpu")
    cfg = cfg.replace(width=16, height=12, spp=8, max_bounces=4)
    out = render_image_multihost(scene, cam, cfg, prng_key(0),
                                 make_global_mesh(*grid, device="cpu"))
    np.savez(f"{out_path}.p{pid}.npz", image=out.image, canvas=out.canvas,
             albedo=out.albedo, normal=out.normal)
    dist.destroy_process_group()
    print(f"worker {pid}: ok", flush=True)


if __name__ == "__main__":
    main()
