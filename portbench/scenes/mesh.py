"""The program's side of a mesh configuration: the committed scene file
(``scene.toml``) loaded by ``raytpu_torch.config.load_scene_file`` on the
run's device, as ``cli render`` loads one, with the configuration's
``render`` group laid over the loaded settings (the quad pairs the
loader found are kept)."""

from __future__ import annotations

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def program(config: dict, dev):
    """(scene, camera, RenderConfig) of ``raytpu_torch`` on ``dev``."""
    from raytpu_torch.config import load_scene_file

    scene, cam, cfg = load_scene_file(str(ROOT / config["scene"]["toml"]),
                                      dev)
    return scene, cam, cfg.replace(**config["render"])


def training_start(config: dict, generator, perturb: float) -> dict:
    raise NotImplementedError("scenes mesh: no training cell yet")
