"""Inverse rendering: Adam on a photometric loss through the renderer
(port of ``raytpu.train``, without sharding)."""

from raytpu_torch.train.inverse import (
    TrainState,
    combine_scene,
    make_train_step,
    partition_scene,
    photometric_loss,
)

__all__ = [
    "TrainState",
    "partition_scene",
    "combine_scene",
    "photometric_loss",
    "make_train_step",
]
