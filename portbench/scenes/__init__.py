"""Program-side builders, one a scene kind: a configuration file's scene
handed to ``raytpu_torch``'s constructors. Each module provides
``program(config, device)`` (the program's scene, camera and
``RenderConfig``) and ``training_start(config, generator, perturb)`` (a
copy of the configuration whose trainable leaves are moved from the
seed's generator: the start both the program and the reference step
from)."""
