"""Torch port of ``i3dr_stereo_tpu.io``."""

from i3dr_stereo_tpu_torch.io.synthetic import SyntheticScene, layered_scene, slanted_scene  # noqa: F401
