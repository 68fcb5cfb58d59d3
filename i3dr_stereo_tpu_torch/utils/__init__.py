"""Torch port of ``i3dr_stereo_tpu.utils``."""
