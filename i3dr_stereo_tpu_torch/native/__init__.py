from i3dr_stereo_tpu_torch.native.shm import FrameRing, pair_pop, build_native  # noqa: F401
