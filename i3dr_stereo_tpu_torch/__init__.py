"""PyTorch + CUDA port of the i3dr_stereo_tpu stereo depth engine.

The JAX package ``i3dr_stereo_tpu`` is the reference; this package mirrors
its subpackage and module names so each module's counterpart is easy to
find, and never imports JAX or the JAX package. Every TPU kernel on the
ported path is a hand-written CUDA kernel for Hopper (``csrc/``, built at
first use by :mod:`i3dr_stereo_tpu_torch._build`) with a plain torch twin
beside it. A tensor's device decides which runs: a CPU tensor takes the
twin, a CUDA tensor launches the kernel or raises.

Ported so far: the flagship frame — ``pipeline.stereo_pipeline.
StereoPipeline`` with ``Algorithm.I3DRSGM``: bicubic rectification of raw
images, the coarse-to-fine pyramid census SGM with the exact speckle
filter, depth, point cloud and crop; the dense matchers (SGBM, BM, dense
I3DRSGM); the engine's post-match stages (half-pel pass, occlusion
handling, Gauss and WLS hole filling) and its facade,
``matchers.i3drsgm.I3DRSGM``, with the ``.param`` profiles; belief
propagation; the shell around the pipeline: the node graph
(``bridge``), the stream runner, the savers and sources, the headless
viewer and the CLI (``python -m i3dr_stereo_tpu_torch.cli``); the
mapping consumers (``mapping``: TSDF fusion and depth odometry); capture
(``native``: the shared-memory frame ring and the C++ GVSP engine,
``bridge.drivers``, ``io.gige``: the GigE Vision driver), the operator's
HTTP server (``viz.serve``) and the sharded matcher (``dist``).
ROADMAP.md lists what comes next.
"""

__version__ = "0.1.0"
