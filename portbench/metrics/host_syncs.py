"""host_syncs: host syncs a frame inside ``StereoPipeline.process``,
counted by PyTorch's sync debug mode over two frames through the graph
after the window (``chip_smoke.py:sync_sites``' method); the sites go to
the result's ``run`` block."""


def read(run):
    return None if run.syncs is None else run.syncs.per_frame
