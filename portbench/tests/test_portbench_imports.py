"""Nothing the harness or its reference loads is JAX or the JAX package,
and the reference loads nothing of the port; compared by whole top-level
names, in fresh interpreters."""

import subprocess
import sys

from portbench.tests.conftest import REPO

CHECK = """
import sys
sys.path.insert(0, {repo!r})
{body}
tops = {{m.split(".")[0] for m in sys.modules}}
print(sorted(tops & {{"jax", "jaxlib", "flax", "i3dr_stereo_tpu",
                      "i3dr_stereo_tpu_torch"}}))
"""


def _tops(body: str) -> str:
    out = subprocess.run([sys.executable, "-c",
                          CHECK.format(repo=str(REPO), body=body)],
                         capture_output=True, text=True, check=True,
                         cwd=str(REPO), timeout=300)
    return out.stdout.strip().splitlines()[-1]


def test_reference_loads_nothing_of_the_port_or_jax():
    body = ("import portbench.reference.pipeline, portbench.check\n"
            "import portbench.reference.matchers.I3DRSGM\n"
            "import portbench.reference.matchers.SGBM\n"
            "import portbench.inputs, portbench.peaks")
    assert _tops(body) == "[]"


def test_a_cells_set_up_loads_no_jax(tiny):
    body = f"""
import torch
torch.set_num_threads(2)
from pathlib import Path
from portbench import manifest, run
root = Path({str(tiny)!r})
cell = manifest.cell(root, "sgbm_1920.replay")
res = run.run_cell(root, cell, 3, 0.5, False, device="cpu",
                   log=lambda *a, **k: None)
assert run.banned_modules() == [], run.banned_modules()
import portbench.reference.pipeline
"""
    got = _tops(body)
    assert got == "['i3dr_stereo_tpu_torch']", got


def test_the_banned_check_compares_whole_names():
    from portbench import run

    sys.modules.setdefault("i3dr_stereo_tpu_torch", sys.modules[__name__])
    assert "i3dr_stereo_tpu" not in run.banned_modules()
