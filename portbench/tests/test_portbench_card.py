"""One short run of each replay cell on the card, through the benchmark's
command; skips without a card (decided here, not at import)."""

import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import REPO


@pytest.mark.card
@pytest.mark.parametrize("cell", ["i3drsgm_2448.replay", "sgbm_1920.replay"])
def test_cell_runs_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=str(REPO), timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"


def test_no_card_no_result(tmp_path):
    """Without a card the command prints no result and exits non-zero
    (here, on the CPU, always)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "sgbm_1920.replay", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=str(REPO), timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
