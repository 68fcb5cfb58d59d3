"""Torch port: the post-match stages inside the lean pyramid
(``lean=True``) against the JAX package's ``I3DR_SGM_BACKEND=pallas``
branch in Pallas interpret mode, on the cases and with the tolerances of
``tests/test_torch_postmatch.py`` (which says where the two packages
round differently and by how much)."""

import pytest
import torch

from test_torch_postmatch import (PYRAMID_CASES, _check_pyramid,
                                  _pyramid_port, _pyramid_reference)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def lean_reference():
    return _pyramid_reference("pallas_interpret")


@pytest.mark.parametrize("name", list(PYRAMID_CASES))
def test_lean_pyramid_postmatch_matches_reference(name, lean_reference):
    _check_pyramid(name, *_pyramid_port(name, lean=True),
                   *lean_reference[name])
