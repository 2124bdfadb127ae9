"""The bn254_g1 commitment entry, handle and table of blitzar_tpu_torch against
blitzar_tpu: the cases of tests/torch_wcommit_cases.py for this curve."""

import pytest

from torch_wcommit_cases import *  # noqa: F401,F403


@pytest.fixture(scope="module")
def curve_name():
    return "bn254_g1"
