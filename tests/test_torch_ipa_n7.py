"""The inner-product argument of blitzar_tpu_torch against blitzar_tpu at
n = 7 (the frozen vector; 8 generators, a padded handle): the cases of
tests/torch_ipa_cases.py."""

import pytest

from torch_ipa_cases import *  # noqa: F401,F403


@pytest.fixture(scope="module")
def n():
    return 7
