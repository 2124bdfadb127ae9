"""The inner-product argument of blitzar_tpu_torch against blitzar_tpu at
n = 1 (no rounds) and n = 4 (the frozen vector): the cases of
tests/torch_ipa_cases.py."""

import pytest

from torch_ipa_cases import *  # noqa: F401,F403


@pytest.fixture(scope="module", params=[1, 4])
def n(request):
    return request.param
