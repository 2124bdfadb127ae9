"""The scalar25519 sumcheck prover and verifier of blitzar_tpu_torch against
blitzar_tpu: the cases of tests/torch_sumcheck_cases.py for this field."""

import pytest

from blitzar_tpu_torch import api
from torch_sumcheck_cases import *  # noqa: F401,F403


@pytest.fixture(scope="module")
def field_id():
    return api.SXT_FIELD_SCALAR255
