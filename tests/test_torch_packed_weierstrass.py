"""Packed and vlen queries of blitzar_tpu_torch against blitzar_tpu on
bls12-381 G1 and Grumpkin (the cases of tests/torch_packed_cases.py)."""

import pytest

from blitzar_tpu.curves import weierstrass as jwc
from blitzar_tpu_torch.curves import weierstrass as twc
from blitzar_tpu_torch.msm import fixed as tfixed
from torch_packed_cases import N, W, check_curve


@pytest.mark.parametrize("jcurve,tcurve", [(jwc.BLS12381_G1, twc.BLS12381_G1), (jwc.GRUMPKIN, twc.GRUMPKIN)],
                         ids=["bls12_381_g1", "grumpkin"])
def test_matches_jax(jcurve, tcurve):
    pts = tcurve.oracle.random_points(N, seed=35)
    pts[3] = None
    th = tfixed.MultiexpHandle(tcurve.from_affine_ints(pts, "cpu"), window_width=W, curve=tcurve)
    check_curve(jcurve, tcurve, th)
