"""The port's Montgomery field instances (moduli are public curve constants;
the same fields as blitzar_tpu/fields/params.py).

  SCALAR25519 curve25519 scalar field (mod l): the IPA, sumcheck's
              SXT_FIELD_SCALAR255
  BN254_FP    bn254 (alt_bn128) base field, the bn254 G1 coordinates
  BN254_FR    bn254 scalar field = Grumpkin base field, sumcheck's
              SXT_FIELD_GRUMPKIN
  BLS12381_FP bls12-381 base field, the bls12-381 G1 coordinates
"""

from .mont import MontField

L25519 = 2**252 + 27742317777372353535851937790883648493
BN254_P = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47
BN254_R = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
BLS12381_P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

SCALAR25519 = MontField("scalar25519", L25519, 16)
BN254_FP = MontField("bn254_fp", BN254_P, 16)
BN254_FR = MontField("bn254_fr", BN254_R, 16)
BLS12381_FP = MontField("bls12381_fp", BLS12381_P, 24)
