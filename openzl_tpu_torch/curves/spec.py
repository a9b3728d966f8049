"""Curve specifications (short Weierstrass y^2 = x^3 + a x + b, a = 0).

The port's own copy of `openzl_tpu/curves/spec.py` (host Python, no JAX).

Parameters match the arkworks curve configs the reference builds against
(plugins/arkworks/Cargo.toml bn254 / bls12-381 features), including the G2
twists over Fq2 (non-residue u^2 = -1; twist factor xi = 1+u for BLS12-381,
9+u for BN254).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

from ..fields.spec import BLS12_381_FQ, BLS12_381_FR, BN254_FQ, BN254_FR, FieldSpec

Coord = Union[int, Tuple[int, int]]


@dataclasses.dataclass(frozen=True)
class CurveSpec:
    """A short-Weierstrass group over `base` (ext=1) or its quadratic
    extension (ext=2), with scalars in `scalar`."""

    name: str
    base: FieldSpec
    scalar: FieldSpec
    a: int
    b: Coord
    gen_x: Coord
    gen_y: Coord
    ext: int = 1
    cofactor: int = 1
    #: Fq2 non-residue (u^2 = nr2) for ext=2 coordinates; -1 for the
    #: BN254/BLS12-381 towers (arkworks fq2.rs configs)
    nr2: int = -1

    def is_on_curve_int(self, x: int, y: int) -> bool:
        assert self.ext == 1
        p = self.base.modulus
        return (y * y - (x * x * x + self.a * x + self.b)) % p == 0


#: BLS12-381 G1 (arkworks ark-bls12-381 g1 config)
BLS12_381_G1 = CurveSpec(
    name="bls12_381_g1",
    base=BLS12_381_FQ,
    scalar=BLS12_381_FR,
    a=0,
    b=4,
    gen_x=0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    gen_y=0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
    cofactor=0x396C8C005555E1568C00AAAB0000AAAB,
)

#: BLS12-381 G2 over Fq2 (twist y^2 = x^3 + 4(1+u))
BLS12_381_G2 = CurveSpec(
    name="bls12_381_g2",
    base=BLS12_381_FQ,
    scalar=BLS12_381_FR,
    a=0,
    b=(4, 4),
    gen_x=(
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    gen_y=(
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
    ext=2,
)

#: BN254 (alt_bn128) G1 (arkworks ark-bn254 g1 config)
BN254_G1 = CurveSpec(
    name="bn254_g1",
    base=BN254_FQ,
    scalar=BN254_FR,
    a=0,
    b=3,
    gen_x=1,
    gen_y=2,
)

#: BN254 G2 over Fq2 (twist y^2 = x^3 + 3/(9+u))
BN254_G2 = CurveSpec(
    name="bn254_g2",
    base=BN254_FQ,
    scalar=BN254_FR,
    a=0,
    b=(
        19485874751759354771024239261021720505790618469301721065564631296452457478373,
        266929791119991161246907387137283842545076965332900288569378510910307636690,
    ),
    gen_x=(
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    gen_y=(
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
    ext=2,
)
