"""KZG (Kate) polynomial commitments over the port's MSM.

Port of `openzl_tpu/proof_systems/kzg.py` (ark-poly-commit's KZG10,
non-hiding): commit is one G1 MSM of the coefficients against the powers of
tau (`ops/msm.py`: kernels K3, K4 and K9), verify one 2-pairing product on
the host (`ref/pairing.py`, native engine when built).

  setup:  powers[i] = tau^i G1 (one fixed-base MSM), [tau] G2
  commit: C = sum_i p_i powers[i]
  open:   q(x) = (p(x) - p(z)) / (x - z),  W = commit(q)
  verify: e(C - v G1, H) e(-W, [tau - z] H) == 1

The witness quotient is a host synthetic division (the recurrence
q_i = p_{i+1} + z q_{i+1} is serial). `backend="device"` runs the MSMs on
`device` (`cuda` unless asked otherwise), `"host"` on the bigint oracle,
and `"auto"` on the device beyond 64 coefficients, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..curves import jacobian as jac
from ..curves.jacobian import JPoint
from ..fields import limb
from ..ops.msm import fixed_base_msm, msm
from ..ref import curve as refc
from ..ref import pairing as refpair
from ..ref.pairing import PairingSpec
from ..utils import codec


@dataclasses.dataclass
class KZGParams:
    """Universal (degree-bounded) setup. `powers_g1` is a JPoint batch on a
    torch device unless `host`, then a list of affine points."""

    pairing: PairingSpec
    powers_g1: object  # JPoint (device) | List[affine] (host)
    g2_gen: Tuple
    tau_g2: Tuple
    max_degree: int
    host: bool = False

    def to_bytes(self, compressed: bool = False) -> bytes:
        """ark UniversalParams member order: powers_of_g, h, beta_h."""
        g1, g2 = self.pairing.g1, self.pairing.g2
        pts = list(self.powers_g1) if self.host else jac.to_affine_ints(g1, self.powers_g1)
        w = codec.Writer()
        w.vec(pts, lambda pt: w.point(g1, pt, compressed))
        w.point(g2, self.g2_gen, compressed)
        w.point(g2, self.tau_g2, compressed)
        return w.getvalue()

    @classmethod
    def from_bytes(
        cls, pairing: PairingSpec, data: bytes, compressed: bool = False, validate: bool = True
    ) -> "KZGParams":
        """Host-form params; `validate` checks subgroup membership of every
        point (ark Validate::Yes), False for trusted parameter files."""
        g1, g2 = pairing.g1, pairing.g2
        r = codec.Reader(data)
        pts = r.vec(lambda: r.point(g1, compressed, validate))
        return cls(
            pairing=pairing, powers_g1=pts, g2_gen=r.point(g2, compressed),
            tau_g2=r.point(g2, compressed), max_degree=len(pts) - 1, host=True,
        )

    @classmethod
    def from_reference(cls, params, device="cuda") -> "KZGParams":
        """From a reference (JAX package) KZGParams: device-form powers through
        `np.asarray` of their limb arrays (onto `device`), host-form ones as
        their affine list, over the port's pairing of the same name."""
        pairing = refpair.PAIRINGS[params.pairing.name]
        if params.host:
            powers = list(params.powers_g1)
        else:
            powers = JPoint(*(limb.tensor(np.asarray(v), device) for v in params.powers_g1))
        return cls(pairing, powers, params.g2_gen, params.tau_g2, params.max_degree, params.host)


class KZG:
    """backend "device" runs the MSMs on `device`, "host" on the bigint
    oracle (tiny degrees, tests), "auto" on the device beyond 64
    coefficients."""

    def __init__(self, pairing: PairingSpec, backend: str = "auto", device="cuda"):
        if backend not in ("auto", "host", "device"):
            raise ValueError(f"unknown KZG backend {backend!r}")
        self.pairing = pairing
        self.backend = backend
        self.device = device
        self.fr = pairing.g1.scalar

    def _use_device(self, n: int) -> bool:
        if self.backend == "auto":
            return n > 64
        return self.backend == "device"

    def _scalars(self, values: Sequence[int]):
        return limb.tensor(limb.pack(self.fr, np.array(list(values), dtype=object)), self.device)

    # -- setup ---------------------------------------------------------------

    def setup(self, max_degree: int, rng) -> KZGParams:
        """Trusted setup: sample tau, encode tau^0 .. tau^max_degree in G1
        (one fixed-base MSM on the device, or the host oracle) and tau in
        G2."""
        r = self.pairing.r
        tau = rng.randrange(1, r)
        n = max_degree + 1
        pows = [1] * n
        for i in range(1, n):
            pows[i] = pows[i - 1] * tau % r
        g2 = self.pairing.g2
        g2_gen = refc.generator(g2)
        tau_g2 = refc.scalar_mul(g2, tau, g2_gen)
        if self._use_device(n):
            powers = fixed_base_msm(self.pairing.g1, self._scalars(pows))
            return KZGParams(self.pairing, powers, g2_gen, tau_g2, max_degree, host=False)
        g1 = self.pairing.g1
        gen = refc.generator(g1)
        powers = [refc.scalar_mul(g1, k, gen) for k in pows]
        return KZGParams(self.pairing, powers, g2_gen, tau_g2, max_degree, host=True)

    def device_params(self, params: KZGParams) -> KZGParams:
        """Host or deserialized params with their powers on `device`."""
        if not params.host:
            return params
        powers = jac.from_affine_ints(self.pairing.g1, params.powers_g1, self.device)
        return dataclasses.replace(params, powers_g1=powers, host=False)

    # -- commit / open -------------------------------------------------------

    def _msm_prefix(self, params: KZGParams, coeffs: Sequence[int]):
        """MSM of `coeffs` against the first len(coeffs) powers."""
        n = len(coeffs)
        if n - 1 > params.max_degree:
            raise ValueError(f"degree {n - 1} exceeds the setup bound {params.max_degree}")
        g1 = self.pairing.g1
        if not any(coeffs):  # the zero polynomial commits to the identity
            return None
        if params.host:
            acc = None
            for c, P in zip(coeffs, params.powers_g1):
                if c:
                    acc = refc.add(g1, acc, refc.scalar_mul(g1, c, P))
            return acc
        pts = JPoint(*(v[..., :n] for v in params.powers_g1))
        return jac.to_affine_ints(g1, msm(g1, self._scalars(coeffs), pts))

    def commit(self, params: KZGParams, coeffs: Sequence[int]):
        """C = [p(tau)] G1 for p given by ascending coefficients."""
        r = self.pairing.r
        return self._msm_prefix(params, [c % r for c in coeffs])

    def open(self, params: KZGParams, coeffs: Sequence[int], z: int) -> Tuple[int, Optional[Tuple]]:
        """(p(z), witness W = [q(tau)] G1) with q = (p - p(z)) / (x - z).

        Synthetic division runs high to low: q_i = p_{i+1} + z q_{i+1}; the
        final remainder is p(z)."""
        r = self.pairing.r
        z = z % r
        cs = [c % r for c in coeffs]
        if not cs:  # zero polynomial: p(z) = 0, identity witness
            return 0, None
        q: List[int] = [0] * (len(cs) - 1)
        acc = cs[-1]
        for i in range(len(cs) - 2, -1, -1):
            q[i] = acc
            acc = (cs[i] + acc * z) % r
        if not q:  # constant polynomial: the witness is the identity
            return acc, None
        return acc, self._msm_prefix(params, q)

    def verify(self, params: KZGParams, commitment: Optional[Tuple], z: int, v: int, proof: Optional[Tuple]) -> bool:
        """e(C - v G1, H) e(-W, [tau - z] H) == 1."""
        r = self.pairing.r
        g1, g2 = self.pairing.g1, self.pairing.g2
        lhs = refc.add(g1, commitment, refc.scalar_mul(g1, (-v) % r, refc.generator(g1)))
        shifted = refc.add(g2, params.tau_g2, refc.scalar_mul(g2, (-z) % r, params.g2_gen))
        if proof is None:
            # identity witness (constant polynomial, or q(tau) = 0): the
            # equation holds iff C - v G1 is the identity
            return lhs is None
        if lhs is None:
            # p(tau) = v with a non-identity witness: holds only if
            # [tau - z] H is the identity, i.e. tau = z
            return shifted is None
        return refpair.pairing_product_is_one(
            self.pairing, [(lhs, params.g2_gen), (refc.neg(g1, proof), shifted)]
        )

    def batch_verify(
        self, params: KZGParams, claims: Sequence[Tuple[Optional[Tuple], int, int, Optional[Tuple]]], rng
    ) -> bool:
        """Random linear combination of (C, z, v, W) openings at any points
        with one 2-pairing product (ark poly-commit KZG10 `batch_check`):
        each valid opening has e(C - v G + z W, H) = e(W, [tau] H), so
            e(sum rho^j (C_j - v_j G + z_j W_j), H) e(-sum rho^j W_j, [tau] H) == 1."""
        r = self.pairing.r
        g1 = self.pairing.g1
        gen = refc.generator(g1)
        rho = rng.randrange(1, r)
        c_acc, w_acc, w_scale = None, None, 1
        for commitment, z, v, proof in claims:
            term = refc.add(g1, commitment, refc.scalar_mul(g1, (-v) % r, gen))
            if proof is not None:
                term = refc.add(g1, term, refc.scalar_mul(g1, z % r, proof))
                w_acc = refc.add(g1, w_acc, refc.scalar_mul(g1, w_scale, proof))
            c_acc = refc.add(g1, c_acc, refc.scalar_mul(g1, w_scale, term))
            w_scale = w_scale * rho % r
        if w_acc is None:
            # every witness is the identity: accept iff the weighted
            # C - v G sum is the identity
            return c_acc is None
        if c_acc is None:
            # e(-w_acc, [tau] H) = 1 with tau in [1, r) needs w_acc = identity
            return False
        return refpair.pairing_product_is_one(
            self.pairing, [(c_acc, params.g2_gen), (refc.neg(g1, w_acc), params.tau_g2)]
        )
