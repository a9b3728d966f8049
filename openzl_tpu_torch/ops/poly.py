"""Dense univariate polynomials and radix-2 evaluation domains.

Port of `openzl_tpu/ops/poly.py` (ark-poly's user surface; the transforms
are `ops/ntt.py`). `DensePoly` keeps its coefficients as host ints
(ascending degree) and sends products of at least `_NTT_MUL_MIN` result
coefficients to the NTT pipeline on its torch device (pack to Montgomery
limbs, two forward transforms, one pointwise product (K1), one inverse
transform); smaller products stay on the host schoolbook path.
`Radix2Domain` mirrors ark-poly's Radix2EvaluationDomain: element
enumeration, vanishing-polynomial evaluation, Lagrange coefficients at a
point, and the (coset) transforms over the domain. Device work runs on the
object's `device`, `cuda` unless the caller asks for another.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..fields import limb
from ..fields.spec import FieldSpec
from . import ntt as nttmod

#: products with fewer result coefficients run host schoolbook; from it on
#: the three-transform NTT product (the reference's threshold)
_NTT_MUL_MIN = 512

#: vanishing-poly divisions with at least this many quotient coefficients
#: run the device suffix-sum path (the reference's threshold)
_VANISH_DIV_DEVICE_MIN = 1 << 12


def _pack(spec: FieldSpec, values: Sequence[int], size: int, device, mont: bool) -> torch.Tensor:
    vals = np.array(list(values) + [0] * (size - len(values)), dtype=object)
    return limb.tensor((limb.pack_mont if mont else limb.pack)(spec, vals), device)


def _unpack(spec: FieldSpec, x, mont: bool) -> List[int]:
    return [int(v) for v in (limb.unpack_mont if mont else limb.unpack)(spec, x)]


def _vanishing_divide_device(spec: FieldSpec, cs: Sequence[int], n: int, device) -> Tuple[List[int], List[int]]:
    """Division by x^n - 1 as a suffix sum over the n-strided chunks (see
    `DensePoly.divide_by_vanishing_poly`), on `device`. Returns (q, r) as
    host ints."""
    m = -(-len(cs) // n)  # chunks of stride n
    chunked = _pack(spec, cs, m * n, device, mont=False).reshape(spec.n_limbs, m, n)
    # reverse accumulation: after visiting chunk t the accumulator holds
    # sum_{k>=t} chunk_k; the value BEFORE adding chunk t is q's row t
    acc = limb.zeros(spec, (n,), device)
    q_rows = [None] * m
    for t in range(m - 1, -1, -1):
        q_rows[t] = acc
        acc = limb.add(spec, acc, chunked[:, t, :])
    q = _unpack(spec, torch.cat(q_rows, dim=1), mont=False)[: len(cs) - n]
    return q, _unpack(spec, acc, mont=False)


@dataclasses.dataclass(frozen=True)
class Radix2Domain:
    """Multiplicative subgroup H = <w> of size 2^log_n (ark-poly
    Radix2EvaluationDomain); its transforms run on `device`."""

    spec: FieldSpec
    log_n: int
    device: str = "cuda"

    @classmethod
    def new(cls, spec: FieldSpec, min_size: int, device="cuda") -> "Radix2Domain":
        if min_size < 1:
            raise ValueError("domain must be non-empty")
        log_n = (min_size - 1).bit_length()  # size 1 -> log_n 0 (ark parity)
        if log_n > nttmod.two_adicity(spec):
            raise ValueError(f"domain 2^{log_n} exceeds the two-adicity of {spec.name}")
        return cls(spec, log_n, device)

    @property
    def size(self) -> int:
        return 1 << self.log_n

    @property
    def group_gen(self) -> int:
        return nttmod.group_gen(self.spec, self.log_n)

    def elements(self) -> List[int]:
        p, w = self.spec.modulus, self.group_gen
        out = [1] * self.size
        for i in range(1, self.size):
            out[i] = out[i - 1] * w % p
        return out

    def evaluate_vanishing(self, z: int) -> int:
        """Z_H(z) = z^n - 1."""
        p = self.spec.modulus
        return (pow(z % p, self.size, p) - 1) % p

    def lagrange_coeffs(self, z: int) -> List[int]:
        """L_i(z) for all i: Z_H(z)/n * w^i / (z - w^i); on-domain z
        degenerates to the indicator vector."""
        p = self.spec.modulus
        z %= p
        els = self.elements()
        vz = self.evaluate_vanishing(z)
        if vz == 0:  # z in H
            return [1 if e == z else 0 for e in els]
        scale = vz * pow(self.size, -1, p) % p
        # batched inversion of (z - w^i): one Fermat inverse total
        diffs = [(z - e) % p for e in els]
        pref = [1] * (self.size + 1)
        for i, d in enumerate(diffs):
            pref[i + 1] = pref[i] * d % p
        inv_all = pow(pref[-1], -1, p)
        out = [0] * self.size
        for i in range(self.size - 1, -1, -1):
            out[i] = scale * els[i] % p * (pref[i] * inv_all % p) % p
            inv_all = inv_all * diffs[i] % p
        return out

    # -- transforms over the domain ------------------------------------------

    def _pack(self, values: Sequence[int]) -> torch.Tensor:
        return _pack(self.spec, values, self.size, self.device, mont=True)

    def _unpack(self, x) -> List[int]:
        return _unpack(self.spec, x, mont=True)

    def _values(self, values: Sequence[int]) -> List[int]:
        p = self.spec.modulus
        return [v % p for v in values] + [0] * (self.size - len(values))

    def _run(self, transform, values: Sequence[int]) -> List[int]:
        if self.log_n == 0:  # size-1 domain (or coset {g}): the identity
            return self._values(values)
        return self._unpack(transform(self.spec, self._pack(values)))

    def fft(self, coeffs: Sequence[int]) -> List[int]:
        return self._run(nttmod.ntt, coeffs)

    def ifft(self, evals: Sequence[int]) -> List[int]:
        return self._run(nttmod.intt, evals)

    def coset_fft(self, coeffs: Sequence[int]) -> List[int]:
        return self._run(nttmod.coset_ntt, coeffs)

    def coset_ifft(self, evals: Sequence[int]) -> List[int]:
        return self._run(nttmod.coset_intt, evals)


class DensePoly:
    """Host-resident dense polynomial (ascending coefficients) whose large
    products run on `device` (ark-poly DensePolynomial)."""

    __slots__ = ("spec", "coeffs", "device")

    def __init__(self, spec: FieldSpec, coeffs: Sequence[int], device="cuda"):
        p = spec.modulus
        cs = [c % p for c in coeffs]
        while cs and cs[-1] == 0:
            cs.pop()
        self.spec = spec
        self.coeffs = cs
        self.device = device

    def _new(self, coeffs: Sequence[int]) -> "DensePoly":
        return DensePoly(self.spec, coeffs, self.device)

    # -- constructors --------------------------------------------------------

    @classmethod
    def zero(cls, spec: FieldSpec, device="cuda") -> "DensePoly":
        return cls(spec, [], device)

    @classmethod
    def rand(cls, spec: FieldSpec, degree: int, rng, device="cuda") -> "DensePoly":
        p = spec.modulus
        cs = [rng.randrange(p) for _ in range(degree + 1)]
        if cs and cs[-1] == 0:
            cs[-1] = 1
        return cls(spec, cs, device)

    @classmethod
    def from_evals(cls, domain: Radix2Domain, evals: Sequence[int]) -> "DensePoly":
        """Interpolate through evaluations on `domain` (one iNTT)."""
        if len(evals) != domain.size:
            raise ValueError(f"{len(evals)} evaluations for a domain of {domain.size}")
        return cls(domain.spec, domain.ifft(evals), domain.device)

    # -- basic algebra -------------------------------------------------------

    @property
    def degree(self) -> int:
        """-1 for the zero polynomial (ark returns 0; the -1 convention
        keeps degree(a*b) == degree(a)+degree(b) total)."""
        return len(self.coeffs) - 1

    def is_zero(self) -> bool:
        return not self.coeffs

    def __eq__(self, other) -> bool:
        return isinstance(other, DensePoly) and self.spec is other.spec and self.coeffs == other.coeffs

    def __add__(self, other: "DensePoly") -> "DensePoly":
        p = self.spec.modulus
        a, b = self.coeffs, other.coeffs
        if len(a) < len(b):
            a, b = b, a
        out = list(a)
        for i, c in enumerate(b):
            out[i] = (out[i] + c) % p
        return self._new(out)

    def __neg__(self) -> "DensePoly":
        p = self.spec.modulus
        return self._new([(-c) % p for c in self.coeffs])

    def __sub__(self, other: "DensePoly") -> "DensePoly":
        return self + (-other)

    def scale(self, k: int) -> "DensePoly":
        p = self.spec.modulus
        k %= p
        return self._new([c * k % p for c in self.coeffs])

    def __mul__(self, other: "DensePoly") -> "DensePoly":
        if self.is_zero() or other.is_zero():
            return self._new([])
        p = self.spec.modulus
        out_len = len(self.coeffs) + len(other.coeffs) - 1
        if out_len < _NTT_MUL_MIN:
            out = [0] * out_len
            for i, a in enumerate(self.coeffs):
                if not a:
                    continue
                for j, b in enumerate(other.coeffs):
                    out[i + j] = (out[i + j] + a * b) % p
            return self._new(out)
        dom = Radix2Domain.new(self.spec, out_len, self.device)
        ea = nttmod.ntt(self.spec, dom._pack(self.coeffs))
        eb = nttmod.ntt(self.spec, dom._pack(other.coeffs))
        prod = nttmod.intt(self.spec, limb.mont_mul(self.spec, ea, eb))
        return self._new(dom._unpack(prod)[:out_len])

    # -- evaluation / division ----------------------------------------------

    def evaluate(self, z: int) -> int:
        p = self.spec.modulus
        z %= p
        acc = 0
        for c in reversed(self.coeffs):
            acc = (acc * z + c) % p
        return acc

    def divide_with_q_and_r(self, divisor: "DensePoly") -> Tuple["DensePoly", "DensePoly"]:
        """Euclidean division: self = q * divisor + r, deg r < deg divisor."""
        if divisor.is_zero():
            raise ZeroDivisionError("division by the zero polynomial")
        p = self.spec.modulus
        rem = list(self.coeffs)
        d = divisor.coeffs
        dq = len(rem) - len(d)
        if dq < 0:
            return self._new([]), self
        q = [0] * (dq + 1)
        lead_inv = pow(d[-1], -1, p)
        for k in range(dq, -1, -1):
            q[k] = rem[k + len(d) - 1] * lead_inv % p
            if not q[k]:
                continue
            for j, dj in enumerate(d):
                rem[k + j] = (rem[k + j] - q[k] * dj) % p
        return self._new(q), self._new(rem)

    def divide_by_vanishing_poly(self, domain: Radix2Domain, on_device: bool = None) -> Tuple["DensePoly", "DensePoly"]:
        """Divide by Z_H = x^n - 1 in O(len) (ark-poly's specialization):
        coefficient i + n folds into coefficient i of the quotient.

        The fold q[i] = cs[i+n] + q[i+n] telescopes to a suffix sum over the
        n-strided chunks of the coefficients (q[j+tn] = sum_{k>t} cs[j+kn],
        r[j] = sum_{k>=0} cs[j+kn]), so the device path reshapes the packed
        limbs to (chunks, n) and adds one chunk row per step on `device`;
        the host path is a serial bigint loop. `on_device` picks the path
        (default: device from `_VANISH_DIV_DEVICE_MIN` quotient
        coefficients on)."""
        p = self.spec.modulus
        n = domain.size
        cs = self.coeffs
        if len(cs) <= n:
            return self._new([]), self
        if on_device is None:
            on_device = len(cs) - n >= _VANISH_DIV_DEVICE_MIN
        if on_device:
            q, r = _vanishing_divide_device(self.spec, cs, n, self.device)
            return self._new(q), self._new(r)
        q = [0] * (len(cs) - n)
        for i in range(len(q) - 1, -1, -1):
            q[i] = (cs[i + n] + (q[i + n] if i + n < len(q) else 0)) % p
        r = [(cs[i] + q[i]) % p if i < len(q) else cs[i] for i in range(n)]
        return self._new(q), self._new(r)
