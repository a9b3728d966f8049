"""Groth16 zk-SNARK: compile / prove / verify on the torch kernel stack.

Port of `openzl_tpu/proof_systems/groth16.py`. The device backend (the
default):

  * compile: QAP columns evaluated at the toxic tau by transposed sparse
    matvecs (K1), the query scalars derived on the device, every query
    encoded by a fixed-base MSM (K3 mixed adds);
  * prove: u/v/w = (A z, B z, C z) by sparse matvecs (K1), H by three
    iNTTs, three coset NTTs, the pointwise (u v - w) / Z and a coset iNTT
    (K1, K2), then the four G1 MSMs in one bucket pipeline and the G2 MSM
    (K3, K4); proof assembly on the host;
  * verify: the pairing check (`openzl_tpu_torch.ref.pairing`, native
    engine when `native/libozlfield.so` is built).

The host backend (`backend="host"`, or "auto" below 512 variables) holds
the queries as affine int lists made by the Python EC oracle, evaluates
the QAP columns and rows on the host and runs the proving MSMs there; the
H polynomial's NTTs still run on the `Groth16`'s device. `device_key`
lifts such a key onto the device.

Randomness (toxic waste, r and s) comes from a Python `random.Random`
exactly as in the reference, so one seed gives the same bytes in both
packages. The QAP matches ark-groth16: domain = next power of two >=
num_constraints + num_instance, instance-binding rows A[nc + i][i] = 1, and
the coset trick divides by the constant Z(g w^j) = g^n - 1.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..curves import jacobian as jac
from ..curves.jacobian import JPoint
from ..eclair.compilers import R1CSCompiler
from ..eclair.r1cs import R1CS, LinComb
from ..fields import limb
from ..fields.spec import FieldSpec
from ..ops import ntt as nttmod
from ..ops.msm import fixed_base_msm, msm, msm_sets
from ..ops.sparse import SparseFieldMatrix
from ..parallel import ops as pops
from ..ref import curve as refc
from ..ref import pairing as refpair
from ..ref.pairing import BLS12_381, BN254, PairingSpec
from ..utils import codec


# ---------------------------------------------------------------------------
# key / proof containers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VerifyingKey:
    """Host-side verification key (affine int points)."""

    pairing: PairingSpec
    alpha_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    gamma_abc_g1: list  # per instance column (incl. ONE)

    def to_bytes(self) -> bytes:
        """ark-groth16 VerifyingKey layout: alpha_g1, beta_g2, gamma_g2,
        delta_g2, Vec<gamma_abc_g1>."""
        g1, g2 = self.pairing.g1, self.pairing.g2
        w = codec.Writer()
        w.point(g1, self.alpha_g1)
        w.point(g2, self.beta_g2)
        w.point(g2, self.gamma_g2)
        w.point(g2, self.delta_g2)
        w.vec(self.gamma_abc_g1, lambda pt: w.point(g1, pt))
        return w.getvalue()

    @classmethod
    def from_bytes(cls, pairing: PairingSpec, data: bytes) -> "VerifyingKey":
        g1, g2 = pairing.g1, pairing.g2
        r = codec.Reader(data)
        return cls(
            pairing=pairing,
            alpha_g1=r.point(g1),
            beta_g2=r.point(g2),
            gamma_g2=r.point(g2),
            delta_g2=r.point(g2),
            gamma_abc_g1=r.vec(lambda: r.point(g1)),
        )

    @classmethod
    def from_reference(cls, vk) -> "VerifyingKey":
        """From a reference (JAX package) VerifyingKey: its affine int
        points, over the port's pairing of the same name."""
        return cls(refpair.PAIRINGS[vk.pairing.name], vk.alpha_g1, vk.beta_g2, vk.gamma_g2, vk.delta_g2,
                   list(vk.gamma_abc_g1))


@dataclasses.dataclass(frozen=True)
class PreparedCircuit:
    """Sparse A/B/C (rows padded to the FFT domain) and their transposes."""

    a: SparseFieldMatrix
    b: SparseFieldMatrix
    c: SparseFieldMatrix
    at: SparseFieldMatrix
    bt: SparseFieldMatrix
    ct: SparseFieldMatrix
    log_n: int
    num_vars: int
    num_instance_total: int

    @classmethod
    def from_reference(cls, prep) -> "PreparedCircuit":
        """From a reference `PreparedCircuit`, through the COO arrays."""
        mats = [SparseFieldMatrix.from_reference(getattr(prep, k))
                for k in ("a", "b", "c", "at", "bt", "ct")]
        return cls(*mats, log_n=prep.log_n, num_vars=prep.num_vars,
                   num_instance_total=prep.num_instance_total)


_QUERIES = ("a_query", "b_g1_query", "b_g2_query", "h_query", "l_query")


@dataclasses.dataclass
class ProvingKey:
    """Proving key with the query tables as batched Jacobian points on one
    torch device."""

    pairing: PairingSpec
    vk: VerifyingKey
    beta_g1: tuple
    delta_g1: tuple
    a_query: JPoint  # (num_vars,) u_k(tau) G1
    b_g1_query: JPoint  # (num_vars,) v_k(tau) G1
    b_g2_query: JPoint  # (num_vars,) v_k(tau) G2
    h_query: JPoint  # (n-1,) tau^i Z(tau) / delta G1
    l_query: JPoint  # (num_witness,) (beta u + alpha v + w) / delta G1
    domain_log2: int
    num_instance_total: int
    #: queries held as affine int lists (host backend) instead of JPoints
    host: bool = False
    #: sparse QAP matrices from compile time; not serialized
    prepared: Optional[PreparedCircuit] = None

    def _curves(self):
        g1, g2 = self.pairing.g1, self.pairing.g2
        return (g1, g1, g2, g1, g1)

    @property
    def device(self) -> Optional[torch.device]:
        """The query tables' device; None for a host-form or staged key."""
        return None if self.host or self.staged else self.a_query.x.device

    @property
    def staged(self) -> bool:
        """Queries offloaded to host numpy (`offload_queries`): the prover
        stages one query at a time onto the `Groth16`'s device."""
        return not self.host and isinstance(self.a_query.x, np.ndarray)

    def offload_queries(self) -> "ProvingKey":
        """Copy with every query table moved to host numpy: the prover then
        stages one query on the device per MSM and frees it after its
        readback (`_prove_msms_staged`), and each QAP matrix's device copy
        after its matvec, so a key that does not fit beside the prover's
        working set still proves on one device. The device tables are
        freed when the original key goes: `pk = pk.offload_queries()`."""
        if self.host or self.staged:
            return self
        host = {k: JPoint(*(v.detach().cpu().numpy().copy() for v in getattr(self, k))) for k in _QUERIES}
        return dataclasses.replace(self, **host)

    def _query_affine(self, query, curve):
        """Affine int list of one query table: host form as it is, device
        form by one batched inversion on its device, staged on the host."""
        if self.host:
            return list(query)
        if self.staged:
            query = JPoint(*(limb.tensor(v) for v in query))
        return jac.to_affine_ints(curve, query)

    def to_bytes(self, compressed: bool = False) -> bytes:
        """ark-groth16 ProvingKey member order (vk, beta_g1, delta_g1,
        a_query, b_g1_query, b_g2_query, h_query, l_query) plus the
        domain_log2 / num_instance_total trailer, as the reference."""
        g1 = self.pairing.g1
        w = codec.Writer()
        vkb = self.vk.to_bytes()
        w.u64(len(vkb))
        w.bytes_(vkb)
        w.point(g1, self.beta_g1, compressed)
        w.point(g1, self.delta_g1, compressed)
        for name, curve in zip(_QUERIES, self._curves()):
            pts = self._query_affine(getattr(self, name), curve)
            w.vec(pts, lambda pt, c=curve: w.point(c, pt, compressed))
        w.u64(self.domain_log2)
        w.u64(self.num_instance_total)
        return w.getvalue()

    @classmethod
    def from_bytes(
        cls,
        pairing: PairingSpec,
        data: bytes,
        compressed: bool = False,
        validate: bool = True,
        device="cuda",
    ) -> "ProvingKey":
        """Deserialize; the query tables land on `device`.
        `validate` checks subgroup membership of every point."""
        g1, g2 = pairing.g1, pairing.g2
        r = codec.Reader(data)
        vk = VerifyingKey.from_bytes(pairing, r.bytes_(r.u64()))
        beta_g1 = r.point(g1, compressed, validate)
        delta_g1 = r.point(g1, compressed, validate)
        curves = (g1, g1, g2, g1, g1)
        queries = [r.vec(lambda c=curve: r.point(c, compressed, validate)) for curve in curves]
        return cls(
            pairing=pairing, vk=vk, beta_g1=beta_g1, delta_g1=delta_g1,
            **{k: jac.from_affine_ints(c, q, device) for k, c, q in zip(_QUERIES, curves, queries)},
            domain_log2=r.u64(), num_instance_total=r.u64(),
        )

    @classmethod
    def from_reference(cls, pk, device="cuda", backend: str = "device") -> "ProvingKey":
        """From a reference (JAX package) ProvingKey, over the port's
        pairing of the same name: device-form queries through `np.asarray`
        of their limb arrays, host-form ones through their affine int
        lists, onto `device`. With `backend="host"` a host-form key stays
        in host form (its affine lists, `host=True`); a staged key (its
        queries offloaded to numpy) stays staged, its queries on the host."""
        if backend not in ("host", "device"):
            raise ValueError(f"backend must be 'host' or 'device', not {backend!r}")
        pairing = refpair.PAIRINGS[pk.pairing.name]
        g1, g2 = pairing.g1, pairing.g2
        host = backend == "host"
        if host and not pk.host:
            raise ValueError("backend='host' takes a host-form key; this one is in device form")
        queries = {}
        for k, curve in zip(_QUERIES, (g1, g1, g2, g1, g1)):
            q = getattr(pk, k)
            if host:
                queries[k] = list(q)
            elif getattr(pk, "staged", False):
                queries[k] = JPoint(*(np.ascontiguousarray(v, dtype=np.int32) for v in q))
            elif pk.host:
                queries[k] = jac.from_affine_ints(curve, list(q), device)
            else:
                queries[k] = JPoint(*(limb.tensor(np.asarray(v), device) for v in q))
        prepared = PreparedCircuit.from_reference(pk.prepared) if pk.prepared is not None and not host else None
        return cls(
            pairing=pairing, vk=VerifyingKey.from_reference(pk.vk),
            beta_g1=pk.beta_g1, delta_g1=pk.delta_g1, **queries,
            domain_log2=pk.domain_log2, num_instance_total=pk.num_instance_total,
            host=host, prepared=prepared,
        )


@dataclasses.dataclass
class Proof:
    a: tuple  # affine G1
    b: tuple  # affine G2
    c: tuple  # affine G1

    def to_bytes(self, pairing: PairingSpec) -> bytes:
        """ark-groth16 Proof layout: A, B, C compressed."""
        w = codec.Writer()
        w.point(pairing.g1, self.a)
        w.point(pairing.g2, self.b)
        w.point(pairing.g1, self.c)
        return w.getvalue()

    @classmethod
    def from_bytes(cls, pairing: PairingSpec, data: bytes) -> "Proof":
        r = codec.Reader(data)
        return cls(a=r.point(pairing.g1), b=r.point(pairing.g2), c=r.point(pairing.g1))


# ---------------------------------------------------------------------------
# QAP helpers (host, per circuit)
# ---------------------------------------------------------------------------


def _qap_matrices(cs: R1CS):
    """A/B/C rows in final global columns, plus the instance-binding rows."""
    rows_a = [cs.remap(a) for a, _, _ in cs.constraints]
    rows_b = [cs.remap(b) for _, b, _ in cs.constraints]
    rows_c = [cs.remap(c) for _, _, c in cs.constraints]
    for i in range(cs.num_instance_total):
        rows_a.append(LinComb.single(i))
        rows_b.append(LinComb())
        rows_c.append(LinComb())
    return rows_a, rows_b, rows_c


def _domain_log2(n_rows: int) -> int:
    return max(1, (n_rows - 1).bit_length())


def _lagrange_at(spec: FieldSpec, log_n: int, tau: int) -> List[int]:
    """ell_j(tau) = (tau^n - 1) w^j / (n (tau - w^j)), batch-inverted."""
    p = spec.modulus
    n = 1 << log_n
    w = nttmod.group_gen(spec, log_n)
    z = (pow(tau, n, p) - 1) % p
    n_inv = pow(n, -1, p)
    ws = [1] * n
    dens = [0] * n
    wj = 1
    for j in range(n):
        ws[j] = wj
        dens[j] = (tau - wj) % p
        wj = wj * w % p
    prefix = [1] * (n + 1)
    for j in range(n):
        prefix[j + 1] = prefix[j] * dens[j] % p
    inv_all = pow(prefix[n], -1, p)
    out = [0] * n
    for j in range(n - 1, -1, -1):
        inv_j = inv_all * prefix[j] % p
        inv_all = inv_all * dens[j] % p
        out[j] = z * ws[j] % p * inv_j % p * n_inv % p
    return out


def _col_evals(rows, lag: List[int], num_vars: int, p: int) -> List[int]:
    """u_k(tau) = sum_j rows[j][k] ell_j(tau): sparse column sums (host)."""
    out = [0] * num_vars
    for j, lc in enumerate(rows):
        lj = lag[j]
        for k, coeff in lc.terms.items():
            out[k] = (out[k] + coeff * lj) % p
    return out


def _fixed_base_host(curve, scalars: Sequence[int]):
    """Host-oracle fixed-base scalars -> list of affine points."""
    G = refc.generator(curve)
    return [refc.scalar_mul(curve, k, G) for k in scalars]


def _row_dot(rows, assignment: List[int], p: int) -> List[int]:
    return [lc.eval(assignment, p) for lc in rows]


_FB_WINDOW = 8


def _setup_queries(g1, g2, u, v, h, l):
    """The five query encodings: fixed-base MSMs of the canonical scalar
    vectors (K3 mixed adds over a windowed generator table)."""
    return (
        fixed_base_msm(g1, u, _FB_WINDOW),
        fixed_base_msm(g1, v, _FB_WINDOW),
        fixed_base_msm(g2, v, _FB_WINDOW),
        fixed_base_msm(g1, h, _FB_WINDOW),
        fixed_base_msm(g1, l, _FB_WINDOW),
    )


def _prove_msms(g1, g2, ni, z_can, h_canon, pk):
    """The five proving MSMs in two bucket pipelines: a, b1, h and l over
    G1 as one `msm_sets` call (one sort, one Horner chain), b2 over G2.
    Returns (G1 sums with batch (3 or 4,), the G2 sum)."""
    jobs = [(z_can, pk.a_query), (z_can, pk.b_g1_query), (h_canon, pk.h_query)]
    if z_can.shape[1] > ni:
        jobs.append((z_can[:, ni:], pk.l_query))
    return msm_sets(g1, jobs), msm(g2, z_can, pk.b_g2_query)


def _prove_msms_sharded(mesh, g1, g2, ni, z_can, h_canon, pk):
    """The mesh form of `_prove_msms`: the a/b1/l multi-set MSM (the L
    query padded in front by ni identities, so the three sets share z), the
    h MSM and the G2 b2 MSM each shard their point axis over the mesh
    (`parallel.ops`). Returns the G1 sums stacked as `_prove_msms` stacks
    them, and the G2 sum, replicated on every rank."""
    sets = [pk.a_query, pk.b_g1_query]
    if z_can.shape[1] > ni:
        sets.append(jac.concat([jac.identity(g1, (ni,), pk.device), pk.l_query]))
    outs = pops.sharded_msm_multi(g1, mesh, z_can, sets)
    h = pops.sharded_msm(g1, mesh, h_canon, pk.h_query)
    b2 = pops.sharded_msm(g2, mesh, z_can, pk.b_g2_query)
    g1s = [outs[0], outs[1], h] + outs[2:]
    return JPoint(*(torch.stack([p[i] for p in g1s], dim=-1) for i in range(3))), b2


def _prove_msms_staged(g1, g2, ni, z_can, h_canon, pk, laps):
    """The staged form of `_prove_msms`: five MSMs, each staging ONE
    host-offloaded query onto z's device and freeing it after its readback,
    so the device holds one query (and the MSM's transients) at a time
    instead of the whole key. Returns the affine (a, b1, b2, h, l) sums."""
    dev = z_can.device

    def stage(curve, scalars, query, name):
        pt = jac.to_affine_ints(curve, msm(curve, scalars, JPoint(*(limb.tensor(v, dev) for v in query))))
        laps.lap(f"msm_{name}")  # the readback synchronized; the staged query is freed on return
        return pt

    a = stage(g1, z_can, pk.a_query, "a")
    b1 = stage(g1, z_can, pk.b_g1_query, "b1")
    l = stage(g1, z_can[:, ni:], pk.l_query, "l") if z_can.shape[1] > ni else None
    h = stage(g1, h_canon, pk.h_query, "h")
    b2 = stage(g2, z_can, pk.b_g2_query, "b2")
    return a, b1, b2, h, l


class Laps:
    """Stage wall-clock table, kept in `rows`. On a CUDA device each lap
    synchronizes first, so a stage's time includes its kernels."""

    def __init__(self, device) -> None:
        self.cuda = torch.device(device).type == "cuda"
        self.rows: list = []
        self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        ms = (now - self.t) * 1e3
        self.rows.append((name, ms))
        self.t = now


# ---------------------------------------------------------------------------
# the proof system
# ---------------------------------------------------------------------------


#: below this many variables `backend="auto"` compiles a host-form key
AUTO_HOST_VARS = 512


class Groth16:
    """compile / prove / verify on one torch device: "cuda" (the default)
    runs the CUDA kernels, "cpu" their plain versions.

    backend: "device" (the default) encodes the queries and runs the
    proving MSMs on the device; "host" uses the Python EC oracle for them
    (the H polynomial's NTTs still run on the device); "auto" picks host
    below `AUTO_HOST_VARS` variables, as the reference does."""

    def __init__(self, pairing: PairingSpec = BLS12_381, device="cuda", backend: str = "device"):
        if backend not in ("auto", "host", "device"):
            raise ValueError(f"backend must be 'auto', 'host' or 'device', not {backend!r}")
        self.pairing = pairing
        self.fr = pairing.g1.scalar
        self.device = torch.device(device)
        self.backend = backend
        #: stage tables of the last compile and prove
        self.laps: dict = {}

    def _use_host(self, num_vars: int) -> bool:
        if self.backend == "auto":
            return num_vars < AUTO_HOST_VARS
        return self.backend == "host"

    def context_compiler(self) -> R1CSCompiler:
        return R1CSCompiler.for_contexts(self.fr)

    def proof_compiler(self) -> R1CSCompiler:
        return R1CSCompiler.for_proofs(self.fr)

    # -- setup --------------------------------------------------------------

    def prepare(self, cs: R1CS) -> PreparedCircuit:
        """Sparse QAP matrices for `cs` (one O(nnz) host pass)."""
        rows_a, rows_b, rows_c = _qap_matrices(cs)
        log_n = _domain_log2(len(rows_a))
        n = 1 << log_n
        num_vars = cs.num_variables
        mats = [SparseFieldMatrix.from_lincombs(self.fr, rows, n, num_vars)
                for rows in (rows_a, rows_b, rows_c)]
        return PreparedCircuit(
            *mats, *(m.transpose() for m in mats),
            log_n=log_n, num_vars=num_vars, num_instance_total=cs.num_instance_total,
        )

    def compile(self, cs: R1CS, rng) -> ProvingKey:
        """Circuit-specific setup (toxic waste drawn from `rng`)."""
        fr, p, dev = self.fr, self.fr.modulus, self.device
        g1, g2 = self.pairing.g1, self.pairing.g2
        alpha, beta, gamma, delta, tau = (rng.randrange(1, p) for _ in range(5))
        if self._use_host(cs.num_variables):
            return self._compile_host(cs, alpha, beta, gamma, delta, tau)
        laps = Laps(dev)
        prepared = self.prepare(cs)
        log_n = prepared.log_n
        n = 1 << log_n
        num_vars, ni = cs.num_variables, cs.num_instance_total
        laps.lap("prepare_matrices")
        lag = _lagrange_at(fr, log_n, tau)
        laps.lap("lagrange")
        gamma_inv = pow(gamma, -1, p)
        delta_inv = pow(delta, -1, p)
        z_delta = (pow(tau, n, p) - 1) % p * delta_inv % p

        lag_m = limb.tensor(limb.pack_mont(fr, np.array(lag, dtype=object)), dev)
        u_m = prepared.at.matvec(lag_m)
        v_m = prepared.bt.matvec(lag_m)
        w_m = prepared.ct.matvec(lag_m)
        laps.lap("qap_evals")

        def cm(x: int):  # Montgomery broadcast constant
            return limb.tensor(limb.pack_mont(fr, x % p), dev).reshape(fr.n_limbs, 1)

        abc_m = limb.add(
            fr, limb.add(fr, limb.mont_mul(fr, u_m, cm(beta)), limb.mont_mul(fr, v_m, cm(alpha))),
            w_m,
        )
        l_can = limb.from_mont(fr, limb.mont_mul(fr, abc_m[:, ni:], cm(delta_inv)))
        gamma_abc = [int(x) for x in limb.unpack_mont(fr, limb.mont_mul(fr, abc_m[:, :ni], cm(gamma_inv)))]
        u_can = limb.from_mont(fr, u_m)
        v_can = limb.from_mont(fr, v_m)
        h_can = limb.from_mont(fr, limb.geom_series_mont(fr, z_delta, tau, n - 1, dev))
        laps.lap("scalar_vectors")

        queries = _setup_queries(g1, g2, u_can, v_can, h_can, l_can)
        laps.lap("fixed_base_queries")
        pk = self._key(queries, gamma_abc, alpha, beta, gamma, delta, log_n, ni, False, prepared)
        laps.lap("verifying_key")
        self.laps["compile"] = laps.rows
        return pk

    def _compile_host(self, cs: R1CS, alpha, beta, gamma, delta, tau) -> ProvingKey:
        """The host backend's setup: QAP columns by sparse host sums and
        every query encoded by the Python EC oracle."""
        fr, p = self.fr, self.fr.modulus
        g1, g2 = self.pairing.g1, self.pairing.g2
        laps = Laps("cpu")
        rows_a, rows_b, rows_c = _qap_matrices(cs)
        log_n = _domain_log2(len(rows_a))
        n = 1 << log_n
        num_vars, ni = cs.num_variables, cs.num_instance_total
        lag = _lagrange_at(fr, log_n, tau)
        laps.lap("lagrange")
        gamma_inv = pow(gamma, -1, p)
        delta_inv = pow(delta, -1, p)
        z_delta = (pow(tau, n, p) - 1) % p * delta_inv % p
        u, v, w = (_col_evals(rows, lag, num_vars, p) for rows in (rows_a, rows_b, rows_c))
        laps.lap("qap_evals")
        abc = [(beta * u[k] + alpha * v[k] + w[k]) % p for k in range(num_vars)]
        gamma_abc = [x * gamma_inv % p for x in abc[:ni]]
        l_scalars = [x * delta_inv % p for x in abc[ni:]]
        h_scalars, acc = [], z_delta
        for _ in range(n - 1):  # tau^i Z(tau) / delta
            h_scalars.append(acc)
            acc = acc * tau % p
        laps.lap("host_scalars")
        queries = (
            _fixed_base_host(g1, u), _fixed_base_host(g1, v), _fixed_base_host(g2, v),
            _fixed_base_host(g1, h_scalars), _fixed_base_host(g1, l_scalars),
        )
        laps.lap("fixed_base_queries")
        pk = self._key(queries, gamma_abc, alpha, beta, gamma, delta, log_n, ni, True, None)
        laps.lap("verifying_key")
        self.laps["compile"] = laps.rows
        return pk

    def _key(self, queries, gamma_abc, alpha, beta, gamma, delta, log_n, ni, host, prepared) -> ProvingKey:
        """The verifying key's points on the host oracle, and the proving
        key around the five query tables."""
        g1, g2 = self.pairing.g1, self.pairing.g2
        G1, G2 = refc.generator(g1), refc.generator(g2)
        vk = VerifyingKey(
            pairing=self.pairing,
            alpha_g1=refc.scalar_mul(g1, alpha, G1),
            beta_g2=refc.scalar_mul(g2, beta, G2),
            gamma_g2=refc.scalar_mul(g2, gamma, G2),
            delta_g2=refc.scalar_mul(g2, delta, G2),
            gamma_abc_g1=_fixed_base_host(g1, gamma_abc),
        )
        return ProvingKey(
            pairing=self.pairing, vk=vk,
            beta_g1=refc.scalar_mul(g1, beta, G1),
            delta_g1=refc.scalar_mul(g1, delta, G1),
            **dict(zip(_QUERIES, queries)),
            domain_log2=log_n, num_instance_total=ni, host=host, prepared=prepared,
        )

    def device_key(self, pk: ProvingKey, cs: Optional[R1CS] = None) -> ProvingKey:
        """Lift a host-form ProvingKey (affine int query lists: a key from
        `backend="host"` setup) onto this `Groth16`'s device for the kernel
        prover. `cs` (or pk.prepared) supplies the sparse QAP matrices."""
        if not pk.host:
            return pk
        prepared = pk.prepared
        if prepared is None:
            if cs is None:
                raise ValueError("device_key needs the circuit (cs)")
            prepared = self.prepare(cs)
        lifted = {k: jac.from_affine_ints(c, getattr(pk, k), self.device)
                  for k, c in zip(_QUERIES, pk._curves())}
        return dataclasses.replace(pk, **lifted, host=False, prepared=prepared)

    # -- prove ---------------------------------------------------------------

    def witness_calculator(self, cs: R1CS):
        """Tape-replay witness generator for `cs` (native when built)."""
        from ..eclair.witness import WitnessCalculator

        return WitnessCalculator(cs)

    def prove(self, pk: ProvingKey, cs: R1CS, rng, prepared: Optional[PreparedCircuit] = None,
              mesh=None) -> Proof:
        """Prove `cs`'s assignment. With a `parallel` mesh (every rank of it
        calls this with the same key, circuit and seeded rng) the H
        polynomial's transforms and the MSMs are sharded over the mesh, and
        every rank returns the same proof."""
        z = cs.assignment()
        if pk.host:
            return self._prove_z(pk, z, rng, None, cs=cs, mesh=mesh)
        return self._prove_z(pk, z, rng, prepared or pk.prepared or self.prepare(cs), mesh=mesh)

    def prove_assigned(self, pk: ProvingKey, z, rng, prepared: Optional[PreparedCircuit] = None,
                       mesh=None) -> Proof:
        """Prove from a full assignment: the planar (n_limbs, num_vars)
        canonical limb array of `WitnessCalculator.evaluate_limbs`, or a
        sequence of ints. Needs `prepared` or a key from `compile`; `mesh`
        as in `prove`."""
        if pk.host:
            raise ValueError("a host-form key proves through prove(pk, cs, rng), or lift it with device_key")
        prepared = prepared or pk.prepared
        if prepared is None:
            raise ValueError("prove_assigned needs the prepared matrices (Groth16.prepare)")
        return self._prove_z(pk, z, rng, prepared, mesh=mesh)

    def _prove_z(self, pk: ProvingKey, z, rng, prepared: Optional[PreparedCircuit], cs: Optional[R1CS] = None,
                 mesh=None) -> Proof:
        """Prove from a full assignment `z`; a host-form key takes it as
        ints with the circuit `cs`, a device-form key as limbs or ints with
        the `prepared` matrices. A staged key (`offload_queries`) proves on
        this `Groth16`'s device one matrix and one query at a time."""
        fr, p = self.fr, self.fr.modulus
        g1, g2 = self.pairing.g1, self.pairing.g2
        dev = self.device if pk.device is None else pk.device
        laps = Laps(dev)
        ni = pk.num_instance_total
        n = 1 << pk.domain_log2
        if mesh is not None and (pk.host or n <= mesh.size):
            mesh = None  # host backend or a domain no larger than the mesh: one device, as the reference
        if mesh is not None and pk.staged:
            raise ValueError("staged and mesh proving are exclusive")

        if pk.host:
            # u/v/w = (A z, B z, C z) by host row sums, lifted for the NTTs
            rows = _qap_matrices(cs)
            ua, va, wa = (
                limb.tensor(limb.pack_mont(fr, np.array(_row_dot(r, z, p) + [0] * (n - len(r)), dtype=object)), dev)
                for r in rows
            )
            laps.lap("qap_rows")
        else:
            if not isinstance(z, np.ndarray):
                z = limb.pack(fr, np.array(list(z), dtype=object))
            num_vars = z.shape[1]
            if prepared.num_vars != num_vars:
                raise ValueError(f"assignment has {num_vars} variables, circuit {prepared.num_vars}")
            z_can = limb.tensor(z, dev)
            z_mont = limb.to_mont(fr, z_can)
            laps.lap("pack_witness")
            mats = (prepared.a, prepared.b, prepared.c)
            if pk.staged:
                # one COO matrix on the device at a time: each matvec is
                # forced and its matrix's device copy freed before the next
                ua, va, wa = (self._staged_matvec(m, z_mont) for m in mats)
            else:
                ua, va, wa = (m.matvec(z_mont) for m in mats)
            laps.lap("qap_matvec")

        g = nttmod.GENERATORS[fr.name]
        zg_inv = pow((pow(g, n, p) - 1) % p, -1, p)
        if mesh is not None:
            # each transform a four-step NTT sharded over the mesh, whose
            # only exchange is one all-to-all; bit-exact with one device
            def tr(v, **kw):
                return pops.sharded_transform(fr, mesh, v, **kw)

            uc, vc, wc = (tr(tr(v, inverse=True), coset=True) for v in (ua, va, wa))
        else:
            # one batched iNTT and coset NTT for u, v and w: (n_limbs, N, 3)
            uc, vc, wc = nttmod.coset_ntt(fr, nttmod.intt(fr, torch.stack([ua, va, wa], dim=2))).unbind(2)
        zg = limb.tensor(limb.pack_mont(fr, zg_inv), uc.device).reshape(fr.n_limbs, 1)
        hc = limb.mont_mul(fr, limb.sub(fr, limb.mont_mul(fr, uc, vc), wc), zg)
        h_coeffs = pops.sharded_coset_intt(fr, mesh, hc) if mesh is not None else nttmod.coset_intt(fr, hc)
        h_canon = limb.from_mont(fr, h_coeffs)[:, : n - 1]
        laps.lap("h_poly_ntts")

        r, s = rng.randrange(p), rng.randrange(p)

        if pk.host:
            h_ints = [int(v) for v in limb.unpack(fr, h_canon)]
            a_msm = refc.msm(g1, z, pk.a_query)
            b1_msm = refc.msm(g1, z, pk.b_g1_query)
            b2_msm = refc.msm(g2, z, pk.b_g2_query)
            h_msm = refc.msm(g1, h_ints, pk.h_query)
            l_msm = refc.msm(g1, z[ni:], pk.l_query) if z[ni:] else None
            laps.lap("host_msms")
        elif pk.staged:
            a_msm, b1_msm, b2_msm, h_msm, l_msm = _prove_msms_staged(g1, g2, ni, z_can, h_canon, pk, laps)
        else:
            if mesh is not None:
                g1_sums, b2_sum = _prove_msms_sharded(mesh, g1, g2, ni, z_can, h_canon, pk)
            else:
                g1_sums, b2_sum = _prove_msms(g1, g2, ni, z_can, h_canon, pk)
            laps.lap("msm_kernels")
            g1_pts = jac.to_affine_ints(g1, g1_sums)
            b2_msm = jac.to_affine_ints(g2, b2_sum)
            a_msm, b1_msm, h_msm = g1_pts[:3]
            l_msm = g1_pts[3] if len(g1_pts) > 3 else None
            laps.lap("msm_readback")

        # A = alpha + sum z_k u_k + r delta
        A = refc.add(g1, refc.add(g1, pk.vk.alpha_g1, a_msm), refc.scalar_mul(g1, r, pk.delta_g1))
        # B (G2) = beta + sum z_k v_k + s delta; B (G1) likewise for C
        B2 = refc.add(g2, refc.add(g2, pk.vk.beta_g2, b2_msm), refc.scalar_mul(g2, s, pk.vk.delta_g2))
        B1 = refc.add(g1, refc.add(g1, pk.beta_g1, b1_msm), refc.scalar_mul(g1, s, pk.delta_g1))
        # C = L + H + s A + r B1 - r s delta
        C = h_msm
        if l_msm is not None:
            C = refc.add(g1, C, l_msm)
        C = refc.add(g1, C, refc.scalar_mul(g1, s, A))
        C = refc.add(g1, C, refc.scalar_mul(g1, r, B1))
        C = refc.add(g1, C, refc.neg(g1, refc.scalar_mul(g1, r * s % p, pk.delta_g1)))
        laps.lap("finalize")
        self.laps["prove"] = laps.rows
        return Proof(a=A, b=B2, c=C)

    @staticmethod
    def _staged_matvec(m: SparseFieldMatrix, z_mont: torch.Tensor) -> torch.Tensor:
        out = m.matvec(z_mont)
        out[:1, :1].cpu()  # forces the matvec before its matrix's device copy goes
        m.drop_device()
        return out

    # -- verify ---------------------------------------------------------------

    def verify(self, vk: VerifyingKey, public_inputs: Sequence[int], proof: Proof) -> bool:
        """e(A, B) == e(alpha, beta) e(Ic, gamma) e(C, delta)."""
        p = self.fr.modulus
        g1 = self.pairing.g1
        inputs = [1] + [x % p for x in public_inputs]
        if len(inputs) != len(vk.gamma_abc_g1):
            return False
        ic = None
        for a_i, P in zip(inputs, vk.gamma_abc_g1):
            ic = refc.add(g1, ic, refc.scalar_mul(g1, a_i, P))
        return refpair.pairing_product_is_one(
            self.pairing,
            [
                (refc.neg(g1, proof.a), proof.b),
                (vk.alpha_g1, vk.beta_g2),
                (ic, vk.gamma_g2),
                (proof.c, vk.delta_g2),
            ],
        )
