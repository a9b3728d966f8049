"""Tasks the port's multi-rank tests send to every rank of a
`openzl_tpu_torch.parallel.launch.RankPool` (gloo ranks on the CPU; on the
card, gloo ranks sharing it and a 1-rank NCCL mesh).

This module imports only torch and the port: the ranks import it by name,
and never load JAX. Each task makes its mesh with `local_mesh(n, device=...)`
on every rank of the pool (a sub-group is made collectively); a rank
outside the mesh returns None. Results come back as host objects.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from openzl_tpu_torch.curves import jacobian as jac
from openzl_tpu_torch.fields import limb
from openzl_tpu_torch.fields import spec as fspec
from openzl_tpu_torch.parallel import (
    local_mesh, sharded_coset_intt, sharded_coset_ntt, sharded_intt, sharded_msm, sharded_msm_multi, sharded_ntt,
    sharded_poseidon_hash,
)
from openzl_tpu_torch.ref import pairing as refpair

TRANSFORMS = {"ntt": sharded_ntt, "intt": sharded_intt, "coset_ntt": sharded_coset_ntt,
              "coset_intt": sharded_coset_intt}


def curve_of(name: str):
    """"bn254_g1" -> the port's curve spec."""
    pairing, group = name.rsplit("_", 1)
    return getattr(refpair.PAIRINGS[pairing], group)


def collectives(n: int, device: str):
    """The mesh's all-gather and all-to-all on rank-tagged tensors."""
    mesh = local_mesh(n, device=device)
    if mesh is None:
        return None
    r = mesh.rank
    v = torch.arange(2 * 3 * (2 * n), dtype=torch.int32).reshape(2, 3, 2 * n) + 1000 * r
    return dict(rank=r, size=mesh.size, gather=mesh.all_gather(v).numpy(),
                a2a=mesh.all_to_all(v, split_axis=2, concat_axis=1).numpy(),
                a2a_front=mesh.all_to_all(v, split_axis=-1, concat_axis=0).numpy())


def msm(n: int, curve_name: str, ks, pts, device: str, window_bits=None, n_bits=None, sets: bool = False):
    """sharded_msm of affine `pts` (or sharded_msm_multi of a list of them,
    with `sets`) by int scalars `ks`; affine results."""
    mesh = local_mesh(n, device=device)
    if mesh is None:
        return None
    curve = curve_of(curve_name)
    scal = limb.tensor(limb.pack(curve.scalar, np.array(ks, dtype=object)))
    if sets:
        outs = sharded_msm_multi(curve, mesh, scal, [jac.from_affine_ints(curve, p) for p in pts],
                                 window_bits, n_bits)
        return [jac.to_affine_ints(curve, o) for o in outs]
    out = sharded_msm(curve, mesh, scal, jac.from_affine_ints(curve, pts), window_bits, n_bits)
    return jac.to_affine_ints(curve, out)


def transform(n: int, spec_name: str, which: str, x: np.ndarray, device: str):
    """One of the four sharded transforms of Montgomery limbs `x`."""
    mesh = local_mesh(n, device=device)
    if mesh is None:
        return None
    spec = getattr(fspec, spec_name)
    return TRANSFORMS[which](spec, mesh, x).cpu().numpy()


def poseidon(n: int, spec_name: str, arity: int, inputs: np.ndarray, device: str):
    from openzl_tpu_torch.crypto.poseidon.permutation import Poseidon

    mesh = local_mesh(n, device=device)
    if mesh is None:
        return None
    perm = Poseidon.create(getattr(fspec, spec_name), arity, device=device)
    return sharded_poseidon_hash(perm, mesh, inputs).cpu().numpy()


def build_circuit(com, x, w, digest):
    """digest = w^5 x + w with x and digest public, and w's low byte
    decomposed: the same gadget calls on either package's compiler."""
    xv, h_pub = com.public_input(x), com.public_input(digest)
    wv = com.secret_witness(w)
    h = com.add(com.mul(com.pow5(wv), xv), wv)
    com.assert_eq(h, h_pub)
    low = com.secret_witness(w % 256)
    com.to_bits_le(low, 8)
    com.assert_eq(com.is_eq(low, com.constant(w % 256)), com.constant(1))
    return com.cs


def groth16_prove(n: int, key: bytes, public, w: int, prove_seed: int, device: str):
    """The mesh proof of `build_circuit` under the key's bytes (lifted onto
    the rank's device), from `random.Random(prove_seed)`: its bytes, and
    how many times the prover called each sharded function."""
    from openzl_tpu_torch.parallel import ops as pops
    from openzl_tpu_torch.proof_systems import BN254, Groth16, ProvingKey

    mesh = local_mesh(n, device=device)
    if mesh is None:
        return None
    g16 = Groth16(BN254, device)
    pk = ProvingKey.from_bytes(BN254, key, validate=False, device=device)
    cs = build_circuit(g16.proof_compiler(), public[0], w, public[1])
    calls, real = {}, {}

    def counted(name):
        def fn(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return real[name](*args, **kw)
        return fn

    for name in ("sharded_transform", "sharded_coset_intt", "sharded_msm", "sharded_msm_multi"):
        real[name] = getattr(pops, name)
        setattr(pops, name, counted(name))
    try:
        proof = g16.prove(pk, cs, random.Random(prove_seed), mesh=mesh)
    finally:
        for name, fn in real.items():
            setattr(pops, name, fn)
    return dict(proof=proof.to_bytes(BN254), calls=calls)


def refusals(device: str):
    """What the sharded code refuses, caught on each rank: a transform on
    a mesh that is not a power of two, a batch that does not split, and an
    NCCL mesh off the card (the group's backend read as "nccl")."""
    from openzl_tpu_torch.crypto.poseidon.permutation import Poseidon
    from openzl_tpu_torch.parallel import mesh as meshmod

    out = {}
    mesh3 = local_mesh(3, device=device)
    mesh = local_mesh(4, device=device)
    x = np.zeros((fspec.BN254_FR.n_limbs, 16), np.uint32)
    for key, fn in (
        ("transform3", lambda: sharded_ntt(fspec.BN254_FR, mesh3, x) if mesh3 is not None else None),
        ("batch", lambda: sharded_poseidon_hash(Poseidon.create(fspec.BN254_FR, 2, device=device), mesh,
                                                np.zeros((fspec.BN254_FR.n_limbs, 2, 6), np.uint32))),
        ("axis", lambda: sharded_ntt(fspec.BN254_FR, mesh, x, axis="model")),
    ):
        try:
            fn()
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    real = meshmod.dist.get_backend
    meshmod.dist.get_backend = lambda group=None: "nccl"
    try:
        meshmod.Mesh(mesh.group, mesh.ranks, mesh.rank, mesh.axis, torch.device(device))
        out["nccl"] = None
    except ValueError as e:
        out["nccl"] = str(e)
    finally:
        meshmod.dist.get_backend = real
    return out


def fail():
    raise RuntimeError("this rank fails on purpose")


def sleep(seconds: float):
    import time

    time.sleep(seconds)
    return seconds
