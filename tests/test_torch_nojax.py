"""The port stands alone: in a fresh interpreter whose import system refuses
`jax`, `jaxlib` and the JAX package `openzl_tpu`, import every module of
`openzl_tpu_torch` (the walk reaching the gadget layer and
`crypto/signature/`), sign and verify an Edwards Schnorr signature, run the
1-link Groth16 slice, a Poseidon2 hash, a
2^3-leaf Merkle build with path checks, a device-backend KZG commit (held
against the host backend), a `DensePoly` NTT product, a sharded coset
iNTT on a one-rank gloo mesh and a ratio proof on the CPU, and
check that none of the blocked modules was loaded. The source scan covers
`parallel/`, `ratio.py`, `chip_smoke.py` and the rank tasks of the
multi-rank tests (`tests/torch_mesh_tasks.py`), which the ranks import."""

import os
import pathlib
import re
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent(
    """
    import importlib, importlib.abc, pkgutil, random, sys

    BLOCKED = ("jax", "jaxlib", "openzl_tpu")

    class BlockJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked in this process: " + name)
            return None

    sys.meta_path.insert(0, BlockJax())

    import openzl_tpu_torch
    walked = [mod.name for mod in pkgutil.walk_packages(openzl_tpu_torch.__path__, "openzl_tpu_torch.")]
    for name in walked:
        importlib.import_module(name)
    for name in ("eclair.gadgets", "eclair.measure", "curves.edwards", "crypto.algebra", "crypto.ec_gadget",
                 "crypto.signature", "crypto.signature.schnorr", "crypto.signature.convert", "parallel",
                 "parallel.mesh", "parallel.ops", "parallel.launch", "proof_systems.ratio"):
        assert "openzl_tpu_torch." + name in walked, name

    from openzl_tpu_torch.crypto.signature.schnorr import EdSchnorr
    from openzl_tpu_torch.curves.edwards import BABY_JUBJUB
    scheme = EdSchnorr(BABY_JUBJUB)
    sig = scheme.sign(5, 7, 11)
    assert scheme.verify(scheme.derive(5), 11, sig) and not scheme.verify(scheme.derive(5), 12, sig)

    from openzl_tpu_torch.eclair import circuits
    from openzl_tpu_torch.proof_systems import BN254, Groth16

    g16 = Groth16(BN254, "cpu")
    params = circuits.poseidon_params(g16.fr)
    rng = random.Random(3)
    witness, digest = circuits.chain_inputs(params, 1, rng)
    cs = circuits.poseidon_chain(g16.context_compiler(), params, 1)
    pk = g16.compile(cs, rng)
    calc = g16.witness_calculator(cs)
    proof = g16.prove_assigned(pk, calc.evaluate_limbs([digest], witness), rng)
    assert g16.verify(pk.vk, [digest], proof)
    assert not g16.verify(pk.vk, [digest + 1], proof)

    import numpy as np
    from openzl_tpu_torch.crypto.merkle import path as mpath
    from openzl_tpu_torch.crypto.merkle.tree import MerkleParameters, MerkleTree
    from openzl_tpu_torch.crypto.poseidon2 import Poseidon2
    from openzl_tpu_torch.fields import limb
    from openzl_tpu_torch.fields.spec import BN254_FR

    p2 = Poseidon2.create(BN254_FR, 2)
    pair = limb.tensor(limb.pack_mont(BN254_FR, [[1], [2]]))
    assert p2.hash(pair).shape == (BN254_FR.n_limbs, 1)
    params = MerkleParameters(BN254_FR, 4)
    leaves = limb.pack_mont(BN254_FR, list(range(1, 9)))
    tree = MerkleTree.from_leaf_digests(params, leaves, device="cpu")
    paths = [tree.path(i) for i in range(8)]
    ok = mpath.verify_batch(
        params, limb.tensor(tree.root()), limb.tensor(leaves),
        limb.tensor(np.stack([q.sibling_digest for q in paths], 1)),
        limb.tensor(np.stack([q.inner_path for q in paths], 2)), np.arange(8),
    )
    assert bool(ok.all())

    from openzl_tpu_torch.ops.poly import DensePoly
    from openzl_tpu_torch.proof_systems import KZG

    kzg = KZG(BN254, backend="device", device="cpu")
    kp = kzg.setup(3, random.Random(4))
    coeffs = [rng.randrange(BN254.r) for _ in range(4)]
    host = KZG(BN254, backend="host")
    assert kzg.commit(kp, coeffs) == host.commit(host.setup(3, random.Random(4)), coeffs)
    a, b = (DensePoly.rand(BN254_FR, 300, rng, device="cpu") for _ in range(2))
    assert (a * b).evaluate(7) == a.evaluate(7) * b.evaluate(7) % BN254_FR.modulus

    import os, tempfile, torch
    import torch.distributed as dist
    from openzl_tpu_torch.ops import ntt
    from openzl_tpu_torch.parallel import data_mesh, sharded_coset_intt
    from openzl_tpu_torch.proof_systems import RatioProof

    store = os.path.join(tempfile.mkdtemp(), "store")
    dist.init_process_group("gloo", store=dist.FileStore(store, 1), rank=0, world_size=1)
    mesh = data_mesh(device="cpu")
    x = limb.tensor(limb.pack_mont(BN254_FR, list(range(16))))
    assert torch.equal(sharded_coset_intt(BN254_FR, mesh, x), ntt.coset_intt(BN254_FR, x))
    dist.destroy_process_group()
    ratio = RatioProof.prove(BN254, b"challenge", 7, random.Random(5))
    assert ratio.verify(BN254, b"challenge") and not ratio.verify(BN254, b"other")

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("NOJAX-OK")
    """
)


def test_port_runs_the_slice_without_jax():
    env = dict(os.environ)
    if os.environ.get("PYTEST_XDIST_WORKER"):
        env["OMP_NUM_THREADS"] = "1"  # one torch thread per xdist worker
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX-OK" in proc.stdout


#: an import of jax, jaxlib or the JAX package (`openzl_tpu` but not
#: `openzl_tpu_torch`)
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|openzl_tpu)\b(?!_)", re.MULTILINE)


def test_port_sources_never_import_jax():
    sources = [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_mesh_tasks.py",
               *(ROOT / "openzl_tpu_torch").rglob("*.py")]
    names = {str(path.relative_to(ROOT)) for path in sources}
    assert {"openzl_tpu_torch/parallel/mesh.py", "openzl_tpu_torch/parallel/ops.py",
            "openzl_tpu_torch/parallel/launch.py", "openzl_tpu_torch/proof_systems/ratio.py"} <= names
    for path in sources:
        assert not _FORBIDDEN.search(path.read_text()), path
