"""The port runs without JAX: in a fresh interpreter whose import system
refuses `jax`, import every module of `openzl_tpu_torch`, run the 1-link
slice on the CPU (compile, prove, verify), and check that no JAX module was
loaded."""

import os
import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = textwrap.dedent(
    """
    import importlib, importlib.abc, pkgutil, random, sys

    class BlockJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in ("jax", "jaxlib"):
                raise ImportError("jax is blocked in this process: " + name)
            return None

    sys.meta_path.insert(0, BlockJax())

    import openzl_tpu_torch
    for mod in pkgutil.walk_packages(openzl_tpu_torch.__path__, "openzl_tpu_torch."):
        importlib.import_module(mod.name)

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
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
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


def test_port_sources_never_import_jax():
    for path in (ROOT / "openzl_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
