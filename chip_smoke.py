#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`openzl_tpu_torch`) on one GPU.

Drives the port's main path, the Groth16 prover, through the entry points a
user calls, and checks every hand-written kernel on the way. Phases:

  1. device   the card's name and power limit; fails without CUDA
  2. build    nvcc builds the kernels (K1-K4) and `make -C native` the
              host library; prints the build seconds and register spills
  3. kernels  each kernel against its plain torch version on the card,
              bit-exact, at the main path's shapes; prints both times
  4. roundtrip  port on CUDA against port on CPU, same seeds, 2 chain
              links: ProvingKey and Proof bytes must be identical
  5. slice    BN254 Poseidon hash chain (512 links, about 2^17
              constraints): compile once, answer 3 prove requests (fresh
              witness, fresh r and s), verify each, reject a fuzzed input;
              launch counters zeroed before the requests and read after;
              then one more request under torch.profiler (device busy
              share, device time by kernel, host launches and syncs;
              `openzl_tpu_torch.utils.profile`)

Prints a JSON line of per-kernel results, then, as the last line,
{"ok": true, "device": {...}}. Any failure exits non-zero with no result.
Imports only the port (`openzl_tpu_torch`), never JAX.

Usage: python3 chip_smoke.py [--chain 512] [--proofs 3]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import random
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    log(smi)
    return name, smi


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------


def phase_build():
    import re

    from openzl_tpu_torch.utils import build

    t0 = time.perf_counter()
    path = build.build()
    build.lib()
    t_nvcc = time.perf_counter() - t0
    t0 = time.perf_counter()
    subprocess.run(["make", "-C", str(ROOT / "native")], check=True, capture_output=True)
    t_native = time.perf_counter() - t0
    from openzl_tpu_torch.eclair.witness import native_available

    if not native_available():
        fail("native/libozlfield.so did not load")
    ptxas = path.with_suffix(".log").read_text()
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", ptxas)]
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", ptxas)]
    log(
        f"[build] nvcc {t_nvcc:.1f} s, make -C native {t_native:.1f} s; "
        f"{len(regs)} kernels, max {max(regs, default=0)} registers, "
        f"{sum(1 for s in spills if s)} spilling (max {max(spills, default=0)} bytes spill stores); "
        f"ptxas report {path.with_suffix('.log').relative_to(ROOT)}"
    )


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------


def _time(fn, reps: int, device) -> float:
    """Mean ms per call: CUDA events on the card, the host clock on the CPU
    (used only when the phases are rehearsed without a GPU)."""
    import torch

    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_err(got, exp) -> int:
    errs = [int((g.long() - e.long()).abs().max()) if g.numel() else 0 for g, e in zip(got, exp)]
    return max(errs)


def _rand_field(spec, n, rng, device):
    from openzl_tpu_torch.fields import limb

    p = spec.modulus
    vals = [0, 1, p - 1] + [rng.randrange(p) for _ in range(n - 3)]
    return limb.tensor(limb.pack(spec, vals), device)


def _check(name, results, got, exp, ms, plain_ms, shape):
    err = _max_err(got, exp)
    log(f"[kernels] {name} {shape}: max_abs_err {err}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if err:
        fail(f"{name} disagrees with its plain version")
    results.setdefault(name, []).append((err, ms, plain_ms))


def _ec_inputs(curve, n, rng, device):
    """(P, Q, Q_affine): P and Q Jacobian with random Z, rows 0-255 with
    P = Q (different Z), rows 256-511 with P = -Q, identities in P (rows
    512-599) and in Q (rows 560-699). The 64 distinct points are random
    multiples of the generator from the port's fixed-base MSM."""
    import numpy as np
    import torch

    from openzl_tpu_torch.curves import jacobian as jac
    from openzl_tpu_torch.fields import limb
    from openzl_tpu_torch.ops import msm

    F = jac.field_ops(curve)
    ks = [rng.randrange(1, curve.scalar.modulus) for _ in range(64)]
    base = jac.normalize(curve, msm.fixed_base_msm(curve, limb.tensor(limb.pack(curve.scalar, ks), device)))
    if not bool(jac.is_on_curve(curve, base).all()):
        fail(f"{curve.name}: fixed-base MSM gave points off the curve")
    npr = np.random.default_rng(rng.randrange(1 << 30))
    ia = torch.as_tensor(npr.integers(0, 64, n), device=device)
    ib = torch.as_tensor(npr.integers(0, 64, n), device=device)
    ib[:256] = ia[:256]
    P = jac.take(base, ia)
    Q = jac.take(base, ib)

    def rows(lo, hi):
        m = torch.zeros(n, dtype=torch.bool, device=device)
        m[lo:hi] = True
        return m

    Q = jac.select(rows(256, 512), jac.negate(curve, P), Q)
    ident = jac.identity(curve, (n,), device)
    P = jac.select(rows(512, 600), ident, P)
    Q_aff = jac.select(rows(560, 700), ident, Q)

    def scale(pt):
        m = curve.base.modulus
        vals = [rng.randrange(1, m) if curve.ext == 1 else (rng.randrange(1, m), rng.randrange(m))
                for _ in range(n)]
        lam = F.from_ints(np.array(vals, dtype=object), device)
        l2 = F.mul(lam, lam)
        return jac.JPoint(F.mul(pt.x, l2), F.mul(pt.y, F.mul(l2, lam)), F.mul(pt.z, lam))

    return tuple(scale(P)), tuple(scale(Q_aff)), tuple(Q_aff)


def phase_kernels(device="cuda", log_n: int = 17, log_m: int = 16, seed: int = 1):
    import torch

    from openzl_tpu_torch.ops import ec_kernel, ntt, ntt_kernel
    from openzl_tpu_torch.proof_systems import BLS12_381, BN254

    BN254_FR, BLS12_381_FQ = BN254.g1.scalar, BLS12_381.g1.base
    BN254_G1, BN254_G2 = BN254.g1, BN254.g2
    dev = torch.device(device)
    rng = random.Random(seed)
    results = {}
    n = 1 << log_n

    # K1: mul and scale over BN254 Fr, mul over BLS12-381 Fq, at 2^17
    for spec in (BN254_FR, BLS12_381_FQ):
        a, b = _rand_field(spec, n, rng, dev), _rand_field(spec, n, rng, dev)
        got = ntt_kernel.mont_mul(spec, a, b)
        exp = ntt_kernel.mont_mul_plain(spec, a, b)
        ms = _time(lambda: ntt_kernel.mont_mul(spec, a, b), 50, dev)
        pms = _time(lambda: ntt_kernel.mont_mul_plain(spec, a, b), 3, dev)
        _check("mont_mul", results, [got], [exp], ms, pms, f"{spec.name} mul (n={n})")
    s = _rand_field(BN254_FR, 4, rng, dev)[:, 3:4].contiguous()
    a = _rand_field(BN254_FR, n, rng, dev)
    got = ntt_kernel.mont_scale(BN254_FR, a, s)
    exp = ntt_kernel.mont_mul_plain(BN254_FR, a, s)
    ms = _time(lambda: ntt_kernel.mont_scale(BN254_FR, a, s), 50, dev)
    pms = _time(lambda: ntt_kernel.mont_mul_plain(BN254_FR, a, s), 3, dev)
    _check("mont_mul", results, [got], [exp], ms, pms, f"bn254_fr scale (n={n})")

    # K2: every (M, lanes, post-twiddle) launch of the 2^log_n NTT plan
    node, _ = ntt._plan(BN254_FR, log_n, False, 1, dev)
    nt, c = n, 1
    while node is not None:
        stage_tw, _, level_tw, inner = node
        M = 2 * stage_tw.shape[2]
        lanes = nt // M * c
        x = _rand_field(BN254_FR, M * lanes, rng, dev).reshape(-1, M, lanes).contiguous()
        got = ntt_kernel.small_ntt(BN254_FR, x, stage_tw, level_tw)
        exp = ntt_kernel.small_ntt_plain(BN254_FR, x, stage_tw, level_tw)
        ms = _time(lambda: ntt_kernel.small_ntt(BN254_FR, x, stage_tw, level_tw), 20, dev)
        pms = _time(lambda: ntt_kernel.small_ntt_plain(BN254_FR, x, stage_tw, level_tw), 2, dev)
        post = "post-twiddle" if level_tw is not None else "no post"
        _check("small_ntt", results, [got], [exp], ms, pms, f"M={M} lanes={lanes} {post}")
        nt, c, node = nt // M, c * M, inner

    # K3 / K4 over BN254 G1 and G2 at 2^log_m points
    m = 1 << log_m
    for curve in (BN254_G1, BN254_G2):
        P, Q, Qa = _ec_inputs(curve, m, rng, dev)
        cases = (
            ("ec_add", "add", lambda: ec_kernel.ec_add(curve, P, Q), lambda: ec_kernel.ec_add_plain(curve, P, Q, False)),
            ("ec_add", "madd", lambda: ec_kernel.ec_add(curve, P, Qa, True), lambda: ec_kernel.ec_add_plain(curve, P, Qa, True)),
            ("ec_dbl", "dbl", lambda: ec_kernel.ec_dbl(curve, P), lambda: ec_kernel.ec_dbl_plain(curve, *P)),
        )
        for kname, op, kern, plain in cases:
            got, exp = kern(), plain()
            ms = _time(kern, 20, dev)
            pms = _time(plain, 2, dev)
            _check(kname, results, list(got), list(exp), ms, pms, f"{curve.name} {op} (n={m})")
    return results


# ---------------------------------------------------------------------------
# 4 and 5: the Groth16 slice
# ---------------------------------------------------------------------------


def phase_roundtrip(chain: int = 2, device="cuda"):
    from openzl_tpu_torch.eclair import circuits
    from openzl_tpu_torch.proof_systems import BN254, Groth16

    gpu, cpu = Groth16(BN254, device), Groth16(BN254, "cpu")
    params = circuits.poseidon_params(gpu.fr)
    witness, digest = circuits.chain_inputs(params, chain, random.Random(21))
    cs = circuits.poseidon_chain(gpu.context_compiler(), params, chain)
    out = {}
    for name, g16 in ((device, gpu), ("cpu", cpu)):
        t0 = time.perf_counter()
        pk = g16.compile(cs, random.Random(22))
        calc = g16.witness_calculator(cs)
        proof = g16.prove_assigned(pk, calc.evaluate_limbs([digest], witness), random.Random(23))
        out[name] = (pk.to_bytes(), proof.to_bytes(g16.pairing), g16.verify(pk.vk, [digest], proof))
        log(f"[roundtrip] {name}: compile + prove {time.perf_counter() - t0:.1f} s, verify {out[name][2]}")
    if out[device][0] != out["cpu"][0]:
        fail(f"ProvingKey bytes differ between {device} and cpu")
    if out[device][1] != out["cpu"][1]:
        fail(f"Proof bytes differ between {device} and cpu")
    if not (out[device][2] and out["cpu"][2]):
        fail("round-trip proof did not verify")
    log(f"[roundtrip] {chain} links, {cs.num_constraints} constraints: "
        f"ProvingKey ({len(out[device][0])} B) and Proof bytes identical on {device} and cpu")


def phase_slice(chain: int, proofs: int, kernels, device="cuda"):
    import torch

    from openzl_tpu_torch.eclair import circuits
    from openzl_tpu_torch.proof_systems import BN254, Groth16
    from openzl_tpu_torch.utils import profile as prof

    g16 = Groth16(BN254, device)
    cuda = g16.device.type == "cuda"
    params = circuits.poseidon_params(g16.fr)
    p = g16.fr.modulus
    rng = random.Random(0xBEEF)
    witness, digest = circuits.chain_inputs(params, chain, rng)
    t0 = time.perf_counter()
    cs = circuits.poseidon_chain(g16.context_compiler(), params, chain)
    log(f"[slice] {chain} links: {cs.num_constraints} constraints, {cs.num_variables} variables, "
        f"circuit build {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pk = g16.compile(cs, rng)
    log(f"[slice] compile {time.perf_counter() - t0:.1f} s, domain 2^{pk.domain_log2}; stages: "
        + ", ".join(f"{k} {v:.0f} ms" for k, v in g16.laps["compile"]))
    calc = g16.witness_calculator(cs)

    def request():
        """One prove request: a fresh witness, then a proof with fresh r, s."""
        return g16.prove_assigned(pk, calc.evaluate_limbs([digest], witness), rng)

    for k in kernels:
        k.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(proofs):
        t0 = time.perf_counter()
        z = calc.evaluate_limbs([digest], witness)
        t_wit = time.perf_counter() - t0
        proof = g16.prove_assigned(pk, z, rng)
        wall = time.perf_counter() - t0
        walls.append(wall)
        ok = g16.verify(pk.vk, [digest], proof)
        log(f"[slice] prove {i + 1}: {wall * 1e3:.1f} ms (witness {t_wit * 1e3:.1f} ms), verify {ok}; "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in g16.laps["prove"]))
        if not ok:
            fail(f"proof {i + 1} did not verify")
    launches = {k.name: k.launches for k in kernels}
    peak = f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB" if cuda else "not measured"
    log(f"[slice] launches during the {proofs} proves: {launches}; peak device memory {peak}")
    before = {k.name: k.launches for k in kernels}
    report = prof.profile(request)
    during = {k.name: k.launches - before[k.name] for k in kernels}
    log(f"[profile] one more warm {chain}-link request; its laps: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in g16.laps["prove"]) + f"; launches {during}")
    for line in report.lines():
        log(f"[profile] {line}")
    if cuda and not report.device_events:
        fail("the profiler recorded no device activity")
    if g16.verify(pk.vk, [(digest + 1) % p], proof):
        fail("fuzzed public input accepted")
    log("[slice] fuzzed public input rejected")
    missing = [n for n, c in launches.items() if c == 0]
    if missing and cuda:
        fail(f"kernels never launched on the main path: {missing}")
    return launches, walls


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--chain", type=int, default=512, help="Poseidon chain links of the slice")
    ap.add_argument("--proofs", type=int, default=3, help="prove requests answered")
    args = ap.parse_args()

    if not (ROOT / "openzl_tpu_torch").is_dir():
        fail("run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    name, smi = phase_device()
    phase_build()

    import torch

    from openzl_tpu_torch.ops import ec_kernel, ntt_kernel

    kernels = [ntt_kernel.K1, ntt_kernel.K2, ec_kernel.K3, ec_kernel.K4]
    results = phase_kernels()
    phase_roundtrip()
    launches, _ = phase_slice(args.chain, args.proofs, kernels)

    rows = []
    for k in kernels:
        runs = results[k.name]
        rows.append({
            "name": k.name, "route": k.route, "source": k.source, "replaces": k.replaces,
            "launches": launches[k.name],
            "max_abs_err": max(r[0] for r in runs),
            "ms": runs[0][1], "plain_ms": runs[0][2],
        })
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
