#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`openzl_tpu_torch`) on one GPU.

Drives the port's five paths through the entry points a user calls, the
Groth16 prover, Poseidon hashing with the Merkle tree, KZG commitments
with dense polynomials, the gadget layer (batched Schnorr verification
and a Groth16 proof of Schnorr verifications), and the multi-device layer
(sharded MSMs, transforms and hashes, and the mesh and staged Groth16
provers), and checks every hand-written kernel on the way.
Phases:

  1. device   the card's name and power limit; fails without CUDA
  2. build    nvcc builds the kernels (K1 with its exponentiation
              `mont_pow`, K2-K9, K3s; K3, K4, K9 and K3s at 16 and 24
              limbs; K5 and K6 at widths 2-17, K7 at 2, 3, 4, 8 and 12)
              and `make -C native` the host library, and, beside them,
              `tools/field_microbench.cu`, whose run gives one product's
              and one square's latency at 16 and 24 limbs (the latency
              bound of K1's exponentiation chain); prints the build
              seconds (and each .cu file's nvcc process) and each
              kernel's registers and spill stores (`-Xptxas -v`)
  3. kernels  each kernel against its plain torch version on the card,
              bit-exact, at the main path's shapes; prints both times
              and the device time: K1's product at 2^17 elements and at
              1 and 4 (the narrow launches the request still makes),
              K1's exponentiation `mont_pow` over BN254 Fq and Fr and
              BLS12-381 Fq at 1, 4 and 2^10 elements, exponents p - 2,
              0, 1 and a random one, each with its bound: the larger of
              its operations bound and its latency bound (squares and
              products times their latency on one warp); K2, one
              four-step level a launch, at every level of the 2^17 plan
              ([6, 6, 5]) at batch 1 and 3, the first level also with the
              forward coset's g^i and the last with the inverse's 1/N and
              1/N g^-i, and the first level over BLS12-377 Fq (24 limbs)
              and BabyBear (2 limbs)
  3b. kernels K3 (add, madd) and K4 at 24 limbs, over BLS12-381 G1 and G2
              at 2^16 points with every mask case, the same way
  4. roundtrip  port on CUDA against port on CPU, same seeds, 2 chain
              links: ProvingKey and Proof bytes must be identical
  5. slice    BN254 Poseidon hash chain (512 links, about 2^17
              constraints): compile once, answer 3 prove requests (fresh
              witness, fresh r and s), verify each, reject a fuzzed input;
              launch counters zeroed before the requests and read after
              (every Groth16 kernel, the fold K9, K3's lifted scan and
              K1's exponentiation included, must launch; K1, mont_pow,
              K3, K4 and scan launches by batch width are printed, and
              the BN254 requests' K1 launches of 1-4 elements must be at
              most 453, a tenth of the 4,534 the exponentiation chains
              made one product a launch); then one more request under
              torch.profiler (device busy share, device time by kernel,
              host launches and syncs; `openzl_tpu_torch.utils.profile`),
              and one more whose lifted scans' inputs are kept (the chunk
              totals of the G1 and the G2 MSM; their lengths are printed)
  5b. scan    K3's lifted scan against its plain version on those two
              inputs (kernel and plain ms, bit-exact) and at the chunk
              edge sizes l = 1, 3, r - 1, r, r + 1, 5 r + 3 over G1 and G2
              with no, all and random flags
  5c. slice   the same slice (512 links, 3 requests, a profiled one, a
              fuzzed input) through `Groth16()` with no arguments:
              BLS12-381 on the card, its circuit's Poseidon parameters
              over BLS12-381 Fr, domain 2^17; K3, K4, K9 and K3s must
              launch at 24 limbs; then 5b over this request's two scans
  6. hash     K5, K6 and K7 against their plain versions at batch 2^16
              (BN254 Fr, width 3, bit-exact), K7 on the worst-case state
              (every element p - 1, the largest input of each linear-layer
              sum K7 leaves unreduced) at widths 2, 3, 4, 8 and 12 over
              BN254 Fr and BLS12-381 Fr, both K5 variants (wide and
              split) at B = 1, 2, 3, 127, 128, 129, 2047, 2048, 16895,
              16896, 16897 and 2^16 and around the wrapper's switch
              (`SPLIT_MAX_B`), and K5 on the BLS12-381 Fr golden vector
              of `tests/vectors/`; then, with the launch
              counters zeroed before and read after, the slice: Poseidon,
              optimized Poseidon and Poseidon2 throughput at batch 2^16
              through `permute`, both hashes, the Merkle h20 bulk builds of
              2^16 and 2^19 leaves (wall ms, peak device memory) and
              `verify_batch` of 2^16 paths (all pass, a flipped leaf fails);
              the 2^16-leaf root must equal a root built on the card through
              the plain hash; then one more warm build under torch.profiler,
              K5 on a single block (the latency of one state) and the device
              time of each level of two more warm builds (CUDA events)
  6b. widths  K5 and K6 at state widths 2, 4, 5, 6, 7 (searched round
              numbers), 9 and 17 over BN254 Fr and 5, 9 and 17 over
              BLS12-381 Fr, K7 at 2, 4, 8 and 12 over both fields, each on
              2^16 states against its plain version (on the first 4096 past
              width 4), bit-exact, with its time and bound (K7's also with
              its linear layers' least additions); state 2 is every element
              p - 1 (K7's worst case); state 3 gives
              K5's last MDS product its largest inputs (every Montgomery
              word p - 1), which a K5 that reduced a row once whole would
              get wrong at BLS12-381 Fr width 17; then, launch counters
              zeroed before and read after, throughput through
              `Poseidon.create(spec, arity)` `permute`,
              `permute_optimized` and `hash` and `Poseidon2.create(spec,
              arity)` `permute` and `hash` at each of those widths; every
              (kernel, width) must launch
  7. kzg      K8 against its plain version: the one-launch transform at
              2^10 and 2^12 BN254 Fr points, forward and inverse, batch 1
              and 4, with its bound, and one stage of 2^12 (batch 1 and
              4); a transform below 2^13 through `ntt._ntt_core` must be
              one K8 launch and no K1 launch; both NTT routes at 2^10 and
              2^12 with their event and device times; the whole
              four-step transforms (`ntt`, `intt`, `coset_ntt`,
              `coset_intt`) at 2^17, batch 1 and 3, and 2^20: one K2
              launch a level and no K1 or K8 launch each, the round trips
              exact, with their event and device times; K9
              against its plain version on the G1 fold of a 2^16-point
              commit, the Fq2 fold of phase 5's B2 MSM and a fold at the
              smallest chunk length r = 1 (bit-exact), with the cost of
              the points' point-major copy; then,
              with the launch counters zeroed before and read after, the
              slice: `KZG(BN254, backend="device")` setup of degree
              2^16 - 1, commit, open, verify (and reject v + 1),
              batch_verify of 4 openings at distinct points (and reject a
              changed v), params to_bytes / from_bytes / device_params /
              commit, a `DensePoly` product of two degree-2047 polynomials
              (the K8 route) and `divide_by_vanishing_poly` on the device
              at n = 2^12, each checked at a random point; wall ms of each
              step and peak device memory; K8 and K9 must launch. Then one
              more commit under torch.profiler, and one commit + open at
              degree 2^20 - 1, timed
  7b. kzg     phase 7 over BLS12-381 at degree 2^12 - 1, the EIP-4844
              blob of 4096 field elements (no 2^20 run): K9 at 24 limbs on
              the G1 commit fold, phase 5c's B2 fold and at r = 1, then
              `KZG(BLS12_381, backend="device")` setup, commit, opens,
              verify, batch_verify, params bytes, a product and a division;
              K9 must launch at 24 limbs
  8. gadgets  the gadget layer (`eclair.TorchCompiler`, the Edwards EC
              gadget, Schnorr): (a) `TorchCompiler` ops (add, sub, neg,
              mul, square, inv, pow5, select, is_eq, is_zero, to_bits_le /
              from_bits_le) at 2^16 elements over BN254 Fr and BLS12-381 Fr
              against `NativeCompiler` on 256 sampled elements (0 and
              p - 1 among them), bit-exact, with each op's wall ms (a
              second call); (b)
              1024 Schnorr verifications on Baby Jubjub in one batch
              (`schnorr_batch_mask`, the gadgets `verify_gadget` calls with
              its two masks ANDed), tiled from 64 signatures made on the
              host, one in eight forged (a wrong message or the scalar +
              1): the mask must equal `EdSchnorr.verify` on every input,
              with the wall ms and verifications/s, and K1 and `mont_pow`
              must launch (counters zeroed before, read after); (c) a
              BN254 Groth16 proof of `--signatures` (16) verification
              circuits in one R1CS (about 105,000 constraints, domain
              2^17): synthesis ms, one compile, two prove requests, each
              verified, a public message + 1 rejected, and every Groth16
              kernel (K1, `mont_pow`, K2, K3, K4, K9, K3s) must launch;
              (d) `Groth16()` with no arguments (BLS12-381) on one Jubjub
              signature: prove, verify, reject a fuzzed message; K3, K4,
              K9 and K3s must launch at 24 limbs. Prints the phase's wall
              time and its record as one JSON line
  9. mesh     `parallel/` on torch.distributed: K1, K2 and K8 against their
              plain versions at the sharded transform's shapes (2^15-point
              levels, its twiddle product, 4-point transforms batched over
              2^13 columns), K5 and K6 at a rank's 2^14 states of the
              sharded hash; then 4 gloo ranks sharing the card (their
              collectives through host memory; `parallel.launch.RankPool`,
              every run under a deadline) run `sharded_msm` over BN254 G1
              and G2 at 2^16 - 3 points (full-width scalars, identities,
              the padding), on a 3-rank sub-mesh (the sequential fold),
              `sharded_msm_multi` of 3 sets, the four sharded transforms
              at 2^17, `sharded_poseidon_hash` of 2^16 width-3 states and
              `Groth16(BN254).prove_assigned(..., mesh=...)` of the
              512-link slice (domain 2^17), each held against the same
              call on one device (MSMs as affine points, transforms and
              digests bit-exact, the proof byte for byte on every rank,
              verified, a fuzzed input rejected), with the wall ms of each
              beside one device's and each rank's launches on the mesh
              prove (every mesh kernel must launch); K9, K3's lifted scan,
              K3 and K4 against their plain versions on the MSM inputs
              the last rank's shard gives them in that prove (each MSM's
              fold and scan, the widest add and doubling a curve); the
              prove on a 1-rank
              NCCL mesh, and on an NCCL mesh of one rank a GPU where the
              machine has two or more; the staged prove
              (`offload_queries`): byte-identical, a second one verified,
              its peak device memory beside the unstaged prove's

After the phases, K6's time and bound share beside K5's at each width
(phases 6 and 6b). Prints a JSON line of per-kernel results (times,
launches on their path, and the bound: the least time the card could take
for the same work; the rows of K3, K4, K9 and K3s also carry their
BLS12-381 launches and runs, with each kernel's registers and spills, the
rows of K5, K6 and K7 their phase 6b runs and launches by state width,
the rows of K1 and `mont_pow` every run with its device time, and every
row each gloo rank's launches on phase 9's mesh prove (K5's and K6's in
its sharded hash) as `mesh_launches`), then,
as the last line, {"ok": true, "device": {...}}. Any failure exits non-zero
with no result. Imports only the port (`openzl_tpu_torch`), never JAX.

Usage: python3 chip_smoke.py [--chain 512] [--proofs 3] [--signatures 16]

`python3 chip_smoke.py --transforms-of DIR` runs only phase 7's whole
four-step transforms of the port in checkout DIR (`transforms_of`): the
parent's and a change's NTT times from one call, run in turns.
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


#: the kernel templates of csrc/ whose registers and spills the kernels line
#: reports, by their names in the -Xptxas -v report
PTXAS_KERNELS = ("ec_add_kernel", "ec_dbl_kernel", "scan_fold_kernel", "scan_step_kernel", "scan_offset_kernel",
                 "fold_kernel")


def _ptxas_key(entry_name: str):
    """(kernel, words, ext) of a mangled entry name of the EC or fold
    kernels (the add kernel's MIXED instantiation named "ec_madd_kernel"),
    or None for the other kernels."""
    import re

    base = next((k for k in PTXAS_KERNELS if re.search(rf"\d{k}I", entry_name)), None)
    words = re.search(r"F1cILi(\d+)E", entry_name)
    if base is None or words is None:
        return None
    if base == "ec_add_kernel":
        base = "ec_madd_kernel" if re.search(r"ELb1E", entry_name) else base
    return base, int(words.group(1)), 2 if "2F2I" in entry_name else 1


def _poseidon_ptxas_key(entry_name: str):
    """(kernel, template arguments) of a mangled entry name of the Poseidon
    kernels, K8's transform and K2's level, e.g. ("slot_kernel", (0, 8)),
    ("poseidon_opt_kernel", (3, 8)), ("poseidon2_kernel", (12, 8)) (K7 on
    F1c; "poseidon2_kernel_f1" on F1), ("ntt_transform_kernel", (8,)) or
    ("fourstep_level_kernel", (8,)) (words; on F1c), or None for the other
    kernels."""
    import re

    m = re.search(r"\d(slot_kernel|poseidon_wide_kernel|poseidon_split_kernel|poseidon_opt_kernel)"
                  r"I((?:Li\d+E)+)E",
                  entry_name)
    if m is not None:
        return m.group(1), tuple(int(v) for v in re.findall(r"Li(\d+)E", m.group(2)))
    m = re.search(r"\d(poseidon2_kernel|ntt_transform_kernel|fourstep_level_kernel)I(3F1c|2F1)ILi\d+EE((?:Li\d+E)+)E",
                  entry_name)
    if m is None:
        return None
    return (m.group(1) + ("_f1" if m.group(2) == "2F1" else ""),
            tuple(int(v) for v in re.findall(r"Li(\d+)E", m.group(3))))


def phase_build():
    """Builds the kernels and the field microbenchmark; returns ({(kernel,
    words, ext): (registers, spill store bytes)} of the EC and fold kernels
    (`_ptxas_key`), and the same for the Poseidon kernels by (kernel,
    template arguments) (`_poseidon_ptxas_key`); {(n_limbs, field, op):
    ns} of one product's and one square's latency on one warp
    (`kernel_probe.product_latency`))."""
    import re

    from openzl_tpu_torch.tools import kernel_probe
    from openzl_tpu_torch.utils import build

    t0 = time.perf_counter()
    micro, micro_proc = kernel_probe.start_microbench()
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
    # per entry function: "Compiling entry function '<name>'", then its
    # "N bytes spill stores" and "Used R registers" lines
    entries = re.split(r"Compiling entry function '", ptxas)[1:]
    log(f"[build] nvcc {t_nvcc:.1f} s, make -C native {t_native:.1f} s; {len(entries)} kernels; "
        f"ptxas report {path.with_suffix('.log').relative_to(ROOT)}")
    for line in ptxas.splitlines():
        if line.startswith("nvcc "):  # one nvcc process per .cu file, all started together
            log(f"[build]   {line}")
    table = {}
    for entry in entries:
        name = entry.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores", entry)
        log(f"[build]   {name}: {regs.group(1) if regs else '?'} registers, "
            f"{spill.group(1) if spill else '?'} bytes spill stores")
        key = _ptxas_key(name) or _poseidon_ptxas_key(name)
        if key is not None and regs and spill:
            table[key] = (int(regs.group(1)), int(spill.group(1)))
    text, _ = micro_proc.communicate()
    if micro_proc.returncode:
        fail(f"nvcc failed for tools/field_microbench.cu:\n{text[-3000:]}")
    latency = kernel_probe.product_latency(micro)
    log("[build] field_microbench, one warp's latency: "
        + ", ".join(f"{n} limbs {field} {op} {ns:.2f} ns" for (n, field, op), ns in sorted(latency.items())))
    return table, latency


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


def _mont_words(n_limbs: int, products: int, squares: int = 0) -> float:
    """32x32->64-bit word products of `products` Montgomery products and
    `squares` Montgomery squares over NW = n_limbs / 2 words (CIOS): a b
    takes NW^2, a a NW (NW + 1) / 2 (each cross term once, doubled by a
    shift), the reduction m p NW^2, and each of its NW factors m = t0 n'
    mod 2^32 is a low half only (one multiply issue): half a word product."""
    nw = n_limbs // 2
    reduce = nw * nw + nw / 2
    return products * (nw * nw + reduce) + squares * (nw * (nw + 1) / 2 + reduce)


#: the kernels over curve points, instantiated for 16-limb (BN254) and
#: 24-limb (BLS12-381) base fields
EC_KERNELS = ("ec_add", "ec_dbl", "fold_madd", "ec_lifted_scan")

#: (base-field Montgomery products, squares) of one point operation
#: (csrc/ec.cuh, a = 0): G1 add 11 + 5, madd 7 + 4, dbl 2 + 5; over Fq2 a
#: product is 3 base products and a square 2 (no base square)
EC_PRODUCTS = {("add", 1): (11, 5), ("madd", 1): (7, 4), ("dbl", 1): (2, 5),
               ("add", 2): (43, 0), ("madd", 2): (29, 0), ("dbl", 2): (16, 0)}


def _device_ms(fn, reps: int):
    """Device time per call of fn on the card (`utils.profile.device_ms`:
    torch.profiler, its kernels' durations summed over reps calls, over
    reps, profiled again while a kernel record is lost), without the
    host's cost of a launch; None off the card or when no profile kept
    every record."""
    from openzl_tpu_torch.utils import profile as prof

    return prof.device_ms(fn, reps)


def _check(name, results, got, exp, ms, plain_ms, shape, work, kern=None, ptx=None):
    """Record one kernel comparison; `work` = (word products, bytes) the
    call needs, each input read once and each output written once. With
    `kern`, also print the device time of one call of it; `ptx` is the
    kernel's key in phase 2's ptxas table."""
    err = _max_err(got, exp)
    dms = _device_ms(kern, 10) if kern is not None else None
    device = "" if kern is None else f" (device {dms:.4f} ms)" if dms is not None else " (device not measured)"
    log(f"[kernels] {name} {shape}: max_abs_err {err}, kernel {ms:.4f} ms{device}, plain {plain_ms:.4f} ms")
    if err:
        fail(f"{name} disagrees with its plain version")
    results.setdefault(name, []).append((err, ms, plain_ms, work, shape, dms, ptx))


def _merge(results, more):
    """Append the runs of `more` to `results`, kernel by kernel."""
    for name, runs in more.items():
        results.setdefault(name, []).extend(runs)
    return results


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


def _pow_work(spec, exponent: int, n: int, latency):
    """(word products, bytes, latency bound ms or None) of K1's
    exponentiation of n elements: bit length - 1 squares and one product
    per set bit (the top bit's one x a included), each element read and
    written once; the latency bound is one thread's chain of those squares
    and products, each at the lesser of one square's and one product's
    latency on one warp of the field the kernel runs (F1c below its
    bound). The chain's bound is the largest of the three (`bound` in
    main)."""
    squares, products = max(exponent.bit_length() - 1, 0), bin(exponent).count("1")
    top = spec.modulus >> (16 * spec.n_limbs - 32)
    field = "F1c" if spec.n_limbs > 2 and top < 0x7FFFFFFF else "F1"
    lat = None
    if latency is not None:
        lat = (squares + products) * min(latency[spec.n_limbs, field, op] for op in ("sqr", "mul")) / 1e6
    return (n * _mont_words(spec.n_limbs, products, squares), 2 * n * spec.n_limbs * 4, lat)


#: fields of other limb counts whose four-step levels phase 3 checks
#: (the generators of `ops/ntt.py` GENERATORS)
BABYBEAR_P = 2013265921
BLS12_377_FQ_P = 0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001


def _level_work(spec, log_n: int, batch: int, lm: int, nt: int, pre, post):
    """(word products, bytes) of one K2 level: per column and lane the DIF's
    M/2 log2 M products less the M - 1 butterflies whose twiddle is 1, the
    (M - 1)(S - 1) level twiddles that are not 1 a lane, and one product an
    element for each scale; the data read once and written once, and each
    distinct table entry read once (the M/2 stage twiddles, the level
    twiddles' distinct exponents, the scale tables)."""
    import numpy as np

    N = 1 << log_n
    M, S, c = 1 << lm, nt >> lm, N * batch // nt
    products = S * c * (M // 2 * lm - (M - 1)) + c * (M - 1) * (S - 1)
    products += N * batch * ((pre is not None) + (post is not None))
    k1, j2 = np.arange(M), np.arange(S)
    exps = np.unique((k1[:, None] * j2[None, :]).ravel())
    entries = M // 2 + np.count_nonzero(exps) + (N if pre is not None else 0)
    entries += 0 if post is None else post.shape[0]
    words = spec.n_limbs // 2
    return _mont_words(spec.n_limbs, products), 2 * N * batch * spec.n_limbs * 4 + entries * words * 4


def _level_checks(spec, log_n, batch, rng, dev, results, scales, first_only=False):
    """K2 against its plain version at each level of the 2^log_n plan
    (`ntt._fourstep_plan`) at `batch`, with its bound; with `scales`, the
    first level also with the coset's g^i and the last with 1/N (one
    element) and with 1/N g^-i (a table)."""
    from openzl_tpu_torch.ops import ntt, ntt_kernel

    x = _rand_field(spec, batch << log_n, rng, dev).reshape(spec.n_limbs, 1 << log_n, batch).contiguous()
    levels = tuple(ntt._levels(log_n))
    shape, roots, _ = ntt._fourstep_plan(spec, log_n, False, levels, dev)
    n_inv = ntt._fourstep_plan(spec, log_n, True, levels, dev)[2]
    runs = []
    for k, (lm, nt) in enumerate(shape[:1] if first_only else shape):
        runs.append((lm, nt, None, None, ""))
        if scales and k == 0:
            runs.append((lm, nt, ntt._coset_scales(spec, 1 << log_n, False, dev, words=True), None, ", coset g^i load"))
        if scales and k == len(shape) - 1:
            runs.append((lm, nt, None, n_inv, ", 1/N store"))
            runs.append((lm, nt, None, ntt._coset_scales(spec, 1 << log_n, True, dev, words=True), ", 1/N g^-i store"))
    carry = spec.n_limbs > 2 and spec.modulus >> (16 * spec.n_limbs - 32) < 0x7FFFFFFF
    key = ("fourstep_level_kernel" + ("" if carry else "_f1"), (spec.n_limbs // 2,))
    for lm, nt, pre, post, label in runs:
        def kern(lm=lm, nt=nt, pre=pre, post=post):
            return ntt_kernel.fourstep_level(spec, x, roots, lm, nt, pre, post)

        got = kern()
        exp = ntt_kernel.level_plain(spec, x, roots, lm, nt, pre, post)
        ms = _time(kern, 20, dev)
        pms = _time(lambda: ntt_kernel.level_plain(spec, x, roots, lm, nt, pre, post), 2, dev)
        S, c = nt >> lm, (batch << log_n) // nt
        _check("small_ntt", results, [got], [exp], ms, pms,
               f"{spec.name} 2^{log_n} batch {batch} level M=2^{lm} S={S} c={c}{label}",
               _level_work(spec, log_n, batch, lm, nt, pre, post), kern, key)


def phase_kernels(device="cuda", log_n: int = 17, log_m: int = 16, seed: int = 1, latency=None,
                  pow_sizes=(1, 4, 1 << 10), pow_reps: int = 20):
    """Phase 3; `latency` is phase 2's {(n_limbs, field, op): ns} (None:
    no latency bound); K1's exponentiation runs at `pow_sizes` elements."""
    import torch

    from openzl_tpu_torch.ops import ec_kernel, ntt, ntt_kernel
    from openzl_tpu_torch.proof_systems import BLS12_381, BN254

    from openzl_tpu_torch.fields.spec import FieldSpec

    BN254_FR, BN254_FQ, BLS12_381_FQ = BN254.g1.scalar, BN254.g1.base, BLS12_381.g1.base
    BABYBEAR, BLS12_377_FQ = FieldSpec("babybear", BABYBEAR_P), FieldSpec("bls12_377_fq", BLS12_377_FQ_P)
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
        _check("mont_mul", results, [got], [exp], ms, pms, f"{spec.name} mul (n={n})",
               (_mont_words(spec.n_limbs, n), 3 * n * spec.n_limbs * 4), lambda: ntt_kernel.mont_mul(spec, a, b))
    s = _rand_field(BN254_FR, 4, rng, dev)[:, 3:4].contiguous()
    a = _rand_field(BN254_FR, n, rng, dev)
    got = ntt_kernel.mont_scale(BN254_FR, a, s)
    exp = ntt_kernel.mont_mul_plain(BN254_FR, a, s)
    ms = _time(lambda: ntt_kernel.mont_scale(BN254_FR, a, s), 50, dev)
    pms = _time(lambda: ntt_kernel.mont_mul_plain(BN254_FR, a, s), 3, dev)
    _check("mont_mul", results, [got], [exp], ms, pms, f"bn254_fr scale (n={n})",
           (_mont_words(16, n), 2 * n * 16 * 4 + 16 * 4), lambda: ntt_kernel.mont_scale(BN254_FR, a, s))
    # K1 at 1 and 4 elements of BN254 Fq: the narrow products the request
    # still launches (a launch's own cost)
    for m in (1, 4):
        a = _rand_field(BN254_FQ, 4, rng, dev)[:, 4 - m:].contiguous()
        b = _rand_field(BN254_FQ, 4, rng, dev)[:, 4 - m:].contiguous()
        got, exp = ntt_kernel.mont_mul(BN254_FQ, a, b), ntt_kernel.mont_mul_plain(BN254_FQ, a, b)
        ms = _time(lambda: ntt_kernel.mont_mul(BN254_FQ, a, b), 50, dev)
        pms = _time(lambda: ntt_kernel.mont_mul_plain(BN254_FQ, a, b), 3, dev)
        _check("mont_mul", results, [got], [exp], ms, pms, f"bn254_fq mul (n={m})",
               (_mont_words(16, m), 3 * m * 16 * 4), lambda: ntt_kernel.mont_mul(BN254_FQ, a, b))

    # K1's exponentiation against its plain chain: the Fermat inverse (p -
    # 2), 0, 1 and a random 256-bit exponent, at 1, 4 and 2^10 elements
    # (0, 1 and p - 1 among the wider ones); BN254 Fq p - 2 at 1 element
    # first, the request's case
    for spec in (BN254_FQ, BN254_FR, BLS12_381_FQ):
        p = spec.modulus
        for label, e in (("p - 2", p - 2), ("0", 0), ("1", 1), ("random", rng.getrandbits(256))):
            for m in pow_sizes:
                a = _rand_field(spec, max(m, 4), rng, dev)[:, 3 if m == 1 else 0:][:, :m].contiguous()
                got = ntt_kernel.mont_pow(spec, a, e)
                exp, pms = _wall(lambda: ntt_kernel.mont_pow_plain(spec, a, e), dev)  # one plain run
                ms = _time(lambda: ntt_kernel.mont_pow(spec, a, e), pow_reps, dev)
                _check("mont_pow", results, [got], [exp], ms, pms,
                       f"{spec.name} e = {label} ({e.bit_length()} bits, n={m})", _pow_work(spec, e, m, latency),
                       lambda: ntt_kernel.mont_pow(spec, a, e))

    # K2: every level of the 2^log_n four-step plan at batch 1 and 3, the
    # first level also with the forward coset's load scales and the last
    # with the inverse's store scales (1/N, 1/N g^-i); then a level of a
    # 24-limb (BLS12-377 Fq) and a 2-limb (BabyBear) field
    for batch in (1, 3):
        _level_checks(BN254_FR, log_n, batch, rng, dev, results, scales=True)
    for spec in (BLS12_377_FQ, BABYBEAR):
        _level_checks(spec, log_n, 1, rng, dev, results, scales=False, first_only=True)

    # K3 / K4 over BN254 G1 and G2 at 2^log_m points
    for curve in (BN254_G1, BN254_G2):
        _ec_checks(curve, 1 << log_m, rng, dev, results)
    return results


def _ec_checks(curve, m, rng, dev, results):
    """K3 (add, madd) and K4 against their plain versions at m points of
    `curve`, with every mask case (`_ec_inputs`)."""
    from openzl_tpu_torch.ops import ec_kernel

    P, Q, Qa = _ec_inputs(curve, m, rng, dev)
    cases = (
        ("ec_add", "add", lambda: ec_kernel.ec_add(curve, P, Q), lambda: ec_kernel.ec_add_plain(curve, P, Q, False)),
        ("ec_add", "madd", lambda: ec_kernel.ec_add(curve, P, Qa, True), lambda: ec_kernel.ec_add_plain(curve, P, Qa, True)),
        ("ec_dbl", "dbl", lambda: ec_kernel.ec_dbl(curve, P), lambda: ec_kernel.ec_dbl_plain(curve, *P)),
    )
    for kname, op, kern, plain in cases:
        # rows 0-255 have P = Q: the add kernels also run the doubling there
        _ec_case(results, curve, kname, op, kern, plain, m, m, min(256, m), f"{curve.name} {op} (n={m})", dev)


def _ec_case(results, curve, kname, op, kern, plain, m, live, doubled, label, dev, reps=20):
    """One K3 (op "add" or "madd") or K4 ("dbl") check at m points, of
    which `live` rows take the group law and `doubled` of those are P = Q
    (the add kernels run the doubling there)."""
    got, exp = kern(), plain()
    ms = _time(kern, reps, dev)
    pms = _time(plain, 2, dev)
    n_limbs, ext = curve.base.n_limbs, curve.ext
    prod, sqr = EC_PRODUCTS[op, ext]
    dprod, dsqr = EC_PRODUCTS["dbl", ext] if op != "dbl" else (0, 0)
    words = _mont_words(n_limbs, live * prod + doubled * dprod, live * sqr + doubled * dsqr)
    coords = (6 + 3) if op != "dbl" else (3 + 3)
    _check(kname, results, list(got), list(exp), ms, pms, label,
           (words, coords * ext * n_limbs * m * 4), kern, (f"ec_{op}_kernel", n_limbs // 2, ext))


def phase_kernels_bls(device="cuda", log_m: int = 16, seed: int = 2):
    """Phase 3b: K3 (add, madd) and K4 at 24 limbs, over BLS12-381 G1 and
    G2 at 2^log_m points, against their plain versions."""
    import torch

    from openzl_tpu_torch.proof_systems import BLS12_381

    dev = torch.device(device)
    rng = random.Random(seed)
    results = {}
    for curve in (BLS12_381.g1, BLS12_381.g2):
        _ec_checks(curve, 1 << log_m, rng, dev, results)
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


def _record_scans(fn):
    """Run fn with K3's lifted scan recording its inputs; returns [(curve,
    totals, tflag)] of each call, in call order."""
    from openzl_tpu_torch.ops import ec_kernel

    real, seen = ec_kernel.lifted_scan, []

    def recording(curve, totals, tflag):
        seen.append((curve, tuple(t.clone() for t in totals), tflag.clone()))
        return real(curve, totals, tflag)

    ec_kernel.lifted_scan = recording
    try:
        fn()
    finally:
        ec_kernel.lifted_scan = real
    return seen


#: K1 launches of 1-4 elements a prove request may make: a tenth of the
#: 4,534 of three BN254 requests when each Fermat inverse was a chain of
#: one-product launches (PERF.md)
NARROW_K1_PER_REQUEST = 4534 / 3 / 10


def phase_slice(chain: int, proofs: int, all_kernels, kernels, device="cuda", default: bool = False):
    """Phase 5 over BN254, or with `default` phase 5c: the same slice
    through `Groth16()` with no arguments (BLS12-381 on the card; on the
    CPU, `Groth16(device="cpu")`), whose K3, K4, K9 and scan launches must
    all be at 24 limbs. Returns (launches during the proves, their walls,
    the B2 MSM's fold inputs, the request's lifted scans' inputs)."""
    import torch

    from openzl_tpu_torch.eclair import circuits
    from openzl_tpu_torch.proof_systems import BLS12_381, BN254, Groth16
    from openzl_tpu_torch.utils import profile as prof

    if default:
        g16 = Groth16() if device == "cuda" else Groth16(device=device)
        if g16.pairing is not BLS12_381:
            fail(f"Groth16() picks {g16.pairing.name}, not bls12_381")
    else:
        g16 = Groth16(BN254, device)
    tag = "slice" if not default else f"slice {g16.pairing.name}"
    cuda = g16.device.type == "cuda"
    params = circuits.poseidon_params(g16.fr)
    p = g16.fr.modulus
    rng = random.Random(0xBEEF)
    witness, digest = circuits.chain_inputs(params, chain, rng)
    t0 = time.perf_counter()
    cs = circuits.poseidon_chain(g16.context_compiler(), params, chain)
    log(f"[{tag}] {chain} links: {cs.num_constraints} constraints, {cs.num_variables} variables, "
        f"circuit build {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pk = g16.compile(cs, rng)
    log(f"[{tag}] compile {time.perf_counter() - t0:.1f} s, domain 2^{pk.domain_log2}; stages: "
        + ", ".join(f"{k} {v:.0f} ms" for k, v in g16.laps["compile"]))
    calc = g16.witness_calculator(cs)

    def request():
        """One prove request: a fresh witness, then a proof with fresh r, s."""
        return g16.prove_assigned(pk, calc.evaluate_limbs([digest], witness), rng)

    for k in all_kernels:
        k.reset()
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
        log(f"[{tag}] prove {i + 1}: {wall * 1e3:.1f} ms (witness {t_wit * 1e3:.1f} ms), verify {ok}; "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in g16.laps["prove"]))
        if not ok:
            fail(f"proof {i + 1} did not verify")
    launches = {k.name: k.launches for k in kernels}
    # every group-law launch of the BLS12-381 path is over its 24-limb Fq
    at24 = {k.name: k.by_limbs.get(24, 0) for k in kernels if k.name in EC_KERNELS}
    peak = f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB" if cuda else "not measured"
    log(f"[{tag}] launches during the {proofs} proves: {launches}; peak device memory {peak}")
    for k in kernels:
        if k.name in ("mont_mul", "mont_pow", "ec_add", "ec_dbl", "ec_lifted_scan"):
            log(f"[{tag}] {k.name} launches by batch (rounded up to a power of two): "
                + ", ".join(f"{w}: {n}" for w, n in sorted(k.by_width.items())))
    # K1's narrow launches: before K1's exponentiation, each Fermat inverse
    # was a chain of some 380 (BN254) to 570 one-product launches
    k1 = next(k for k in kernels if k.name == "mont_mul")
    narrow = sum(n for w, n in k1.by_width.items() if 0 < w <= 4)
    limit = NARROW_K1_PER_REQUEST * proofs
    log(f"[{tag}] mont_mul launches of 1-4 elements during the {proofs} proves: {narrow} (at most {limit:.0f}); "
        f"mont_pow launches: {launches.get('mont_pow', 0)}")
    if cuda and narrow > limit:
        fail(f"{narrow} mont_mul launches of 1-4 elements in {proofs} requests, more than {limit:.0f}")
    before = {k.name: k.launches for k in kernels}
    report = prof.profile(request)
    during = {k.name: k.launches - before[k.name] for k in kernels}
    log(f"[profile] one more warm {chain}-link {g16.pairing.name} request; its laps: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in g16.laps["prove"]) + f"; launches {during}")
    for line in report.lines():
        log(f"[profile] {line}")
    if cuda and not report.device_events:
        fail("the profiler recorded no device activity")
    if g16.verify(pk.vk, [(digest + 1) % p], proof):
        fail("fuzzed public input accepted")
    log(f"[{tag}] fuzzed public input rejected")
    missing = [n for n, c in launches.items() if c == 0]
    if missing and cuda:
        fail(f"kernels never launched on the main path: {missing}")
    if default:
        log(f"[{tag}] launches at 24 limbs during the {proofs} proves: {at24}")
        if cuda and not all(at24.values()):
            fail(f"kernels never launched at 24 limbs on the BLS12-381 path: {[n for n, c in at24.items() if not c]}")
    # the B2 MSM's fold inputs of one more request, for K9's check in phase 7
    from openzl_tpu_torch.fields import limb
    from openzl_tpu_torch.ops import msm

    z_can = limb.tensor(calc.evaluate_limbs([digest], witness), g16.device)
    b2_fold = msm.fold_inputs(g16.pairing.g2, [(z_can, pk.b_g2_query)])
    scans = _record_scans(request)
    log(f"[{tag}] the lifted scans of one more request: " + ", ".join(
        f"{curve.name} l = {tflag.shape[0]} ({int(tflag.sum())} flagged)" for curve, _, tflag in scans))
    return launches, walls, b2_fold, scans


def _scan_adds(tflag, r: int) -> int:
    """The full adds the lifted scan's function needs on these flags, as a
    scan in chunks of r at every level does them: phase 1 adds an unflagged
    element to its chunk's running sum (past the chunk's first element,
    whose running sum is the identity), phase 3 adds its chunk's offset to
    an element past the chunk's first whose prefix within the chunk is
    unflagged, and the chunk totals' flags are the next level's. The
    shipped scan's Hillis-Steele steps on its narrow levels do more; the
    bound takes this least count."""
    import torch

    adds, f = 0, tflag
    while True:
        n = f.shape[0]
        m = -(-n // r)
        grid = torch.cat([f, f.new_zeros(m * r - n)]).reshape(m, r)
        valid = (torch.arange(m * r, device=f.device) < n).reshape(m, r)
        valid[:, 0] = False
        adds += int((valid & ~grid).sum())
        if m == 1:
            return adds
        pre = torch.cat([grid.new_zeros((m, 1)), grid[:, :-1].to(torch.int8).cummax(dim=1).values.bool()], dim=1)
        adds += int((valid & ~pre).sum())
        f = grid.any(dim=1)


def _scan_check(label, results, curve, totals, tflag, dev, reps):
    """K3's lifted scan against its plain version on one MSM's chunk
    totals; returns the kernel's output."""
    from openzl_tpu_torch.ops import ec_kernel

    got = ec_kernel.lifted_scan(curve, totals, tflag)
    exp = ec_kernel.lifted_scan_plain(curve, totals, tflag)
    ms = _time(lambda: ec_kernel.lifted_scan(curve, totals, tflag), reps, dev)
    pms = _time(lambda: ec_kernel.lifted_scan_plain(curve, totals, tflag), 1, dev)
    R = ec_kernel.SCAN_R
    l, adds = tflag.shape[0], _scan_adds(tflag, R)
    prod, sqr = EC_PRODUCTS["add", curve.ext]
    coord = curve.ext * curve.base.n_limbs * 4
    _check("ec_lifted_scan", results, list(got), list(exp), ms, pms, f"{label} (l={l}, r={R}, {adds} adds)",
           (_mont_words(curve.base.n_limbs, adds * prod, adds * sqr), l * (6 * coord + 1)),
           lambda: ec_kernel.lifted_scan(curve, totals, tflag),
           [(k, curve.base.n_limbs // 2, curve.ext) for k in PTXAS_KERNELS[2:5]])
    return got


def phase_scan(scans, device="cuda", reps: int = 20, seed: int = 5):
    """Phase 5b: K3's lifted scan against its plain version on the request's
    inputs and at the chunk edge sizes. Returns the kernel results."""
    import torch

    from openzl_tpu_torch.curves import jacobian as jac
    from openzl_tpu_torch.ops import ec_kernel
    from openzl_tpu_torch.tools.kernel_probe import hillis_steele_scan

    dev = torch.device(device)
    results = {}
    R = ec_kernel.SCAN_R
    # the G2 (B2) scan first: its row leads the kernels line
    for curve, totals, tflag in sorted(scans, key=lambda s: -s[0].ext):
        got = _scan_check(f"{curve.name} chunk totals of the request", results, curve, totals, tflag, dev, reps)
        # the Hillis-Steele scan through K3 that it replaced: the same group
        # elements, associated otherwise
        old = hillis_steele_scan(curve, totals, tflag)
        if not all(torch.equal(a, b) for a, b in zip(jac.normalize(curve, jac.JPoint(*old)),
                                                       jac.normalize(curve, jac.JPoint(*got)))):
            fail(f"K3's lifted scan and the Hillis-Steele scan disagree on {curve.name}")
        old_ms = _time(lambda: hillis_steele_scan(curve, totals, tflag), 2, dev)
        old_dms = _device_ms(lambda: hillis_steele_scan(curve, totals, tflag), 2)
        log(f"[scan] {curve.name} l={tflag.shape[0]}: the Hillis-Steele scan through K3 it replaced takes "
            f"{old_ms:.4f} ms" + (f" (device {old_dms:.4f} ms)" if old_dms is not None else "")
            + "; the same group elements")
    rng = random.Random(seed)
    sizes = sorted({1, 3, R - 1, R, R + 1, 5 * R + 3})
    shipped = ec_kernel.SCAN_NARROW
    for curve, totals, _ in scans:
        pool = jac.JPoint(*(v[..., :64] for v in totals))
        for l in sizes:
            for mode in ("none", "all", "random"):
                P = jac.take(pool, torch.tensor([rng.randrange(pool.z.shape[-1]) for _ in range(l)], device=dev))
                flags = torch.tensor([mode == "all" or (mode == "random" and rng.random() < 0.3)
                                      for _ in range(l)], device=dev)
                # in chunks (no narrow level) and in Hillis-Steele steps
                for narrow in (0, shipped):
                    ec_kernel.SCAN_NARROW = narrow
                    try:
                        got = ec_kernel.lifted_scan(curve, tuple(P), flags)
                        exp = ec_kernel.lifted_scan_plain(curve, tuple(P), flags)
                    finally:
                        ec_kernel.SCAN_NARROW = shipped
                    if _max_err(got, exp):
                        fail(f"K3's lifted scan disagrees with its plain version: {curve.name}, l={l}, "
                             f"{mode} flags, narrow={narrow}")
    log(f"[scan] K3's lifted scan equals its plain version at l = {', '.join(map(str, sizes))} "
        f"(r = {R}) with no, all and random flags, in chunks and in Hillis-Steele steps, over "
        f"{', '.join(c.name for c, _, _ in scans)}")
    return results


# ---------------------------------------------------------------------------
# 6. hash: Poseidon / Poseidon2 and the Merkle tree
# ---------------------------------------------------------------------------


def _rand_states(spec, batch, rng, device):
    """(n_limbs, 3, batch) Montgomery states: rows 0, 1 and p - 1 in every
    element, then uniform values from `rng`."""
    import numpy as np

    from openzl_tpu_torch.fields import limb

    p = spec.modulus
    vals = np.array([[0, 1, p - 1] + [rng.randrange(p) for _ in range(batch - 3)] for _ in range(3)],
                    dtype=object)
    return limb.tensor(limb.pack_mont(spec, vals), device)


def _plain_merkle_root(params, level):
    """The Merkle root of the leaves `level` through the plain torch hash on
    their device: the tree's level recursion with K5's plain version."""
    import torch

    from openzl_tpu_torch.fields import limb
    from openzl_tpu_torch.ops import poseidon_kernel

    perm = params.poseidon
    tag = limb.tensor(perm.domain_tag_mont(), level.device).reshape(-1, 1)
    for _ in range(params.height - 1):
        if level.shape[1] % 2:
            level = torch.cat([level, torch.zeros_like(level[:, :1])], dim=1)
        lhs, rhs = level[:, 0::2], level[:, 1::2]
        state = torch.stack([tag.expand_as(lhs), lhs, rhs], dim=1).contiguous()
        level = poseidon_kernel.permute_plain(perm, state)[:, 0]
    return level[:, 0]


def _level_ms(params, leaves, device):
    """[(states, ms)] of each level's hash in one bulk build, as
    `MerkleTree.from_leaf_digests` runs it: CUDA events recorded between the
    levels' hashes and read after one sync at the end (so a level's time
    also holds any wait for the host's next launch); the host clock on the
    CPU."""
    import torch

    from openzl_tpu_torch.crypto.merkle.tree import hash_level

    cuda = device.type == "cuda"

    def mark():
        if not cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    if cuda:
        torch.cuda.synchronize()
    current, states, marks = leaves, [], [mark()]
    for _ in range(params.height - 1):
        states.append((current.shape[1] + 1) // 2)
        current = hash_level(params, current)
        marks.append(mark())
    if cuda:
        torch.cuda.synchronize()
    ms = [a.elapsed_time(b) if cuda else (b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return list(zip(states, ms))


def _wall(fn, device):
    """(result, wall ms) of fn, ended by a device sync."""
    import torch

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _peak(device) -> str:
    import torch

    return f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB" if device.type == "cuda" else "not measured"


def _mac_group(spec) -> int:
    """The most products one Montgomery reduction takes summed unreduced,
    K p < 2 R, from p's top 32-bit word (csrc/poseidon.cuh `mac_group`)."""
    return (2**33 - 1) // ((spec.modulus >> (16 * spec.n_limbs - 32)) + 1)


def _p2_addition_issues(perm) -> int:
    """Word issues per state of Poseidon2's linear layers, the least they
    need: one NW-word addition (NW issues) per term of each layer's
    cheapest chain, and one reduction per output counted as one more
    NW-word subtraction. External layer: at width 2 or 3 the sum (W - 1
    additions) and x_i + sum (W); at width 4k M4's chain on each block (8
    additions and 4 doublings), the block sums (4 (k - 1)) and x + sum
    (W); internal layer: the sum (W - 1) and sum + diag_i x_i (W, the
    small product taken as one term). R_F + 1 external layers, R_P
    internal."""
    w, nw = perm.width, perm.spec.n_limbs // 2
    ext = 2 * w - 1 if w in (2, 3) else 12 * (w // 4) + 4 * (w // 4 - 1) + w
    internal = 2 * w - 1
    layers = (perm.full_rounds + 1) * (ext + w) + perm.partial_rounds * (internal + w)
    return layers * nw


def _perm_words(name, perm, additions: bool = False) -> float:
    """32x32-bit word products per state of kernel `name` on `perm`, the
    least its function needs: an S-box x^5 is 2 Montgomery squares and a
    product (`_mont_words`); a matrix row of n products is n
    multiply-accumulates of NW^2 word products and one reduction (NW^2 +
    NW/2) for each group of up to `_mac_group` of them. K5: a dense row of
    W for each element of each round; K6: dense rows in the full rounds,
    and in each partial round a row of W (w_hat) and W - 1 rows of one
    (v_rest); Poseidon2's matrices take additions only. With `additions`,
    K7 also counts its linear layers' least word additions
    (`_p2_addition_issues`), each one issue, that is half a word product
    (two multiply issues) of the bound's rate."""
    w, rf, rp = perm.width, perm.full_rounds, perm.partial_rounds
    nw, group = perm.spec.n_limbs // 2, _mac_group(perm.spec)

    def rows(n, products):
        return n * (products * nw * nw + -(-products // group) * (nw * nw + nw / 2))

    sboxes = rf * w + rp
    matrices = {"poseidon_permute": rows((rf + rp) * w, w),
                "poseidon_permute_opt": rows(rf * w, w) + rp * (rows(1, w) + rows(w - 1, 1)),
                "poseidon2_permute": 0}[name]
    extra = _p2_addition_issues(perm) / 2 if additions and name == "poseidon2_permute" else 0
    return _mont_words(perm.spec.n_limbs, sboxes, 2 * sboxes) + matrices + extra


#: {(field, width): {kernel: (ms, work)}} of phases 6 and 6b: K6 beside K5
PERM_RUNS = {}
#: {(field, width): (ms, device ms, work with the linear layers' additions)}
#: of K7 in phases 6 and 6b
K7_LINEAR = {}
#: phase 2's ptxas keys of the width-3 Poseidon kernels
WIDTH3_PTXAS = {"poseidon_permute": ("poseidon_wide_kernel", (3, 8)),
                "poseidon_permute_opt": ("poseidon_opt_kernel", (3, 8)),
                "poseidon2_permute": ("poseidon2_kernel", (3, 8))}


def phase_hash(all_kernels, device="cuda", log_b: int = 16, height: int = 20, log_full: int = 19,
               reps: int = 20, seed: int = 3):
    """Phase 6. Returns (kernel results, launches of the slice's kernels)."""
    import numpy as np
    import torch

    from openzl_tpu_torch.crypto.merkle import path as mpath
    from openzl_tpu_torch.crypto.merkle.tree import MerkleParameters, MerkleTree
    from openzl_tpu_torch.crypto.poseidon.permutation import Poseidon
    from openzl_tpu_torch.crypto.poseidon2 import Poseidon2
    from openzl_tpu_torch.fields import limb
    from openzl_tpu_torch.fields.spec import BLS12_381_FR, BN254_FR
    from openzl_tpu_torch.ops import poseidon2_kernel, poseidon_kernel
    from openzl_tpu_torch.utils import profile as prof

    dev = torch.device(device)
    rng = random.Random(seed)
    results = {}
    B = 1 << log_b
    perm, perm2 = Poseidon.create(BN254_FR, 2, device=dev), Poseidon2.create(BN254_FR, 2, device=dev)
    x = _rand_states(BN254_FR, B, rng, dev)
    per_state = {name: _perm_words(name, p) for name, p in
                 (("poseidon_permute", perm), ("poseidon_permute_opt", perm), ("poseidon2_permute", perm2))}
    cases = (
        ("poseidon_permute", lambda: poseidon_kernel.permute(perm, x),
         lambda: poseidon_kernel.permute_plain(perm, x)),
        ("poseidon_permute_opt", lambda: poseidon_kernel.permute_optimized(perm, x),
         lambda: poseidon_kernel.permute_optimized_plain(perm, x)),
        ("poseidon2_permute", lambda: poseidon2_kernel.permute(perm2, x),
         lambda: poseidon2_kernel.poseidon2_permute_plain(perm2, x)),
    )
    plain_out = {}
    for name, kern, plain in cases:
        got, exp = kern(), plain()
        ms = _time(kern, reps, dev)
        pms = _time(plain, 1, dev)
        _check(name, results, [got], [exp], ms, pms,
               f"bn254_fr width 3 (B={B}, {per_state[name]:.0f} word products per state)",
               (B * per_state[name], 2 * x.numel() * 4), kern, WIDTH3_PTXAS[name])
        PERM_RUNS.setdefault(("bn254_fr", 3), {})[name] = (ms, (B * per_state[name], 2 * x.numel() * 4))
        plain_out[name] = (exp, pms)
    k7 = results["poseidon2_permute"][-1]
    K7_LINEAR["bn254_fr", 3] = (k7[1], k7[5], (B * _perm_words("poseidon2_permute", perm2, True), 2 * x.numel() * 4))

    # K7 on the worst-case state, every element p - 1, at every built width
    # over both 16-limb scalar fields (129 states: a block and one more)
    for spec in (BN254_FR, BLS12_381_FR):
        for w in poseidon2_kernel.KERNEL_WIDTHS:
            p2 = Poseidon2.create(spec, w - 1, device=dev)
            worst = limb.tensor(limb.pack_mont(spec, [spec.modulus - 1]), dev).reshape(-1, 1, 1)
            worst = worst.expand(-1, w, 129).contiguous()
            if not torch.equal(poseidon2_kernel.permute(p2, worst), poseidon2_kernel.poseidon2_permute_plain(p2, worst)):
                fail(f"K7 differs from its plain version on the worst-case state, {spec.name} width {w}")
    log(f"[hash] K7 bit-equal to its plain version on the worst-case state (every element p - 1) at widths "
        f"{', '.join(map(str, poseidon2_kernel.KERNEL_WIDTHS))} over bn254_fr and bls12_381_fr")

    # both K5 variants at the batch sizes around a block of 128 states, a
    # narrow Merkle level and the wrapper's switch between them, against the
    # first b states of the plain version's output at B (it permutes each
    # state alone; one plain call costs about as much at b = 1 as at 2^16,
    # so this slicing is itself held once, at b = 3)
    edge = poseidon_kernel.SPLIT_MAX_B
    full, pms = plain_out["poseidon_permute"]
    if not torch.equal(poseidon_kernel.permute_plain(perm, x[:, :, :3].contiguous()), full[:, :, :3]):
        fail("the plain K5 of 3 states differs from the first 3 of its 2^16 output")
    for b in sorted({1, 2, 3, 127, 128, 129, 2047, 2048, 16895, 16896, 16897, edge, edge + 1, B} & set(range(1, B + 1))):
        xb = x[:, :, :b].contiguous()
        for which in poseidon_kernel.VARIANTS:
            got = poseidon_kernel.permute(perm, xb, which)
            ms = _time(lambda: poseidon_kernel.permute(perm, xb, which), reps, dev)
            _check("poseidon_permute", results, [got], [full[:, :, :b]], ms, pms,
                   f"K5 {which} (B={b}{', the wrapper picks it' if poseidon_kernel.variant(b) == which else ''};"
                   f" plain: the B={B} call)", (b * per_state["poseidon_permute"], 2 * xb.numel() * 4))

    vec = json.loads((ROOT / "tests" / "vectors" / "poseidon_perm_width3_bls381.json").read_text())
    gstate = limb.tensor(limb.pack_mont(BLS12_381_FR, [[int(v)] for v in vec["input"]]), dev)
    gout = poseidon_kernel.permute(Poseidon.create(BLS12_381_FR, 2, device=dev), gstate)
    if [int(v) for v in limb.unpack_mont(BLS12_381_FR, gout)[:, 0]] != [int(v) for v in vec["output"]]:
        fail("K5 does not reproduce the BLS12-381 Fr golden vector")
    log("[hash] K5 reproduces the BLS12-381 Fr width-3 golden vector (tests/vectors)")

    # the slice through its entry points, launch counters zeroed before
    params = MerkleParameters(BN254_FR, height)
    leaves = _rand_field(BN254_FR, 1 << log_b, rng, dev)
    full = _rand_field(BN254_FR, 1 << log_full, rng, dev)
    for k in all_kernels:
        k.reset()
    for label, fn in (("poseidon", lambda: perm.permute(x)), ("poseidon optimized", lambda: perm.permute_optimized(x)),
                      ("poseidon2", lambda: perm2.permute(x))):
        ms = _time(fn, reps, dev)
        log(f"[hash] {label} permute, BN254 Fr width 3: {ms:.4f} ms per batch of {B}, {B / ms * 1e3:.1f} perms/s")
    for label, h in (("poseidon", perm), ("poseidon2", perm2)):
        digest, ms = _wall(lambda: h.hash(x[:, 1:]), dev)
        if tuple(digest.shape) != (BN254_FR.n_limbs, B):
            fail(f"{label} hash gave shape {tuple(digest.shape)}")
        log(f"[hash] {label} hash of {B} pairs: {ms:.3f} ms wall")
    # the first build also moves the tree's Poseidon constants to the card
    for run in ("first", "warm", "warm"):
        tree, ms = _wall(lambda: MerkleTree.from_leaf_digests(params, leaves, device=dev), dev)
        log(f"[merkle] h{height} bulk build of {leaves.shape[1]} leaves ({run}): {ms:.3f} ms wall, "
            f"peak {_peak(dev)}")
    for run in ("warm", "warm"):
        big, ms = _wall(lambda: MerkleTree.from_leaf_digests(params, full, device=dev), dev)
        log(f"[merkle] h{height} bulk build of {full.shape[1]} leaves ({run}): {ms:.3f} ms wall, "
            f"peak {_peak(dev)}")
    if not bool(limb.eq(big.levels[-1], big.root()[:, None]).all()) or big.levels[-1].shape[1] != 1:
        fail("full-capacity build has no single root")
    idx = np.arange(leaves.shape[1])
    for _ in range(2):
        (sib, inner), ms_paths = _wall(lambda: tree.path_arrays(idx), dev)
        ok, ms = _wall(lambda: mpath.verify_batch(params, tree.root(), leaves, sib, inner, idx), dev)
        log(f"[merkle] verify_batch of {len(idx)} paths: {ms:.3f} ms wall (gathering the paths "
            f"{ms_paths:.3f} ms), {int(ok.sum())} pass")
    if not bool(ok.all()):
        fail("verify_batch rejected a valid path")
    flipped = leaves.clone()
    flipped[0, 12345 % len(idx)] ^= 1
    bad = mpath.verify_batch(params, tree.root(), flipped, sib, inner, idx)
    if bad.tolist() != [i != 12345 % len(idx) for i in idx]:
        fail("verify_batch accepted a flipped leaf (or rejected another path)")
    log("[merkle] a flipped leaf fails, every other path passes")
    launches = {k.name: k.launches for k in all_kernels}
    log(f"[hash] launches during the slice: {launches}")

    plain_root, ms = _wall(lambda: _plain_merkle_root(params, leaves), dev)
    if not torch.equal(plain_root.cpu(), tree.root().cpu()):
        fail("the h20 root differs between the kernel build and the plain-hash build")
    log(f"[merkle] h{height} root of {leaves.shape[1]} leaves equals the plain-hash root on {dev.type} "
        f"(plain build {ms:.1f} ms)")

    # where a warm build's time goes, and the floor of its narrow levels:
    # K5 on one block of 128 states is one state's 63 serial rounds
    report = prof.profile(lambda: MerkleTree.from_leaf_digests(params, leaves, device=dev))
    log(f"[profile] one more warm h{height} bulk build of {leaves.shape[1]} leaves")
    for line in report.lines(8):
        log(f"[profile] {line}")
    if dev.type == "cuda" and not report.device_events:
        fail("the profiler recorded no device activity")
    one_block = x[:, :, :128].contiguous()
    ms = _time(lambda: poseidon_kernel.permute(perm, one_block), reps, dev)
    log(f"[hash] K5 on 128 states ({poseidon_kernel.variant(128)} variant, one state's latency): {ms:.4f} ms")
    # each level's device time in warm builds; a level is narrow when its
    # states fill less than one 128-thread block per SM
    narrow = 128 * (torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else 1)
    for _ in range(2):
        levels = _level_ms(params, leaves, dev)
        total = sum(ms for _, ms in levels)
        thin = [ms for states, ms in levels if states < narrow]
        log(f"[merkle] per-level ms of a warm h{height} build of {leaves.shape[1]} leaves (states:ms): "
            + " ".join(f"{states}:{ms:.4f}" for states, ms in levels))
        log(f"[merkle] levels sum {total:.3f} ms; the {len(thin)} levels under {narrow} states "
            f"{sum(thin):.3f} ms ({sum(thin) / total:.1%}); the other {len(levels) - len(thin)} "
            f"{total - sum(thin):.3f} ms")
    return results, launches


# ---------------------------------------------------------------------------
# 6b. widths: K5, K6 and K7 at the other state widths
# ---------------------------------------------------------------------------

#: (field, kernel, widths) of phase 6b: K5 and K6 at the reference's pinned
#: widths 2-6, 9 and 17 and a searched one (7), over BN254 Fr, and at the
#: BLS12-381 Fr widths past the unreduced MDS row's bound (W p < 2 R holds
#: to width 4 there; at 17 a row reduced once whole goes wrong); K7 at
#: every other width it is built for
WIDTHS = (
    ("bn254_fr", ("poseidon_permute", "poseidon_permute_opt"), (2, 4, 5, 6, 7, 9, 17)),
    ("bls12_381_fr", ("poseidon_permute", "poseidon_permute_opt"), (5, 9, 17)),
    ("bn254_fr", ("poseidon2_permute",), (2, 4, 8, 12)),
    ("bls12_381_fr", ("poseidon2_permute",), (2, 4, 8, 12)),
)


def _uniform_states(spec, width, batch, gen, device):
    """(n_limbs, width, batch) Montgomery states from the torch generator
    `gen`: uniform limbs under p's top limb (so every value is below p),
    with 0, 1 and p - 1 in every element of the first three states."""
    import torch

    from openzl_tpu_torch.fields import limb

    n = spec.n_limbs
    x = torch.randint(0, 1 << 16, (n, width, batch), generator=gen, dtype=torch.int32)
    x[-1] = torch.randint(0, spec.modulus >> (16 * (n - 1)), (width, batch), generator=gen, dtype=torch.int32)
    edges = limb.tensor(limb.pack_mont(spec, [0, 1, spec.modulus - 1]), "cpu")[:, None, : min(3, batch)]
    x[:, :, : edges.shape[2]] = edges
    return x.to(device)


def _ptxas_runs(name, width):
    """Phase 2's ptxas key of the instantiation that runs kernel `name` at
    a `width` other than 3."""
    if name == "poseidon2_permute":
        return ("poseidon2_kernel", (width, 8))
    return ("slot_kernel", (0 if name == "poseidon_permute" else 1, 8))


def phase_widths(all_kernels, device="cuda", log_b: int = 16, check_b: int = 4096, reps: int = 5,
                 seed: int = 9, widths=WIDTHS):
    """Phase 6b. Each (field, kernel, width) of `widths`: the kernel on
    2^log_b states against its plain version on the first `check_b` of
    them (all of them from width 4 down), bit-exact, with its time and
    bound; then, with the launch counters zeroed before and read after,
    throughput through the entry points at 2^log_b states: `permute`,
    `permute_optimized` and `hash` of `Poseidon.create(spec, arity)`,
    `permute` and `hash` of `Poseidon2.create(spec, arity)`. Every (kernel,
    width) must launch. Returns (kernel results, {kernel: {width:
    launches}})."""
    import torch

    from openzl_tpu_torch.crypto.poseidon.permutation import Poseidon
    from openzl_tpu_torch.crypto.poseidon2 import Poseidon2
    from openzl_tpu_torch.fields import limb
    from openzl_tpu_torch.fields import spec as fspec
    from openzl_tpu_torch.ops import poseidon2_kernel, poseidon_kernel
    from openzl_tpu_torch.tools import kernel_probe

    dev = torch.device(device)
    gen = torch.Generator().manual_seed(seed)
    B = 1 << log_b
    kernel_fns = {
        "poseidon_permute": (poseidon_kernel.permute, poseidon_kernel.permute_plain),
        "poseidon_permute_opt": (poseidon_kernel.permute_optimized, poseidon_kernel.permute_optimized_plain),
        "poseidon2_permute": (poseidon2_kernel.permute, poseidon2_kernel.poseidon2_permute_plain),
    }
    fields = {"bn254_fr": fspec.BN254_FR, "bls12_381_fr": fspec.BLS12_381_FR}
    results, perms, states = {}, {}, {}
    t0 = time.perf_counter()
    for field, names, ws in widths:
        spec = fields[field]
        cls = Poseidon2 if names == ("poseidon2_permute",) else Poseidon
        for w in ws:
            perms[field, cls.__name__, w] = cls.create(spec, w - 1, device=dev)
            if (field, w) not in states:
                states[field, w] = _uniform_states(spec, w, B, gen, dev)
            if cls is Poseidon:  # state 3: K5's largest MDS inputs
                directed, share = kernel_probe.directed_state(perms[field, "Poseidon", w])
                states[field, w][:, :, 3] = limb.tensor(limb.pack_mont(spec, directed), dev)
                log(f"[widths] {field} width {w}: on state 3 K5's last MDS rows meet {share:.3f} of what a row "
                    f"reduced once whole could take ({'more' if share >= 1 else 'less'} than it; "
                    f"groups of {_mac_group(spec)})")
    log(f"[widths] parameters of {len(perms)} instances and their states: {time.perf_counter() - t0:.1f} s (host)")
    for field, names, ws in widths:
        cls = "Poseidon2" if names == ("poseidon2_permute",) else "Poseidon"
        for w in ws:
            perm, x = perms[field, cls, w], states[field, w]
            for name in names:
                kern, plain = kernel_fns[name]
                got = kern(perm, x)
                b = B if w <= 4 else min(check_b, B)
                xb = x[:, :, :b].contiguous()
                exp, pms = _wall(lambda: plain(perm, xb), dev)
                ms = _time(lambda: kern(perm, x), reps, dev)
                per_state = _perm_words(name, perm)
                _check(name, results, [got[:, :, :b]], [exp], ms, pms,
                       f"{field} width {w} (R_F={perm.full_rounds}, R_P={perm.partial_rounds}, B={B}, "
                       f"{per_state:.0f} word products per state; plain and check on the first {b})",
                       (B * per_state, 2 * x.numel() * 4), lambda: kern(perm, x),
                       _ptxas_runs(name, w))
                PERM_RUNS.setdefault((field, w), {})[name] = (ms, (B * per_state, 2 * x.numel() * 4))
                if name == "poseidon2_permute":
                    K7_LINEAR[field, w] = (ms, results[name][-1][5],
                                           (B * _perm_words(name, perm, True), 2 * x.numel() * 4))

    # the entry points, launch counters zeroed before and read after
    for k in all_kernels:
        k.reset()
    for field, names, ws in widths:
        spec = fields[field]
        for w in ws:
            x = states[field, w]
            if names == ("poseidon2_permute",):
                perm = perms[field, "Poseidon2", w]
                calls = (("poseidon2 permute", lambda: perm.permute(x)),)
            else:
                perm = perms[field, "Poseidon", w]
                calls = (("poseidon permute", lambda: perm.permute(x)),
                         ("poseidon permute_optimized", lambda: perm.permute_optimized(x)))
            outs = []
            for label, fn in calls:
                out, wall = _wall(fn, dev)
                ms = _time(fn, reps, dev)
                outs.append(out)
                log(f"[widths] {label} {field} width {w} (arity {w - 1}): {ms:.4f} ms per batch of {B}, "
                    f"{B / ms * 1e3:.1f} perms/s (first call {wall:.3f} ms wall)")
            digest, wall = _wall(lambda: perm.hash(x[:, 1:]), dev)
            tagged = x.clone()
            tagged[:, 0] = limb.tensor(perm.domain_tag_mont(), dev)[:, None]
            if tuple(digest.shape) != (spec.n_limbs, B) or not torch.equal(digest, perm.permute(tagged)[:, 0]):
                fail(f"{type(perm).__name__} hash at width {w} is not element 0 of its tagged permutation")
            if len(outs) > 1 and not torch.equal(outs[0], outs[1]):
                fail(f"permute and permute_optimized differ at {field} width {w}")
            log(f"[widths] {type(perm).__name__.lower()} hash {field} of {B} {w - 1}-tuples: {wall:.3f} ms wall")
    launches = {k.name: dict(sorted(k.by_state_width.items())) for k in all_kernels if k.by_state_width}
    log(f"[widths] launches by state width through the entry points: {launches}")
    missing = [(name, w) for _, names, ws in widths for name in names for w in ws
               if not launches.get(name, {}).get(w)]
    if missing:
        fail(f"(kernel, width) pairs never launched through the entry points: {missing}")
    return results, launches


# ---------------------------------------------------------------------------
# 7. kzg: KZG commitments, dense polynomials, K8 and K9
# ---------------------------------------------------------------------------


def _fold_check(name, results, curve, fold_in, device, reps):
    """K9 against its plain version on one MSM's sorted entries (one job:
    W 2^c bucket slots and the dump slot)."""
    from openzl_tpu_torch.ops import ec_kernel

    pts, keys, pidx, r, c, W = fold_in
    width = (W << c) + 1
    args = (curve, pts, keys, pidx, r, width)
    got, exp = ec_kernel.fold_madd(*args), ec_kernel.fold_madd_plain(*args)

    def flat(out):  # (totals, tflag, buckets, bflag, bchunk) -> tensors
        return [*out[0], out[1], *out[2], out[3], out[4]]

    ms = _time(lambda: ec_kernel.fold_madd(*args), reps, device)
    pms = _time(lambda: ec_kernel.fold_madd_plain(*args), 1, device)
    packed = ec_kernel.point_words(curve, pts)
    copy_ms = _time(lambda: ec_kernel.point_words(curve, pts), reps, device)
    log(f"[kzg] {name}: the point-major copy of {pts.x.shape[-1]} points ({packed.numel() * 4 / 2**20:.1f} MiB) "
        f"takes {copy_ms:.4f} ms per fold call (in the kernel time below)")
    E, l, ext, n_limbs = keys.numel(), keys.numel() // r, curve.ext, curve.base.n_limbs
    starts = int((keys[1:] != keys[:-1]).sum().item()) + 1
    prod, sqr = EC_PRODUCTS["madd", ext]
    coord = ext * n_limbs * 4
    moved = E * 16 + pts.x.shape[-1] * 2 * coord + l * (3 * coord + 1) + width * (3 * coord + 9)
    _check("fold_madd", results, flat(got), flat(exp), ms, pms,
           f"{name}: {E} entries, r={r}, {l} chunks, c={c}, {W} windows, {starts} segments",
           (_mont_words(n_limbs, (E - starts) * prod, (E - starts) * sqr), moved), lambda: ec_kernel.fold_madd(*args),
           ("fold_kernel", n_limbs // 2, ext))


#: phase 7's whole four-step transforms: (log2 N, batch, transform, K2
#: launches, ms, device ms)
FOURSTEP_RUNS = []

#: the keys of a `_fourstep_runs` row
TRANSFORM_KEYS = ("log_n", "batch", "transform", "launches", "ms", "device_ms", "digest")


def _fourstep_runs(spec, log_n, batch, rng, dev, reps, check_launches=True):
    """`ntt`, `intt`, `coset_ntt` and `coset_intt` of 2^log_n random
    canonical points (limbs drawn on the host, the top one below p's) at
    `batch` through the entry points: launches (with `check_launches`, one
    K2 a level of `ntt._levels` and no K1 or K8 on the card, the plans
    built first), CUDA events and device time a call, and a digest of the
    output (two checkouts that compute the same transform print the same
    digest); intt(ntt(x)) and coset_intt(coset_ntt(x)) must give x back."""
    import torch

    from openzl_tpu_torch.ops import ntt, ntt_kernel

    gen = torch.Generator().manual_seed(rng.randrange(1 << 30))
    x = torch.randint(0, 1 << 16, (spec.n_limbs, 1 << log_n, batch), generator=gen, dtype=torch.int32)
    x[-1] %= spec.modulus >> (16 * spec.n_limbs - 16)  # below p's top limb: canonical
    x = (x[:, :, 0] if batch == 1 else x).contiguous().to(dev)
    levels = len(ntt._levels(log_n))
    rows = []
    for fn, back in ((ntt.ntt, ntt.intt), (ntt.intt, None), (ntt.coset_ntt, ntt.coset_intt), (ntt.coset_intt, None)):
        y = fn(spec, x)  # builds the plans
        for k in (ntt_kernel.K2, ntt_kernel.K1, ntt_kernel.K8):
            k.reset()
        y = fn(spec, x)
        launches = (ntt_kernel.K2.launches, ntt_kernel.K1.launches, ntt_kernel.K8.launches)
        if check_launches and dev.type == "cuda" and launches != (levels, 0, 0):
            fail(f"{fn.__name__} of 2^{log_n} at batch {batch} made {launches} K2, K1, K8 launches, not "
                 f"({levels}, 0, 0)")
        if back is not None and not torch.equal(back(spec, y), x):
            fail(f"{back.__name__}({fn.__name__}(x)) is not x at 2^{log_n}, batch {batch}")
        weights = torch.arange(1, y[0].numel() + 1, device=dev, dtype=torch.int64).reshape(y.shape[1:])
        digest = int(((y.to(torch.int64) * weights) % 1_000_000_007).sum())
        ms = _time(lambda: fn(spec, x), reps, dev)
        dms = _device_ms(lambda: fn(spec, x), 10)
        rows.append((log_n, batch, fn.__name__, launches[0], ms, dms, digest))
        dtext = f"{dms:.4f} ms" if dms is not None else "not measured"
        log(f"[kzg] {spec.name} {fn.__name__} 2^{log_n} batch {batch}: {launches[0]} K2 launches ({levels} levels), "
            f"{launches[1]} K1, {launches[2]} K8; {ms:.4f} ms (CUDA events on the card), device {dtext}, "
            f"digest {digest}")
    return rows


def phase_kzg(all_kernels, b2_fold, device="cuda", log_d: int = 16, log_big: int = 20, log_mul: int = 11,
              reps: int = 20, seed: int = 7, pairing=None, fourstep_sizes=((17, 1), (17, 3), (20, 1))):
    """Phase 7 over BN254 (`pairing` None), or phase 7b over another
    pairing (BLS12-381: K9 and every group-law launch at 24 limbs).
    Returns (kernel results, launches of the slice's kernels); the whole
    four-step transforms at `fourstep_sizes` (log2 N, batch) go to
    FOURSTEP_RUNS."""
    import torch

    from openzl_tpu_torch.curves import jacobian as jac
    from openzl_tpu_torch.fields import limb
    from openzl_tpu_torch.ops import msm, ntt, ntt_kernel
    from openzl_tpu_torch.ops.poly import DensePoly, Radix2Domain
    from openzl_tpu_torch.proof_systems import BN254, KZG, KZGParams
    from openzl_tpu_torch.utils import profile as prof

    dev = torch.device(device)
    rng = random.Random(seed)
    results = {}
    pairing = pairing or BN254
    spec, g1, r = pairing.g1.scalar, pairing.g1, pairing.r
    name = pairing.name

    # K8: the one-launch transform (the per-stage route's launch) at 2^12
    # and 2^10, forward and inverse, batch 1 and 4; 2^12 forward at batch 1
    # first, the row's headline. Bound: the larger of its Montgomery
    # products over the issue rate and the column read and written once.
    # The products are those the function needs: N/2 log2 N butterflies a
    # column less the N - 1 whose twiddle is w^0 = 1 (group 0 of every
    # stage), and N more for the inverse's scale
    for log_n in (12, 10):
        N = 1 << log_n
        for inverse in (False, True):
            rev, table, n_inv = ntt._plan(spec, log_n, inverse, dev)
            for batch in (1, 4):
                x = _rand_field(spec, batch << log_n, rng, dev).reshape(spec.n_limbs, N, batch)
                x = x[:, :, 0].contiguous() if batch == 1 else x.contiguous()

                def kern(x=x, table=table, rev=rev, n_inv=n_inv, inverse=inverse):
                    return ntt_kernel.transform(spec, x, table, rev, n_inv, inverse)

                got = kern()
                exp = ntt_kernel.transform_plain(spec, x, table, rev, n_inv, inverse)
                ms = _time(kern, reps * 5, dev)
                pms = _time(lambda: ntt_kernel.transform_plain(spec, x, table, rev, n_inv, inverse), 3, dev)
                blocks = ntt_kernel.cluster_size(N, batch, dev) if dev.type == "cuda" else ntt_kernel.CLUSTER[N]
                products = batch * (N // 2 * log_n - (N - 1) + (N if inverse else 0))
                _check("butterfly", results, [got], [exp], ms, pms,
                       f"{spec.name} transform 2^{log_n} ({'inverse' if inverse else 'forward'}, batch {batch}, "
                       f"one launch, {blocks} blocks a transform)",
                       (_mont_words(spec.n_limbs, products), 2 * batch * N * spec.n_limbs * 4), kern,
                       ("ntt_transform_kernel", (8,)))
    # a transform below the four-step threshold is one K8 launch, no K1
    # (its tables are built once, by K1 products, for the tensor's device)
    x = _rand_field(spec, 1 << 12, rng, dev)
    for inverse in (False, True):
        ntt._plan(spec, 12, inverse, x.device)
    for k in (ntt_kernel.K8, ntt_kernel.K1):
        k.reset()
    for inverse in (False, True):
        ntt._ntt_core(spec, x, inverse)
    if dev.type == "cuda" and (ntt_kernel.K8.launches, ntt_kernel.K1.launches) != (2, 0):
        fail(f"a forward and an inverse 2^12 transform made {ntt_kernel.K8.launches} K8 and "
             f"{ntt_kernel.K1.launches} K1 launches, not 2 and 0")
    log(f"[kzg] {spec.name} 2^12 forward and inverse through ntt._ntt_core: {ntt_kernel.K8.launches} K8 launches, "
        f"{ntt_kernel.K1.launches} K1")

    # K8: one middle stage of a 2^12 transform, batch 1 and 4
    log_n = 12
    _, table, _ = ntt._plan(spec, log_n, False, dev)
    for batch in (1, 4):
        x = _rand_field(spec, batch << log_n, rng, dev).reshape(spec.n_limbs, batch, 1 << log_n)
        x = x.transpose(1, 2).contiguous()
        if batch == 1:
            x = x[:, :, 0].contiguous()
        got = ntt_kernel.stage(spec, x, table, 5)
        exp = ntt_kernel.stage_plain(spec, x, table, 5)
        ms = _time(lambda: ntt_kernel.stage(spec, x, table, 5), reps * 5, dev)
        pms = _time(lambda: ntt_kernel.stage_plain(spec, x, table, 5), 3, dev)
        half = (batch << log_n) // 2
        _check("butterfly", results, [got], [exp], ms, pms, f"{spec.name} stage 5 of 2^{log_n} (batch {batch})",
               (_mont_words(16, half), (4 * half + (1 << log_n) // 2) * 16 * 4),
               lambda: ntt_kernel.stage(spec, x, table, 5))

    # both NTT routes below the four-step threshold
    for log_n in (10, 12):
        x = _rand_field(spec, 1 << log_n, rng, dev)
        if not torch.equal(ntt._ntt_core(spec, x, False), ntt.fourstep_transform(spec, x, False)):
            fail(f"the NTT routes disagree at 2^{log_n}")
        t_stage = _time(lambda: ntt._ntt_core(spec, x, False), reps, dev)
        t_four = _time(lambda: ntt.fourstep_transform(spec, x, False), reps, dev)
        d_stage = _device_ms(lambda: ntt._ntt_core(spec, x, False), 10)
        d_four = _device_ms(lambda: ntt.fourstep_transform(spec, x, False), 10)
        dev_ms = ", ".join(f"{label} {v:.4f} ms" if v is not None else f"{label} not measured"
                           for label, v in (("per-stage", d_stage), ("four-step", d_four)))
        log(f"[kzg] NTT 2^{log_n} {spec.name}: per-stage route (one K8 launch) {t_stage:.4f} ms, four-step route "
            f"(K2) {t_four:.4f} ms (CUDA events on the card); device time {dev_ms}; the same evaluations")

    # the whole four-step transforms: the prover's 2^17 at batch 1 and 3
    # and KZG's 2^20, each of the four one K2 launch a level and nothing
    # else, with their event and device times; the round trips must give
    # the input back
    if pairing is BN254:
        for log_n, batch in fourstep_sizes:
            FOURSTEP_RUNS.extend(_fourstep_runs(spec, log_n, batch, rng, dev, reps))

    # K9: the G1 fold of a 2^log_d-point commit, the Fq2 fold of phase 5's B2
    kzg = KZG(pairing, backend="device", device=dev)
    d = (1 << log_d) - 1
    params = kzg.setup(d, random.Random(seed))
    coeffs = [rng.randrange(r) for _ in range(d + 1)]
    scalars = limb.tensor(limb.pack(spec, coeffs), dev)
    _fold_check(f"{name} G1 commit of 2^{log_d}", results, g1, msm.fold_inputs(g1, [(scalars, params.powers_g1)]),
                dev, reps)
    if b2_fold is not None:
        _fold_check(f"{name} G2 B2 MSM of the Groth16 slice", results, pairing.g2, b2_fold, dev, reps)
    few = limb.tensor(limb.pack(spec, [9, 9, 4]), dev)
    small = msm.fold_inputs(g1, [(few, jac.take(params.powers_g1, torch.arange(3, device=dev)))], 4, 4)
    if small[3] != 1:
        fail(f"the small fold has r = {small[3]}, not the smallest chunk length 1")
    _fold_check(f"{name} G1 MSM of 3 entries (r = 1)", results, g1, small, dev, reps)

    # the slice through its entry points, launch counters zeroed before
    for k in all_kernels:
        k.reset()
    steps = []

    def step(label, fn):
        out, ms = _wall(fn, dev)
        steps.append((label, ms, _peak(dev)))
        log(f"[kzg] {name} {label}: {ms:.3f} ms wall, peak {_peak(dev)}")
        return out

    params = step(f"setup degree 2^{log_d} - 1", lambda: kzg.setup(d, random.Random(seed)))
    C = step(f"commit degree 2^{log_d} - 1", lambda: kzg.commit(params, coeffs))
    zs = [rng.randrange(r) for _ in range(4)]
    opened = [step(f"open {i + 1} at a random z", lambda z=z: kzg.open(params, coeffs, z)) for i, z in enumerate(zs)]
    v, w = opened[0]
    if not step("verify", lambda: kzg.verify(params, C, zs[0], v, w)):
        fail("a KZG opening did not verify")
    if kzg.verify(params, C, zs[0], (v + 1) % r, w):
        fail("a KZG opening with v + 1 verified")
    claims = [(C, z, vz, wz) for z, (vz, wz) in zip(zs, opened)]
    if not step("batch_verify of 4 openings", lambda: kzg.batch_verify(params, claims, rng)):
        fail("batch_verify rejected 4 valid openings")
    bad = claims[:2] + [(C, zs[2], (opened[2][0] + 1) % r, opened[2][1])] + claims[3:]
    if kzg.batch_verify(params, bad, rng):
        fail("batch_verify accepted a changed v")
    log(f"[kzg] {name}: v + 1 rejected by verify, a changed v by batch_verify")
    blob = step("params to_bytes", params.to_bytes)
    loaded = step("params from_bytes + device_params", lambda: kzg.device_params(KZGParams.from_bytes(pairing, blob)))
    if step("commit with the loaded params", lambda: kzg.commit(loaded, coeffs)) != C:
        fail("the loaded params commit to another point")
    a, b = (DensePoly.rand(spec, (1 << log_mul) - 1, rng, device=dev) for _ in range(2))
    prod = step(f"DensePoly product of two degree 2^{log_mul} - 1 polynomials", lambda: a * b)
    z = rng.randrange(r)
    if prod.degree != 2 * a.degree or prod.evaluate(z) != a.evaluate(z) * b.evaluate(z) % r:
        fail("the DensePoly product is wrong at a random point")
    dom = Radix2Domain.new(spec, 1 << 12, device=dev)
    big = DensePoly.rand(spec, 3 << 12, rng, device=dev)
    q, rem = step("divide_by_vanishing_poly at n = 2^12 (device path)",
                  lambda: big.divide_by_vanishing_poly(dom, on_device=True))
    if big.evaluate(z) != (q.evaluate(z) * dom.evaluate_vanishing(z) + rem.evaluate(z)) % r or rem.degree >= dom.size:
        fail("divide_by_vanishing_poly is wrong at a random point")
    log(f"[kzg] {name}: the product and the division hold at a random point")
    launches = {k.name: k.launches for k in all_kernels}
    log(f"[kzg] {name} launches during the slice: {launches}")
    missing = [n for n in ("butterfly", "fold_madd") if launches[n] == 0]
    if pairing is not BN254:
        at24 = {k.name: k.by_limbs.get(24, 0) for k in all_kernels if k.name in EC_KERNELS}
        log(f"[kzg] {name} launches at 24 limbs during the slice: {at24}")
        missing += [] if at24["fold_madd"] else ["fold_madd at 24 limbs"]
    if missing and dev.type == "cuda":
        fail(f"kernels never launched on the {name} KZG slice: {missing}")
    report = prof.profile(lambda: kzg.commit(params, coeffs))
    log(f"[profile] one more {name} commit of degree 2^{log_d} - 1")
    for line in report.lines(8):
        log(f"[profile] {line}")
    if dev.type == "cuda" and not report.device_events:
        fail("the profiler recorded no device activity")

    # one commit + open at degree 2^log_big - 1
    if log_big:
        D = (1 << log_big) - 1
        big_params = step(f"setup degree 2^{log_big} - 1", lambda: kzg.setup(D, random.Random(seed)))
        big_coeffs = [rng.randrange(r) for _ in range(D + 1)]
        Cb = step(f"commit degree 2^{log_big} - 1", lambda: kzg.commit(big_params, big_coeffs))
        zb = rng.randrange(r)
        vb, wb = step(f"open degree 2^{log_big} - 1", lambda: kzg.open(big_params, big_coeffs, zb))
        if not kzg.verify(big_params, Cb, zb, vb, wb):
            fail(f"the degree 2^{log_big} - 1 opening did not verify")
        log(f"[kzg] degree 2^{log_big} - 1 opening verifies")
    return results, launches


# ---------------------------------------------------------------------------
# 8. gadgets
# ---------------------------------------------------------------------------


def _gadget_ops(spec, device, log_n: int, sample: int, rng):
    """Part (a): `TorchCompiler` ops at 2^log_n elements of `spec`, each
    held bit-exact against the port's `NativeCompiler` on `sample`
    elements (0 and p - 1 among them); returns {op: wall ms}."""
    import torch

    from openzl_tpu_torch.eclair import NativeCompiler, TorchCompiler
    from openzl_tpu_torch.fields import limb

    n, p = 1 << log_n, spec.modulus
    a = [0, p - 1] + [rng.randrange(p) for _ in range(n - 2)]
    b = [x if i % 4 == 0 else rng.randrange(p) for i, x in enumerate(a)]
    bit = [bool(rng.getrandbits(1)) for _ in range(n)]
    idx = [0, 1] + rng.sample(range(2, n), sample - 2)
    com, nat = TorchCompiler(spec, (n,), device), NativeCompiler(spec)
    ta, tb = (limb.tensor(limb.pack_mont(spec, v), device) for v in (a, b))
    tbit = torch.tensor(bit, device=device)
    ops = {
        "add": (lambda c, x, y, z: c.add(x, y)),
        "sub": (lambda c, x, y, z: c.sub(x, y)),
        "neg": (lambda c, x, y, z: c.neg(x)),
        "mul": (lambda c, x, y, z: c.mul(x, y)),
        "square": (lambda c, x, y, z: c.square(x)),
        "inv": (lambda c, x, y, z: c.inv(x)),
        "pow5": (lambda c, x, y, z: c.pow5(x)),
        "select": (lambda c, x, y, z: c.select(z, x, y)),
        "is_eq": (lambda c, x, y, z: c.is_eq(x, y)),
        "is_zero": (lambda c, x, y, z: c.is_zero(x)),
        "to_bits_le": (lambda c, x, y, z: c.to_bits_le(x, spec.bits)),
    }
    def timed(f, *args):
        """(result, wall ms of a second call: the first pays one-time costs)"""
        f(*args)
        return _wall(lambda: f(*args), torch.device(device))

    times = {}
    for name, fn in ops.items():
        out, times[name] = timed(fn, com, ta, tb, tbit)
        if name == "to_bits_le":
            back, times["from_bits_le"] = timed(com.from_bits_le, out)
            if not torch.equal(back, ta):
                fail(f"[gadgets] {spec.name}: from_bits_le(to_bits_le(a)) != a")
            got = torch.stack(out)[:, idx].T.tolist()
            want = [nat.to_bits_le(a[i], spec.bits) for i in idx]
        elif out.dtype == torch.bool:
            got = out[idx].tolist()
            want = [fn(nat, a[i], b[i], bit[i]) for i in idx]
        else:
            got = [int(v) for v in limb.unpack_mont(spec, out[:, idx])]
            want = [0 if name == "inv" and a[i] == 0 else fn(nat, a[i], b[i], bit[i]) for i in idx]
        if got != want:
            bad = next(k for k in range(len(idx)) if got[k] != want[k])
            fail(f"[gadgets] {spec.name} {name} at element {idx[bad]} differs from NativeCompiler")
    log(f"[gadgets] (a) {spec.name}: TorchCompiler ops at 2^{log_n} elements equal NativeCompiler on "
        f"{len(idx)} sampled elements (0 and p - 1 among them); wall ms of a second call: "
        + ", ".join(f"{k} {v:.2f}" for k, v in times.items()))
    return times


def schnorr_batch_mask(com, spec, vk, msg, s, R):
    """The gadgets `verify_gadget` calls (crypto/signature/schnorr.py:64),
    composed so that its two `assert_eq` masks come back ANDed: one bool
    a verification. vk and R are `PointVar`s, msg and s field tensors."""
    from openzl_tpu_torch.crypto import ec_gadget as ecg
    from openzl_tpu_torch.crypto.signature import schnorr

    c = schnorr.challenge_gadget(com, spec, vk, R, msg)
    c_bits = com.to_bits_le(c, spec.base.bits)
    s_bits = com.to_bits_le(s, spec.scalar_bits)
    lhs = ecg.fixed_base_scalar_mul(com, schnorr._gen_table(spec), s_bits)
    rhs = ecg.add_points(com, spec, R, ecg.scalar_mul(com, spec, c_bits, vk))
    return com.and_(com.assert_eq(lhs.x, rhs.x), com.assert_eq(lhs.y, rhs.y))


def _signatures(spec, count: int, seed: int):
    """`count` (vk, msg, signature) triples made on the host by EdSchnorr."""
    from openzl_tpu_torch.crypto.signature.schnorr import EdSchnorr

    scheme, rng, out = EdSchnorr(spec), random.Random(seed), []
    for _ in range(count):
        sk = scheme.generate_key(rng)
        msg = rng.randrange(spec.base.modulus)
        out.append((scheme.derive(sk), msg, scheme.sign(sk, rng.randrange(spec.order), msg)))
    return out


def _batched_verify(kernels, device, verifies: int, distinct: int, seed: int):
    """Part (b): `verifies` Schnorr verifications on Baby Jubjub in one
    batch, tiled from `distinct` signatures, one in eight forged (a wrong
    message or the scalar + 1). Returns (launches, wall ms, verifications/s)."""
    import dataclasses

    import torch

    from openzl_tpu_torch.crypto.ec_gadget import PointVar
    from openzl_tpu_torch.crypto.signature.schnorr import EdSchnorr
    from openzl_tpu_torch.curves.edwards import BABY_JUBJUB as spec
    from openzl_tpu_torch.eclair import TorchCompiler
    from openzl_tpu_torch.fields import limb

    t0 = time.perf_counter()
    sigs = _signatures(spec, distinct, seed)
    t_sign = time.perf_counter() - t0
    rows = []
    for i in range(verifies):
        vk, msg, sig = sigs[i % distinct]
        if i % 8 == 7:
            if (i // 8) % 2:
                msg = (msg + 1) % spec.base.modulus
            else:
                sig = dataclasses.replace(sig, scalar=(sig.scalar + 1) % spec.order)
        rows.append((vk, msg, sig))
    scheme = EdSchnorr(spec)
    t0 = time.perf_counter()
    native = {}
    for vk, msg, sig in rows:
        key = (vk, msg, sig.scalar, sig.nonce_point)
        if key not in native:
            native[key] = scheme.verify(vk, msg, sig)
    t_native = time.perf_counter() - t0

    def col(vals):
        return limb.tensor(limb.pack_mont(spec.base, vals), device)

    vkv = PointVar(col([r[0][0] for r in rows]), col([r[0][1] for r in rows]))
    Rv = PointVar(col([r[2].nonce_point[0] for r in rows]), col([r[2].nonce_point[1] for r in rows]))
    msgv, sv = col([r[1] for r in rows]), col([r[2].scalar for r in rows])
    com = TorchCompiler(spec.base, (verifies,), device)
    walls = []
    for rep in range(2):
        for k in kernels:
            k.reset()
        mask, ms = _wall(lambda: schnorr_batch_mask(com, spec, vkv, msgv, sv, Rv), torch.device(device))
        got = mask.tolist()
        walls.append(ms)
        if rep == 0:
            launches = {k.name: k.launches for k in kernels}
    want = [native[(vk, msg, sig.scalar, sig.nonce_point)] for vk, msg, sig in rows]
    forged = [i for i in range(verifies) if i % 8 == 7]
    log(f"[gadgets] (b) {verifies} Schnorr verifications on baby_jubjub in one batch ({distinct} distinct "
        f"signatures, signed in {t_sign:.1f} s; {len(native)} distinct inputs verified natively in "
        f"{t_native:.1f} s); {sum(got)} pass, {len(forged)} forged")
    if got != want:
        fail("[gadgets] the batched verification mask differs from EdSchnorr.verify")
    if any(got[i] for i in forged) or not all(got[i] for i in range(verifies) if i % 8 != 7):
        fail("[gadgets] a forgery passed or a valid signature failed")
    rate = verifies / (walls[-1] / 1e3)
    log(f"[gadgets] (b) mask equals EdSchnorr.verify on every input, every forgery rejected; wall "
        f"{walls[0]:.1f} ms (first), {walls[1]:.1f} ms (second), {rate:.1f} verifications/s; launches of the "
        f"first: {launches}")
    if torch.device(device).type == "cuda" and not (launches["mont_mul"] and launches["mont_pow"]):
        fail(f"[gadgets] K1 or mont_pow never launched in the batched verification: {launches}")
    return launches, walls, rate


def _schnorr_proof(g16, spec, sigs, kernels, proofs: int, tag: str):
    """Parts (c) and (d): one R1CS of len(sigs) verification circuits,
    compiled once, `proofs` prove requests, each verified, and a public
    message + 1 rejected. Returns (launches during the proves, stats)."""
    from openzl_tpu_torch.crypto.signature.schnorr import verification_circuit

    t0 = time.perf_counter()
    setup = g16.context_compiler()
    for _ in sigs:
        verification_circuit(setup, spec)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    prove = g16.proof_compiler()
    for vk, msg, sig in sigs:
        verification_circuit(prove, spec, vk, msg, sig)
    t_prove = time.perf_counter() - t0
    cs = prove.cs
    public = [v for vk, msg, _ in sigs for v in (vk[0], vk[1], msg)]
    log(f"[gadgets] {tag}: {len(sigs)} verification circuits over {spec.name}: {cs.num_constraints} constraints, "
        f"{cs.num_variables} variables, {cs.num_instance} public; synthesis {t_setup * 1e3:.0f} ms (setup), "
        f"{t_prove * 1e3:.0f} ms (prove)")
    rng = random.Random(0x5C)
    t0 = time.perf_counter()
    pk = g16.compile(setup.cs, rng)
    t_compile = (time.perf_counter() - t0) * 1e3
    log(f"[gadgets] {tag}: compile {t_compile:.0f} ms, domain 2^{pk.domain_log2}")
    for k in kernels:
        k.reset()
    walls = []
    for i in range(proofs):
        t0 = time.perf_counter()
        proof = g16.prove(pk, cs, rng)
        walls.append((time.perf_counter() - t0) * 1e3)
        ok = g16.verify(pk.vk, public, proof)
        log(f"[gadgets] {tag}: prove {i + 1}: {walls[-1]:.1f} ms, verify {ok}; "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in g16.laps["prove"]))
        if not ok:
            fail(f"[gadgets] {tag}: proof {i + 1} did not verify")
    launches = {k.name: k.launches for k in kernels}
    fuzzed = list(public)
    fuzzed[2] = (fuzzed[2] + 1) % g16.fr.modulus
    if g16.verify(pk.vk, fuzzed, proof):
        fail(f"[gadgets] {tag}: a public message + 1 was accepted")
    log(f"[gadgets] {tag}: a public message + 1 rejected; launches during the {proofs} proves: {launches}")
    stats = {"signatures": len(sigs), "constraints": cs.num_constraints, "domain_log2": pk.domain_log2,
             "synthesis_ms": [t_setup * 1e3, t_prove * 1e3], "compile_ms": t_compile, "prove_ms": walls}
    return launches, stats, {k.name: k.by_limbs.get(24, 0) for k in kernels}


def phase_gadgets(all_kernels, groth16_kernels, device="cuda", log_ops: int = 16, sample: int = 256,
                  verifies: int = 1024, distinct: int = 64, signatures: int = 16, proofs: int = 2, seed: int = 9):
    """Phase 8: the gadget layer on the card. (a) `TorchCompiler` ops over
    BN254 Fr and BLS12-381 Fr against `NativeCompiler`; (b) batched
    Schnorr verification on Baby Jubjub; (c) a BN254 Groth16 proof of
    `signatures` Schnorr verifications in one R1CS; (d) `Groth16()` with no
    arguments (BLS12-381) on one Jubjub signature, whose K3, K4, K9 and
    scan launches must be at 24 limbs. Returns the phase's record."""
    import torch

    from openzl_tpu_torch.curves.edwards import BABY_JUBJUB, jubjub
    from openzl_tpu_torch.fields.spec import BLS12_381_FR, BN254_FR
    from openzl_tpu_torch.proof_systems import BLS12_381, BN254, Groth16

    t_phase = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    rng = random.Random(seed)
    ops = {spec.name: _gadget_ops(spec, device, log_ops, sample, rng) for spec in (BN254_FR, BLS12_381_FR)}
    k1 = [k for k in groth16_kernels if k.name in ("mont_mul", "mont_pow")]
    v_launches, v_walls, rate = _batched_verify(k1, device, verifies, distinct, seed)

    sigs = _signatures(BABY_JUBJUB, signatures, seed + 1)
    launches, stats, _ = _schnorr_proof(Groth16(BN254, device), BABY_JUBJUB, sigs, all_kernels, proofs,
                                        "(c) bn254")
    missing = [k.name for k in groth16_kernels if launches[k.name] == 0]
    if cuda and missing:
        fail(f"[gadgets] (c) Groth16 kernels never launched: {missing}")

    g16 = Groth16() if cuda else Groth16(device=device)
    if g16.pairing is not BLS12_381:
        fail(f"Groth16() picks {g16.pairing.name}, not bls12_381")
    jj = jubjub()
    bls_launches, bls_stats, at24 = _schnorr_proof(g16, jj, _signatures(jj, 1, seed + 2), all_kernels, 1,
                                                   "(d) bls12_381")
    at24 = {k: v for k, v in at24.items() if k in EC_KERNELS}
    log(f"[gadgets] (d) launches at 24 limbs: {at24}")
    if cuda and not all(at24.values()):
        fail(f"[gadgets] (d) kernels never launched at 24 limbs: {[k for k, v in at24.items() if not v]}")
    wall = time.perf_counter() - t_phase
    log(f"[gadgets] phase 8 wall {wall:.1f} s")
    return {"ops_ms": ops, "verify": {"count": verifies, "distinct": distinct, "wall_ms": v_walls,
                                      "per_s": rate, "launches": v_launches},
            "proof": {**stats, "launches": launches}, "default_proof": {**bls_stats, "launches": bls_launches,
                                                                        "at_24_limbs": at24},
            "wall_s": wall}


# ---------------------------------------------------------------------------
# 9. mesh: parallel/ on torch.distributed, the mesh and staged provers
# ---------------------------------------------------------------------------


#: gloo ranks sharing the card in phase 9 (R = 4 rows of the sharded
#: transform; a 3-rank sub-mesh of them runs the sequential fold)
MESH_RANKS = 4


def _mesh_kernels():
    """The kernels of the mesh path: K1, its exponentiation, K2, K8, K3,
    K4, K9 and K3's scan."""
    from openzl_tpu_torch.ops import ec_kernel, ntt_kernel

    return [ntt_kernel.K1, ntt_kernel.K1P, ntt_kernel.K2, ntt_kernel.K8, ec_kernel.K3, ec_kernel.K4,
            ec_kernel.K9, ec_kernel.K3S]


def _sync_ms(fn):
    """(fn(), wall ms), between two device syncs where there is a card."""
    import torch

    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def _mesh_points(curve, n, seed, device):
    """(scalars, points): n full-width canonical scalars (0, 1 and r - 1
    first) and n normalized points, random picks of 64 random multiples of
    the generator (the port's fixed-base MSM) with every 97th the
    identity; the same from the same seed on every rank and in the parent."""
    import numpy as np
    import torch

    from openzl_tpu_torch.curves import jacobian as jac
    from openzl_tpu_torch.fields import limb
    from openzl_tpu_torch.ops import msm

    rng = random.Random(seed)
    ks = [rng.randrange(1, curve.scalar.modulus) for _ in range(64)]
    base = jac.normalize(curve, msm.fixed_base_msm(curve, limb.tensor(limb.pack(curve.scalar, ks), device)))
    pts = jac.take(base, torch.as_tensor(np.random.default_rng(seed).integers(0, 64, n), device=device))
    ident = torch.zeros(n, dtype=torch.bool, device=device)
    ident[::97] = True
    pts = jac.select(ident, jac.identity(curve, (n,), device), pts)
    return _rand_field(curve.scalar, n, rng, device), pts


def _mesh_msm_task(n_ranks, group, log_m, seed, sets, device):
    """Rank task: sharded_msm (sets = 0) or sharded_msm_multi of `sets`
    point sets sharing the scalars, at 2^log_m - 3 points; (affine result,
    warm wall ms)."""
    from openzl_tpu_torch.curves import jacobian as jac
    from openzl_tpu_torch.parallel import local_mesh, sharded_msm, sharded_msm_multi
    from openzl_tpu_torch.proof_systems import BN254

    mesh = local_mesh(n_ranks, device=device)
    if mesh is None:
        return None
    curve = getattr(BN254, group)
    n = (1 << log_m) - 3
    scal, pts = _mesh_points(curve, n, seed, mesh.device)
    more = [_mesh_points(curve, n, seed + 1 + s, mesh.device)[1] for s in range(sets - 1)]

    def fn():
        return sharded_msm_multi(curve, mesh, scal, [pts, *more]) if sets else sharded_msm(curve, mesh, scal, pts)

    fn()
    out, ms = _sync_ms(fn)
    aff = [jac.to_affine_ints(curve, o) for o in out] if sets else jac.to_affine_ints(curve, out)
    return aff, ms


def _mesh_transform_task(n_ranks, log_n, seed, device):
    """Rank task: the four sharded transforms of 2^log_n random canonical
    BN254 Fr elements: {name: (digest, warm wall ms)}."""
    from openzl_tpu_torch import parallel
    from openzl_tpu_torch.fields.spec import BN254_FR
    from openzl_tpu_torch.parallel import local_mesh

    mesh = local_mesh(n_ranks, device=device)
    if mesh is None:
        return None
    x = _rand_field(BN254_FR, 1 << log_n, random.Random(seed), mesh.device)
    out = {}
    for name in ("ntt", "intt", "coset_ntt", "coset_intt"):
        fn = getattr(parallel, f"sharded_{name}")
        fn(BN254_FR, mesh, x)
        y, ms = _sync_ms(lambda: fn(BN254_FR, mesh, x))
        out[name] = (_digest(y), ms)
    return out


def _mesh_poseidon_task(n_ranks, log_b, seed, device):
    """Rank task: sharded_poseidon_hash at width 3 of 2^log_b states:
    (digest, warm wall ms, K5 and K6 launches of the timed call)."""
    from openzl_tpu_torch.crypto.poseidon.permutation import Poseidon
    from openzl_tpu_torch.fields.spec import BN254_FR
    from openzl_tpu_torch.ops import poseidon_kernel
    from openzl_tpu_torch.parallel import local_mesh, sharded_poseidon_hash

    mesh = local_mesh(n_ranks, device=device)
    if mesh is None:
        return None
    perm = Poseidon.create(BN254_FR, 2, device=mesh.device)
    x = _rand_field(BN254_FR, 2 << log_b, random.Random(seed), mesh.device)
    x = x.reshape(BN254_FR.n_limbs, 2, 1 << log_b)
    sharded_poseidon_hash(perm, mesh, x)
    for k in (poseidon_kernel.K5, poseidon_kernel.K6):
        k.reset()
    y, ms = _sync_ms(lambda: sharded_poseidon_hash(perm, mesh, x))
    return _digest(y), ms, {k.name: k.launches for k in (poseidon_kernel.K5, poseidon_kernel.K6)}


def _mesh_circuit(g16, chain, seed):
    """The 512-link Poseidon chain of phase 5: (circuit, key from
    random.Random(seed + 1), the assignment's limbs, the public digest)."""
    from openzl_tpu_torch.eclair import circuits

    params = circuits.poseidon_params(g16.fr)
    witness, digest = circuits.chain_inputs(params, chain, random.Random(seed))
    cs = circuits.poseidon_chain(g16.context_compiler(), params, chain)
    t0 = time.perf_counter()
    pk = g16.compile(cs, random.Random(seed + 1))
    compile_s = time.perf_counter() - t0
    z = g16.witness_calculator(cs).evaluate_limbs([digest], witness)
    return cs, pk, z, digest, compile_s


def _record_msm_jobs(fn):
    """Run fn with `ops.msm.msm_sets` recording its jobs; returns [(curve
    name, [(scalars, (x, y, z))] as numpy arrays, window bits, bits)] of
    each call, in call order."""
    from openzl_tpu_torch.ops import msm

    real, seen = msm.msm_sets, []

    def recording(curve, jobs, window_bits=None, n_bits=None):
        seen.append((curve.name, [(s.cpu().numpy(), tuple(v.cpu().numpy() for v in p)) for s, p in jobs],
                     window_bits, n_bits))
        return real(curve, jobs, window_bits, n_bits)

    msm.msm_sets = recording
    try:
        fn()
    finally:
        msm.msm_sets = real
    return seen


def _mesh_prove_task(n_ranks, chain, seed, device, record=False):
    """Rank task: compile the chain's key (the same seeded rng on every
    rank), prove once to warm up, then prove again with the launch counters
    zeroed before and read after; verify, and a fuzzed input must fail.
    With `record`, every rank proves once more and the last one returns
    the MSM jobs of its shard (`_record_msm_jobs`) as `jobs`."""
    from openzl_tpu_torch.parallel import local_mesh
    from openzl_tpu_torch.proof_systems import BN254, Groth16

    mesh = local_mesh(n_ranks, device=device)
    if mesh is None:
        return None
    g16 = Groth16(BN254, mesh.device)
    _, pk, z, digest, compile_s = _mesh_circuit(g16, chain, seed)
    g16.prove_assigned(pk, z, random.Random(seed + 2), mesh=mesh)
    kernels = _mesh_kernels()
    for k in kernels:
        k.reset()
    proof, ms = _sync_ms(lambda: g16.prove_assigned(pk, z, random.Random(seed + 2), mesh=mesh))
    launches = {k.name: k.launches for k in kernels}
    laps = g16.laps["prove"]
    jobs = None
    if record:
        again = lambda: g16.prove_assigned(pk, z, random.Random(seed + 2), mesh=mesh)  # noqa: E731
        if mesh.rank == mesh.size - 1:
            jobs = _record_msm_jobs(again)
        else:
            again()
    return dict(proof=proof.to_bytes(BN254), verify=g16.verify(pk.vk, [digest], proof),
                fuzzed=g16.verify(pk.vk, [(digest + 1) % BN254.r], proof), launches=launches, ms=ms,
                compile_s=compile_s, laps=laps, backend=mesh.backend, size=mesh.size, jobs=jobs)


def _mesh_shard_checks(results, jobs, dev, reps: int = 10):
    """K9, K3's lifted scan, K3 and K4 against their plain versions on the
    MSM jobs one rank's shard gave the bucket pipeline in the mesh prove
    (`_record_msm_jobs`): each MSM's fold and the scan of its chunk totals,
    then per curve and operation the widest K3 and K4 call of its
    pipeline, with the rows that take the group law counted from the data."""
    import torch

    from openzl_tpu_torch.curves import jacobian as jac
    from openzl_tpu_torch.ops import ec_kernel, msm
    from openzl_tpu_torch.proof_systems import BN254

    curves = {c.name: c for c in (BN254.g1, BN254.g2)}
    widest = {}
    real_add, real_dbl = ec_kernel.ec_add, ec_kernel.ec_dbl

    def keep(curve, op, *coords):
        n = coords[0][2].numel() // (curve.base.n_limbs * curve.ext)
        if n > widest.get((curve.name, op), (0,))[0]:
            widest[curve.name, op] = (n, curve, *(tuple(t.clone() for t in c) for c in coords))

    def add(curve, P, Q, mixed=False):
        keep(curve, "madd" if mixed else "add", P, Q)
        return real_add(curve, P, Q, mixed)

    def dbl(curve, P):
        keep(curve, "dbl", P)
        return real_dbl(curve, P)

    for name, raw, wb, nb in jobs:
        curve = curves[name]
        tjobs = [(torch.as_tensor(s, device=dev), jac.JPoint(*(torch.as_tensor(v, device=dev) for v in p)))
                 for s, p in raw]
        tag = f"{name} MSM of one rank's shard ({len(raw)} x {tjobs[0][0].shape[1]} points)"
        pts, keys, pidx, r, c, W = msm.fold_inputs(curve, tjobs, wb, nb)
        S = len(raw)
        _fold_check(tag, results, curve, (pts, keys, pidx, r, c, S * W), dev, reps)
        totals, tflag = ec_kernel.fold_madd(curve, pts, keys, pidx, r, (S * W << c) + 1)[:2]
        _scan_check(f"{tag}, its chunk totals", results, curve, totals, tflag, dev, reps)
        ec_kernel.ec_add, ec_kernel.ec_dbl = add, dbl
        try:
            msm.msm_sets(curve, tjobs, wb, nb)
        finally:
            ec_kernel.ec_add, ec_kernel.ec_dbl = real_add, real_dbl
    for (name, op), (n, curve, P, *Q) in sorted(widest.items()):
        F = jac.field_ops(curve)
        live = ~F.is_zero(P[2])
        doubled = 0
        if Q:
            live = live & ~F.is_zero(Q[0][2])
            a, b = jac.normalize(curve, jac.JPoint(*P)), jac.normalize(curve, jac.JPoint(*Q[0]))
            same = [(u == v).flatten(0, F.value_ndim - 1).all(0) for u, v in ((a.x, b.x), (a.y, b.y))]
            doubled = int((live & same[0] & same[1]).sum())
        mixed = op == "madd"
        if Q:
            kern = lambda P=P, Q=Q[0], mixed=mixed: ec_kernel.ec_add(curve, P, Q, mixed)  # noqa: E731
            plain = lambda P=P, Q=Q[0], mixed=mixed: ec_kernel.ec_add_plain(curve, P, Q, mixed)  # noqa: E731
        else:
            kern = lambda P=P: ec_kernel.ec_dbl(curve, P)  # noqa: E731
            plain = lambda P=P: ec_kernel.ec_dbl_plain(curve, *P)  # noqa: E731
        nlive = int(live.sum())
        _ec_case(results, curve, "ec_dbl" if op == "dbl" else "ec_add", op, kern, plain, n, nlive, doubled,
                 f"{name} {op} (n={n}, {nlive} live, {doubled} doubled): the widest of one rank's MSMs", dev, reps)


def _mesh_checks(results, dev, rng):
    """K1, K2 and K8 against their plain versions at the shapes the sharded
    transform of 2^17 points over 4 ranks gives them: the 2^15-point
    sub-transform's levels (with the coset and 1/N scales), its twiddle
    product, and the 4-point sub-transforms batched over 2^13 columns; K5
    and K6 at a rank's 2^14 states of the sharded hash of 2^16."""
    from openzl_tpu_torch.crypto.poseidon.permutation import Poseidon
    from openzl_tpu_torch.fields.spec import BN254_FR
    from openzl_tpu_torch.ops import ntt, ntt_kernel, poseidon_kernel
    from openzl_tpu_torch.proof_systems import BN254

    spec = BN254.g1.scalar
    _level_checks(spec, 15, 1, rng, dev, results, scales=True)
    a, b = _rand_field(spec, 1 << 15, rng, dev), _rand_field(spec, 1 << 15, rng, dev)
    ms = _time(lambda: ntt_kernel.mont_mul(spec, a, b), 50, dev)
    pms = _time(lambda: ntt_kernel.mont_mul_plain(spec, a, b), 3, dev)
    _check("mont_mul", results, [ntt_kernel.mont_mul(spec, a, b)], [ntt_kernel.mont_mul_plain(spec, a, b)], ms, pms,
           "bn254_fr mul (n=32768, the sharded transform's twiddle)",
           (_mont_words(16, 1 << 15), 3 * (1 << 15) * 16 * 4), lambda: ntt_kernel.mont_mul(spec, a, b))
    N, batch = 4, 1 << 13
    for inverse in (False, True):
        rev, table, n_inv = ntt._plan(spec, 2, inverse, dev)
        x = _rand_field(spec, N * batch, rng, dev).reshape(spec.n_limbs, N, batch).contiguous()

        def kern(x=x, table=table, rev=rev, n_inv=n_inv, inverse=inverse):
            return ntt_kernel.transform(spec, x, table, rev, n_inv, inverse)

        products = batch * (N // 2 * 2 - (N - 1) + (N if inverse else 0))
        exp = ntt_kernel.transform_plain(spec, x, table, rev, n_inv, inverse)
        pms = _time(lambda: ntt_kernel.transform_plain(spec, x, table, rev, n_inv, inverse), 3, dev)
        _check("butterfly", results, [kern()], [exp], _time(kern, 50, dev), pms,
               f"{spec.name} transform 2^2 ({'inverse' if inverse else 'forward'}, batch {batch}, the sharded "
               "transform's 4-point sub-transforms)",
               (_mont_words(spec.n_limbs, products), 2 * batch * N * spec.n_limbs * 4), kern,
               ("ntt_transform_kernel", (8,)))
    B = 1 << 14
    perm = Poseidon.create(BN254_FR, 2, device=dev)
    x = _rand_states(BN254_FR, B, rng, dev)
    for name, kern, plain in (
        ("poseidon_permute", lambda: poseidon_kernel.permute(perm, x), lambda: poseidon_kernel.permute_plain(perm, x)),
        ("poseidon_permute_opt", lambda: poseidon_kernel.permute_optimized(perm, x),
         lambda: poseidon_kernel.permute_optimized_plain(perm, x)),
    ):
        words = _perm_words(name, perm)
        _check(name, results, [kern()], [plain()], _time(kern, 20, dev), _time(plain, 1, dev),
               f"bn254_fr width 3 (B={B}, a rank's share of the sharded hash of 2^16)",
               (B * words, 2 * x.numel() * 4), kern, WIDTH3_PTXAS[name])


def phase_mesh(device="cuda", log_m: int = 16, log_n: int = 17, log_b: int = 16,
               chain: int = 512, seed: int = 13, timeout: float = 420.0):
    """Phase 9: `parallel/` on torch.distributed. `MESH_RANKS` gloo ranks
    share the card (their collectives through host memory) and run the sharded
    MSMs (G1 and G2 at 2^log_m - 3 points, a 3-rank sub-mesh, three sets),
    the four sharded transforms at 2^log_n, the sharded Poseidon hash of
    2^log_b states and `Groth16(BN254).prove_assigned(..., mesh=...)` of
    the `chain`-link slice; each is held against the same call on one
    device here (MSMs as affine points, transforms and digests bit-exact,
    proofs byte for byte on every rank), and the last rank's MSM inputs in
    the mesh prove are held against the plain kernels here
    (`_mesh_shard_checks`). Then the prove on a 1-rank NCCL
    mesh, on an NCCL mesh of one rank a GPU where there are two GPUs or
    more, and the staged prove (`offload_queries`). Returns (the kernel
    checks, each rank's launches on the mesh prove, the K5/K6 launches of
    the sharded hash, the phase's record)."""
    import tempfile

    import torch

    from openzl_tpu_torch.crypto.poseidon.permutation import Poseidon
    from openzl_tpu_torch.curves import jacobian as jac
    from openzl_tpu_torch.fields.spec import BN254_FR
    from openzl_tpu_torch.ops import msm, ntt
    from openzl_tpu_torch.parallel.launch import RankPool
    from openzl_tpu_torch.proof_systems import BN254, Groth16

    t_phase = time.perf_counter()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    rng = random.Random(seed)
    results, record = {}, {}
    if cuda:
        _mesh_checks(results, dev, rng)
    where = "on one card, over host memory" if cuda else "on the CPU"
    store = tempfile.mkdtemp(prefix="ozl_mesh_")

    def one(fn):
        fn()
        return _sync_ms(fn)

    def compare(tag, got, want, ms_mesh, ms_one, backend="gloo"):
        """Each member rank's result equals one device's; the ranks' wall
        ms beside one device's, labelled with the backend."""
        bad = [r for r, g in enumerate(got) if g is not None and g != want]
        k = sum(g is not None for g in got)
        label = f"gloo, {k} ranks {where}" if backend == "gloo" else backend
        log(f"[mesh] {tag}: {ms_mesh} ms ({label}) against {ms_one:.1f} ms on one device; "
            + ("equal on every rank" if not bad else f"DIFFERS on ranks {bad}"))
        if bad:
            fail(f"[mesh] {tag} differs from one device on ranks {bad}")
        record[tag] = {"mesh_ms": ms_mesh, "one_device_ms": ms_one}

    ranks = MESH_RANKS
    t0 = time.perf_counter()
    with RankPool(ranks, "gloo", store, devices=[str(dev)] * ranks, timeout=timeout) as pool:
        log(f"[mesh] {ranks} gloo ranks on {dev} up in {time.perf_counter() - t0:.1f} s")
        n = (1 << log_m) - 3
        for group, sub in (("g1", ranks), ("g2", ranks), ("g1", ranks - 1)):
            curve = getattr(BN254, group)
            scal, pts = _mesh_points(curve, n, seed, dev)
            want, ms_one = one(lambda: msm.msm(curve, scal, pts))
            got = pool.run(_mesh_msm_task, sub, group, log_m, seed, 0, str(dev))
            compare(f"sharded_msm {curve.name} n={n} over {sub} ranks", [g and g[0] for g in got],
                    jac.to_affine_ints(curve, want), [round(g[1], 1) for g in got if g], ms_one)
        scal, first = _mesh_points(BN254.g1, n, seed, dev)
        sets = [first] + [_mesh_points(BN254.g1, n, seed + s, dev)[1] for s in (1, 2)]
        want, ms_one = one(lambda: msm.msm_multi(BN254.g1, scal, sets))
        got = pool.run(_mesh_msm_task, ranks, "g1", log_m, seed, 3, str(dev))
        compare(f"sharded_msm_multi bn254_g1 3 sets n={n}", [g and g[0] for g in got],
                [jac.to_affine_ints(BN254.g1, w) for w in want], [round(g[1], 1) for g in got], ms_one)

        x = _rand_field(BN254_FR, 1 << log_n, random.Random(seed), dev)
        got = pool.run(_mesh_transform_task, ranks, log_n, seed, str(dev))
        for name in ("ntt", "intt", "coset_ntt", "coset_intt"):
            fn = getattr(ntt, name)
            y, ms_one = one(lambda: fn(BN254_FR, x))
            compare(f"sharded_{name} 2^{log_n}", [g[name][0] for g in got], _digest(y),
                    [round(g[name][1], 2) for g in got], ms_one)

        perm = Poseidon.create(BN254_FR, 2, device=dev)
        states = _rand_field(BN254_FR, 2 << log_b, random.Random(seed), dev).reshape(BN254_FR.n_limbs, 2, 1 << log_b)
        y, ms_one = one(lambda: perm.hash(states))
        got = pool.run(_mesh_poseidon_task, ranks, log_b, seed, str(dev))
        compare(f"sharded_poseidon_hash width 3, 2^{log_b} states", [g[0] for g in got], _digest(y),
                [round(g[1], 2) for g in got], ms_one)
        hash_launches = [g[2] for g in got]
        log(f"[mesh] each rank's K5 / K6 launches in the sharded hash: {hash_launches}")
        if cuda and not all(h["poseidon_permute"] + h["poseidon_permute_opt"] for h in hash_launches):
            fail("[mesh] the sharded hash launched no Poseidon kernel on some rank")

        g16 = Groth16(BN254, dev)
        cs, pk, z, digest, compile_s = _mesh_circuit(g16, chain, seed)
        proof, ms_one = one(lambda: g16.prove_assigned(pk, z, random.Random(seed + 2)))
        want = proof.to_bytes(BN254)
        if not g16.verify(pk.vk, [digest], proof):
            fail("[mesh] the one-device proof did not verify")
        log(f"[mesh] {chain} links, {cs.num_constraints} constraints, domain 2^{pk.domain_log2}: compile "
            f"{compile_s:.1f} s, one-device prove {ms_one:.1f} ms")
        got = pool.run(_mesh_prove_task, ranks, chain, seed, str(dev), True)
    mesh_launches = [g["launches"] for g in got]
    jobs = got[-1].pop("jobs")
    log(f"[mesh] the last rank's MSM jobs in the mesh prove: " + "; ".join(
        f"{name} {len(raw)} x {raw[0][0].shape[1]} points" for name, raw, _, _ in jobs))
    _mesh_shard_checks(results, jobs, dev)
    del jobs

    def check_prove(tag, got, backend="gloo", skip=()):
        """Every rank's proof verifies, rejects a fuzzed input, equals the
        one-device bytes, and launched every mesh kernel but `skip`."""
        for r, g in enumerate(got):
            log(f"[mesh] {tag} rank {r}: prove {g['ms']:.1f} ms (compile {g['compile_s']:.1f} s), verify "
                f"{g['verify']}, fuzzed input accepted {g['fuzzed']}; launches {g['launches']}; laps "
                + ", ".join(f"{k} {v:.1f} ms" for k, v in g["laps"]))
            if not g["verify"] or g["fuzzed"]:
                fail(f"[mesh] {tag} rank {r}: the proof did not verify, or a fuzzed input passed")
            missing = [k for k, v in g["launches"].items() if not v and k not in skip]
            if cuda and missing:
                fail(f"[mesh] {tag} rank {r}: kernels never launched on the mesh prove: {missing}")
        compare(f"Groth16 prove {tag}", [g["proof"] for g in got], want, [round(g["ms"], 1) for g in got], ms_one,
                backend)

    check_prove(f"{ranks} gloo ranks", got)
    if cuda:
        with RankPool(1, "nccl", store, devices=[str(dev)], timeout=timeout) as pool:
            got = pool.run(_mesh_prove_task, 1, chain, seed, str(dev))
        log("[mesh] a 1-rank NCCL mesh: " + json.dumps({k: got[0][k] for k in ("backend", "size", "ms")}))
        # one rank: R = 1, so no 4-point sub-transforms and no K8
        check_prove("1 NCCL rank", got, "NCCL, 1 rank on one card", skip=("butterfly",))
        record["nccl_1_launches"] = got[0]["launches"]
        gpus = torch.cuda.device_count()
        if gpus >= 2:
            k = min(4, gpus)
            with RankPool(k, "nccl", store, devices=[f"cuda:{i}" for i in range(k)], timeout=timeout) as pool:
                got = pool.run(_mesh_prove_task, k, chain, seed, "cuda")
            check_prove(f"{k} NCCL ranks", got, f"NCCL, {k} ranks, one a GPU")
            record["nccl_gpus"] = k
        else:
            log(f"[mesh] NCCL across GPUs: skipped, this machine has {gpus} GPU")
            record["nccl_gpus"] = None

    # the staged prover: the queries on the host, one staged per MSM
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0
    _, ms_unstaged = _sync_ms(lambda: g16.prove_assigned(pk, z, random.Random(seed + 2)))
    peak_unstaged = torch.cuda.max_memory_allocated() if cuda else 0
    staged = pk.offload_queries()
    del pk
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    base_staged = torch.cuda.memory_allocated() if cuda else 0
    srng = random.Random(seed + 2)
    proof, ms_staged = _sync_ms(lambda: g16.prove_assigned(staged, z, srng))
    peak_staged = torch.cuda.max_memory_allocated() if cuda else 0
    if not staged.staged or proof.to_bytes(BN254) != want:
        fail("[mesh] the staged proof differs from the unstaged one")
    again = g16.prove_assigned(staged, z, srng)
    if not g16.verify(staged.vk, [digest], again) or g16.verify(staged.vk, [(digest + 1) % BN254.r], again):
        fail("[mesh] the second staged proof did not verify, or a fuzzed input passed")
    log(f"[mesh] staged prove: {ms_staged:.1f} ms, peak device memory {peak_staged / 2**20:.1f} MiB "
        f"({base_staged / 2**20:.1f} MiB held before it); unstaged {ms_unstaged:.1f} ms, peak "
        f"{peak_unstaged / 2**20:.1f} MiB ({base / 2**20:.1f} MiB held before it, the key's tables among them); "
        "the staged proof byte-identical, a second staged proof verified")
    record["staged"] = {"ms": ms_staged, "peak_mib": peak_staged / 2**20, "held_mib": base_staged / 2**20}
    record["unstaged"] = {"ms": ms_unstaged, "peak_mib": peak_unstaged / 2**20, "held_mib": base / 2**20}
    record["wall_s"] = time.perf_counter() - t_phase
    log(f"[mesh] phase 9 wall {record['wall_s']:.1f} s")
    return results, mesh_launches, hash_launches, record


def transforms_of(root: pathlib.Path, reps: int = 20, seed: int = 7) -> None:
    """Phase 7's whole four-step transforms alone (`_fourstep_runs`, BN254
    Fr at 2^17, batch 1 and 3, and 2^20) of the port in checkout `root`,
    so that two commits are timed on one card in one call (parent, change,
    change, parent); the launches are printed, not checked. Prints the
    rows as one JSON line and no contract line."""
    if not (root / "openzl_tpu_torch").is_dir():
        fail(f"{root} holds no openzl_tpu_torch")
    sys.path.insert(0, str(root))
    _, smi = phase_device()

    import torch

    import openzl_tpu_torch
    from openzl_tpu_torch.fields.spec import BN254_FR

    if pathlib.Path(openzl_tpu_torch.__file__).resolve().parents[1] != root:
        fail(f"imported {openzl_tpu_torch.__file__}, not the port under {root}")
    rng, dev, rows = random.Random(seed), torch.device("cuda"), []
    for log_n, batch in ((17, 1), (17, 3), (20, 1)):
        rows += _fourstep_runs(BN254_FR, log_n, batch, rng, dev, reps, check_launches=False)
    log(json.dumps({"root": str(root), "device": smi, "transforms": [dict(zip(TRANSFORM_KEYS, r)) for r in rows]}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--chain", type=int, default=512, help="Poseidon chain links of the slices")
    ap.add_argument("--proofs", type=int, default=3, help="prove requests answered")
    ap.add_argument("--signatures", type=int, default=16,
                    help="Schnorr verification circuits in phase 8's BN254 proof")
    ap.add_argument("--transforms-of", metavar="DIR",
                    help="only time phase 7's whole four-step transforms of the port in checkout DIR")
    args = ap.parse_args()

    if args.transforms_of:
        transforms_of(pathlib.Path(args.transforms_of).resolve())
        return
    if not (ROOT / "openzl_tpu_torch").is_dir():
        fail("run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    name, smi = phase_device()
    ptxas, latency = phase_build()

    import torch

    from openzl_tpu_torch.ops import ec_kernel, ntt_kernel, poseidon2_kernel, poseidon_kernel
    from openzl_tpu_torch.proof_systems import BLS12_381

    groth16_kernels = [ntt_kernel.K1, ntt_kernel.K1P, ntt_kernel.K2, ec_kernel.K3, ec_kernel.K4, ec_kernel.K9,
                       ec_kernel.K3S]
    hash_kernels = [poseidon_kernel.K5, poseidon_kernel.K6, poseidon2_kernel.K7]
    kzg_kernels = [ntt_kernel.K8]
    kernels = [*groth16_kernels[:5], *hash_kernels, ntt_kernel.K8, ec_kernel.K9, ec_kernel.K3S]
    results = phase_kernels(latency=latency)
    bls = phase_kernels_bls()  # the BLS12-381 (24-limb) runs of K3, K4, K9 and the scan
    phase_roundtrip()
    launches, _, b2_fold, scans = phase_slice(args.chain, args.proofs, kernels, groth16_kernels)
    _merge(results, phase_scan(scans))
    del scans  # the request's chunk totals (86 MB at 512 links) stay out of the later phases' peaks
    bls_launches, _, bls_b2_fold, scans = phase_slice(args.chain, args.proofs, kernels, groth16_kernels, default=True)
    _merge(bls, phase_scan(scans, seed=6))
    del scans
    hash_results, hash_launches = phase_hash(kernels)
    _merge(results, hash_results)
    launches = {**launches, **{k.name: hash_launches[k.name] for k in hash_kernels}}
    missing = [k.name for k in hash_kernels if hash_launches[k.name] == 0]
    if missing:
        fail(f"kernels never launched on the hash slice: {missing}")
    width_results, width_launches = phase_widths(kernels)
    kzg_results, kzg_launches = phase_kzg(kernels, b2_fold)
    _merge(results, kzg_results)
    launches.update({k.name: kzg_launches[k.name] for k in kzg_kernels})
    # BLS12-381 KZG at the EIP-4844 blob size (4096 coefficients)
    bls_kzg, bls_kzg_launches = phase_kzg(kernels, bls_b2_fold, log_d=12, log_big=0, seed=8, pairing=BLS12_381)
    _merge(bls, {k: v for k, v in bls_kzg.items() if k in EC_KERNELS})
    gadgets = phase_gadgets(kernels, groth16_kernels, signatures=args.signatures)
    log("[gadgets] " + json.dumps(gadgets))
    mesh_results, mesh_launches, mesh_hash_launches, mesh_record = phase_mesh(chain=args.chain)
    _merge(results, mesh_results)
    log("[mesh] " + json.dumps(mesh_record))

    # bound: the larger of the word products over the card's 32-bit integer
    # multiply rate (64 multiply issues per clock per SM, two per 32x32->64
    # product, at the highest SM clock) and the bytes over 3.35 TB/s (H100
    # SXM HBM3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    products_per_s = 64 * sms * clock_mhz * 1e6 / 2
    log(f"[bound] {sms} SMs at {clock_mhz:.0f} MHz: {products_per_s:.4g} word products/s; 3.35e12 B/s")

    def bound(work):
        """(ms, "operations" or "bytes") of `work`; a third item, the
        latency of K1's exponentiation chain (`_pow_work`), bounds its
        operations too"""
        t_ops, t_bytes = work[0] / products_per_s * 1e3, work[1] / 3.35e12 * 1e3
        if len(work) > 2 and work[2] is not None:
            t_ops = max(t_ops, work[2])
        return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

    # the repo's TPU experiments, which no path of either package runs
    # (PERF.md rows #12-#14): #12 computes K5's function at B = 2^16 (K5's
    # bound above); #13 and #14 move uint32 arrays, each read and written once
    for label, shape in (("#13 experiments/rowshuffle_probe.py kernel", (16, 64, 128)),
                         ("#13 experiments/rowshuffle_probe.py tiny", (16, 1024, 128)),
                         ("#14 experiments/dif_probe.py kernel_A, kernel_C", (4, 512, 128))):
        moved = 2 * 4 * shape[0] * shape[1] * shape[2]
        log(f"[bound] {label} on {shape}: {moved} bytes, bound {bound((0, moved))[0]:.6f} ms (bytes)")
    for runs in (results, bls, width_results):
        for kname, entries in runs.items():
            for _, ms, _, work, shape, dms, _ in entries:
                b_ms, b_by = bound(work)
                dev = f", {b_ms / dms:.1%} of its device time {dms:.4f} ms" if dms else ""
                log(f"[bound] {kname} {shape}: bound {b_ms:.4f} ms ({b_by}), kernel {ms:.4f} ms, "
                    f"{b_ms / ms:.1%} of the bound{dev}")
    from openzl_tpu_torch.utils import profile as prof

    log(f"[profile] device times: {prof.DEVICE_MS_PROFILES['taken']} profiles, "
        f"{prof.DEVICE_MS_PROFILES['lost']} of them lost a kernel record (profiled again)")
    for (field, w), runs in PERM_RUNS.items():
        if {"poseidon_permute", "poseidon_permute_opt"} <= runs.keys():
            (k5, work5), (k6, work6) = runs["poseidon_permute"], runs["poseidon_permute_opt"]
            b5, b6 = bound(work5)[0], bound(work6)[0]
            log(f"[bound] K6 against K5, {field} width {w}: K6 {k6:.4f} ms, {b6 / k6:.1%} of its bound "
                f"{b6:.4f} ms; K5 {k5:.4f} ms, {b5 / k5:.1%} of {b5:.4f} ms; K6 / K5 {k6 / k5:.3f}")

    for (field, w), (ms, dms, work) in K7_LINEAR.items():
        b_lin = bound(work)[0]
        b_prod = bound(PERM_RUNS[field, w]["poseidon2_permute"][1])[0]
        dev = f", device {dms:.4f} ms ({b_prod / dms:.1%} / {b_lin / dms:.1%})" if dms else ""
        log(f"[bound] K7 {field} width {w}: products-only bound {b_prod:.4f} ms, with the linear layers' least "
            f"additions {b_lin:.4f} ms; kernel {ms:.4f} ms, {b_prod / ms:.1%} / {b_lin / ms:.1%} of them{dev}")

    def ptx(key):
        """{kernel: {"registers": R, "spill_bytes": S}} of a run's ptxas key(s)."""
        keys = [] if key is None else [key] if isinstance(key, tuple) else key
        return {k[0]: dict(zip(("registers", "spill_bytes"), ptxas.get(k, (None, None)))) for k in keys}

    def run_row(run):
        err, ms, pms, work, shape, dms, key = run
        b_ms, b_by = bound(work)
        return {"shape": shape, "max_abs_err": err, "ms": ms, "device_ms": dms, "plain_ms": pms,
                "bound_ms": b_ms, "bound_by": b_by, "ptxas": ptx(key)}

    rows = []
    for k in kernels:
        runs = results[k.name]
        b_ms, b_by = bound(runs[0][3])
        row = {
            "name": k.name, "route": k.route, "source": k.source, "replaces": k.replaces,
            "launches": launches[k.name],
            "max_abs_err": max(r[0] for r in runs),
            "ms": runs[0][1], "plain_ms": runs[0][2],
            "bound_ms": b_ms, "bound_by": b_by,
            # no single PyTorch call computes a Montgomery product, an NTT
            # over a prime field, a radix-2 Montgomery butterfly, a group
            # law, a curve fold or a Poseidon permutation
            "library_ms": None,
        }
        if k.name in EC_KERNELS:
            # the 24-limb instantiations: launches on the BLS12-381 Groth16
            # slice (its proves) and KZG slice, and each run of phase 3b,
            # 5b (the BLS12-381 request's scans), 7b
            row["max_abs_err"] = max(row["max_abs_err"], *(r[0] for r in bls[k.name]))
            row["bls12_381"] = {"launches": bls_launches[k.name], "kzg_launches": bls_kzg_launches[k.name],
                                "runs": [run_row(r) for r in bls[k.name]]}
            row["bn254_ptxas"] = ptx(runs[0][6])
        elif runs[0][6] is not None:
            row["ptxas"] = ptx(runs[0][6])
        if k.name in ("mont_mul", "mont_pow", "small_ntt"):
            # each run (2^17 and narrow products; every exponentiation case;
            # every four-step level) with its device time
            row["runs"] = [run_row(r) for r in runs]
        if k.name == "small_ntt":
            # phase 7's whole transforms through the entry points
            row["transforms"] = [dict(zip(TRANSFORM_KEYS, r)) for r in FOURSTEP_RUNS]
        if k.name in ("mont_mul", "mont_pow"):
            # phase 8: launches in the batched Schnorr verification (b)
            row["gadgets_verify_launches"] = gadgets["verify"]["launches"][k.name]
        if k.name in gadgets["proof"]["launches"]:
            # phase 8: launches in the proves of the Schnorr proof (c) and
            # of the default Groth16's Jubjub proof (d)
            row["gadgets_proof_launches"] = {"bn254": gadgets["proof"]["launches"][k.name],
                                             "bls12_381": gadgets["default_proof"]["launches"][k.name]}
        # phase 9: each gloo rank's launches on the mesh prove (K5 and K6:
        # in the sharded hash)
        row["mesh_launches"] = [ml.get(k.name, 0) + hl.get(k.name, 0)
                                for ml, hl in zip(mesh_launches, mesh_hash_launches)]
        # phase 9's checks at the shapes the mesh path gives the kernel
        row["mesh_runs"] = [run_row(r) for r in mesh_results.get(k.name, [])]
        if k.name == "poseidon2_permute":
            # the bound that also counts the linear layers' least additions
            row["bound_with_additions_ms"] = bound(K7_LINEAR["bn254_fr", 3][2])[0]
        if k.name in width_results:
            # phase 6b: each other state width's run, and the launches by
            # state width through the entry points
            row["max_abs_err"] = max(row["max_abs_err"], *(r[0] for r in width_results[k.name]))
            row["widths"] = {"launches": width_launches[k.name],
                             "runs": [run_row(r) for r in width_results[k.name]]}
        rows.append(row)
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))

if __name__ == "__main__":
    main()
