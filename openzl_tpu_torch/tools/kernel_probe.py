"""Measurements behind K2's, K3's, K4's, K5's, K7's, K8's and K9's design choices, on one GPU.

    python3 -m openzl_tpu_torch.tools.kernel_probe [part ...]

Parts (all by default): microbench, k5, k9, k3, scan, k7, k8, k2. Prints, on
the card it runs on:
  * `field_microbench.cu` (built here with nvcc): latency and throughput of
    the F1 and F1c field operations and of one G1 mixed add, and K5's
    split rounds at 32, 64 and 128 threads a block; then the instruction
    mix of each of its kernels (`cuobjdump -sass`); then the latency of
    one F1 and one F1c product and square at 16 and 24 limbs
    (`product_latency`, which `chip_smoke.py` also runs for the bound of
    K1's exponentiation chain);
  * K5's two variants through the wrapper over batch sizes around the
    switch (`poseidon_kernel.SPLIT_MAX_B`);
  * K9 on the G1 fold of a 2^16-point KZG commit and a G2 fold of 120,323
    random points with 120-bit scalars: the point-major copy, the output
    initialisation, and builds of `csrc/fold_kernel.cu` with other block
    sizes and launch bounds, with the point reads straight from device
    memory instead of the cp.async ring, and without the tail stores
    (which gives wrong buckets: timing only). Each build is held against
    the shipped one (chunk totals; buckets too where the tail stores are
    kept);
  * K3 (add, madd) and K4 over G1 and G2 at 2^16 points, from builds of
    `csrc/ec_kernel.cu` with other launch bounds or the base field F1
    (its -D options), each held against the shipped build;
  * K3's lifted scan on the chunk totals of the two K9 folds above, at
    bounds of its Hillis-Steele levels (`ec_kernel.SCAN_NARROW`), with the
    device time of each kernel (torch.profiler), against the Hillis-Steele
    scan through K3 that it replaced (the same group elements; compared
    affine);
  * K7 (Poseidon2, width 3, BN254 Fr) through the wrapper at 2^12 to 2^18
    states: time per batch and permutations per second, which stay flat
    once the card is full when the kernel is bound by its issue;
    "queued" times here and in part k8 are CUDA events around calls queued
    behind a sleeping kernel (`_queued_ms`), the card's time without the
    host's launch cost;
  * K8's one-launch transform (BN254 Fr) at 2^4 to 2^12 points, batch 1,
    3 and 16, split over clusters of 1, 2, 4 and 8 blocks (each set in
    turn as `ntt_kernel.CLUSTER`'s entry), queued; the four-step route and
    the stage-a-launch route at 2^10 and 2^12 beside it;
  * K2's four-step level, queued, on F1c (BN254 Fr) and on F1 (a 16-limb
    prime past F1c's bound, at the same shapes): each level of the 2^17
    plan at batch 1 and 3 by threads a block (`ntt_kernel.LEVEL_THREADS`,
    which sets the lanes a block), each held against the shipped setting's
    output (and that against the plain version); a first level
    of 2^17 points, batch 3, by M = 2 to 512; and the whole 2^17 (batch 1
    and 3) and 2^20 transforms by `ntt_kernel.M_MAX` (64, 128, 512: 2^17
    splits into [6, 6, 5] under the first two and [9, 8] under 512, 2^20
    into [5, 5, 5, 5], [7, 7, 6] and [7, 7, 6]), the evidence for M_MAX.
Builds go to `build/kernel_probe/` beside the kernel library. Exits non-zero
without a card.
"""

from __future__ import annotations

import ctypes
import pathlib
import random
import re
import subprocess
import sys

import numpy as np
import torch

from ..curves import jacobian as jac
from ..curves.jacobian import JPoint
from ..fields import limb
from ..fields.spec import BN254_FR
from ..ops import ec_kernel, msm, poseidon_kernel
from ..crypto.poseidon.permutation import Poseidon
from ..proof_systems import BN254, KZG
from ..utils import build, profile

HERE = pathlib.Path(__file__).resolve().parent
OUT = build.BUILD_DIR.parent / "kernel_probe"

#: (threads a block, least blocks per SM over Fq, over Fq2); the first is
#: what fold_kernel.cu ships
FOLD_BOUNDS = [(128, 4, 2), (128, 3, 3), (64, 8, 4), (64, 6, 4), (32, 16, 8), (32, 12, 8)]
#: K3 and K4 builds of ec_kernel.cu: (least blocks per SM over Fq, over
#: Fq2, base field), passed as -D options; (2, 1, "F1c") is what it ships
EC_BUILDS = [(2, 1, "F1c"), (3, 2, "F1c"), (4, 2, "F1c"), (2, 1, "F1")]
#: bounds of the lifted scan's narrow levels swept (`ec_kernel.SCAN_NARROW`)
SCAN_NARROWS = [0, 4096, 16384, 32768]
PARTS = ("microbench", "k5", "k9", "k3", "scan", "k7", "k8", "k2")
DIRECT_SRC = """template <class T>
struct DirectRead {
  static constexpr int PW = 2 * (int)(sizeof(T) / sizeof(uint32_t));
  static constexpr int STRIDE = PW + 4;
  const uint32_t* pts;
  const uint32_t* p0 = nullptr;
  const uint32_t* p1 = nullptr;
  __device__ void fetch(int j, int64_t i) { (j & 1 ? p1 : p0) = pts + i * PW; }
  __device__ void commit() {}
  __device__ void wait() {}
  __device__ const T& x(int j) const { return *reinterpret_cast<const T*>(j & 1 ? p1 : p0); }
  __device__ const T& y(int j) const { return *reinterpret_cast<const T*>((j & 1 ? p1 : p0) + PW / 2); }
};

"""


def log(msg: str) -> None:
    print(msg, flush=True)


def _timed(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _ptxas(text: str) -> list:
    """(registers, spill store bytes) of each entry function in a -Xptxas -v log."""
    out = []
    for entry in re.split(r"Compiling entry function '", text)[1:]:
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores", entry)
        out.append((int(regs.group(1)) if regs else None, int(spill.group(1)) if spill else None))
    return out


def _fold_sources() -> dict:
    """name -> (fold_kernel.cu, fold.cuh, ec.cuh) texts of each K9 build to
    time (16 limbs: the builds compile fold_kernel.cu alone, with
    -DOZL_NO_W12)."""
    fold = (build.CSRC / "fold_kernel.cu").read_text()
    tmpl = (build.CSRC / "fold.cuh").read_text()
    ec = (build.CSRC / "ec.cuh").read_text()
    shipped = "constexpr int kThreads = 128;\nconstexpr int kMinBlocksG1 = 4;\nconstexpr int kMinBlocksG2 = 2;"
    if shipped not in fold:
        raise RuntimeError("fold_kernel.cu no longer ships 128 threads and 4 / 2 blocks per SM")
    builds = {}
    for t, g1, g2 in FOLD_BOUNDS:
        bounds = f"constexpr int kThreads = {t};\nconstexpr int kMinBlocksG1 = {g1};\nconstexpr int kMinBlocksG2 = {g2};"
        builds[f"{t} threads, {g1} / {g2} blocks per SM"] = (fold.replace(shipped, bounds), tmpl, ec)
    kernel = "template <class F, int THREADS, int MIN_BLOCKS>\n__global__"
    direct = tmpl.replace(kernel, DIRECT_SRC + kernel, 1).replace(
        "Src src{pts, ring + threadIdx.x * Src::STRIDE};", "DirectRead<T> src{pts};")
    no_tails = ec.replace("if (key != next) {  // segment tail", "if (false) {  // segment tail")
    builds["direct reads"] = (fold, direct, ec)
    builds["no tail stores"] = (fold, tmpl, no_tails)
    for name, texts in builds.items():
        if name != "128 threads, 4 / 2 blocks per SM" and texts == (fold, tmpl, ec):
            raise RuntimeError(f"the {name} build did not change the source")
    return builds


def _start_builds(parts):
    """Start nvcc for the microbenchmark and every K9 and K3 / K4 build
    that `parts` needs; returns the processes by name (the K3 / K4 builds
    under "k3: <name>") with their outputs."""
    nvcc = build._nvcc()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}

    def start(name, out, cmd):
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    if "microbench" in parts:
        procs["microbench"] = start_microbench()
    if "k9" in parts:
        for i, (name, (fold, tmpl, ec)) in enumerate(_fold_sources().items()):
            d = OUT / f"fold_{i}"
            d.mkdir(exist_ok=True)
            (d / "fold_kernel.cu").write_text(fold)
            (d / "fold.cuh").write_text(tmpl)
            (d / "ec.cuh").write_text(ec)
            so = d / "fold.so"
            start(name, so, [nvcc, *build.NVCC_FLAGS, "-DOZL_NO_W12", "-I", str(d), "-I", str(build.CSRC),
                             "-shared", "-o", str(so), str(d / "fold_kernel.cu")])
    if "k3" in parts:
        for i, (g1, g2, field) in enumerate(EC_BUILDS):
            so = OUT / f"ec_{i}.so"
            flags = [f"-DOZL_EC_MIN_BLOCKS_G1={g1}", f"-DOZL_EC_MIN_BLOCKS_G2={g2}", f"-DOZL_EC_BASE={field}",
                     "-DOZL_NO_W12"]
            start(f"k3: {field}, {g1} / {g2} blocks per SM", so,
                  [nvcc, *build.NVCC_FLAGS, *flags, "-I", str(build.CSRC), "-shared", "-o", str(so),
                   str(build.CSRC / "ec_kernel.cu")])
    return procs


def start_microbench():
    """Start nvcc for `field_microbench.cu`; returns (executable, process)."""
    OUT.mkdir(parents=True, exist_ok=True)
    exe = OUT / "field_microbench"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(exe), str(HERE / "field_microbench.cu")]
    return exe, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def product_latency(exe: pathlib.Path, specs=None) -> dict:
    """{(n_limbs, field, op): ns} on one warp of the card: a chain of 2000
    F1 / F1c ("F1", "F1c") products and squares ("mul", "sqr") over each
    of `specs` (BN254 Fq and BLS12-381 Fq by default: 16 and 24 limbs),
    from `field_microbench latency`."""
    from ..fields.spec import BLS12_381_FQ, BN254_FQ
    from ..ops.ntt_kernel import word_consts

    out = {}
    for spec in specs or (BN254_FQ, BLS12_381_FQ):
        words, n0 = word_consts(spec)
        args = [str(exe), "latency", str(len(words)), f"{n0:x}", *(f"{int(w):x}" for w in words)]
        text = subprocess.run(args, capture_output=True, text=True, check=True).stdout
        for field, op, ns in re.findall(r"\[latency\] NW=\d+ (\w+) (\w+): ([\d.]+) ns", text):
            out[spec.n_limbs, field, op] = float(ns)
    return out


def _finish(proc, name: str) -> str:
    text, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{text[-3000:]}")
    return text


def microbench(exe: pathlib.Path, report: str) -> None:
    log(f"[build] field_microbench (registers, spill bytes): {_ptxas(report)}")
    log(subprocess.run([str(exe)], capture_output=True, text=True, check=True).stdout.rstrip())
    for (n, field, op), ns in product_latency(exe).items():
        log(f"[latency] {n} limbs {field} {op}: {ns:.2f} ns on one warp")
    cuobjdump = pathlib.Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(exe)], capture_output=True, text=True, check=True).stdout
    for fn in re.split(r"\n\s+Function : ", sass)[1:]:
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", fn)
        mix = {}
        for op in ops:
            mix[op.split(".")[0]] = mix.get(op.split(".")[0], 0) + 1
        top = sorted(mix.items(), key=lambda kv: -kv[1])[:5]
        log(f"[sass] {fn.split(chr(10), 1)[0][:70]}: {len(ops)} instructions; "
            + ", ".join(f"{k} {v}" for k, v in top))


def _builds_in_turns(procs, part: str, entries, cases, reps: int) -> None:
    """Each build of `procs` named "<part>: <name>": its `entries` in place
    of the shipped library's, every case of `cases` ((name, fn)) held
    against the shipped build's result and timed by device ms per call
    over `reps` calls, twice, in turns (builds in order, then in reverse),
    so that a drift of the card's clock shows; one line per build."""
    want = [fn() for _, fn in cases]
    main = build.lib()
    libs = {}
    for name, (so, proc) in procs.items():
        if not name.startswith(f"{part}: "):
            continue
        regs = _ptxas(_finish(proc, name))
        lib = ctypes.CDLL(str(so))
        fns = {}
        for entry in entries:
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = build._SIGNATURES[entry], ctypes.c_int
            fns[entry] = fn
        libs[name[len(part) + 2:]] = (regs, fns)

    def same(a, b):
        return torch.equal(a, b) if isinstance(a, torch.Tensor) else all(map(torch.equal, a, b))

    times = {name: {case: [] for case, _ in cases} for name in libs}
    try:
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                build.lib = lambda fns=libs[name][1]: _With(main, **fns)
                for (case, fn), w in zip(cases, want):
                    if not same(fn(), w):
                        raise RuntimeError(f"the {name} build's {case} differs from the shipped build's")
                    times[name][case].append(_device_ms(fn, reps))
    finally:
        build.lib = lambda: main
    for name, (regs, _) in libs.items():
        log(f"[{part}] {name} (registers, spill bytes per entry function: {regs}): device ms per launch "
            + "; ".join(f"{case} {t[0]:.4f} / {t[1]:.4f}" for case, t in times[name].items()))


def k5_sweep(dev, rng) -> None:
    perm = Poseidon.create(BN254_FR, 2, device=dev)
    p = BN254_FR.modulus
    sizes = (32, 2048, 8192, 9216, 10240, 11264, 12288, 16896, 1 << 16)
    x = limb.tensor(limb.pack_mont(BN254_FR, np.array([[rng.randrange(p) for _ in range(sizes[-1])]
                                                        for _ in range(3)], dtype=object)), dev)
    for B in sizes:
        xb = x[:, :, :B].contiguous()
        wide, split = (poseidon_kernel.permute(perm, xb, w) for w in poseidon_kernel.VARIANTS)
        if not torch.equal(wide, split):
            raise RuntimeError(f"K5 variants disagree at B={B}")
        times = [_timed(lambda w=w: poseidon_kernel.permute(perm, xb, w), 20) for w in poseidon_kernel.VARIANTS]
        log(f"[k5] B={B}: wide {times[0]:.4f} ms, split {times[1]:.4f} ms; the wrapper picks "
            f"{poseidon_kernel.variant(B)}")


class _With:
    """The kernel library with some entry points from another build."""

    def __init__(self, main, **fns):
        self.main = main
        self.__dict__.update(fns)

    def __getattr__(self, name):
        return getattr(self.main, name)


def _fold_cases(dev, rng):
    """The fold arguments of the G1 fold of a 2^16-point KZG commit and a G2
    fold of 120,323 random points with 120-bit scalars."""
    g1, g2 = BN254.g1, BN254.g2
    params = KZG(BN254, backend="device", device=dev).setup((1 << 16) - 1, random.Random(7))
    s1 = limb.tensor(limb.pack(g1.scalar, [rng.randrange(g1.scalar.modulus) for _ in range(1 << 16)]), dev)
    n2 = 120323
    base = jac.normalize(g2, msm.fixed_base_msm(g2, limb.tensor(limb.pack(
        g2.scalar, [rng.randrange(1, g2.scalar.modulus) for _ in range(64)]), dev)))
    pick = [torch.as_tensor(np.random.default_rng(s).integers(0, 64, n2), device=dev) for s in (1, 2)]
    P2 = jac.add(g2, jac.take(base, pick[0]), jac.take(base, pick[1]))
    s2 = limb.tensor(limb.pack(g2.scalar, [rng.randrange(1 << 120) for _ in range(n2)]), dev)
    cases = []
    for name, curve, job in (("G1 commit of 2^16", g1, (s1, params.powers_g1)), (f"G2 of {n2} points", g2, (s2, P2))):
        pts, keys, pidx, r, c, W = msm.fold_inputs(curve, [job])
        cases.append((name, curve, (curve, pts, keys, pidx, r, (W << c) + 1)))
    return cases


def k9_builds(procs, cases, dev) -> None:
    timed = []
    for name, curve, args in cases:
        _, pts, keys, _, r, width = args
        want = ec_kernel.fold_madd(*args)
        reps = 20 if curve is BN254.g1 else 5
        copy = _timed(lambda: ec_kernel.point_words(curve, pts), reps)
        init = _timed(lambda: ec_kernel._fold_outputs(curve, keys.numel() // r, width, dev), reps)
        fold = [_timed(lambda: ec_kernel.fold_madd(*args), reps) for _ in range(2)]
        log(f"[k9] {name}: {keys.numel()} entries, r={r}; shipped build {fold[0]:.4f} / {fold[1]:.4f} ms "
            f"(of which the point-major copy {copy:.4f} ms, the output initialisation {init:.4f} ms)")
        timed.append((name, args, want, reps))
    cases = timed
    main = build.lib()
    flat = lambda o: [*o[0], o[1], *o[2], o[3], o[4]]
    try:
        for name, (so, proc) in procs.items():
            if name == "microbench" or name.startswith("k3: "):
                continue
            regs = _ptxas(_finish(proc, name))
            lib = ctypes.CDLL(str(so))
            fn = lib.ozl_fold_madd
            fn.argtypes, fn.restype = build._SIGNATURES["ozl_fold_madd"], ctypes.c_int
            build.lib = lambda fn=fn: _With(main, ozl_fold_madd=fn)
            cols = []
            for case, args, want, reps in cases:
                got = ec_kernel.fold_madd(*args)
                n = 4 if name == "no tail stores" else 9
                same = all(torch.equal(a, b) for a, b in zip(flat(got)[:n], flat(want)[:n]))
                t = [_timed(lambda: ec_kernel.fold_madd(*args), reps) for _ in range(2)]
                cols.append(f"{case} {t[0]:.4f} / {t[1]:.4f} ms{'' if same else ' DIFFERS'}")
            log(f"[k9] {name} (registers, spill bytes: Fq2 then Fq {regs}): " + "; ".join(cols))
    finally:
        build.lib = lambda: main


def _ec_points(curve, n, dev, seed):
    """(P Jacobian with random Z, Q Jacobian, Q normalized): sums of random
    pairs of 64 fixed-base multiples, with rows where P = Q and P = -Q."""
    rng = random.Random(seed)
    base = jac.normalize(curve, msm.fixed_base_msm(curve, limb.tensor(limb.pack(
        curve.scalar, [rng.randrange(1, curve.scalar.modulus) for _ in range(64)]), dev)))
    npr = np.random.default_rng(seed)
    pick = [torch.as_tensor(npr.integers(0, 64, n), device=dev) for _ in range(4)]
    P = jac.add(curve, jac.take(base, pick[0]), jac.double(curve, jac.take(base, pick[1])))
    Q = jac.add(curve, jac.take(base, pick[2]), jac.take(base, pick[3]))
    Q = JPoint(*(torch.cat([a[..., :256], b[..., 256:]], dim=-1) for a, b in zip(P, Q)))
    Q = jac.select(torch.arange(n, device=dev) % 1000 == 999, jac.negate(curve, P), Q)
    return P, Q, jac.normalize(curve, Q)


def _device_ms(fn, reps: int) -> float:
    """Device time per call of fn (`profile.device_ms`: the sum of its
    kernels' durations over reps calls, divided by reps): the launch's
    host cost, which is of the order of a G1 kernel's own time, is left
    out. Raises when every profile lost a kernel record."""
    ms = profile.device_ms(fn, reps)
    if ms is None:
        raise RuntimeError("torch.profiler lost kernel records in every try")
    return ms


def k3_builds(procs, dev) -> None:
    """K3 add and madd and K4 over G1 and G2 at 2^16 points, every build
    (`_builds_in_turns`)."""
    n = 1 << 16
    cases = []
    for curve in (BN254.g1, BN254.g2):
        P, Q, Qa = _ec_points(curve, n, dev, 5)
        cases += [
            (f"{curve.name} add", lambda c=curve, P=P, Q=Q: ec_kernel.ec_add(c, tuple(P), tuple(Q))),
            (f"{curve.name} madd", lambda c=curve, P=P, Qa=Qa: ec_kernel.ec_add(c, tuple(P), tuple(Qa), True)),
            (f"{curve.name} dbl", lambda c=curve, P=P: ec_kernel.ec_dbl(c, tuple(P))),
        ]
    _builds_in_turns(procs, "k3", ("ozl_ec_add", "ozl_ec_dbl"), cases, 20)


def _inverse_mod(m, p):
    """The inverse of the square matrix m (lists of ints) over F_p."""
    n = len(m)
    a = [[*row, *(int(i == j) for j in range(n))] for i, row in enumerate(m)]
    for c in range(n):
        piv = next(r for r in range(c, n) if a[r][c])
        a[c], a[piv] = a[piv], a[c]
        inv = pow(a[c][c], -1, p)
        a[c] = [v * inv % p for v in a[c]]
        for r in range(n):
            if r != c and a[r][c]:
                f = a[r][c]
                a[r] = [(v - f * u) % p for v, u in zip(a[r], a[c])]
    return [row[n:] for row in a]


def directed_state(perm):
    """The state that gives K5's last MDS product, whose rows are the
    output, its largest inputs: after the last round's keys and S-box every
    element's Montgomery word is p - 1 (found by running the rounds
    backwards). Returns (its field elements, the largest row sum T that
    product then meets, over the most a row summed whole and reduced once
    could take). `F1c::redc` reads 2 NW words of T and subtracts p at most
    twice, and the row's final addition once more, so such a row is exact
    only while T < min(R^2, 3 p R); `mac_group`'s groups keep every T below
    K p^2 < 2 p R whatever the width."""
    spec, w = perm.spec, perm.width
    p, R = spec.modulus, 1 << (16 * spec.n_limbs)
    r_inv, root5 = pow(R, -1, p), pow(5, -1, p - 1)
    half, rounds = perm.full_rounds // 2, perm.full_rounds + perm.partial_rounds
    keys = [[int(k) for k in limb.unpack_mont(spec, perm.round_keys[r])] for r in range(rounds)]
    mds = [[int(v) for v in row] for row in limb.unpack(spec, perm.mds)]
    mds_inv = _inverse_mod([[v * r_inv % p for v in row] for row in mds], p)
    x = [(p - 1) * r_inv % p] * w
    for r in reversed(range(rounds)):
        full = r < half or r >= half + perm.partial_rounds
        x = [(pow(v, root5, p) if j == 0 or full else v) - k for j, (v, k) in enumerate(zip(x, keys[r]))]
        if r:
            x = [sum(m * v for m, v in zip(row, x)) % p for row in mds_inv]
    return [v % p for v in x], (p - 1) * max(map(sum, mds)) / min(R * R, 3 * p * R)


def hillis_steele_scan(curve, totals, tflag):
    """The exclusive lifted scan as the port ran it before K3's scan
    variant: a Hillis-Steele scan through K3 (ops/scan_utils.py)."""
    from ..ops.scan_utils import inclusive_scan

    dev = tflag.device

    def lifted(a, b):
        merged = jac.add(curve, JPoint(*a[:3]), JPoint(*b[:3]))
        return (*jac.select(b[3], JPoint(*b[:3]), merged), a[3] | b[3])

    def pad(k):
        return (*jac.identity(curve, (k,), dev), torch.zeros(k, dtype=torch.bool, device=dev))

    incl = inclusive_scan(lifted, (*totals, tflag), pad)
    return tuple(torch.cat([p, v[..., :-1]], dim=-1) for p, v in zip(pad(1), incl[:3]))


def scan_sweep(cases) -> None:
    """K3's lifted scan over the chunk totals of each fold case, at each
    bound of its narrow levels, against the Hillis-Steele scan it
    replaced."""
    shipped = ec_kernel.SCAN_NARROW
    for name, curve, args in cases:
        totals, tflag = ec_kernel.fold_madd(*args)[:2]
        l = tflag.shape[0]
        old = hillis_steele_scan(curve, totals, tflag)
        want = jac.normalize(curve, JPoint(*old))
        t_old = _timed(lambda: hillis_steele_scan(curve, totals, tflag), 3)
        log(f"[scan] {name}: l = {l} chunk totals, {int(tflag.sum())} flagged; Hillis-Steele through K3 "
            f"{t_old:.4f} ms")
        scan = lambda: ec_kernel.lifted_scan(curve, totals, tflag)
        try:
            for narrow in SCAN_NARROWS:
                ec_kernel.SCAN_NARROW = narrow
                got = jac.normalize(curve, JPoint(*scan()))
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                before = ec_kernel.K3S.launches
                t = [_timed(scan, 10) for _ in range(2)]
                launches = (ec_kernel.K3S.launches - before) // 22
                report = profile.profile(scan)
                log(f"[scan]   narrow={narrow}: {t[0]:.4f} / {t[1]:.4f} ms, device busy {report.busy_ms:.4f} ms "
                    f"({launches} launches){'' if same else ' DIFFERS'}; device ms by kernel: "
                    + ", ".join(f"{k.split('<')[0].split('::')[-1]} {ms:.4f} ({n})" for ms, n, k in report.kernels))
                if not same:
                    raise RuntimeError(f"the lifted scan at narrow={narrow} gives other group elements")
        finally:
            ec_kernel.SCAN_NARROW = shipped


def _queued_ms(fn, reps: int) -> float:
    """Device ms per call of fn: reps calls queued behind a kernel that
    sleeps about 10 ms, so that the host's cost of each launch overlaps
    the card's work, timed by CUDA events around them (each call's time
    and the card's gap between two launches). torch.profiler's device
    times, which lose records in such a run, are not needed."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k7_sweep(dev) -> None:
    """K7 at width 3 over BN254 Fr through the wrapper, 2^12 to 2^18 states."""
    from ..crypto.poseidon2 import Poseidon2
    from ..ops import poseidon2_kernel

    perm = Poseidon2.create(BN254_FR, 2, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    for log_b in range(12, 19):
        x = torch.randint(0, 1 << 16, (16, 3, 1 << log_b), generator=gen, device=dev, dtype=torch.int32)
        x[-1] = 0  # below p
        ms = _timed(lambda: poseidon2_kernel.permute(perm, x), 10)
        qms = _queued_ms(lambda: poseidon2_kernel.permute(perm, x), 10)
        log(f"[k7] width 3, 2^{log_b} states: {ms:.4f} ms ({qms:.4f} queued), {(1 << log_b) / ms / 1e3:.2f} M perms/s")


def k8_sweep(dev, rng) -> None:
    """K8's transform by size, batch and cluster, and the two other
    routes."""
    from ..ops import ntt, ntt_kernel

    spec = BN254_FR
    for log_n in range(4, 13):
        N = 1 << log_n
        rev, table, n_inv = ntt._plan(spec, log_n, False, dev)
        for batch in (1, 3, 16):
            vals = np.array([rng.randrange(spec.modulus) for _ in range(N * batch)], dtype=object)
            x = limb.tensor(limb.pack_mont(spec, vals.reshape(N, batch)), dev)
            want = ntt_kernel.transform_plain(spec, x, table, rev, n_inv, False)
            default = ntt_kernel.cluster_size(N, batch, dev)
            f = lambda: ntt_kernel.transform(spec, x, table, rev, n_inv, False)
            row = []
            shipped = ntt_kernel.CLUSTER[N]
            try:
                for C in (1, 2, 4, 8):
                    if N // C < 2:
                        continue
                    ntt_kernel.CLUSTER[N] = C
                    if not torch.equal(f(), want):
                        raise RuntimeError(f"the transform of 2^{log_n} over {C} blocks differs from its plain "
                                           f"version")
                    row.append(f"{ntt_kernel.cluster_size(N, batch, dev)} blocks {_queued_ms(f, 20) * 1e3:.1f}")
            finally:
                ntt_kernel.CLUSTER[N] = shipped
            log(f"[k8] 2^{log_n} batch {batch}, us a transform queued: {'; '.join(row)}; the wrapper takes {default}")
    for log_n in (10, 12):
        x = limb.tensor(limb.pack_mont(spec, [rng.randrange(spec.modulus) for _ in range(1 << log_n)]), dev)
        _, table, _ = ntt._plan(spec, log_n, False, dev)
        rev = torch.as_tensor(ntt._bitrev(1 << log_n), device=dev)

        def stages():
            y = x
            for s in range(log_n):
                y = ntt_kernel.stage(spec, y, table, s)
            return y[:, rev]

        for label, f in (("one launch", lambda: ntt._ntt_core(spec, x, False)),
                         ("four-step", lambda: ntt.fourstep_transform(spec, x, False)),
                         ("a stage a launch", stages)):
            log(f"[k8] 2^{log_n} batch 1, {label}: {_timed(f, 50):.4f} ms (CUDA events), {_queued_ms(f, 20):.4f} ms "
                f"queued")


def _k2_input(log_n: int, batch: int, dev) -> torch.Tensor:
    """(16, 2^log_n, batch) canonical random BN254 Fr limbs."""
    gen = torch.Generator().manual_seed(log_n * 10 + batch)
    x = torch.randint(0, 1 << 16, (16, 1 << log_n, batch), generator=gen, dtype=torch.int32)
    x[15] %= 0x3000
    return x.to(dev)


#: a 16-limb prime k 2^32 + 1 past F1c's bound (top word 0xFFFFFFFF): K2
#: runs it on F1, at BN254 Fr's shapes
F1_PRIME = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFD500000001


def _k2_roots(spec, log_n: int, dev):
    """Word-packed roots (2^log_n, NW) of w^j: BN254 Fr's plan table, or for
    another prime k 2^32 + 1 the powers of an element of order 2^log_n."""
    from ..ops import ntt, ntt_kernel

    if spec is BN254_FR:
        return ntt._fourstep_plan(spec, log_n, False, tuple(ntt._levels(log_n)), dev)[1]
    p = spec.modulus
    w = next(w for w in (pow(g, (p - 1) >> 32, p) for g in range(2, 64)) if pow(w, 1 << 31, p) != 1)
    return ntt_kernel.to_words(spec, limb.geom_series_mont(spec, 1, pow(w, 1 << (32 - log_n), p), 1 << log_n, dev))


def k2_sweep(dev) -> None:
    """K2's level by tile lanes on F1c (BN254 Fr) and F1 (a prime past
    F1c's bound), by M, and the whole transform by M_MAX (queued)."""
    from ..fields.spec import FieldSpec
    from ..ops import ntt, ntt_kernel

    shipped = (ntt_kernel.LEVEL_THREADS, ntt_kernel.M_MAX)
    fields = {"F1c": BN254_FR, "F1": FieldSpec("top_ffffffff", F1_PRIME)}
    try:
        for field, spec in fields.items():
            roots = _k2_roots(spec, 17, dev)
            shape = ntt._fourstep_plan(BN254_FR, 17, False, tuple(ntt._levels(17)), dev)[0]
            for batch in (1, 3):
                x = _k2_input(17, batch, dev)
                for lm, nt in shape:
                    ntt_kernel.LEVEL_THREADS = shipped[0]
                    want = ntt_kernel.fourstep_level(spec, x, roots, lm, nt)
                    if not torch.equal(want, ntt_kernel.level_plain(spec, x, roots, lm, nt)):
                        raise RuntimeError(f"K2 on {field} at M=2^{lm}, nt={nt}, batch {batch} differs from its "
                                           f"plain version")
                    row = []
                    for threads in (64, 128, 256):
                        ntt_kernel.LEVEL_THREADS = threads
                        tile = ntt_kernel.level_tile(spec, lm)
                        f = lambda: ntt_kernel.fourstep_level(spec, x, roots, lm, nt)  # noqa: E731
                        if not torch.equal(f(), want):
                            raise RuntimeError(f"K2 on {field} with {tile} lanes a block differs")
                        row.append(f"{tile} lanes {_queued_ms(f, 20) * 1e3:.1f}")
                    log(f"[k2] {field} 2^17 batch {batch}, level M=2^{lm} nt={nt}, us a launch queued by lanes a "
                        f"block (64, 128, 256 threads): {'; '.join(row)}; shipped {shipped[0]} threads")
            ntt_kernel.LEVEL_THREADS = shipped[0]
            x = _k2_input(17, 3, dev)
            row = []
            for lm in range(1, 10):
                f = lambda: ntt_kernel.fourstep_level(spec, x, roots, lm, 1 << 17)  # noqa: E731
                us = _queued_ms(f, 20) * 1e3
                row.append(f"M=2^{lm} {us:.1f} us ({us * 1e3 / (3 << 17):.3f} ns an element)")
            log(f"[k2] {field} first level of 2^17, batch 3, by M (shipped threads): {'; '.join(row)}")
        spec = BN254_FR
        for log_n, batch in ((17, 1), (17, 3), (20, 1)):
            x = _k2_input(log_n, batch, dev)
            row, want = [], None
            for m_max in (64, 128, 512):
                ntt_kernel.M_MAX = m_max
                f = lambda: ntt.ntt(spec, x)  # noqa: E731
                got = f()
                want = got if want is None else want
                if not torch.equal(got, want):
                    raise RuntimeError(f"the 2^{log_n} transform under M_MAX={m_max} differs")
                row.append(f"M_MAX={m_max} {ntt._levels(log_n)} {_queued_ms(f, 10) * 1e3:.1f}")
            ntt_kernel.M_MAX = shipped[1]
            log(f"[k2] 2^{log_n} batch {batch} ntt, us queued: {'; '.join(row)}; shipped M_MAX={shipped[1]}")
    finally:
        ntt_kernel.LEVEL_THREADS, ntt_kernel.M_MAX = shipped


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("kernel_probe needs a GPU")
    parts = sys.argv[1:] or list(PARTS)
    unknown = sorted(set(parts) - set(PARTS))
    if unknown:
        sys.exit(f"unknown parts {unknown}; parts are {', '.join(PARTS)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] {smi}")
    procs = _start_builds(parts)
    build.lib()
    if "microbench" in parts:
        exe, proc = procs.pop("microbench")
        microbench(exe, _finish(proc, "microbench"))
    dev, rng = torch.device("cuda"), random.Random(1)
    if "k5" in parts:
        k5_sweep(dev, rng)
    cases = _fold_cases(dev, rng) if {"k9", "scan"} & set(parts) else []
    if "k9" in parts:
        k9_builds(procs, cases, dev)
    if "k3" in parts:
        k3_builds(procs, dev)
    if "scan" in parts:
        scan_sweep(cases)
    if "k7" in parts:
        k7_sweep(dev)
    if "k8" in parts:
        k8_sweep(dev, rng)
    if "k2" in parts:
        k2_sweep(dev)


if __name__ == "__main__":
    main()
