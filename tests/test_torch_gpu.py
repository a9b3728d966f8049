"""The hand-written CUDA kernels against their plain torch versions, on the
card. Every test needs an NVIDIA GPU and skips without one.

This file imports only the port (no JAX, no `openzl_tpu`), so it also
runs where JAX is not installed (the tests' conftest imports JAX, hence
`--noconftest`). Run on the card:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \\
        -m gpu tests/test_torch_gpu.py -q

Inputs come from seeded `random.Random`; every comparison is exact
(tolerance 0). `chip_smoke.py` repeats these checks at the main path's
shapes."""

import random

import numpy as np
import pytest
import torch

from openzl_tpu_torch.crypto.merkle.tree import MerkleParameters, MerkleTree
from openzl_tpu_torch.crypto.poseidon.permutation import Poseidon
from openzl_tpu_torch.crypto.poseidon2 import ROUND_NUMBERS_128, Poseidon2
from openzl_tpu_torch.curves import jacobian as jac
from openzl_tpu_torch.curves.spec import BLS12_381_G1, BLS12_381_G2, BN254_G1, BN254_G2
from openzl_tpu_torch.fields import limb
from openzl_tpu_torch.fields.spec import BLS12_381_FR, BN254_FR, FieldSpec
from openzl_tpu_torch.ops import ec_kernel, msm, ntt, ntt_kernel, poseidon2_kernel, poseidon_kernel
from openzl_tpu_torch.proof_systems import BLS12_381, BN254, KZG, Groth16
from openzl_tpu_torch.ref import curve as ref
from openzl_tpu_torch.tools import kernel_probe

pytestmark = pytest.mark.gpu

#: the curves of the EC kernels: 16-limb (BN254) and 24-limb (BLS12-381)
#: base fields
EC_CURVES = [BN254_G1, BN254_G2, BLS12_381_G1, BLS12_381_G2]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _field(spec, n, seed, device=None):
    rng = random.Random(seed)
    p = spec.modulus
    vals = [0, 1, p - 1, p - 2] + [rng.randrange(p) for _ in range(n - 4)]
    return limb.tensor(limb.pack(spec, vals), device)


def _points(curve, n, seed):
    """Affine points P and Q with an identity on either side, and rows where
    2P = Q and 2P = -Q (the EC test doubles P first, so that its Z != 1)."""
    rng = random.Random(seed)
    G = ref.generator(curve)
    pts = [ref.scalar_mul(curve, rng.randrange(1, 1 << 64), G) for _ in range(n)]
    qts = [ref.scalar_mul(curve, rng.randrange(1, 1 << 64), G) for _ in range(n)]
    pts[0] = None
    qts[1] = None
    qts[2] = ref.add(curve, pts[2], pts[2])
    qts[3] = ref.neg(curve, ref.add(curve, pts[3], pts[3]))
    return pts, qts


def test_k1_kernel_matches_plain(cuda):
    spec = BN254_FR
    a = _field(spec, 1000, 7, cuda)
    b = torch.roll(a, 1, dims=1).contiguous()
    assert torch.equal(ntt_kernel.mont_mul(spec, a, b), ntt_kernel.mont_mul_plain(spec, a, b))
    s = b[:, 3:4].contiguous()
    assert torch.equal(ntt_kernel.mont_scale(spec, a, s), ntt_kernel.mont_mul_plain(spec, a, s))


@pytest.mark.parametrize("spec", [BN254_FR, BLS12_381_G1.base], ids=lambda s: s.name)
@pytest.mark.parametrize("n", [1, 4, 1 << 10])
def test_k1_mont_pow_matches_plain(cuda, spec, n):
    """K1's exponentiation at 16 and 24 limbs against its plain chain, by
    p - 2, 0, 1 and a random exponent, 0 among the inputs past one."""
    a = _field(spec, max(n, 4), 11 + n, cuda)[:, 3 if n == 1 else 0:][:, :n].contiguous()
    for e in (spec.modulus - 2, 0, 1, random.Random(n).getrandbits(256)):
        assert torch.equal(ntt_kernel.mont_pow(spec, a, e), ntt_kernel.mont_pow_plain(spec, a, e)), e


@pytest.mark.parametrize("curve", EC_CURVES, ids=lambda c: c.name)
def test_k3_k4_kernels_match_plain(cuda, curve):
    pts, qts = _points(curve, 12, 5)
    P = jac.double(curve, jac.from_affine_ints(curve, pts, cuda))
    Q = jac.from_affine_ints(curve, qts, cuda)
    want_aff = [ref.add(curve, ref.add(curve, a, a), b) for a, b in zip(pts, qts)]
    assert jac.to_affine_ints(curve, jac.add(curve, P, Q)) == want_aff
    for got, want in (
        (ec_kernel.ec_add(curve, P, Q), ec_kernel.ec_add_plain(curve, P, Q, False)),
        (ec_kernel.ec_add(curve, P, Q, True), ec_kernel.ec_add_plain(curve, P, Q, True)),
        (ec_kernel.ec_dbl(curve, P), ec_kernel.ec_dbl_plain(curve, *P)),
    ):
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("curve", EC_CURVES, ids=lambda c: c.name)
def test_k3_lifted_scan_matches_plain(cuda, curve, monkeypatch):
    """K3's lifted scan at the edge sizes of its chunks (l = 1, 3, R - 1, R,
    R + 1, 5 R + 3) with no, all and random flags, through chunks
    (`SCAN_NARROW` set to 0) and through Hillis-Steele steps, over four
    levels of chunks (l = 600), and with a narrow last level."""
    pts, qts = _points(curve, 12, 41)
    base = jac.concat([jac.double(curve, jac.from_affine_ints(curve, pts, cuda)),
                       jac.from_affine_ints(curve, qts, cuda)])
    rng = random.Random(42)
    R, N = ec_kernel.SCAN_R, ec_kernel.SCAN_NARROW
    runs = [(l, mode, narrow) for l in sorted({1, 3, R - 1, R, R + 1, 5 * R + 3}) for mode in ("none", "all", "rand")
            for narrow in (0, N)]
    runs += [(600, "rand", 0), (600, "rand", 40), (600, "rand", N)]
    for l, mode, narrow in runs:
        P = jac.take(base, torch.tensor([rng.randrange(24) for _ in range(l)], device=cuda))
        flags = torch.tensor([mode == "all" or (mode == "rand" and rng.random() < 0.3) for _ in range(l)],
                             device=cuda)
        monkeypatch.setattr(ec_kernel, "SCAN_NARROW", narrow)
        got = ec_kernel.lifted_scan(curve, tuple(P), flags)
        want = ec_kernel.lifted_scan_plain(curve, tuple(P), flags)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (l, mode, narrow)


@pytest.mark.parametrize("curve", EC_CURVES, ids=lambda c: c.name)
def test_msm_matches_cpu(cuda, curve):
    pts, _ = _points(curve, 256, 13)
    rng = random.Random(14)
    scalars = limb.pack(curve.scalar, [rng.randrange(curve.scalar.modulus) for _ in pts])
    cpu = msm.msm(curve, limb.tensor(scalars), jac.from_affine_ints(curve, pts))
    gpu = msm.msm(curve, limb.tensor(scalars, cuda), jac.from_affine_ints(curve, pts, cuda))
    assert jac.to_affine_ints(curve, gpu) == jac.to_affine_ints(curve, cpu)


def test_k8_kernel_and_stage_route_match(cuda):
    spec = BN254_FR
    x = limb.to_mont(spec, _field(spec, 4 * 64, 23)).reshape(spec.n_limbs, 64, 4).to(cuda)
    _, table, _ = ntt._plan(spec, 6, False, cuda)
    for s in range(6):
        assert torch.equal(ntt_kernel.stage(spec, x, table, s), ntt_kernel.stage_plain(spec, x, table, s))
    u, t, w = x[:, :32], x[:, 32:], torch.roll(x[:, :32], 1, dims=1)
    got, want = ntt_kernel.butterfly(spec, u, t, w), ntt_kernel.butterfly_plain(spec, u, t, w)
    assert all(torch.equal(g, e) for g, e in zip(got, want))
    for fn in (ntt.ntt, ntt.intt, ntt.coset_ntt, ntt.coset_intt):
        assert torch.equal(fn(spec, x).cpu(), fn(spec, x.cpu())), fn.__name__


@pytest.mark.parametrize("batch", [1, 3, 4])
def test_k8_transform_matches_plain_at_every_size(cuda, batch, monkeypatch):
    """K8's one-launch transform against its plain version (Pease stages,
    gather, scale) at every N from 2 to 2^12, forward and inverse, with
    the wrapper's cluster sizes and with one block a transform (every
    `CLUSTER` entry 1)."""
    spec = BN254_FR
    one_block = {N: 1 for N in ntt_kernel.CLUSTER}
    for log_n in range(1, 13):
        N = 1 << log_n
        x = limb.to_mont(spec, _field(spec, max(N * batch, 4), 60 + log_n)[:, :N * batch])
        x = x.reshape(spec.n_limbs, N, batch).to(cuda)
        x = x[:, :, 0].contiguous() if batch == 1 else x.contiguous()
        for inverse in (False, True):
            rev, table, n_inv = ntt._plan(spec, log_n, inverse, cuda)
            want = ntt_kernel.transform_plain(spec, x, table, rev, n_inv, inverse)
            for clusters in (dict(ntt_kernel.CLUSTER), one_block):
                monkeypatch.setattr(ntt_kernel, "CLUSTER", clusters)
                got = ntt_kernel.transform(spec, x, table, rev, n_inv, inverse)
                assert torch.equal(got, want), (N, inverse, clusters[N])


#: 16-limb primes k 2^32 + 1 (5 not dividing k) with p's top word at F1c's
#: bound (0x7FFFFFFF) and at its largest (0xFFFFFFFF): the kernels that
#: have both fields run these on F1
F1_PRIMES = [
    FieldSpec("top_7fffffff", 0x7FFFFFFF00000000000000000000000000000000000000000000004700000001),
    FieldSpec("top_ffffffff", 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFD500000001),
]


def _root_plan(spec, log_n, inverse, device):
    """(bit-reversal index, root table, 1/N) of an N-point transform over
    a prime k 2^32 + 1, from an element of order 2^32."""
    p, N = spec.modulus, 1 << log_n
    w = next(w for w in (pow(g, (p - 1) >> 32, p) for g in range(2, 64)) if pow(w, 1 << 31, p) != 1)
    w = pow(w, 1 << (32 - log_n), p)
    if inverse:
        w = pow(w, -1, p)
    table = limb.tensor(limb.pack_mont(spec, [pow(w, j, p) for j in range(N // 2)]), device)
    return torch.as_tensor(ntt._bitrev(N), device=device), table, limb.tensor(limb.pack_mont(spec, pow(N, -1, p)),
                                                                                device)


@pytest.mark.parametrize("spec", F1_PRIMES, ids=lambda s: s.name)
def test_k8_transform_on_f1_matches_plain(cuda, spec):
    """K8's one-launch transform over primes past F1c's bound (its F1
    instantiation) against its plain version, 2^1 to 2^12, forward and
    inverse, batch 1 and 3."""
    for log_n in (1, 2, 5, 9, 10, 12):
        N = 1 << log_n
        for batch in (1, 3):
            x = limb.to_mont(spec, _field(spec, max(N * batch, 4), 80 + log_n)[:, :N * batch])
            x = x.reshape(spec.n_limbs, N, batch).to(cuda)
            x = x[:, :, 0].contiguous() if batch == 1 else x.contiguous()
            for inverse in (False, True):
                rev, table, n_inv = _root_plan(spec, log_n, inverse, cuda)
                got = ntt_kernel.transform(spec, x, table, rev, n_inv, inverse)
                assert torch.equal(got, ntt_kernel.transform_plain(spec, x, table, rev, n_inv, inverse)), (
                    N, batch, inverse)


#: fields the one-launch transform is not built for: 2 and 24 limbs
STAGE_FIELDS = [FieldSpec("babybear", 2013265921), FieldSpec(
    "bls12_377_fq",
    0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001,
)]


@pytest.mark.parametrize("spec", STAGE_FIELDS, ids=lambda s: s.name)
def test_small_transforms_of_other_fields_run_k8_stages(cuda, spec):
    """`ntt` and `intt` below the four-step threshold over BabyBear and
    BLS12-377 Fq on the card: a K8 `stage` launch a stage (the inverse's
    scale one K1 launch), equal to the CPU route."""
    for log_n in (1, 4, 10, 12):
        x = limb.to_mont(spec, _field(spec, max(1 << log_n, 4), 90 + log_n)[:, :1 << log_n])
        xc = x.to(cuda)
        for fn, scales in ((ntt.ntt, 0), (ntt.intt, 1)):
            ntt._plan(spec, log_n, fn is ntt.intt, xc.device)  # the tables, built once by K1 products
            before = (ntt_kernel.K8.launches, ntt_kernel.K1.launches)
            got = fn(spec, xc)
            assert (ntt_kernel.K8.launches - before[0], ntt_kernel.K1.launches - before[1]) == (log_n, scales)
            assert torch.equal(got.cpu(), fn(spec, x)), (log_n, fn.__name__)


#: the four transforms of `ops/ntt.py`
TRANSFORMS = (ntt.ntt, ntt.intt, ntt.coset_ntt, ntt.coset_intt)


def _fourstep_matches_cpu(spec, x, cuda):
    """Each of the four transforms of x (a CPU tensor, N >= 2^13) on the
    card: one K2 launch a level of `ntt._levels(N)`, no K1 and no K8 launch
    (the plans built first), and the CPU route's result."""
    log_n = x.shape[1].bit_length() - 1
    xc = x.to(cuda)
    for fn in TRANSFORMS:
        want = fn(spec, x)
        fn(spec, xc)  # the plans and coset tables, built once by K1 products
        before = [k.launches for k in (ntt_kernel.K2, ntt_kernel.K1, ntt_kernel.K8)]
        got = fn(spec, xc)
        after = [k.launches for k in (ntt_kernel.K2, ntt_kernel.K1, ntt_kernel.K8)]
        assert [a - b for a, b in zip(after, before)] == [len(ntt._levels(log_n)), 0, 0], (log_n, fn.__name__)
        assert torch.equal(got.cpu(), want), (log_n, fn.__name__)


@pytest.mark.parametrize("log_n", [13, 14])
@pytest.mark.parametrize("spec", [BN254_FR, *F1_PRIMES, *STAGE_FIELDS], ids=lambda s: s.name)
def test_fourstep_route_matches_cpu(cuda, spec, log_n, monkeypatch):
    """`ntt`, `intt`, `coset_ntt` and `coset_intt` at 2^13 and 2^14, batch 1
    and 2, on the four-step route: K2 on F1c (BN254 Fr, BLS12-377 Fq), on
    F1 (the two 16-limb primes past F1c's bound, with generator 3) and at
    one word (BabyBear), each a K2 launch a level, equal to the CPU route."""
    monkeypatch.setitem(ntt.GENERATORS, spec.name, ntt.GENERATORS.get(spec.name, 3))
    for batch in (1, 2):
        x = limb.to_mont(spec, _field(spec, batch << log_n, 100 + log_n))
        x = x.reshape(spec.n_limbs, 1 << log_n, batch)
        _fourstep_matches_cpu(spec, x[:, :, 0].contiguous() if batch == 1 else x.contiguous(), cuda)


def test_prover_shape_fourstep_is_three_k2_launches(cuda):
    """The Groth16 prover's transforms, 2^17 points over BN254 Fr at batch 3:
    each of the four is three K2 launches ([6, 6, 5]) and nothing else, and
    equals the CPU route."""
    assert ntt._levels(17) == [6, 6, 5]
    x = limb.to_mont(BN254_FR, _field(BN254_FR, 3 << 17, 117)).reshape(16, 1 << 17, 3)
    _fourstep_matches_cpu(BN254_FR, x, cuda)


def test_small_transform_is_one_k8_launch(cuda):
    """A transform below the four-step threshold through `ntt._ntt_core`
    on a CUDA tensor is one K8 launch and no K1 launch (no `stage`, no
    scale), forward and inverse, and equals the CPU route."""
    spec = BN254_FR
    x = limb.to_mont(spec, _field(spec, 1 << 12, 71))
    xc = x.to(cuda)
    for inverse in (False, True):
        ntt._plan(spec, 12, inverse, xc.device)  # the tables, built once by K1 products
        before = (ntt_kernel.K8.launches, ntt_kernel.K1.launches)
        got = ntt._ntt_core(spec, xc, inverse)
        assert (ntt_kernel.K8.launches - before[0], ntt_kernel.K1.launches - before[1]) == (1, 0)
        assert torch.equal(got.cpu(), ntt._ntt_core(spec, x, inverse)), inverse


def test_k8_transform_refuses_before_any_launch(cuda):
    """A 16-limb field's N = 2^13 and a 24-limb field's transform raise a
    ValueError before any launch."""
    spec, wide = BN254_FR, BLS12_381_G1.base
    launches = ntt_kernel.K8.launches
    x = torch.zeros((16, 1 << 13), dtype=torch.int32, device=cuda)
    table = torch.zeros((16, 1 << 12), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="N=8192"):
        ntt_kernel.transform(spec, x, table, None, None, False)
    xw = torch.zeros((24, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match=f"{wide.name} has 24 limbs"):
        ntt_kernel.transform(wide, xw, torch.zeros((24, 4), dtype=torch.int32, device=cuda), None, None, False)
    assert ntt_kernel.K8.launches == launches


@pytest.mark.parametrize("n_pts", [200, 2], ids=["r32", "r1"])
@pytest.mark.parametrize("curve", EC_CURVES, ids=lambda c: c.name)
def test_k9_kernel_matches_plain(cuda, curve, n_pts):
    """Chunks of r = 32 (200 points, 12-bit scalars, 3 windows), and of the
    smallest r that `_chunk_len` picks (2 points, 4-bit scalars: at most 4
    entries, r = 1)."""
    pts, _ = _points(curve, max(n_pts, 12), 29)
    pts = pts[4:4 + n_pts] if n_pts < 12 else pts
    if n_pts > 8:
        pts[7] = pts[8]  # a repeated point: P = Q inside a bucket
    bits = 12 if n_pts > 8 else 4
    rng = random.Random(30)
    scalars = limb.tensor(limb.pack(curve.scalar, [rng.randrange(1, 1 << bits) for _ in pts]), cuda)
    P, keys, pidx, r, c, W = msm.fold_inputs(curve, [(scalars, jac.from_affine_ints(curve, pts, cuda))], 4, bits)
    assert r == (32 if n_pts > 8 else 1)
    width = (W << c) + 1
    got = ec_kernel.fold_madd(curve, P, keys, pidx, r, width)
    want = ec_kernel.fold_madd_plain(curve, P, keys, pidx, r, width)
    for g, w in zip(got, want):
        for a, b in zip(*((v,) if torch.is_tensor(v) else v for v in (g, w))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("pairing", [BN254, BLS12_381], ids=lambda p: p.name)
def test_kzg_on_cuda_matches_cpu(cuda, pairing):
    gpu, cpu = KZG(pairing, backend="device", device=cuda), KZG(pairing, backend="device", device="cpu")
    params, params_cpu = gpu.setup(40, random.Random(31)), cpu.setup(40, random.Random(31))
    assert params.to_bytes() == params_cpu.to_bytes()
    rng = random.Random(32)
    coeffs = [rng.randrange(pairing.r) for _ in range(41)]
    C = gpu.commit(params, coeffs)
    assert C == cpu.commit(params_cpu, coeffs)
    z = rng.randrange(BN254.r)
    v, w = gpu.open(params, coeffs, z)
    assert (v, w) == cpu.open(params_cpu, coeffs, z)
    assert gpu.verify(params, C, z, v, w)


def test_default_groth16_on_cuda_matches_cpu(cuda):
    """`Groth16()` (BLS12-381 on the card, K3, K4, K9 and the scan at 24
    limbs) against `Groth16(BLS12_381, "cpu")` on an 8-constraint circuit:
    key and proof bytes are identical, and the proof verifies."""
    gpu, cpu = Groth16(), Groth16(BLS12_381, "cpu")
    assert gpu.pairing is BLS12_381 and gpu.device.type == "cuda"
    p = gpu.fr.modulus
    x = 3
    y = (pow(x, 8, p) + x + 5) % p
    out = []
    for g16 in (gpu, cpu):
        com = g16.proof_compiler()
        pub, w = com.public_input(y), com.secret_witness(x)
        t = w
        for _ in range(3):
            t = com.square(t)
        com.assert_eq(com.add_const(com.add(t, w), 5), pub)
        pk = g16.compile(com.cs, random.Random(33))
        proof = g16.prove(pk, com.cs, random.Random(34))
        out.append((pk.to_bytes(), proof.to_bytes(g16.pairing), g16.verify(pk.vk, [y], proof),
                    g16.verify(pk.vk, [y + 1], proof)))
    assert out[0] == out[1]
    assert out[0][2] and not out[0][3]


def test_ec_kernels_refuse_an_unbuilt_field(cuda):
    """A 2-limb curve has no K3 / K4 / scan instantiation: each wrapper
    raises a ValueError naming the curve and the limb count before any
    launch (the coordinates are never read)."""
    from openzl_tpu_torch.curves.spec import CurveSpec
    from openzl_tpu_torch.fields.spec import FieldSpec

    field = FieldSpec(name="toy_fp32", modulus=(1 << 31) - 1)
    curve = CurveSpec(name="toy_g1", base=field, scalar=field, a=0, b=7, gen_x=3, gen_y=0)
    P = jac.JPoint(*(torch.zeros((2, 4), dtype=torch.int32, device=cuda) for _ in range(3)))
    launches = (ec_kernel.K3.launches, ec_kernel.K4.launches)
    for call in (lambda: ec_kernel.ec_add(curve, P, P), lambda: ec_kernel.ec_dbl(curve, P),
                 lambda: ec_kernel.lifted_scan(curve, tuple(P), torch.zeros(4, dtype=torch.bool, device=cuda))):
        with pytest.raises(ValueError, match=f"{curve.name}.*2"):
            call()
    assert (ec_kernel.K3.launches, ec_kernel.K4.launches) == launches


def _states(spec, n, seed, device, width=3):
    """(n_limbs, width, n) random Montgomery-form states with 0, 1, p - 1
    and p - 2 among them."""
    x = _field(spec, width * n, seed).reshape(spec.n_limbs, width, n)
    return limb.to_mont(spec, x).contiguous().to(device)


@pytest.mark.parametrize("spec", [BN254_FR, BLS12_381_FR], ids=lambda s: s.name)
def test_k5_k6_k7_kernels_match_plain(cuda, spec):
    x = _states(spec, 1000, 17, cuda)
    perm, perm2 = Poseidon.create(spec, 2, device=cuda), Poseidon2.create(spec, 2, device=cuda)
    want = poseidon_kernel.permute_plain(perm, x)
    assert torch.equal(poseidon_kernel.permute(perm, x), want)
    assert torch.equal(poseidon_kernel.permute_optimized(perm, x), want)
    assert torch.equal(poseidon2_kernel.permute(perm2, x), poseidon2_kernel.poseidon2_permute_plain(perm2, x))
    assert torch.equal(perm.permute(x.cpu()), want.cpu())


@pytest.mark.parametrize("spec", [BN254_FR, BLS12_381_FR], ids=lambda s: s.name)
@pytest.mark.parametrize("width", [w for w in poseidon_kernel.KERNEL_WIDTHS if w != 3])
def test_k5_k6_kernels_match_plain_at_other_widths(cuda, spec, width):
    """K5 and K6 at every other built width (the run-time-width kernel),
    on 129 states (a block and one more), over both fields: BLS12-381
    Fr's MDS rows pass the unreduced sum's bound from width 5 on."""
    x = _states(spec, 129, 41 + width, cuda, width)
    perm = Poseidon.create(spec, width - 1, device=cuda)
    want = poseidon_kernel.permute_plain(perm, x)
    assert torch.equal(poseidon_kernel.permute(perm, x), want)
    assert torch.equal(poseidon_kernel.permute_optimized(perm, x), want)
    assert poseidon_kernel.variant(1, width) == "wide"


def test_k6_kernel_matches_plain_on_the_worst_case_state(cuda):
    """K6 at BLS12-381 Fr width 17, where its rows need `mac_group`'s
    groups most, on 129 states with K5's worst-case state (every last-round
    MDS input the Montgomery word p - 1) among them."""
    perm = Poseidon.create(BLS12_381_FR, 16, device=cuda)
    x = _states(BLS12_381_FR, 129, 59, cuda, 17)
    directed, _ = kernel_probe.directed_state(perm)
    x[:, :, 3] = limb.tensor(limb.pack_mont(BLS12_381_FR, directed), cuda)
    want = poseidon_kernel.permute_plain(perm, x)
    assert torch.equal(poseidon_kernel.permute_optimized(perm, x), want)
    assert torch.equal(poseidon_kernel.permute(perm, x), want)


@pytest.mark.parametrize("spec", [BN254_FR, BLS12_381_FR], ids=lambda s: s.name)
@pytest.mark.parametrize("width", [w for w in poseidon2_kernel.KERNEL_WIDTHS if w != 3])
def test_k7_kernel_matches_plain_at_other_widths(cuda, spec, width):
    x = _states(spec, 129, 43 + width, cuda, width)
    perm2 = Poseidon2.create(spec, width - 1, device=cuda)
    assert torch.equal(poseidon2_kernel.permute(perm2, x), poseidon2_kernel.poseidon2_permute_plain(perm2, x))


@pytest.mark.parametrize("spec", [BN254_FR, BLS12_381_FR], ids=lambda s: s.name)
@pytest.mark.parametrize("width", poseidon2_kernel.KERNEL_WIDTHS)
def test_k7_kernel_matches_plain_on_the_worst_case_state(cuda, spec, width):
    """K7 at every built width over both fields on 129 states, the first 64
    with every element p - 1 (the largest input of each linear-layer sum
    the kernel leaves unreduced), the rest random."""
    x = _states(spec, 129, 61 + width, cuda, width)
    x[:, :, :64] = limb.tensor(limb.pack_mont(spec, [spec.modulus - 1]), cuda).reshape(-1, 1, 1)
    perm2 = Poseidon2.create(spec, width - 1, device=cuda)
    assert torch.equal(poseidon2_kernel.permute(perm2, x), poseidon2_kernel.poseidon2_permute_plain(perm2, x))


@pytest.mark.parametrize("spec", F1_PRIMES, ids=lambda s: s.name)
@pytest.mark.parametrize("width", poseidon2_kernel.KERNEL_WIDTHS)
def test_k7_kernel_on_f1_matches_plain(cuda, spec, width):
    """K7 over primes past F1c's bound (its F1 instantiation) at every
    built width against its plain version, on 129 states, the first 64
    with every element p - 1, the rest random; seeded round keys and a
    diagonal of 2 to 40 (the kernel's result does not depend on how they
    were chosen)."""
    rng = random.Random(width)
    p = spec.modulus
    full, partial = ROUND_NUMBERS_128[width]
    ext = limb.pack_mont(spec, [[rng.randrange(p) for _ in range(width)] for _ in range(full)])
    ints = limb.pack_mont(spec, [rng.randrange(p) for _ in range(partial)])
    diag = tuple(rng.randrange(2, 41) for _ in range(width))
    perm2 = Poseidon2(spec, width, full, partial, np.moveaxis(ext, 0, 1), np.moveaxis(ints, 0, 1), diag, cuda)
    x = _states(spec, 129, 71 + width, cuda, width)
    x[:, :, :64] = limb.tensor(limb.pack_mont(spec, [p - 1]), cuda).reshape(-1, 1, 1)
    assert torch.equal(poseidon2_kernel.permute(perm2, x), poseidon2_kernel.poseidon2_permute_plain(perm2, x))


@pytest.mark.parametrize("which", poseidon_kernel.VARIANTS)
def test_k5_variants_match_plain_at_boundary_batches(cuda, which):
    """Both K5 variants at the batch sizes around a block of 128 states,
    a narrow Merkle level and the wrapper's switch between them."""
    perm = Poseidon.create(BN254_FR, 2, device=cuda)
    edge = poseidon_kernel.SPLIT_MAX_B
    x = _states(BN254_FR, edge + 1, 37, cuda)
    for B in (1, 2, 3, 127, 128, 129, 2047, 2048, edge, edge + 1):
        xb = x[:, :, :B].contiguous()
        assert torch.equal(poseidon_kernel.permute(perm, xb, which), poseidon_kernel.permute_plain(perm, xb)), B


def test_merkle_tree_on_cuda_matches_cpu(cuda):
    params = MerkleParameters(BN254_FR, 8)
    leaves = limb.to_mont(BN254_FR, _field(BN254_FR, 77, 19))
    gpu = MerkleTree.from_leaf_digests(params, leaves.to(cuda))
    cpu = MerkleTree.from_leaf_digests(params, leaves, device="cpu")
    assert gpu.device.type == "cuda"
    assert all(torch.equal(g.cpu(), c) for g, c in zip(gpu.levels, cpu.levels))


def test_k8_takes_the_sharded_transforms_sub_transforms(cuda):
    """The sharded transform's R-point sub-transforms (R the mesh size):
    K8's one launch at 2, 4 and 8 points batched over 2^13 columns,
    forward and inverse, bit-equal to its plain version."""
    batch = 1 << 13
    for log_n in (1, 2, 3):
        for inverse in (False, True):
            rev, table, n_inv = ntt._plan(BN254_FR, log_n, inverse, cuda)
            x = _field(BN254_FR, batch << log_n, 40 + log_n, cuda).reshape(BN254_FR.n_limbs, 1 << log_n, batch)
            x = x.contiguous()
            got = ntt_kernel.transform(BN254_FR, x, table, rev, n_inv, inverse)
            assert torch.equal(got, ntt_kernel.transform_plain(BN254_FR, x, table, rev, n_inv, inverse))


def test_sharded_functions_on_ranks_sharing_the_card(cuda, tmp_path):
    """Two gloo ranks on the card (their exchange through host memory) and
    a 1-rank NCCL mesh: the four sharded transforms at 2^13 and a sharded
    G1 MSM of 1000 points equal one device's."""
    import torch_mesh_tasks as tasks
    from openzl_tpu_torch.parallel.launch import RankPool

    x = _field(BN254_FR, 1 << 13, 50).numpy()
    rng = random.Random(51)
    pts = [ref.scalar_mul(BN254_G1, rng.randrange(1, 1 << 20), ref.generator(BN254_G1)) for _ in range(64)]
    pts = [pts[rng.randrange(64)] for _ in range(1000)]
    ks = [rng.randrange(BN254_G1.scalar.modulus) for _ in range(1000)]
    scal = limb.tensor(limb.pack(BN254_G1.scalar, np.array(ks, dtype=object)), cuda)
    want = jac.to_affine_ints(BN254_G1, msm.msm(BN254_G1, scal, jac.from_affine_ints(BN254_G1, pts, cuda)))
    for world, backend in ((2, "gloo"), (1, "nccl")):
        with RankPool(world, backend, tmp_path, devices=["cuda:0"] * world, timeout=300) as pool:
            for which, fn in (("ntt", ntt.ntt), ("intt", ntt.intt), ("coset_ntt", ntt.coset_ntt),
                              ("coset_intt", ntt.coset_intt)):
                one = fn(BN254_FR, limb.tensor(x, cuda)).cpu().numpy()
                for got in pool.run(tasks.transform, world, "BN254_FR", which, x, "cuda:0"):
                    assert np.array_equal(got, one), (backend, which)
            assert pool.run(tasks.msm, world, "bn254_g1", ks, pts, "cuda:0") == [want] * world
