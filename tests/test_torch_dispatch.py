"""What the port's kernel wrappers do around a launch, checked on the CPU:
the launch counts by batch width (`build.KernelInfo`), K9's point-major
copy of the points (`ec_kernel.point_words`) against the limb-planar
points, the K5 wrapper's choice of variant by batch and width, and the
Poseidon wrappers' state widths: K5 and K6 launch at every width from 2
to 17 and K7 at 2, 3, 4, 8 and 12, and any other width (or K5's split
variant at a width but 3) is refused before the library is called.

The launch path is driven on CPU tensors with the kernel library replaced
by a recording stand-in (`_FakeLib`), whose K5 entry point computes the
plain permutation on the buffers the wrapper hands it; another stand-in
(`_RecordingLib`) shows that the EC wrappers refuse a field with no built
instantiation (2 limbs; a p past `F1c`'s bound) before any launch, and
launch BN254 (16 limbs) and BLS12-381 (24 limbs). Through it a BN254
Merkle build, the slice's entry point, is held against the JAX package's
Python-int Poseidon oracle (`CurrentPath`). A transform below the
four-step threshold reaches the library as one K8 transform launch and
nothing else (`_TransformLib`, which computes the plain transform on the
buffers it is handed), with the wrapper's cluster size; a 24-limb field
and N = 2^13 are refused before it; fields of other limb counts run a
K8 stage launch a stage instead. From 2^13 (or with the threshold
lowered) each of the four transforms reaches the library as one K2 level
launch a level and nothing else (`_LevelLib`, which computes the plain
level), with the level shapes, the coset scales in the first level's load
and the inverse's scales in the last level's store, and a new plan when
`ntt_kernel.M_MAX` changes the level split. Inputs come from seeded
`random.Random` / numpy; every comparison is exact (tolerance 0)."""

import collections
import ctypes
import os
import random

import numpy as np
import pytest
import torch

from openzl_tpu.crypto.merkle import path as ref_path
from openzl_tpu.crypto.merkle.tree import MerkleParameters as RefParameters
from openzl_tpu.fields import limb as ref_limb
from openzl_tpu.fields.spec import BN254_FR as REF_BN254_FR
from openzl_tpu_torch.crypto.merkle.tree import MerkleParameters, MerkleTree
from openzl_tpu_torch.crypto.poseidon.permutation import Poseidon
from openzl_tpu_torch.curves import jacobian as jac
from openzl_tpu_torch.curves.spec import BLS12_381_G1, BLS12_381_G2, BN254_G1, BN254_G2
from openzl_tpu_torch.fields import limb
from openzl_tpu_torch.fields.spec import BN254_FR
from openzl_tpu_torch.ops import ec_kernel, poseidon_kernel
from openzl_tpu_torch.ref import curve as ref
from openzl_tpu_torch.utils import build

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _view(ptr: int, shape) -> np.ndarray:
    """The int32 buffer at a data pointer, as a numpy array (no copy)."""
    n = int(np.prod(shape))
    return np.ctypeslib.as_array((ctypes.c_int32 * n).from_address(ptr)).reshape(shape)


class _FakeLib:
    """Stands in for the kernel library: records each K5 launch's batch and
    variant flag (`calls`) and state width (`widths`) and, when `compute`,
    writes the plain permutation of the instance of that width into the
    output."""

    def __init__(self, *perms):
        self.perms, self.calls, self.widths, self.compute = {p.width: p for p in perms}, [], [], True

    def ozl_poseidon_permute(self, out, state, consts, B, split, width, rf, rp, n_limbs, p, n0, stream):
        self.calls.append((B, split))
        self.widths.append(width)
        if not self.compute:
            return 0
        x = torch.from_numpy(_view(state, (n_limbs, width, B)).copy())
        _view(out, (n_limbs, width, B))[...] = poseidon_kernel.permute_plain(self.perms[width], x).numpy()
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """The K5 wrapper's launch path on CPU tensors, through `_FakeLib`."""
    perm = Poseidon.create(BN254_FR, 2, device="cpu")
    fake = _FakeLib(perm)
    monkeypatch.setattr(poseidon_kernel, "device_kind", lambda *t: "cuda")
    monkeypatch.setattr(build, "lib", lambda: fake)
    monkeypatch.setattr(build, "stream_ptr", lambda t: None)
    monkeypatch.setattr(poseidon_kernel.K5, "launches", 0)
    monkeypatch.setattr(poseidon_kernel.K5, "by_width", {})
    monkeypatch.setattr(poseidon_kernel.K5, "by_state_width", {})
    return perm, fake


def test_launch_counts_by_width():
    k = build.KernelInfo(name="k", source="s", replaces="r")
    for batch in (1, 2, 3, 4, 5, 128, 129, 16896, 1 << 17, 0):
        k.count(batch)
    assert k.launches == 10
    assert k.by_width == {1: 1, 2: 1, 4: 2, 8: 1, 128: 1, 256: 1, 32768: 1, 1 << 17: 1, 0: 1}
    k.reset()
    assert (k.launches, k.by_width) == (0, {})


@pytest.mark.parametrize("curve", [BN254_G1, BN254_G2], ids=lambda c: c.name)
def test_point_words_match_limb_planar_points(curve):
    rng = random.Random(41)
    G = ref.generator(curve)
    pts = [ref.scalar_mul(curve, rng.randrange(1, 1 << 64), G) for _ in range(9)]
    P = jac.from_affine_ints(curve, pts)
    words = ec_kernel.point_words(curve, P)
    n, ext = curve.base.n_limbs, curve.ext
    assert words.dtype == torch.int32 and tuple(words.shape) == (9, ext * n) and words.is_contiguous()
    w = words.to(torch.int64) & 0xFFFFFFFF
    limbs = torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(9, 2, ext, n)  # point, X/Y, c, limb
    for k, coord in enumerate((P.x, P.y)):
        planar = coord.reshape(n, ext, 9) if ext == 2 else coord[:, None, :]
        assert torch.equal(limbs[:, k], planar.permute(2, 1, 0).to(torch.int64))


def test_k5_wrapper_picks_variant_by_batch(fake_card):
    perm, fake = fake_card
    fake.compute = False
    edge = poseidon_kernel.SPLIT_MAX_B
    assert [poseidon_kernel.variant(b) for b in (1, 2048, edge, edge + 1, 1 << 16)] == \
        ["split", "split", "split", "wide", "wide"]
    x = torch.zeros((BN254_FR.n_limbs, 3, edge + 1), dtype=torch.int32)
    for B in (1, edge, edge + 1):
        poseidon_kernel.permute(perm, x[:, :, :B].contiguous())
    poseidon_kernel.permute(perm, x[:, :, :5].contiguous(), "wide")
    poseidon_kernel.permute(perm, x.contiguous(), "split")
    assert fake.calls == [(1, 1), (edge, 1), (edge + 1, 0), (5, 0), (edge + 1, 1)]
    assert poseidon_kernel.K5.launches == 5
    want = collections.Counter(1 << (b - 1).bit_length() for b in (1, edge, edge + 1, 5, edge + 1))
    assert poseidon_kernel.K5.by_width == dict(want)
    with pytest.raises(ValueError, match="variant"):
        poseidon_kernel.permute(perm, x[:, :, :5].contiguous(), "both")


def test_k5_wide_at_width_5_matches_plain(fake_card):
    """A width-5 state goes through the K5 launch path as "wide" (the split
    variant is width 3's), the launch counted under its state width."""
    _, fake = fake_card
    perm = Poseidon.create(BN254_FR, 4, device="cpu")
    fake.perms[5] = perm
    assert poseidon_kernel.variant(1, 5) == poseidon_kernel.variant(1 << 16, 5) == "wide"
    rng = np.random.default_rng(47)
    vals = np.array([[int.from_bytes(rng.bytes(40), "little") % BN254_FR.modulus for _ in range(6)]
                     for _ in range(5)], dtype=object)
    x = limb.tensor(limb.pack_mont(BN254_FR, vals), "cpu")
    assert torch.equal(poseidon_kernel.permute(perm, x), poseidon_kernel.permute_plain(perm, x))
    assert (fake.calls, fake.widths) == ([(6, 0)], [5])
    assert poseidon_kernel.K5.by_state_width == {5: 1}


def test_merkle_build_through_k5_launch_path_matches_reference(fake_card):
    """Every level of a BN254 build goes through the K5 launch path (the
    split variant: each level is narrow) and the root equals the JAX
    package's oracle root."""
    perm, fake = fake_card
    height, count = 6, 11
    rng = np.random.default_rng(43)
    vals = np.array([int.from_bytes(rng.bytes(40), "little") % BN254_FR.modulus for _ in range(count)], dtype=object)
    leaves = ref_limb.pack_mont(REF_BN254_FR, vals)
    tree = MerkleTree.from_leaf_digests(MerkleParameters(BN254_FR, height), leaves, device="cpu")
    ref_cur = ref_path.CurrentPath.empty(RefParameters(REF_BN254_FR, height))
    for i in range(count):
        ref_cur = ref_cur.push(leaves[:, i])
    assert [b for b, _ in fake.calls] == [6, 3, 2, 1, 1] and all(split for _, split in fake.calls)
    assert torch.equal(tree.root(), limb.tensor(np.asarray(ref_cur.root_digest), "cpu"))


class _RecordingLib:
    """Stands in for the kernel library: records every entry point called."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("ozl_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append(name) or 0


def _wide_top_curve():
    """A 16-limb curve whose p has its top 32-bit word above F1c's bound."""
    import dataclasses

    from openzl_tpu_torch.fields.spec import FieldSpec

    return dataclasses.replace(BN254_G1, name="wide_top_g1", base=FieldSpec("wide_top_fq", (1 << 256) - 189))


@pytest.mark.parametrize("which", ["toy", "wide_top"])
def test_ec_wrappers_refuse_an_unbuilt_field_before_any_launch(which, monkeypatch):
    """On a CUDA tensor (the wrappers' device check patched to "cuda"), K3,
    K4, K9 and the scan raise a ValueError that names the curve and its
    limb count for a field with no built instantiation (the 2-limb toy
    curve; a 16-limb p past F1c's bound), and the library is never called."""
    from openzl_tpu.curves.spec import toy_curve

    curve = toy_curve() if which == "toy" else _wide_top_curve()
    n = curve.base.n_limbs
    fake = _RecordingLib()
    monkeypatch.setattr(ec_kernel, "device_kind", lambda *t: "cuda")
    monkeypatch.setattr(build, "lib", lambda: fake)
    monkeypatch.setattr(build, "stream_ptr", lambda t: None)
    P = tuple(torch.zeros((n, 4), dtype=torch.int32) for _ in range(3))
    keys = torch.zeros(4, dtype=torch.int64)
    calls = (lambda: ec_kernel.ec_add(curve, P, P), lambda: ec_kernel.ec_add(curve, P, P, True),
             lambda: ec_kernel.ec_dbl(curve, P),
             lambda: ec_kernel.fold_madd(curve, P, keys, keys, 1, 2),
             lambda: ec_kernel.lifted_scan(curve, P, torch.zeros(4, dtype=torch.bool)))
    for call in calls:
        with pytest.raises(ValueError, match=rf"{curve.name}.*\b{n}\b"):
            call()
    assert fake.calls == []


@pytest.mark.parametrize("curve", [BN254_G1, BN254_G2, BLS12_381_G1, BLS12_381_G2], ids=lambda c: c.name)
def test_ec_wrappers_launch_the_built_fields(curve, monkeypatch):
    """BN254 (16 limbs) and BLS12-381 (24 limbs) pass the check and reach
    the library's entry points, each launch counted with its limb count."""
    fake = _RecordingLib()
    monkeypatch.setattr(ec_kernel, "device_kind", lambda *t: "cuda")
    monkeypatch.setattr(build, "lib", lambda: fake)
    monkeypatch.setattr(build, "stream_ptr", lambda t: None)
    for k in (ec_kernel.K3, ec_kernel.K4):
        monkeypatch.setattr(k, "launches", 0)
        monkeypatch.setattr(k, "by_width", {})
        monkeypatch.setattr(k, "by_limbs", {})
    ec_kernel.check_built(curve)
    head = (curve.base.n_limbs,) + ((2,) if curve.ext == 2 else ())
    P = tuple(torch.zeros(head + (4,), dtype=torch.int32) for _ in range(3))
    ec_kernel.ec_add(curve, P, P)
    ec_kernel.ec_dbl(curve, P)
    assert fake.calls == ["ozl_ec_add", "ozl_ec_dbl"]
    assert ec_kernel.K3.by_limbs == ec_kernel.K4.by_limbs == {curve.base.n_limbs: 1}


class _WidthLib:
    """Stands in for the kernel library: records each Poseidon entry point
    called with the state width it was given."""

    def __init__(self):
        self.calls = []

    def ozl_poseidon_permute(self, out, state, consts, B, split, width, *rest):
        self.calls.append(("ozl_poseidon_permute", width, split))
        return 0

    def ozl_poseidon_permute_opt(self, out, state, consts, B, width, *rest):
        self.calls.append(("ozl_poseidon_permute_opt", width))
        return 0

    def ozl_poseidon2_permute(self, out, state, consts, B, width, *rest):
        self.calls.append(("ozl_poseidon2_permute", width))
        return 0


@pytest.fixture
def width_card(monkeypatch):
    """The Poseidon wrappers' launch paths on CPU tensors through
    `_WidthLib`, with instances of any width made from the width-3 ones
    (`dataclasses.replace`: the stand-in reads no constant)."""
    import dataclasses

    from openzl_tpu_torch.crypto.poseidon2 import Poseidon2
    from openzl_tpu_torch.ops import poseidon2_kernel

    fake = _WidthLib()
    for mod in (poseidon_kernel, poseidon2_kernel):
        monkeypatch.setattr(mod, "device_kind", lambda *t: "cuda")
    monkeypatch.setattr(build, "lib", lambda: fake)
    monkeypatch.setattr(build, "stream_ptr", lambda t: None)
    for k in (poseidon_kernel.K5, poseidon_kernel.K6, poseidon2_kernel.K7):
        monkeypatch.setattr(k, "launches", 0)
        monkeypatch.setattr(k, "by_width", {})
        monkeypatch.setattr(k, "by_state_width", {})
    perm, perm2 = Poseidon.create(BN254_FR, 2, device="cpu"), Poseidon2.create(BN254_FR, 2, device="cpu")

    def at(width, two=False):
        return dataclasses.replace(perm2 if two else perm, width=width, _dev={})

    def state(width):
        return torch.zeros((BN254_FR.n_limbs, width, 4), dtype=torch.int32)

    return fake, at, state, poseidon2_kernel


def test_poseidon_wrappers_launch_every_built_width(width_card):
    """K5 and K6 reach the library at every width from 2 to 17 (K5 split
    only at width 3, where 4 states are a narrow batch), K7 at 2, 3, 4, 8
    and 12, each launch counted under its state width."""
    fake, at, state, poseidon2_kernel = width_card
    for w in poseidon_kernel.KERNEL_WIDTHS:
        poseidon_kernel.permute(at(w), state(w))
        poseidon_kernel.permute_optimized(at(w), state(w))
    for w in poseidon2_kernel.KERNEL_WIDTHS:
        poseidon2_kernel.permute(at(w, two=True), state(w))
    assert poseidon_kernel.KERNEL_WIDTHS == tuple(range(2, 18))
    assert poseidon2_kernel.KERNEL_WIDTHS == (2, 3, 4, 8, 12)
    want = [c for w in poseidon_kernel.KERNEL_WIDTHS
            for c in (("ozl_poseidon_permute", w, int(w == 3)), ("ozl_poseidon_permute_opt", w))]
    want += [("ozl_poseidon2_permute", w) for w in poseidon2_kernel.KERNEL_WIDTHS]
    assert fake.calls == want
    for k, widths in ((poseidon_kernel.K5, poseidon_kernel.KERNEL_WIDTHS),
                      (poseidon_kernel.K6, poseidon_kernel.KERNEL_WIDTHS),
                      (poseidon2_kernel.K7, poseidon2_kernel.KERNEL_WIDTHS)):
        assert k.by_state_width == {w: 1 for w in widths}


def test_poseidon_wrappers_refuse_unbuilt_widths_before_any_launch(width_card):
    """A width outside the built set raises a ValueError naming the width
    and the built widths, and "split" raises at any width but 3, before
    the library is called."""
    fake, at, state, poseidon2_kernel = width_card
    for w in (1, 18, 20):
        with pytest.raises(ValueError, match=rf"widths 2, 3, .*, 17 .*not width {w} "):
            poseidon_kernel.permute(at(w), state(w))
        with pytest.raises(ValueError, match=rf"not width {w} "):
            poseidon_kernel.permute_optimized(at(w), state(w))
    for w in (5, 6, 16):
        with pytest.raises(ValueError, match=rf"widths 2, 3, 4, 8, 12 .*not width {w} "):
            poseidon2_kernel.permute(at(w, two=True), state(w))
    for w in (2, 4, 5, 17):
        with pytest.raises(ValueError, match=rf"split variant .*width 3 only, not width {w}"):
            poseidon_kernel.permute(at(w), state(w), "split")
    assert fake.calls == []
    poseidon_kernel.permute(at(3), state(3), "split")
    assert fake.calls == [("ozl_poseidon_permute", 3, 1)]


class _TransformLib:
    """Stands in for the kernel library with K8's transform entry alone:
    records (log_n, B, cluster, inverse) and writes the plain transform of
    the buffers into the output. Any other entry point is missing, so a
    stage or K1 launch fails the caller."""

    def __init__(self, spec):
        self.spec, self.calls = spec, []

    def ozl_ntt_transform(self, out, x, table, n_inv, log_n, B, cluster, n_limbs, p, n0, stream):
        from openzl_tpu_torch.ops import ntt, ntt_kernel

        N = 1 << log_n
        self.calls.append((log_n, B, cluster, n_inv is not None))
        xt = torch.from_numpy(_view(x, (n_limbs, N, B)).copy())
        tt = torch.from_numpy(_view(table, (n_limbs, N // 2)).copy())
        scale = torch.from_numpy(_view(n_inv, (n_limbs,)).copy()) if n_inv is not None else None
        rev = torch.as_tensor(ntt._bitrev(N))
        _view(out, (n_limbs, N, B))[...] = ntt_kernel.transform_plain(self.spec, xt, tt, rev, scale,
                                                                       n_inv is not None).numpy()
        return 0


def test_small_transform_is_one_transform_launch(monkeypatch):
    """`ntt._ntt_core` on a (stand-in) card: one `ozl_ntt_transform` call a
    transform, forward and inverse, batch 1 and 3, with the wrapper's
    cluster size, its result the plain route's; a 24-limb field and N =
    2^13 raise a ValueError before any call."""
    from openzl_tpu_torch.curves.spec import BLS12_381_G1
    from openzl_tpu_torch.ops import ntt, ntt_kernel

    fake = _TransformLib(BN254_FR)
    rng = random.Random(81)
    cases = [(6, ()), (10, (3,)), (1, ())]
    inputs = {c: limb.tensor(limb.pack_mont(BN254_FR, np.array(
        [rng.randrange(BN254_FR.modulus) for _ in range((1 << c[0]) * int(np.prod(c[1])))], dtype=object
    ).reshape((1 << c[0],) + c[1]))) for c in cases}
    want = {(c, inv): ntt._ntt_core(BN254_FR, inputs[c], inv) for c in cases for inv in (False, True)}
    ntt._plan(BN254_FR, 13, False, torch.device("cpu"))
    monkeypatch.setattr(ntt_kernel, "device_kind", lambda *t: "cuda")
    monkeypatch.setattr(build, "lib", lambda: fake)
    monkeypatch.setattr(build, "stream_ptr", lambda t: None)
    monkeypatch.setattr(ntt_kernel, "_sm_count", lambda device: 132)
    monkeypatch.setattr(ntt_kernel.K8, "launches", 0)
    monkeypatch.setattr(ntt_kernel.K8, "by_width", {})
    for (log_n, batch), x in inputs.items():
        for inverse in (False, True):
            got = ntt._ntt_core(BN254_FR, x, inverse)
            assert torch.equal(got, want[(log_n, batch), inverse]), (log_n, batch, inverse)
    blocks = {6: ntt_kernel.CLUSTER[64], 10: ntt_kernel.CLUSTER[1024], 1: 1}
    assert fake.calls == [(log_n, int(np.prod(batch)), blocks[log_n], inv)
                          for log_n, batch in cases for inv in (False, True)]
    assert ntt_kernel.K8.launches == len(fake.calls)
    rev, table, n_inv = ntt._plan(BN254_FR, 13, False, torch.device("cpu"))
    with pytest.raises(ValueError, match="N=8192"):
        ntt_kernel.transform(BN254_FR, torch.zeros((16, 1 << 13), dtype=torch.int32), table, rev, n_inv, False)
    wide = BLS12_381_G1.base
    with pytest.raises(ValueError, match=f"{wide.name} has 24 limbs"):
        ntt_kernel.transform(wide, torch.zeros((24, 8), dtype=torch.int32), torch.zeros((24, 4), dtype=torch.int32),
                             None, None, False)
    assert len(fake.calls) == ntt_kernel.K8.launches == 6


@pytest.mark.parametrize("log_n", [1, 6])
def test_small_transform_routes_by_limb_count(log_n, monkeypatch):
    """`ntt._ntt_core` hands a 16-limb field's transform to K8's one launch
    (`transform`) and runs other fields (BabyBear, 2 limbs; BLS12-377 Fq,
    24) a K8 `stage` a stage, then the gather and, for the inverse, one K1
    scale; every result equals the plain transform."""
    from openzl_tpu_torch.fields.spec import FieldSpec
    from openzl_tpu_torch.ops import ntt, ntt_kernel

    fields = {BN254_FR: 16, FieldSpec("babybear", 2013265921): 2, FieldSpec(
        "bls12_377_fq",
        0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001,
    ): 24}
    calls = collections.Counter()

    def recorded(name):
        fn = getattr(ntt_kernel, name)

        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    for name in ("transform", "stage", "mont_scale"):
        monkeypatch.setattr(ntt_kernel, name, recorded(name))
    rng = random.Random(log_n)
    N = 1 << log_n
    for spec, n_limbs in fields.items():
        assert spec.n_limbs == n_limbs
        x = limb.tensor(limb.pack_mont(spec, [rng.randrange(spec.modulus) for _ in range(N)]))
        for inverse in (False, True):
            calls.clear()
            got = ntt._ntt_core(spec, x, inverse)
            rev, table, n_inv = ntt._plan(spec, log_n, inverse, x.device)
            assert torch.equal(got, ntt_kernel.transform_plain(spec, x, table, rev, n_inv, inverse))
            want = {"transform": 1} if n_limbs == 16 else {"stage": log_n, "mont_scale": int(inverse)}
            assert +calls == collections.Counter(want), (spec.name, inverse)


def test_native_converter_leaves_other_radixes_to_python(monkeypatch):
    """With the native library present, `limb.pack_mont` over a 2-limb
    field (BabyBear, whose radix 2^32 the converter's 64-bit words do not
    share) takes the Python conversion and never calls the library; a
    16-limb field still reaches it."""
    from openzl_tpu_torch import native
    from openzl_tpu_torch.fields.spec import FieldSpec

    class Lib:
        calls = 0

        def ozl_to_mont_limbs16(self, *args):
            Lib.calls += 1

    monkeypatch.setattr(native, "_lib", lambda: Lib())
    babybear = FieldSpec("babybear", 2013265921)
    vals = [0, 1, babybear.modulus - 1, 12345]
    got = limb.pack_mont(babybear, vals)
    assert got.tolist() == limb._ints_to_limbs(np.array([v * babybear.R % babybear.modulus for v in vals],
                                                        dtype=object), 2).tolist()
    assert Lib.calls == 0
    limb.pack_mont(BN254_FR, vals)
    assert Lib.calls == 1



class _LevelLib:
    """Stands in for the kernel library with K2's level entry alone:
    records (log_m, S, c, B, pre given, post given, post_one) and writes the
    plain level of the buffers into the output. Any other entry point is
    missing, so a K1 or K8 launch fails the caller."""

    def __init__(self, spec):
        self.spec, self.calls = spec, []

    def ozl_fourstep_level(self, out, x, roots, pre, post, post_one, log_n, log_m, S, c, B, tile, n_limbs, p, n0,
                           stream):
        from openzl_tpu_torch.ops import ntt_kernel

        N, nw = 1 << log_n, n_limbs // 2
        assert tile == ntt_kernel.level_tile(self.spec, log_m)
        self.calls.append((log_m, S, c, B, pre is not None, post is not None, post_one))
        table = lambda ptr, rows: torch.from_numpy(_view(ptr, (rows, nw)).copy())  # noqa: E731
        got = ntt_kernel.level_plain(
            self.spec, torch.from_numpy(_view(x, (n_limbs, N, B)).copy()), table(roots, N), log_m, (1 << log_m) * S,
            table(pre, N) if pre is not None else None,
            table(post, 1 if post_one else N) if post is not None else None,
        )
        _view(out, (n_limbs, N, B))[...] = got.numpy()
        return 0


@pytest.mark.parametrize("log_n,batch,m_max,threshold", [(13, 1, 64, None), (10, 3, 8, 1), (9, 1, 64, 1)])
def test_fourstep_route_is_one_k2_launch_a_level(log_n, batch, m_max, threshold, monkeypatch):
    """`ntt`, `intt`, `coset_ntt` and `coset_intt` on the four-step route on
    a (stand-in) card: one `ozl_fourstep_level` call a level of
    `ntt._levels`, each level reading (M, S, c) with S c = the next
    level's ..., g^i only in the first level's load of `coset_ntt`, 1/N
    (one element) in the last level's store of `intt` and 1/N g^-i (a
    table) in that of `coset_intt`; no other launch; results equal to the
    plain route's. 2^13 takes the route by default ([5, 4, 4]); 2^10 with
    M_MAX = 8 has four levels; a plan built under another M_MAX is not
    reused (each split's plan is built before the stand-in, whose missing K1
    entry would fail a plan built during the run)."""
    from openzl_tpu_torch.ops import ntt, ntt_kernel

    spec = BN254_FR
    if threshold is not None:
        monkeypatch.setattr(ntt, "_FOURSTEP_MIN", threshold)
    monkeypatch.setattr(ntt_kernel, "M_MAX", m_max)
    rng = random.Random(log_n)
    N = 1 << log_n
    vals = np.array([rng.randrange(spec.modulus) for _ in range(N * batch)], dtype=object).reshape(N, batch)
    x = limb.tensor(limb.pack_mont(spec, vals if batch > 1 else vals[:, 0]))
    fns = (ntt.ntt, ntt.intt, ntt.coset_ntt, ntt.coset_intt)
    want = {fn: fn(spec, x) for fn in fns}  # the plain route; builds the plans and coset tables
    levels = ntt._levels(log_n)
    other = 64 if m_max == 8 else 8
    monkeypatch.setattr(ntt_kernel, "M_MAX", other)
    ntt.ntt(spec, x)  # the plan of the other split, built by K1 products before the stand-in
    monkeypatch.setattr(ntt_kernel, "M_MAX", m_max)
    fake = _LevelLib(spec)
    monkeypatch.setattr(ntt_kernel, "device_kind", lambda *t: "cuda")
    monkeypatch.setattr(build, "lib", lambda: fake)
    monkeypatch.setattr(build, "stream_ptr", lambda t: None)
    monkeypatch.setattr(ntt_kernel.K2, "launches", 0)
    monkeypatch.setattr(ntt_kernel.K2, "by_width", {})
    monkeypatch.setattr(ntt_kernel.K2, "by_limbs", {})
    for fn in fns:
        fake.calls.clear()
        assert torch.equal(fn(spec, x), want[fn]), fn.__name__
        nt, c, shapes = N, batch, []
        for k, lm in enumerate(levels):
            last = k == len(levels) - 1
            inverse = fn in (ntt.intt, ntt.coset_intt)
            post = last and inverse
            shapes.append((lm, nt >> lm, c, batch, k == 0 and fn is ntt.coset_ntt, post, int(post and fn is ntt.intt)))
            c <<= lm
            nt >>= lm
        assert fake.calls == shapes, fn.__name__
    assert ntt_kernel.K2.launches == 4 * len(levels) and ntt_kernel.K2.by_limbs == {16: 4 * len(levels)}
    monkeypatch.setattr(ntt_kernel, "M_MAX", other)
    fake.calls.clear()
    assert torch.equal(ntt.ntt(spec, x), want[ntt.ntt])
    assert [call[0] for call in fake.calls] == ntt._levels(log_n) != levels
