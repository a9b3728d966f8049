"""ctypes loader for the repository's native host library (`native/*.cpp`,
built by `make -C native` into `native/libozlfield.so`; g++ only).

The port's own copy of the loader of `openzl_tpu/native/__init__.py`,
keeping what the port calls: ints -> Montgomery planar limbs
(`fields.limb.pack_mont`), the pairing-product check (`ref.pairing`) and the
witness-tape replay (`eclair.witness`). Each returns None (or `available()`
is False) when the library is not built, and the callers take their
pure-Python paths.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import numpy as np

from .fields.spec import FieldSpec

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native",
    "libozlfield.so",
)


@functools.lru_cache(maxsize=1)
def _lib() -> Optional[ctypes.CDLL]:
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.ozl_to_mont_limbs16.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int, u64p, u64p,
        ctypes.c_uint64, ctypes.c_int, u32p, ctypes.c_int,
    ]
    lib.ozl_from_mont_limbs16.argtypes = [
        u32p, ctypes.c_int64, u64p, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int,
    ]
    lib.ozl_pack_limbs16.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int, u32p, ctypes.c_int,
    ]
    lib.ozl_unpack_limbs16.argtypes = [
        u32p, ctypes.c_int64, ctypes.c_int, u8p, ctypes.c_int,
    ]
    lib.ozl_pairing_product_is_one.argtypes = [
        u8p, u8p, ctypes.c_uint64, ctypes.c_int,  # mod, r2, n0inv, n64
        ctypes.c_int, u8p, ctypes.c_int,  # beta_abs, xi, twist_d
        u8p, ctypes.c_int, ctypes.c_int,  # ate bytes/len/negative
        u8p, ctypes.c_int,  # inv_exp (p-2)
        u8p, ctypes.c_int,  # hard_exp ((p^4-p^2+1)/r)
        u8p,  # gamma_w (Fq)
        u8p, ctypes.c_int,  # pairs, n_pairs
    ]
    lib.ozl_pairing_product_is_one.restype = ctypes.c_int
    lib.ozl_witness_eval.argtypes = [
        u8p, u8p, ctypes.c_uint64, ctypes.c_int,  # mod, r2, n0inv, n64
        u8p, ctypes.c_int,  # inv_exp (p-2)
        ctypes.c_int64,  # n_vars
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,  # preset cols
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,  # ops
        ctypes.POINTER(ctypes.c_int32),  # lc_cols
        u8p,  # lc_coeffs (Montgomery)
        u8p,  # moduli (canonical)
        u8p,  # z in/out
    ]
    lib.ozl_witness_eval.restype = ctypes.c_int
    return lib


def available() -> bool:
    return _lib() is not None


def _u64_limbs(x: int, n64: int) -> np.ndarray:
    return np.array(
        [(x >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(n64)],
        dtype=np.uint64,
    )


def _field_consts(spec: FieldSpec):
    n64 = -(-spec.n_limbs // 4)
    r = (1 << (64 * n64)) % spec.modulus
    # the python radix 2^(16*n16) must equal 2^(64*n64): n16 = 4*n64 always
    # holds for our fields (n_limbs is computed from bit length; assert it)
    assert spec.n_limbs == 4 * n64 or (1 << (16 * spec.n_limbs)) == (
        1 << (64 * n64)
    ), f"radix mismatch for {spec.name}"
    r2 = r * r % spec.modulus
    n0inv = (-pow(spec.modulus, -1, 1 << 64)) % (1 << 64)
    return (
        _u64_limbs(spec.modulus, n64),
        _u64_limbs(r2, n64),
        np.uint64(n0inv),
        n64,
    )


def _as_bytes_le(spec: FieldSpec, values: np.ndarray) -> tuple[np.ndarray, int]:
    stride = -(-spec.bits // 8)
    flat = values.reshape(-1)
    buf = np.empty((flat.shape[0], stride), dtype=np.uint8)
    for i, v in enumerate(flat):
        buf[i] = np.frombuffer(
            int(v).to_bytes(stride, "little"), dtype=np.uint8
        )
    return buf, stride


def to_mont_limbs(spec: FieldSpec, values) -> Optional[np.ndarray]:
    """Python ints -> Montgomery planar limbs (n_limbs, *batch); None if the
    native library is unavailable, or if the field's limb count is not a
    multiple of 4 (BabyBear's 2): the converter's radix 2^(64 n64) is then
    not the limbs' 2^(16 n_limbs)."""
    lib = _lib()
    if lib is None or spec.n_limbs % 4:
        return None
    arr = np.asarray(values, dtype=object)
    buf, stride = _as_bytes_le(spec, arr)
    count = buf.shape[0]
    mod, r2, n0inv, n64 = _field_consts(spec)
    out = np.empty((spec.n_limbs, count), dtype=np.uint32)
    lib.ozl_to_mont_limbs16(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        count,
        stride,
        mod.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        r2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n0inv,
        n64,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        spec.n_limbs,
    )
    return out.reshape((spec.n_limbs,) + arr.shape)


# ---------------------------------------------------------------------------
# native pairing (native/pairing.cpp)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _pairing_consts(spec):
    """Precompute the curve-independent marshalling constants for a
    PairingSpec: Montgomery parameters, exponent byte strings, and the
    p^2-Frobenius scalar gamma_w = xi^((p^2-1)/6) (must land in Fq)."""
    from .ref import fields as tf

    p = spec.p
    r = spec.r
    n64 = -(-p.bit_length() // 64)
    stride = n64 * 8
    R = 1 << (64 * n64)
    r2 = (R * R) % p
    n0inv = (-pow(p, -1, 1 << 64)) % (1 << 64)
    beta_abs = -spec.beta
    assert beta_abs >= 1
    hard_num = p**4 - p**2 + 1
    if hard_num % r:
        return None  # not a BLS/BN-style embedding-degree-12 family
    hard = hard_num // r
    e = (p * p - 1) // 6
    if (p * p - 1) % 6:
        return None
    acc, base = (1, 0), spec.xi
    while e:
        if e & 1:
            acc = tf.f2_mul(p, acc, base, spec.beta)
        base = tf.f2_mul(p, base, base, spec.beta)
        e >>= 1
    if acc[1] != 0:
        return None  # gamma_w not in Fq: tower shape unsupported natively

    def le(x, nbytes=None):
        nb = nbytes or stride
        return int(x).to_bytes(nb, "little")

    return {
        "n64": n64,
        "stride": stride,
        "mod": le(p),
        "r2": le(r2),
        "n0inv": n0inv,
        "beta_abs": beta_abs,
        "xi": le(spec.xi[0]) + le(spec.xi[1]),
        "twist_d": 1 if spec.twist_type == "D" else 0,
        "ate": le(spec.ate_loop, -(-spec.ate_loop.bit_length() // 8)),
        "ate_neg": 1 if spec.ate_negative else 0,
        "inv_exp": le(p - 2),
        "hard": le(hard, -(-hard.bit_length() // 8)),
        "gw": le(acc[0]),
    }


def pairing_product_is_one(spec, pairs):
    """Native prod e(P_i, Q_i) == 1 check; None if unavailable.

    pairs: [(P, Q)] with P = (x, y) ints, Q = ((x0,x1), (y0,y1));
    infinite pairs must already be filtered out by the caller.
    """
    lib = _lib()
    if lib is None:
        return None
    consts = _pairing_consts(spec)
    if consts is None:
        return None
    if not pairs:
        return True
    stride = consts["stride"]

    def le(x):
        return int(x).to_bytes(stride, "little")

    buf = bytearray()
    for P, Q in pairs:
        (px, py), (qx, qy) = P, Q
        buf += le(px) + le(py)
        buf += le(qx[0]) + le(qx[1]) + le(qy[0]) + le(qy[1])
    u8p = ctypes.POINTER(ctypes.c_uint8)

    def bp(b):
        return ctypes.cast(ctypes.create_string_buffer(bytes(b), len(b)), u8p)

    rc = lib.ozl_pairing_product_is_one(
        bp(consts["mod"]), bp(consts["r2"]),
        ctypes.c_uint64(consts["n0inv"]), consts["n64"],
        consts["beta_abs"], bp(consts["xi"]), consts["twist_d"],
        bp(consts["ate"]), len(consts["ate"]), consts["ate_neg"],
        bp(consts["inv_exp"]), len(consts["inv_exp"]),
        bp(consts["hard"]), len(consts["hard"]),
        bp(consts["gw"]),
        bp(buf), len(pairs),
    )
    if rc < 0:
        return None
    return bool(rc)


# ---------------------------------------------------------------------------
# witness-tape evaluation (native/witness.cpp)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _prime_consts(p: int):
    """(mod_bytes, r2_bytes, n0inv, n64, inv_exp_bytes) for a prime p."""
    n64 = -(-p.bit_length() // 64)
    stride = n64 * 8
    r2 = pow(1 << (64 * n64), 2, p)
    n0inv = (-pow(p, -1, 1 << 64)) % (1 << 64)
    return (
        p.to_bytes(stride, "little"),
        r2.to_bytes(stride, "little"),
        n0inv,
        n64,
        (p - 2).to_bytes(stride, "little"),
    )


def pack_witness_tape(p: int, ops, lc_cols, lc_coeffs, moduli):
    """One-time flattening of a hint tape into C-ready buffers (see
    eclair/witness.py); returns an opaque dict or None when the native
    library is unavailable."""
    if _lib() is None:
        return None
    mod_b, r2_b, n0inv, n64, inv_exp = _prime_consts(p)
    stride = n64 * 8
    shift = 64 * n64

    # Montgomery-form coefficient pool; small coeffs repeat heavily (1, -1,
    # powers of two), so memoize the bigint transform per distinct value.
    cache = {}

    def mont_bytes(cval: int) -> bytes:
        b = cache.get(cval)
        if b is None:
            b = ((cval << shift) % p).to_bytes(stride, "little")
            cache[cval] = b
        return b

    return {
        "p": p,
        "n64": n64,
        "stride": stride,
        "mod_b": mod_b,
        "r2_b": r2_b,
        "n0inv": n0inv,
        "inv_exp": inv_exp,
        "coeff_buf": b"".join(mont_bytes(int(cv)) for cv in lc_coeffs),
        "mod_buf": b"".join(
            int(m).to_bytes(stride, "little") for m in moduli
        ),
        "ops": np.ascontiguousarray(ops, dtype=np.int32),
        "cols": np.ascontiguousarray(lc_cols, dtype=np.int32),
    }


def witness_eval(packed, n_vars: int, preset_cols: np.ndarray, preset_vals):
    """Replay a packed hint tape; returns the full canonical assignment as
    raw LE bytes (n_vars x packed['stride'])."""
    lib = _lib()
    assert lib is not None and packed is not None
    stride = packed["stride"]

    z = bytearray(n_vars * stride)
    pc = np.ascontiguousarray(preset_cols, dtype=np.int32)
    for col, v in zip(pc, preset_vals):
        z[int(col) * stride : (int(col) + 1) * stride] = int(v).to_bytes(
            stride, "little"
        )

    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)

    def bp(b):
        # zero-copy view of an immutable bytes object (C side only reads;
        # the object is kept alive by `packed` / this frame for the call)
        return ctypes.cast(ctypes.c_char_p(b or b"\0"), u8p)

    ops_arr, cols_arr = packed["ops"], packed["cols"]
    zbuf = (ctypes.c_uint8 * len(z)).from_buffer(z)
    rc = lib.ozl_witness_eval(
        bp(packed["mod_b"]), bp(packed["r2_b"]),
        ctypes.c_uint64(packed["n0inv"]), packed["n64"],
        bp(packed["inv_exp"]), len(packed["inv_exp"]),
        ctypes.c_int64(n_vars),
        pc.ctypes.data_as(i32p), ctypes.c_int64(len(pc)),
        ops_arr.ctypes.data_as(i32p), ctypes.c_int64(ops_arr.shape[0]),
        cols_arr.ctypes.data_as(i32p),
        bp(packed["coeff_buf"]),
        bp(packed["mod_buf"]),
        ctypes.cast(zbuf, u8p),
    )
    if rc == 2:
        raise ZeroDivisionError("witness tape: inverse of zero")
    if rc != 0:
        raise RuntimeError(f"native witness evaluation failed (rc={rc})")
    return bytes(z)
