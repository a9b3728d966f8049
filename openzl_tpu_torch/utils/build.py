"""Build and load the hand-written CUDA kernels (`openzl_tpu_torch/csrc`).

Every `csrc/*.cu` file is compiled by `nvcc` for Hopper (`sm_90a`) into one
shared library with a plain C interface, loaded with `ctypes`. The library
lives under `build/openzl_tpu_torch/` at the repository root, named by a hash
of the sources and flags, so an edited kernel rebuilds and an unchanged one
loads at once. Nothing is built when this module is imported: the first
kernel launch builds. A missing `nvcc` or a failed build raises; there is no
fallback.

C entry points take device pointers and the CUDA stream as `c_void_p` and
return `cudaGetLastError()` after the launch; :func:`check` raises on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "openzl_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIB = None


@dataclasses.dataclass
class KernelInfo:
    """One hand-written kernel: where it lives, what it replaces, and how
    many times a wrapper has launched it (plain counters the smoke run
    zeroes before driving the main path): in all, by the launch's batch
    rounded up to a power of two (`by_width`), so a ranking of the kernels
    can read the shapes the path really gives them, by the field's limb
    count where the wrapper gives it (`by_limbs`: 16 for BN254 Fq, 24 for
    BLS12-381 Fq), and by a permutation's state width where the wrapper
    gives it (`by_state_width`)."""

    name: str
    source: str
    replaces: str
    route: str = "cuda"
    launches: int = 0
    by_width: dict = dataclasses.field(default_factory=dict)
    by_limbs: dict = dataclasses.field(default_factory=dict)
    by_state_width: dict = dataclasses.field(default_factory=dict)

    def count(self, batch: int, limbs: Optional[int] = None, state_width: Optional[int] = None) -> None:
        """Record one launch over `batch` elements (states, points, ...) of
        a field of `limbs` 16-bit limbs, states of `state_width` elements."""
        self.launches += 1
        bucket = 1 << (int(batch) - 1).bit_length() if batch > 0 else 0
        self.by_width[bucket] = self.by_width.get(bucket, 0) + 1
        if limbs is not None:
            self.by_limbs[limbs] = self.by_limbs.get(limbs, 0) + 1
        if state_width is not None:
            self.by_state_width[state_width] = self.by_state_width.get(state_width, 0) + 1

    def reset(self) -> None:
        self.launches = 0
        self.by_width = {}
        self.by_limbs = {}
        self.by_state_width = {}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libozl_torch_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels if the hashed library is missing; returns its
    path. Each `.cu` file compiles to an object in its own nvcc process
    (in parallel), then one link. The `-Xptxas -v` report (registers,
    spills) is kept beside the library as `<library>.log`, after one line
    per file, "nvcc <file>: <seconds> s", the wall time of its process."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
        procs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    results = [None] * len(procs)

    def wait(i, proc):  # each process's output is read as it comes (no full pipe)
        text, _ = proc.communicate()
        results[i] = (text, time.perf_counter() - t0)

    waiters = [threading.Thread(target=wait, args=(i, proc)) for i, (_, proc) in enumerate(procs)]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    report, failed = [], []
    for (obj, proc), (_, secs) in zip(procs, results):
        report.append(f"nvcc {obj.name.split('.')[-2]}.cu: {secs:.1f} s\n")
        if proc.returncode != 0:
            failed.append(obj.name)
    report += [text for text, _ in results]
    log = out.with_suffix(".log")
    if not failed:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *(str(o) for o, _ in procs)],
            capture_output=True, text=True,
        )
        report.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append("link")
    log.write_text("".join(report))
    for obj, _ in procs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}; see {log}:\n{''.join(report)[-4000:]}")
    tmp.replace(out)
    return out


_VP = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32

_SIGNATURES = {
    # (out, a, b, N, b_limb_stride, b_elem_stride, n_limbs, p, n0, stream)
    "ozl_mont_mul": [_VP, _VP, _VP, _I64, _I64, _I64, _I, _VP, _U32, _VP],
    # (out, a, N, exponent words, bits, n_limbs, p, n0, one, stream)
    "ozl_mont_pow": [_VP, _VP, _I64, _VP, _I, _I, _VP, _U32, _VP, _VP],
    # (out, x, roots, pre|0, post|0, post_one, log_n, log_m, S, c, B, tile,
    #  n_limbs, p, n0, stream)
    "ozl_fourstep_level": [_VP] * 5 + [_I, _I, _I, _I64, _I64, _I64, _I, _I, _VP, _U32, _VP],
    # (u, t, in_ls, tw, tw_ls, mask, lo, hi, out_ls, out_ks, H, B, n_limbs,
    #  p, n0, stream)
    "ozl_butterfly": [_VP, _VP, _I64, _VP, _I64, _I64, _VP, _VP, _I64, _I64, _I64, _I64, _I, _VP, _U32, _VP],
    # (out, x, table, n_inv|0, log_n, B, cluster, n_limbs, p, n0, stream)
    "ozl_ntt_transform": [_VP, _VP, _VP, _VP, _I, _I64, _I, _I, _VP, _U32, _VP],
    # (mixed, ext, x1, y1, z1, x2, y2, z2, x3, y3, z3, N, n_limbs, p, n0,
    #  beta, has_a, a_words, stream)
    "ozl_ec_add": [_I, _I] + [_VP] * 9 + [_I64, _I, _VP, _U32, _I, _I, _VP, _VP],
    # (ext, x1, y1, z1, x3, y3, z3, N, n_limbs, p, n0, beta, has_a, a, stream)
    "ozl_ec_dbl": [_I] + [_VP] * 6 + [_I64, _I, _VP, _U32, _I, _I, _VP, _VP],
    # (phase, ext, a x, y, z, flag, b x, y, z, flag, c x, y, z, flag, n, d,
    #  n_limbs, p, n0, beta, has_a, a, one, stream)
    "ozl_ec_lifted_scan": [_I, _I] + [_VP] * 12 + [_I64, _I64, _I, _VP, _U32, _I, _I, _VP, _VP, _VP],
    # (ext, keys, pidx, l, r, pts, tx, ty, tz, tflag, bx, by, bz, bflag,
    #  bchunk, width, n_limbs, p, n0, beta, has_a, a, one, stream)
    "ozl_fold_madd": [_I, _VP, _VP, _I64, _I, _VP] + [_VP] * 9
    + [_I64, _I, _VP, _U32, _I, _I, _VP, _VP, _VP],
    # (out, state, consts, B, split, width, full_rounds, partial_rounds,
    #  n_limbs, p, n0, stream)
    "ozl_poseidon_permute": [_VP] * 3 + [_I64, _I, _I, _I, _I, _I, _VP, _U32, _VP],
    # (out, state, consts, B, width, full_rounds, partial_rounds, n_limbs,
    #  p, n0, stream)
    "ozl_poseidon_permute_opt": [_VP] * 3 + [_I64, _I, _I, _I, _I, _VP, _U32, _VP],
    "ozl_poseidon2_permute": [_VP] * 3 + [_I64, _I, _I, _I, _I, _VP, _U32, _VP],
}


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = handle
    return _LIB


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
