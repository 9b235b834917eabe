"""Native (C++) host runtime, loaded via ctypes: the Poseidon permutation
of the transcript sponges and the golden host MSM.

`pasta.cpp` is compiled with g++ into the package's build directory at
first use (keyed by the source hash). The MSM is the exact host reference
that device commitments are checked against at full width. Without a
compiler `curves.py` falls back to its pure-Python double-and-add and the
sponges to the Python permutation (poseidon/permutation.py).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

from .. import BUILD_DIR

_SRC = os.path.join(os.path.dirname(__file__), "pasta.cpp")


@functools.cache
def _lib() -> ctypes.CDLL | None:
    """The shared library, built and loaded once per process; None when
    g++ or the build fails."""
    try:
        return _build()
    except (OSError, subprocess.SubprocessError):
        return None


def _build() -> ctypes.CDLL:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out_dir = BUILD_DIR / "native"
    so = out_dir / f"pasta_{tag}.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp), _SRC],
            check=True,
            capture_output=True,
            timeout=300,
        )
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.ps_new.restype = ctypes.c_void_p
    lib.ps_new.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p,
    ]
    lib.ps_permute.restype = None
    lib.ps_permute.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ps_free.restype = None
    lib.ps_free.argtypes = [ctypes.c_void_p]
    lib.pc_new.restype = ctypes.c_void_p
    lib.pc_new.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64]
    lib.pc_free.restype = None
    lib.pc_free.argtypes = [ctypes.c_void_p]
    lib.pc_msm.restype = None
    lib.pc_msm.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
    ]
    return lib


def _le32(x: int) -> bytes:
    return x.to_bytes(32, "little")


class NativePoseidon:
    """ctypes handle for one Poseidon parameter set."""

    def __init__(self, params, lib: ctypes.CDLL) -> None:
        p = params.field.p
        pinv = (-pow(p, -1, 1 << 64)) % (1 << 64)
        r2 = pow(2, 512, p)
        mds = b"".join(_le32(v % p) for row in params.mds for v in row)
        rcs = params.round_constants[: params.rounds_full + int(params.initial_ark)]
        rc = b"".join(_le32(v % p) for row in rcs for v in row)
        self._lib = lib
        self._ctx = lib.ps_new(
            _le32(p), _le32(r2), pinv,
            params.rounds_full, params.sbox, int(params.initial_ark), mds, rc,
        )
        self.p = p

    def permute(self, state: list[int]) -> list[int]:
        buf = ctypes.create_string_buffer(b"".join(_le32(x % self.p) for x in state), 96)
        self._lib.ps_permute(self._ctx, buf)
        raw = buf.raw
        return [int.from_bytes(raw[32 * i : 32 * i + 32], "little") for i in range(3)]

    def __del__(self):
        ctx = getattr(self, "_ctx", None)
        if ctx:
            self._lib.ps_free(ctx)


class NativeCurve:
    """ctypes handle for one Pasta curve: Pippenger MSM on the host.

    `pc_msm` releases the interpreter lock (ctypes does for every foreign
    call), so several MSMs can run at once from a thread pool."""

    def __init__(self, curve, lib: ctypes.CDLL) -> None:
        p = curve.base.p
        pinv = (-pow(p, -1, 1 << 64)) % (1 << 64)
        r2 = pow(2, 512, p)
        self._lib = lib
        self._ctx = lib.pc_new(_le32(p), _le32(r2), pinv)

    def msm(self, scalars: list[int], points) -> tuple[int, int] | None:
        """scalars: canonical ints; points: affine (x, y) tuples or None."""
        n = len(scalars)
        if n != len(points):
            raise ValueError("scalars and points differ in length")
        if n == 0:
            return None
        sbuf = b"".join(_le32(s) for s in scalars)
        pbuf = bytearray(64 * n)
        inf = bytearray(n)
        for i, pt in enumerate(points):
            if pt is None:
                inf[i] = 1
            else:
                pbuf[64 * i : 64 * i + 32] = _le32(pt[0])
                pbuf[64 * i + 32 : 64 * i + 64] = _le32(pt[1])
        out = ctypes.create_string_buffer(65)
        self._lib.pc_msm(self._ctx, n, sbuf, bytes(pbuf), bytes(inf), out)
        raw = out.raw
        if raw[64]:
            return None
        return (
            int.from_bytes(raw[0:32], "little"),
            int.from_bytes(raw[32:64], "little"),
        )

    def __del__(self):
        ctx = getattr(self, "_ctx", None)
        if ctx:
            self._lib.pc_free(ctx)


_CURVES: dict[str, NativeCurve] = {}


def native_curve(curve) -> NativeCurve | None:
    """Cached per-curve native MSM, or None when g++ is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    c = _CURVES.get(curve.name)
    if c is None:
        c = _CURVES[curve.name] = NativeCurve(curve, lib)
    return c


_SPONGES: dict[str, NativePoseidon] = {}


def native_poseidon(params) -> NativePoseidon | None:
    """Cached per-parameter-set native permutation, or None when g++ is
    unavailable."""
    lib = _lib()
    if lib is None:
        return None
    s = _SPONGES.get(params.name)
    if s is None:
        s = _SPONGES[params.name] = NativePoseidon(params, lib)
    return s
