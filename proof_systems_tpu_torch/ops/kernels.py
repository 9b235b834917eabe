"""The port's hand-written CUDA kernels: loader, wrappers, plain versions.

Counterpart of proof_systems_tpu/ops/pallas_field.py. All twelve of its
TPU kernels are ported; each has a CUDA C++ kernel for sm_90a in `csrc/`
and, beside its wrapper here, a plain PyTorch version with the same
signature and the same results:

  K1 mont_mul                 (pallas_field.py:398)   csrc/field_kernels.cu
  K2 jacobian_add             (pallas_field.py:412)   csrc/curve_kernels.cu
  K3 jacobian_double          (pallas_field.py:439)   csrc/curve_kernels.cu
  K4 mont_pow                 (pallas_field.py:481)   csrc/field_kernels.cu, chain_field.cuh
  K5 mont_prefix_scan         (pallas_field.py:1019)  csrc/scan_kernels.cu, scan_field.cuh
  K6 ec_prefix_scan_parts     (pallas_field.py:1333)  csrc/ec_scan_kernels.cu
  K7 ec_prefix_scan_fused     (pallas_field.py:1410)  csrc/ec_scan_kernels.cu
  K8 combine_windows          (pallas_field.py:560)   csrc/k8_kernels.cu, k8_combine.cuh
  K9 linear_scan              (pallas_field.py:1069)  csrc/scan_kernels.cu, scan_field.cuh
  K10 sponge_squeeze2         (pallas_field.py:646)   csrc/transcript_kernels.cu, chain_field.cuh
  K11 endo_inv                (pallas_field.py:742)   csrc/transcript_kernels.cu, inv_field.cuh
  K12 mont_prefix_scan_parts  (pallas_field.py:956)   csrc/scan_kernels.cu, scan_field.cuh

and one kernel for a loop of them: the IPA fold step's endo ladder
(`endo_ladder`, csrc/ladder_kernels.cu, endo_ladder.cuh), the reference's
`fori_loop` of K2 and K3 (proof_systems_tpu/poly_commitment/ipa.py:566).
`bits128` (pallas_field.py:733) is a torch op.

A wrapper takes its plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel on the current stream or raises; there is no
fallback. Each wrapper counts its launches in LAUNCHES[<name>].

Layout: a field element is (8, ...) int32, the 32-bit limbs of its
Montgomery integer (limb-major, little-endian). The plain versions compute
on 16-bit limbs (a 32x32-bit product overflows int64, and the CPU build of
torch has no uint32 arithmetic): in int64, or for wide batches in float64,
which holds every limb product, column sum and carry exactly. They follow
the kernels' formulas and association order, so the two agree limb for
limb; K6 and K7 where a team of threads shares a lane chunk agree as group
elements.

The library is built with nvcc into the gitignored build directory at first
use, keyed by a hash of the sources, and loaded with ctypes: each source of
SOURCES is one translation unit, compiled to an object by its own nvcc
process, all started together, and the objects are linked into one shared
library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from .. import BUILD_DIR

NL = 8  # 32-bit limbs per field element
LANES = 128  # threads per block of the row-scan kernels (csrc/field.cuh)
M16 = 0xFFFF

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# One translation unit a kernel family (the kernels of a unit share its
# launchers and attribute readers; a unit launches only its own kernels).
SOURCES = ("field_kernels.cu", "scan_kernels.cu", "transcript_kernels.cu",
           "curve_kernels.cu", "ladder_kernels.cu", "ec_scan_kernels.cu", "k8_kernels.cu")
LIBRARY_NAME = "pst_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def _source_tag() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


class KernelLibrary:
    """The shared library of `csrc/`, built once and loaded once. `field` and
    `curve` are the same library, bound for the field and curve launchers."""

    def __init__(self) -> None:
        self.field: ctypes.CDLL | None = None
        self.curve: ctypes.CDLL | None = None
        self.build_seconds = 0.0  # 0 when the build directory was current
        self.unit_seconds: dict[str, float] = {}  # each unit's nvcc, when built
        self.ptxas_log = ""

    def load(self) -> "KernelLibrary":
        if self.field is None:
            out = BUILD_DIR / "kernels" / _source_tag()
            t0 = time.perf_counter()
            logs = self._build(out)
            self.build_seconds = time.perf_counter() - t0 if logs else 0.0
            cached = out / "ptxas.log"  # the build's, when this process did not build
            self.ptxas_log = "\n".join(logs) or (cached.read_text() if cached.exists() else "")
            lib = ctypes.CDLL(str(out / LIBRARY_NAME))
            self.field = _bind_field(lib)
            self.curve = _bind_curve(lib)
        return self

    def _build(self, out: Path) -> list[str]:
        if (out / LIBRARY_NAME).exists():
            return []
        out.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tag = os.getpid()
        procs = []
        for src in SOURCES:
            obj = out / f"{Path(src).stem}.{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
            procs.append((src, obj, time.perf_counter(), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        logs, failed = [], []
        for src, obj, t0, proc in procs:
            text, _ = proc.communicate()
            self.unit_seconds[src] = time.perf_counter() - t0
            logs.append(f"== {src}\n{text}")
            if proc.returncode != 0:
                failed.append(src)
        if not failed:
            tmp = out / f"{LIBRARY_NAME}.{tag}.tmp"
            link = subprocess.run(
                [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _, _ in procs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            logs.append(f"== link\n{link.stdout}")
            if link.returncode != 0:
                failed.append("link")
            else:
                os.replace(tmp, out / LIBRARY_NAME)
        for _, obj, _, _ in procs:
            obj.unlink(missing_ok=True)
        (out / "ptxas.log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        return logs


_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def _bind_field(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.pst_mont_mul.argtypes = [_P, _P, _P, _P, _I64, _P]
    lib.pst_mont_pow.argtypes = [_P, ctypes.c_char_p, ctypes.c_int, _P, _P, _I64, _P]
    lib.pst_mont_prefix.argtypes = [_P, _P, _P] + [_I64] * 3 + [ctypes.c_int] * 2 + [_P]
    lib.pst_mont_prefix_parts.argtypes = [_P] * 4 + [_I64] * 3 + [ctypes.c_int, _P]
    lib.pst_linear_scan.argtypes = [_P] * 3 + [_I64, _P, _P] + [_I64] * 3 + [ctypes.c_int, _P]
    lib.pst_scan_attrs.argtypes = [ctypes.c_int, _P]
    lib.pst_sponge_squeeze2.argtypes = [_P, _P, _P, _P, _P, ctypes.c_int, _P, _P, _P]
    lib.pst_endo_inv.argtypes = [_P] * 6
    lib.pst_chain_attrs.argtypes = [ctypes.c_int, _P]
    lib.pst_product_chain.argtypes = [_P, ctypes.c_int, _P, ctypes.c_int, _P, _P]
    for fn in (lib.pst_mont_mul, lib.pst_mont_pow, lib.pst_mont_prefix,
               lib.pst_mont_prefix_parts, lib.pst_linear_scan,
               lib.pst_sponge_squeeze2, lib.pst_endo_inv, lib.pst_chain_attrs,
               lib.pst_product_chain, lib.pst_scan_attrs):
        fn.restype = ctypes.c_int
    lib.pst_field_error_string.argtypes = [ctypes.c_int]
    lib.pst_field_error_string.restype = ctypes.c_char_p
    return lib


def _bind_curve(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.pst_jacobian_add.argtypes = [_P] * 10 + [_I64, _P]
    lib.pst_jacobian_double.argtypes = [_P] * 7 + [_I64, _P]
    lib.pst_endo_ladder.argtypes = [_P] * 9 + [_I64, _P]
    lib.pst_group_law_attrs.argtypes = [ctypes.c_int, _P]
    lib.pst_ec_scan_parts.argtypes = [_P] * 10 + [_I64, _I64, _I64] + [ctypes.c_int] * 3 + [_P]
    lib.pst_ec_scan_parts_attrs.argtypes = [ctypes.c_int] * 3 + [_P]
    lib.pst_ec_scan_fused.argtypes = [_P] * 6 + [_I64] * 3 + [ctypes.c_int] * 2 + [_P]
    lib.pst_ec_scan_fused_attrs.argtypes = [_P]
    lib.pst_combine_windows.argtypes = [_P] * 7 + [_I64, _I64, ctypes.c_int, _P]
    lib.pst_combine_windows_attrs.argtypes = [_P]
    for fn in (lib.pst_jacobian_add, lib.pst_jacobian_double, lib.pst_endo_ladder,
               lib.pst_group_law_attrs, lib.pst_ec_scan_parts, lib.pst_ec_scan_parts_attrs,
               lib.pst_ec_scan_fused, lib.pst_ec_scan_fused_attrs, lib.pst_combine_windows,
               lib.pst_combine_windows_attrs):
        fn.restype = ctypes.c_int
    lib.pst_curve_error_string.argtypes = [ctypes.c_int]
    lib.pst_curve_error_string.restype = ctypes.c_char_p
    return lib


LIBRARY = KernelLibrary()


def _launch(lib: ctypes.CDLL, fn_name: str, err_name: str, dev: torch.device, *args):
    """Call one C launcher on the current stream; raise on a launch error."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        msg = getattr(lib, err_name)(rc).decode()
        raise RuntimeError(f"{fn_name}: CUDA error {rc}: {msg}")


def _ptrs(ts) -> list[int]:
    return [t.data_ptr() for t in ts]


def _check(*ts: torch.Tensor, same_shape: bool = True) -> torch.device:
    """All operands (8, ...) int32, contiguous, on one device, and (unless
    same_shape is False) of one shape."""
    first = ts[0]
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"limb tensors are int32, got {t.dtype}")
        if t.dim() < 1 or t.shape[0] != NL:
            raise ValueError(f"limb tensors are (8, ...), got {tuple(t.shape)}")
        if same_shape and t.shape != first.shape:
            raise ValueError(f"shape mismatch {tuple(t.shape)} vs {tuple(first.shape)}")
        if t.device != first.device:
            raise ValueError(f"device mismatch {t.device} vs {first.device}")
        if not t.is_contiguous():
            raise ValueError("limb tensors must be contiguous")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {first.device}")
    return first.device


def _field_words(F) -> int:
    """Host address of F's 17 parameter words (kept alive by F)."""
    return F.kernel_params.ctypes.data


@functools.lru_cache(maxsize=None)
def _pasta_shape(p: int) -> bool:
    """The shape that csrc/chain_field.cuh's product relies on (K4, K10,
    K11, K5): p's 32-bit word 0 is 1 (so -p^-1 mod 2^32 is 0xFFFFFFFF), words
    4-6 are 0 and word 7 is 0x40000000."""
    w = _words(p)
    return w[0] == 1 and w[4:7] == [0, 0, 0] and w[7] == 0x40000000


def _require_pasta(F, name: str) -> None:
    if not _pasta_shape(F.p):
        raise ValueError(f"{name} runs the Pasta moduli's product; p = {F.p:#x} has "
                         "another shape")


# ---------------------------------------------------------------------------
# int64 arithmetic on (16, ...) 16-bit limbs, mirroring csrc/field.cuh value
# for value: the core of the plain versions, and of the field layer's
# torch ops (limb.add, limb.sub), which have no kernel.
# ---------------------------------------------------------------------------


class Field16:
    """Per-(modulus, device) constants of the 16-bit limb arithmetic."""

    def __init__(self, p: int, r_mod_p: int, device: str) -> None:
        if p.bit_length() > 255:  # the reductions keep values below 2p < 2^256
            raise ValueError("the 16-bit limb arithmetic takes primes below 2^255")
        self.p16 = torch.tensor(limbs16(p), dtype=torch.int64, device=device)
        self.one16 = torch.tensor(limbs16(r_mod_p), dtype=torch.int64, device=device)
        self.pinv16 = (-pow(p, -1, 1 << 16)) % (1 << 16)
        # the product's float64 copy of p and the runs [s, e) of its nonzero
        # limbs (a Pasta prime has 8: limbs 0, 2-7 and 15)
        self.p16f = self.p16.to(torch.float64)
        self.p_limbs = limbs16(p)  # on the host: a scale factor reads no device memory
        self.p_runs = _runs(self.p_limbs)
        # 2^256 - p: adding it subtracts p mod 2^256, with limbs >= 0
        self.np16 = torch.tensor(limbs16((1 << 256) - p), dtype=torch.int64, device=device)
        # -p^-1 mod 2^256, the full-width reduction's factor (_mul_narrow)
        self.pinv256 = torch.tensor(limbs16(-pow(p, -1, 1 << 256) % (1 << 256)),
                                    dtype=torch.int64, device=device)
        # limb i <-> bit i of a carry word (_carries); 33 limbs at most
        self.shift = torch.arange(34, dtype=torch.int64, device=device)
        self.bit = torch.ones_like(self.shift) << self.shift

    def col(self, v: torch.Tensor, ndim: int) -> torch.Tensor:
        return v.view(v.shape[0], *([1] * ndim))


def limbs16(x: int) -> list[int]:
    return [(x >> (16 * i)) & M16 for i in range(16)]


def _runs(limbs: list[int]) -> list[tuple[int, int]]:
    """The runs [s, e) of nonzero entries."""
    out, i = [], 0
    while i < len(limbs):
        if limbs[i]:
            j = i
            while j < len(limbs) and limbs[j]:
                j += 1
            out.append((i, j))
            i = j
        else:
            i += 1
    return out


@functools.lru_cache(maxsize=None)
def _field16(p: int, r_mod_p: int, device: str) -> Field16:
    return Field16(p, r_mod_p, device)


def field16(F, device: torch.device) -> Field16:
    return _field16(F.p, F.r_mod_p, str(device))


def to16(w: torch.Tensor) -> torch.Tensor:
    """(8, ...) int32 words -> (16, ...) int64 16-bit limbs."""
    u = w.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([u & M16, u >> 16], dim=1).reshape(16, *w.shape[1:])


def from16(a: torch.Tensor) -> torch.Tensor:
    """(16, ...) canonical 16-bit limbs -> (8, ...) int32 words."""
    u = a[0::2] | (a[1::2] << 16)
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def _serial(t: torch.Tensor) -> bool:
    """Whether to resolve carries limb by limb: for a wide batch the
    16-step loop moves far fewer bytes than the carry word (_carries) and
    the launches no longer dominate; for a narrow one its many small ops
    cost more than the word's fixed handful. The crossover is lower on the
    CPU, where an op costs microseconds, than on the card, where
    scripts/torch_carry_ab.py finds it between 2^19 and 2^20 elements."""
    return t[0].numel() > (1 << 19 if t.is_cuda else 1 << 12)


def _carries(P: Field16, g: torch.Tensor, p: torch.Tensor):
    """Carries along a limb chain for per-limb generate g and propagate p
    (0/1, never both): c_0 = 0, c_(i+1) = g_i | (p_i & c_i). With limb i as
    bit i, X = G | P and Y = G, the chain is the carry chain of the integer
    sum X + Y, so the carry into bit i is bit i of (X + Y) ^ X ^ Y: a fixed
    handful of torch ops instead of one op per limb. Returns (carry into
    each limb, carry out of the top limb)."""
    k = g.shape[0]
    w = P.col(P.bit[:k], g.dim() - 1)
    gw = (g * w).sum(0)
    x = gw | (p * w).sum(0)
    c = (x + gw) ^ x ^ gw
    return (c[None] >> P.col(P.shift[:k], g.dim() - 1)) & 1, (c >> k) & 1


def _shift_up(t: torch.Tensor) -> torch.Tensor:
    """t[i - 1] along the limb axis, 0 shifted in at limb 0."""
    return torch.nn.functional.pad(t[:-1], (0, 0) * (t.dim() - 1) + (1, 0))


def _normalize(P: Field16, v: torch.Tensor, out_limbs: int, bits: int = 17) -> torch.Tensor:
    """Nonnegative limb sums below 2^bits -> out_limbs canonical 16-bit
    limbs (the value mod 2^(16 * out_limbs)). Narrow batches: split rounds
    move each limb's carry up one limb until every sum is below 2^17 - 1,
    then one carry word (_carries) resolves the rest exactly. Wide ones:
    a ripple, limb by limb."""
    if _serial(v):
        outs, carry = [], torch.zeros_like(v[0])
        for k in range(out_limbs):
            t = (v[k] + carry) if k < v.shape[0] else carry
            outs.append(t & M16)
            carry = t >> 16
        return torch.stack(outs)
    if v.shape[0] < out_limbs:
        v = torch.nn.functional.pad(v, (0, 0) * (v.dim() - 1) + (0, out_limbs - v.shape[0]))
    while bits > 17:
        v = (v & M16) + _shift_up(v >> 16)
        bits = max(bits - 16, 16) + 1
    lo = v & M16
    c, _ = _carries(P, v >> 16, lo == M16)
    return (lo + c) & M16


def _sub_raw(P: Field16, a: torch.Tensor, b: torch.Tensor):
    """a - b over 16 canonical limbs: (difference mod 2^256, borrow out),
    by the carry word or, for wide batches, limb by limb."""
    if _serial(a):
        outs, borrow = [], torch.zeros_like(a[0])
        for i in range(16):
            v = a[i] - b[i] - borrow
            outs.append(v & M16)
            borrow = (v < 0).to(torch.int64)
        return torch.stack(outs), borrow
    d = a - b
    lo = d & M16
    c, borrow = _carries(P, d < 0, lo == 0)
    return (lo - c) & M16, borrow


def add16(P: Field16, a, b):
    a, b = torch.broadcast_tensors(a, b)
    pv = P.col(P.p16, a.dim() - 1)
    s = _normalize(P, a + b, 16)
    d, borrow = _sub_raw(P, s, pv)
    return torch.where(borrow[None] != 0, s, d)


def sub16(P: Field16, a, b):
    a, b = torch.broadcast_tensors(a, b)
    pv = P.col(P.p16, a.dim() - 1)
    d, borrow = _sub_raw(P, a, b)
    return torch.where(borrow[None] != 0, _normalize(P, d + pv, 16), d)


def mul16(P: Field16, a, b):
    """Montgomery product a*b*R^-1 mod p of canonical int64 limbs, in the
    family of field ops that _arith picks for the batch. Any correct
    Montgomery product gives the one canonical value."""
    A = _arith(P, torch.broadcast_shapes(a.shape, b.shape)[1:].numel())
    x = A.enter(a)
    return A.leave(A.mul(x, x if a is b else A.enter(b)))


def _skew_sum(x: torch.Tensor) -> torch.Tensor:
    """(16, 16, ...) products x[i, j] -> (31, ...) column sums over i + j:
    each row padded with 16 zeros and the rows read back 31 wide, so that
    row i starts i places later."""
    batch = x.shape[2:]
    x = torch.nn.functional.pad(x, (0, 0) * len(batch) + (0, 16))
    return x.reshape(512, *batch)[:496].reshape(16, 31, *batch).sum(0)


def _mul_narrow(P: Field16, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The Montgomery product at full width in int64: T = a * b, the one
    m < R with T + m p = 0 mod R as (T mod R) (-p^-1) mod R, and
    (T + m p) / R, from whole 16 x 16 product tables. The word-by-word
    reduction finds the same m, so the value is the same."""
    nb = a.dim() - 1
    t = _skew_sum(a[:, None] * b[None])  # column sums < 2^36
    m = _normalize(P, _skew_sum(t[:16, None] * P.col(P.pinv256, nb)[None])[:16], 16,
                   bits=58)
    v = t + _skew_sum(m[:, None] * P.col(P.p16, nb)[None])
    return _pick_reduced(P, v, 16)


def _pick_reduced(P: Field16, v: torch.Tensor, at: int) -> torch.Tensor:
    """The canonical limbs of V >> (16 at) for column sums v < 2^38 (limbs
    first) whose V >> (16 at) is below 2p: V and V + (2^256 - p) 2^(16 at)
    normalised together, the second where its carry out shows V >> (16 at)
    >= p."""
    w = v.new_zeros((at + 16, 2, *v.shape[1:]))
    w[: v.shape[0]] = v[:, None]
    w[at : at + 16, 1] += P.col(P.np16, v.dim() - 1)
    r = _normalize(P, w, at + 17, bits=39)
    return torch.where(r[at + 16, 1][None] != 0, r[at : at + 16, 1], r[at : at + 16, 0])


def _schoolbook(a: torch.Tensor, b: torch.Tensor | None, out: torch.Tensor | None = None):
    """(34, ...) float64 column sums of a * b (of a * a when b is None) for
    (16, ...) float64 limbs, into `out` if given; columns 31-33 are the
    reduction's room."""
    cols = a.new_empty((34, *a.shape[1:])) if out is None else out
    if b is not None:
        torch.mul(b, a[0:1], out=cols[0:16])
        cols[16:].zero_()
        for i in range(1, 16):
            cols[i : i + 16].addcmul_(b, a[i : i + 1])
        return cols
    torch.mul(a, a, out=cols[0:32:2])
    cols[1:32:2].zero_()
    cols[32:].zero_()
    two_a = a * 2
    for i in range(15):
        cols[2 * i + 1 : i + 16].addcmul_(two_a[i + 1 :], a[i : i + 1])
    return cols


def is_zero16(a):
    return (a == 0).all(dim=0)


def _sel(cond, t, f):
    return torch.where(cond[None], t, f)


def _muls(P: Field16, *pairs):
    """Independent Montgomery products of int64 limbs in one reduction
    (stacked on a new axis after the limbs): the same products, fewer
    torch ops."""
    shape = torch.broadcast_shapes(*(t.shape for pair in pairs for t in pair))
    A = _arith(P, shape[1:].numel())
    f = {id(t): A.enter(t) for pair in pairs for t in pair}
    return tuple(A.leave(t) for t in A.muls(*((f[id(x)], f[id(y)]) for x, y in pairs)))


class _Int16:
    """The formulas' field ops on int64 canonical 16-bit limbs: add16,
    sub16 and whole 16 x 16 product tables (_mul_narrow), few torch ops
    each, for narrow batches."""

    def __init__(self, P: Field16) -> None:
        self.P = P

    def add(self, a, b):
        return add16(self.P, a, b)

    def sub(self, a, b):
        return sub16(self.P, a, b)

    def mul(self, a, b):
        return _mul_narrow(self.P, *torch.broadcast_tensors(a, b))

    def muls(self, *pairs):
        shape = torch.broadcast_shapes(*(t.shape for pair in pairs for t in pair))
        a = torch.stack([x.expand(shape) for x, _ in pairs], dim=1)
        b = torch.stack([y.expand(shape) for _, y in pairs], dim=1)
        return _mul_narrow(self.P, a, b).unbind(1)

    @staticmethod
    def enter(t):
        return t

    @staticmethod
    def leave(t):
        return t


class _Float16:
    """The formulas' field ops on float64 canonical 16-bit limbs, for wide
    batches: every limb, column sum and carry is an integer below 2^53, so
    float64 holds it exactly, and the CPU multiplies and adds float64
    several times faster than int64. Carries ripple limb by limb over
    (16, ...) slices; a conditional subtract is computed for every lane and
    picked by lerp, whose weight is 0 or 1 (exact: no rounding happens)."""

    def __init__(self, P: Field16) -> None:
        self.P = P

    @staticmethod
    def enter(t):
        return t.to(torch.float64)

    @staticmethod
    def leave(t):
        return t.to(torch.int64)

    def _pick(self, w, use_second):
        """Canonical lanes of the two candidates w[:16, 0] and w[:16, 1]."""
        return torch.lerp(w[:16, 0], w[:16, 1], use_second.to(torch.float64)[None])

    def add(self, a, b):
        """a + b, and a + b - p, rippled; the second where it is >= 0."""
        a, b = torch.broadcast_tensors(a, b)
        w = a.new_empty((17, 2, *a.shape[1:]))
        torch.add(a, b, out=w[:16, 0])
        torch.sub(w[:16, 0], self.P.col(self.P.p16f, a.dim() - 1), out=w[:16, 1])
        w[16].zero_()
        _ripple(w, 16)
        return self._pick(w, w[16, 1] >= 0)

    def sub(self, a, b):
        """a - b, and a - b + p, rippled; the second where the first is < 0."""
        a, b = torch.broadcast_tensors(a, b)
        w = a.new_empty((17, 2, *a.shape[1:]))
        torch.sub(a, b, out=w[:16, 0])
        torch.add(w[:16, 0], self.P.col(self.P.p16f, a.dim() - 1), out=w[:16, 1])
        w[16].zero_()
        _ripple(w, 16)
        return self._pick(w, w[16, 0] < 0)

    def mul(self, a, b):
        same = a is b
        a, b = torch.broadcast_tensors(a, b)
        return self._reduce(_schoolbook(a, None if same else b))

    def muls(self, *pairs):
        """Independent products in one reduction, squares first."""
        shape = torch.broadcast_shapes(*(t.shape for pair in pairs for t in pair))
        sq = [k for k, (x, y) in enumerate(pairs) if x is y]
        gen = [k for k, (x, y) in enumerate(pairs) if x is not y]
        cols = torch.empty((34, len(pairs), *shape[1:]), dtype=torch.float64,
                           device=pairs[0][0].device)
        if sq:
            _schoolbook(torch.stack([pairs[k][0].expand(shape) for k in sq], 1), None,
                        cols[:, : len(sq)])
        if gen:
            _schoolbook(torch.stack([pairs[k][0].expand(shape) for k in gen], 1),
                        torch.stack([pairs[k][1].expand(shape) for k in gen], 1),
                        cols[:, len(sq) :])
        out = self._reduce(cols).unbind(1)
        res = [None] * len(pairs)
        for j, k in enumerate(sq + gen):
            res[k] = out[j]
        return tuple(res)

    def _reduce(self, cols):
        """(T + m p) / R of T's float64 columns, canonical."""
        P = self.P
        v = _redc_cols(P, cols)  # (17, ...) limbs of a value < 2p
        w = v.new_empty((17, 2, *v.shape[1:]))
        w[:, 0] = v
        torch.sub(v[:16], P.col(P.p16f, v.dim() - 1), out=w[:16, 1])
        w[16, 1] = v[16]
        _ripple(w, 16)
        return self._pick(w, w[16, 1] >= 0)


def _ripple(w: torch.Tensor, k: int) -> None:
    """Carry limbs 0 .. k-1 of float64 w (limbs first) into the next, in
    place: limbs 0 .. k-1 end in [0, 2^16), limb k takes the rest (signed
    limbs borrow by the floor)."""
    rows = w.unbind(0)
    for i in range(k):
        c = rows[i].mul(1.0 / 65536).floor_()
        rows[i].sub_(c, alpha=65536.0)
        rows[i + 1].add_(c)


def _redc_cols(P: Field16, cols: torch.Tensor) -> torch.Tensor:
    """The 16 REDC steps over float64 columns (34, ...) of T, in place: the
    (17, ...) column sums of (T + m p) / R, a value below 2p. Each step adds
    m * p over p's nonzero limbs only. Where p = 1 mod 2^16 (the Pasta
    primes), -p^-1 = -1 and the step's m is 2^16 - (c mod 2^16), in
    [1, 2^16]: the column becomes (floor(c / 2^16) + 1) 2^16 and carries
    that quotient, with no division of its own; m may be 2^16, so the m of
    the whole reduction may exceed R by a hair (R / (2^16 - 1)), which
    keeps the value below p^2 / R + 1.0001 p < 2p."""
    pv = P.col(P.p16f, cols.dim() - 1)
    rows = cols.unbind(0)
    if P.pinv16 == M16:
        runs = [(max(s, 1), e) for s, e in P.p_runs if e > 1]
        for i in range(16):
            q1 = rows[i].mul(1.0 / 65536).floor_().add_(1.0)
            m = q1.mul(65536.0).sub_(rows[i])
            rows[i + 1].add_(q1)
            for s, e in runs:
                if e - s == 1:
                    rows[i + s].add_(m, alpha=float(P.p_limbs[s]))
                else:
                    cols[i + s : i + e].addcmul_(pv[s:e], m[None])
        return cols[16:33]
    for i in range(16):
        m = torch.fmod(rows[i], 65536.0).mul_(P.pinv16).fmod_(65536.0)
        for s, e in P.p_runs:
            if e - s == 1:
                rows[i + s].add_(m, alpha=float(P.p_limbs[s]))
            else:
                cols[i + s : i + e].addcmul_(pv[s:e], m[None])
        rows[i + 1].add_(rows[i], alpha=1.0 / 65536)  # rows[i] is 0 mod 2^16 now
    return cols[16:33]


# Lanes from which the plain versions' field products and curve formulas run
# on float64 limbs (_Float16) rather than int64 (_Int16): the crossover of
# the complete add, which scripts/torch_plain_arith_ab.py measures (on the
# CPU at one torch thread, as most test files run; on an H100).
FLOAT_LANES = {"cpu": 1 << 6, "cuda": 1 << 16}


def _arith(P: Field16, lanes: int):
    return _Float16(P) if lanes >= FLOAT_LANES[P.p16.device.type] else _Int16(P)


def _double(A, p):
    """dbl-2009-l, as ec_double in csrc/field.cuh, over the field ops A."""
    x, y, z = p
    a, b, yz = A.muls((x, x), (y, y), (y, z))
    xb = A.add(x, b)
    e = A.add(A.add(a, a), a)
    c, xb2, f = A.muls((b, b), (xb, xb), (e, e))
    d = A.sub(A.sub(xb2, a), c)
    d = A.add(d, d)
    x3 = A.sub(f, A.add(d, d))
    c8 = A.add(c, c)
    c8 = A.add(c8, c8)
    c8 = A.add(c8, c8)
    y3 = A.sub(A.mul(e, A.sub(d, x3)), c8)
    return x3, y3, A.add(yz, yz)


def ec_double16(P: Field16, p):
    """dbl-2009-l, as ec_double in csrc/field.cuh."""
    A = _arith(P, p[0][0].numel())
    return tuple(A.leave(t) for t in _double(A, tuple(A.enter(t) for t in p)))


def _lanes(t: torch.Tensor, idx: torch.Tensor | None) -> torch.Tensor:
    """(16, ...) -> (16, L) flattened, or its lanes idx."""
    t = t.reshape(16, -1)
    return t if idx is None else t.index_select(1, idx)


# odd multipliers of _duplicates' lane hash, one a limb of the six operands
_HASH = [(0x9E3779B97F4A7C15 * (2 * k + 1)) % (1 << 63) | 1 for k in range(96)]


def _duplicates(lanes):
    """(rep, inverse) for (16, L) operand tensors whose L lanes repeat: the
    lanes rep hold each distinct operand tuple once and lane l equals lane
    rep[inverse[l]]; None when none repeats. The lanes are grouped by a hash
    and every lane is then compared with its representative limb for limb,
    so a collision only costs the saving."""
    L = lanes[0].shape[1]
    h = None
    for k, t in enumerate(lanes):
        mult = torch.tensor(_HASH[16 * k : 16 * k + 16], dtype=torch.int64, device=t.device)
        part = (t * mult[:, None]).sum(0)
        h = part if h is None else h.mul_(0x100000001B3).add_(part)
    uniq, inverse = torch.unique(h, return_inverse=True)
    if uniq.numel() == L:
        return None
    rep = torch.empty(uniq.numel(), dtype=torch.int64, device=h.device)
    rep.scatter_(0, inverse, torch.arange(L, device=h.device))
    back = rep.index_select(0, inverse)
    if not all(bool((t.index_select(1, back) == t).all()) for t in lanes):
        return None
    return rep, inverse


def _ec_complete(P: Field16, p, q, main, double_p: bool):
    """The complete law of ec_add / ec_madd (csrc/field.cuh): where q is
    the identity (z = 0) the sum is p, else where p is the identity it is
    q, else the formula `main`, with the doubling of p (double_p) or of q
    where h = r = 0 and the identity (z = 0) where h = 0 and r != 0.

    Only lanes that keep the formula's value compute it, once for each
    distinct pair of operands, and only lanes that keep the doubling's
    compute that: a lane's value is the kernel's whichever way the others
    go, and the scans of bucket sums hold many identities."""
    p, q = (tuple(t) for t in (p, q))
    shape = torch.broadcast_shapes(*(t.shape for t in p + q))
    p = tuple(t.expand(shape) for t in p)
    q = tuple(t.expand(shape) for t in q)
    p_inf, q_inf = is_zero16(p[2]), is_zero16(q[2])
    out = tuple(_sel(q_inf, pc, _sel(p_inf, qc, pc)).reshape(16, -1) for pc, qc in zip(p, q))
    live = ~(p_inf | q_inf).reshape(-1)
    n_live = int(live.sum())
    if n_live == 0:
        return tuple(t.reshape(shape) for t in out)
    idx = None if n_live == live.numel() else live.nonzero().squeeze(1)
    lp = tuple(_lanes(t, idx) for t in p)
    lq = tuple(_lanes(t, idx) for t in q)
    dup = _duplicates(lp + lq)
    if dup is not None:  # one lane of each distinct pair of operands computes
        rep, inverse = dup
        lp, lq = (tuple(t.index_select(1, rep) for t in pt) for pt in (lp, lq))
    A = _arith(P, lp[0].shape[1])
    lp, lq = (tuple(A.enter(t) for t in pt) for pt in (lp, lq))
    (x, y, z), h, r2 = main(A, lp, lq)
    h_zero = is_zero16(h)
    r_zero = is_zero16(r2)
    dbl = (h_zero & r_zero).nonzero().squeeze(1)
    if dbl.numel():
        d = _double(A, tuple(t.index_select(1, dbl) for t in (lp if double_p else lq)))
        x, y, z = (m.index_copy(1, dbl, dc) for m, dc in zip((x, y, z), d))
    z = _sel(h_zero & ~r_zero, torch.zeros_like(z), z)
    x, y, z = (A.leave(t) for t in (x, y, z))
    if dup is not None:
        x, y, z = (t.index_select(1, inverse) for t in (x, y, z))
    if idx is None:
        return tuple(t.reshape(shape) for t in (x, y, z))
    return tuple(o.index_copy(1, idx, v).reshape(shape) for o, v in zip(out, (x, y, z)))


def _add_tail(A, u1, s1, h, rr):
    """The part of add-2007-bl after h = u2 - u1 and rr = s2 - s1."""
    r2 = A.add(rr, rr)
    h2 = A.add(h, h)
    i = A.mul(h2, h2)
    j, v, r2sq = A.muls((h, i), (u1, i), (r2, r2))
    x3 = A.sub(A.sub(r2sq, j), A.add(v, v))
    s1j, t = A.muls((s1, j), (r2, A.sub(v, x3)))
    return r2, x3, A.sub(t, A.add(s1j, s1j))


def _add_main(A, p, q):
    (x1, y1, z1), (x2, y2, z2) = p, q
    zs = A.add(z1, z2)
    z1z1, z2z2, zs2 = A.muls((z1, z1), (z2, z2), (zs, zs))
    u1, u2, t2, t1 = A.muls((x1, z2z2), (x2, z1z1), (z2, z2z2), (z1, z1z1))
    s1, s2 = A.muls((y1, t2), (y2, t1))
    h = A.sub(u2, u1)
    r2, x3, y3 = _add_tail(A, u1, s1, h, A.sub(s2, s1))
    z3 = A.mul(A.sub(A.sub(zs2, z1z1), z2z2), h)
    return (x3, y3, z3), h, r2


def _madd_main(A, p, q):
    (x1, y1, z1), (x2, y2, _) = p, q
    z1z1 = A.mul(z1, z1)
    u2, t1 = A.muls((x2, z1z1), (z1, z1z1))
    s2 = A.mul(y2, t1)
    h = A.sub(u2, x1)
    r2, x3, y3 = _add_tail(A, x1, y1, h, A.sub(s2, y1))
    z3 = A.mul(A.add(z1, z1), h)
    return (x3, y3, z3), h, r2


def ec_add16(P: Field16, p, q):
    """Complete add-2007-bl, as ec_add in csrc/field.cuh."""
    return _ec_complete(P, p, q, _add_main, double_p=True)


def ec_madd16(P: Field16, p, q):
    """Mixed add, q affine-encoded, as ec_madd in csrc/field.cuh."""
    return _ec_complete(P, p, q, _madd_main, double_p=False)


def _shift_lanes(t: torch.Tensor, s: int, fill: torch.Tensor) -> torch.Tensor:
    """t[..., l - s] along the last (lane) axis, `fill` shifted in."""
    pad = fill.expand(*t.shape[:-1], s)
    return torch.cat([pad, t[..., : t.shape[-1] - s]], dim=-1)


# ---------------------------------------------------------------------------
# K1 mont_mul
# ---------------------------------------------------------------------------


def mont_mul_plain(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check(a, b)
    P = field16(F, a.device)
    return from16(mul16(P, to16(a), to16(b)))


def mont_mul(F, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Montgomery product of two (8, ...) tensors."""
    dev = _check(a, b)
    if dev.type == "cpu":
        return mont_mul_plain(F, a, b)
    out = torch.empty_like(a)
    lib = LIBRARY.load().field
    _launch(lib, "pst_mont_mul", "pst_field_error_string", dev,
            _field_words(F), a.data_ptr(), b.data_ptr(), out.data_ptr(), a[0].numel())
    LAUNCHES["mont_mul"] += 1
    return out


# ---------------------------------------------------------------------------
# K2 jacobian_add, K3 jacobian_double
# ---------------------------------------------------------------------------


def jacobian_add_plain(F, px, py, pz, qx, qy, qz):
    _check(px, py, pz, qx, qy, qz)
    P = field16(F, px.device)
    p = tuple(to16(t) for t in (px, py, pz))
    q = tuple(to16(t) for t in (qx, qy, qz))
    return tuple(from16(t) for t in ec_add16(P, p, q))


def jacobian_add(F, px, py, pz, qx, qy, qz):
    """Complete elementwise Jacobian addition; returns (x, y, z)."""
    dev = _check(px, py, pz, qx, qy, qz)
    if dev.type == "cpu":
        return jacobian_add_plain(F, px, py, pz, qx, qy, qz)
    out = tuple(torch.empty_like(px) for _ in range(3))
    lib = LIBRARY.load().curve
    _launch(lib, "pst_jacobian_add", "pst_curve_error_string", dev,
            _field_words(F), *_ptrs((px, py, pz, qx, qy, qz)),
            *_ptrs(out), px[0].numel())
    LAUNCHES["jacobian_add"] += 1
    return out


def jacobian_double_plain(F, px, py, pz):
    _check(px, py, pz)
    P = field16(F, px.device)
    return tuple(from16(t) for t in ec_double16(P, tuple(to16(t) for t in (px, py, pz))))


def jacobian_double(F, px, py, pz):
    """Elementwise Jacobian doubling (a = 0); returns (x, y, z)."""
    dev = _check(px, py, pz)
    if dev.type == "cpu":
        return jacobian_double_plain(F, px, py, pz)
    out = tuple(torch.empty_like(px) for _ in range(3))
    lib = LIBRARY.load().curve
    _launch(lib, "pst_jacobian_double", "pst_curve_error_string", dev,
            _field_words(F), *_ptrs((px, py, pz)), *_ptrs(out), px[0].numel())
    LAUNCHES["jacobian_double"] += 1
    return out


# The kernels of the group law, for group_law_attrs: (which, name)
GROUP_LAW_KERNELS = {0: "k_jacobian_add", 1: "k_jacobian_double", 2: "k_endo_ladder"}


def group_law_attrs() -> dict[str, tuple[int, ...]]:
    """(registers, local bytes, static and dynamic shared bytes) of K2, K3
    and the endo ladder, from cudaFuncGetAttributes."""
    lib = LIBRARY.load().curve
    out = {}
    for which, name in GROUP_LAW_KERNELS.items():
        buf = (ctypes.c_int * 4)()
        rc = lib.pst_group_law_attrs(which, buf)
        if rc:
            raise RuntimeError(f"pst_group_law_attrs: CUDA error {rc}")
        out[name] = tuple(buf)
    return out


# ---------------------------------------------------------------------------
# The endo ladder: a loop of K2 and K3 as one kernel
# ---------------------------------------------------------------------------


def _ladder_args(x, y, z, bits, per_lane: bool = False) -> torch.device:
    dev = _check(x, y, z)
    _endo_args(bits, per_lane)
    if x.dim() != 2:
        raise ValueError(f"the ladder takes (8, n) points, got {tuple(x.shape)}")
    if bits.dim() == 2 and bits.shape[1] != x.shape[1]:
        raise ValueError(f"{bits.shape[1]} lanes of bits for {x.shape[1]} points")
    if bits.device != dev:
        raise ValueError(f"device mismatch {bits.device} vs {dev}")
    return dev


def endo_ladder_plain(F, endo_q: int, x, y, z, bits):
    """The ladder's loop of K2 and K3; `bits` (128,), or (128, n) for a
    challenge of each point's own."""
    _ladder_args(x, y, z, bits, per_lane=True)
    P = field16(F, x.device)
    endo = torch.tensor(limbs16(endo_q % F.p * F.r_mod_p % F.p), device=x.device)
    phix = from16(mul16(P, to16(x), P.col(endo, 1)))
    y16 = to16(y)
    negy = from16(sub16(P, torch.zeros_like(y16), y16))
    acc = jacobian_double_plain(F, *jacobian_add_plain(F, x, y, z, phix, y, z))
    for j in range(63, -1, -1):
        qx = torch.where(bits[2 * j + 1] == 1, phix, x)
        qy = torch.where(bits[2 * j] == 1, y, negy)
        acc = jacobian_add_plain(F, *jacobian_double_plain(F, *acc), qx, qy, z)
    return acc


def endo_ladder(F, endo_q: int, x, y, z, bits):
    """[u] P for the points P = (x, y, z), (8, n) with z in {0, R}, and the
    scalar challenge u of the 128 bits `bits` ((128,) int32, least
    significant first; kernels.bits128): the IPA fold step's 64-step ladder
    acc = 2 acc + (+-phi(P) or +-P) with phi(x) = endo_q * x, from acc =
    2 (P + phi(P)). Returns the Jacobian acc (x, y, z), the limbs of the
    loop of K2 and K3 (endo_ladder_plain). endo_q: the curve's base-field
    endomorphism constant, an int."""
    dev = _ladder_args(x, y, z, bits)
    if dev.type == "cpu":
        return endo_ladder_plain(F, endo_q, x, y, z, bits)
    endo = (ctypes.c_uint32 * NL)(*_words(endo_q % F.p * F.r_mod_p % F.p))
    out = tuple(torch.empty_like(x) for _ in range(3))
    lib = LIBRARY.load().curve
    _launch(lib, "pst_endo_ladder", "pst_curve_error_string", dev,
            _field_words(F), ctypes.addressof(endo), *_ptrs((x, y, z, bits)), *_ptrs(out),
            x.shape[1])
    LAUNCHES["endo_ladder"] += 1
    return out


# ---------------------------------------------------------------------------
# K4 mont_pow
# ---------------------------------------------------------------------------


def pow_digits(e: int) -> list[int]:
    """4-bit digits of e, most significant first (pallas_field.py:497-504)."""
    if e < 0 or e.bit_length() > 256:
        raise ValueError("exponent must be in [0, 2^256)")
    nd = (e.bit_length() + 3) // 4
    return [(e >> (4 * (nd - 1 - i))) & 15 for i in range(nd)]


def pow16(P: Field16, base: torch.Tensor, e: int) -> torch.Tensor:
    """base^e on 16-bit limbs: 4-bit windows, most significant first, over
    a 15-entry table, as fe_pow in csrc/field_kernels.cu."""
    tab = [P.col(P.one16, base.dim() - 1).expand_as(base), base]
    for _ in range(14):
        tab.append(mul16(P, tab[-1], base))
    acc = tab[0]
    for d in pow_digits(e):
        for _ in range(4):
            acc = mul16(P, acc, acc)
        acc = mul16(P, acc, tab[d])
    return acc


def mont_pow_plain(F, a: torch.Tensor, e: int) -> torch.Tensor:
    _check(a)
    return from16(pow16(field16(F, a.device), to16(a), e).contiguous())


def mont_pow(F, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e elementwise for a static exponent e (a in Montgomery form), over
    a Pasta field."""
    dev = _check(a)
    _require_pasta(F, "mont_pow")
    if dev.type == "cpu":
        return mont_pow_plain(F, a, e)
    digits = bytes(pow_digits(e))
    out = torch.empty_like(a)
    lib = LIBRARY.load().field
    _launch(lib, "pst_mont_pow", "pst_field_error_string", dev,
            _field_words(F), digits, len(digits), a.data_ptr(), out.data_ptr(), a[0].numel())
    LAUNCHES["mont_pow"] += 1
    return out


# ---------------------------------------------------------------------------
# Row scans: K5 mont_prefix_scan, K12 mont_prefix_scan_parts, K9 linear_scan,
# K6 ec_prefix_scan_parts, K7 ec_prefix_scan_fused
# ---------------------------------------------------------------------------


def scan_chunk(n: int) -> int:
    """Positions per thread (cp) of a row of length n: ceil(n / LANES)."""
    return max(1, -(-n // LANES))


# Most chunks of 128 a K12 block folds per step on the TPU (its PST_SCAN_CB
# default): the padding of the row follows from it (scan_geometry).
SCAN_CB = 16


def scan_geometry(n: int) -> tuple[int, int, int]:
    """(cb, nC, Cp) of a K12 row of length n (pallas_field._scan_geometry):
    C = ceil(n / 128) chunks split into nC near-equal blocks of cb <= 16,
    and Cp = cb * nC >= C positions per lane."""
    C = scan_chunk(n)
    nC = -(-C // min(SCAN_CB, C))
    cb = -(-C // nC)
    return cb, nC, cb * nC


def _rows_n(x: torch.Tensor) -> tuple[int, int]:
    if x.dim() < 2 or x.shape[-1] == 0:
        raise ValueError(f"scans need (8, ..., n) with n > 0, got {tuple(x.shape)}")
    n = x.shape[-1]
    return x[0].numel() // n, n


def _mont_scan_phases(P: Field16, x: torch.Tensor, cp: int):
    """Phases 1-2 of the blocked product scan of (8, ..., n) rows, lane l
    owning positions [l * cp, l * cp + cp), one past n: the inclusive chunk
    products (16, rows, LANES, cp) and the exclusive lane offsets (16, rows,
    LANES), as k_mont_prefix and k_mont_prefix_parts compute them."""
    rows, n = _rows_n(x)
    one = P.col(P.one16, 2)
    a = to16(x.reshape(NL, rows, n))
    a = torch.cat([a, one.expand(16, rows, LANES * cp - n)], dim=-1)
    a = a.view(16, rows, LANES, cp)
    carry = one.expand(16, rows, LANES)
    parts = []
    for c in range(cp):
        carry = mul16(P, carry, a[..., c])
        parts.append(carry)
    excl = _shift_lanes(carry, 1, one)
    s = 1
    while s < LANES:
        excl = mul16(P, excl, _shift_lanes(excl, s, one))
        s *= 2
    return torch.stack(parts, dim=-1), excl


def mont_prefix_scan_plain(F, x: torch.Tensor) -> torch.Tensor:
    _check(x)
    rows, n = _rows_n(x)
    P = field16(F, x.device)
    cp = scan_chunk(n)
    parts, excl = _mont_scan_phases(P, x, cp)
    out = mul16(P, excl[..., None], parts)
    return from16(out.reshape(16, rows, LANES * cp)[..., :n]).reshape(x.shape)


# K5's block (csrc/scan_field.cuh prefix_block_thread): the most positions
# a thread keeps where the block can grow, and the largest block (at 1,024
# threads the product spilled; PERF.md section 6).
PREFIX_MAX_SUB = 8
PREFIX_MAX_THREADS = 512


def prefix_geometry(n: int, threads: int | None = None) -> tuple[int, int, int]:
    """(T, sc, lanes_log2) of K5 on a row of n: T threads a block (by
    default the fewest, a power of two from 32 to PREFIX_MAX_THREADS, that
    leave each at most PREFIX_MAX_SUB positions), sc = ceil(n / T)
    positions a thread, and the levels of the warp scan: 5, fewer where a
    block of one warp holds the row in its first lanes."""
    t = threads or 32
    while threads is None and t < PREFIX_MAX_THREADS and -(-n // t) > PREFIX_MAX_SUB:
        t *= 2
    sc = -(-n // t)
    lanes_log2 = 5 if t > 32 else (-(-n // sc) - 1).bit_length()
    return t, sc, lanes_log2


def _mont_prefix_launch(F, x: torch.Tensor, threads: int) -> torch.Tensor:
    """K5 on (8, ..., n) CUDA rows with `threads` threads a block (a power
    of two from 32 to PREFIX_MAX_THREADS); counts nothing."""
    rows, n = _rows_n(x)
    t, sc, lanes_log2 = prefix_geometry(n, threads)
    out = torch.empty_like(x)
    _launch(LIBRARY.load().field, "pst_mont_prefix", "pst_field_error_string", x.device,
            _field_words(F), x.data_ptr(), out.data_ptr(), rows, n, sc, t.bit_length() - 6,
            lanes_log2)
    return out


def mont_prefix_scan(F, x: torch.Tensor) -> torch.Tensor:
    """Inclusive Montgomery prefix products along the last axis (a Pasta
    field): on the card one block a row, prefix_geometry's threads."""
    dev = _check(x)
    _require_pasta(F, "mont_prefix_scan")
    if dev.type == "cpu":
        return mont_prefix_scan_plain(F, x)
    out = _mont_prefix_launch(F, x, prefix_geometry(x.shape[-1])[0])
    LAUNCHES["mont_prefix_scan"] += 1
    return out


def mont_prefix_scan_parts_plain(F, x: torch.Tensor):
    _check(x)
    cp = scan_geometry(_rows_n(x)[1])[2]
    parts, excl = _mont_scan_phases(field16(F, x.device), x, cp)
    batch = x.shape[1:-1]
    return (from16(parts).reshape(NL, *batch, LANES * cp),
            from16(excl).reshape(NL, *batch, LANES), cp)


# K12's and K9's team size (csrc/scan_field.cuh): the threads a team split
# may put on one SM (two waves at the team kernels' 128-138 registers: at 24
# rows of 2^16 a team of 32 still ran fastest, PERF.md), the largest team
# (one warp), and the fewest positions a member keeps.
FIELD_SCAN_SM_THREADS = 1024
FIELD_SCAN_TEAM_MAX = 32
FIELD_SCAN_MIN_SUB = 2


@functools.lru_cache(maxsize=None)
def field_scan_team(rows: int, cp: int, sms: int) -> int:
    """The team size S of K12 and K9 for `rows` rows of lane chunks of cp
    positions on a card of `sms` SMs: S threads share each lane chunk. A
    chain of dependent products is shortest with the largest team (sc +
    log2 S + sc levels, sc = ceil(cp / S)), and a row of the main path
    leaves the card nearly idle: S doubles up to one warp while twice the
    threads fit FIELD_SCAN_SM_THREADS an SM and each member keeps at least
    FIELD_SCAN_MIN_SUB positions; S = 1 where the rows fill the card."""
    lanes, slots = rows * LANES, sms * FIELD_SCAN_SM_THREADS
    s = 1
    while s < FIELD_SCAN_TEAM_MAX and 2 * s * lanes <= slots and cp >= 2 * s * FIELD_SCAN_MIN_SUB:
        s *= 2
    return s


def _prefix_parts_launch(F, x: torch.Tensor, team: int):
    """K12's two kernels on (8, ..., n) CUDA rows with `team` threads a lane
    chunk (a power of two up to FIELD_SCAN_TEAM_MAX); counts nothing."""
    dev = x.device
    rows, n = _rows_n(x)
    cp = scan_geometry(n)[2]
    batch = x.shape[1:-1]
    partial = torch.empty((NL, *batch, LANES * cp), dtype=torch.int32, device=dev)
    excl = torch.empty((NL, *batch, LANES), dtype=torch.int32, device=dev)
    _launch(LIBRARY.load().field, "pst_mont_prefix_parts", "pst_field_error_string", dev,
            _field_words(F), x.data_ptr(), partial.data_ptr(), excl.data_ptr(), rows, n, cp,
            team.bit_length() - 1)
    return partial, excl, cp


def mont_prefix_scan_parts(F, x: torch.Tensor):
    """Blocked Montgomery prefix product, phases 1-2, along the last axis.

    Returns (partial, excl, cp) with cp = scan_geometry(n)[2]: partial
    (8, ..., LANES * cp), position j of lane j // cp holding the product of
    its lane's positions up to j (one past n); excl (8, ..., LANES), the
    exclusive products of the lane totals. The inclusive prefix product of
    position j is excl[..., j // cp] * partial[..., j]. On the card a team
    of threads shares each lane (field_scan_team); the limbs are the plain
    version's."""
    dev = _check(x)
    if dev.type == "cpu":
        return mont_prefix_scan_parts_plain(F, x)
    rows, n = _rows_n(x)
    out = _prefix_parts_launch(F, x, field_scan_team(rows, scan_geometry(n)[2], _sm_count(dev)))
    LAUNCHES["mont_prefix_scan_parts"] += 1
    return out


def _mont_table(p: int, r_mod_p: int, vals: list[int], device: str) -> torch.Tensor:
    """(8, len(vals)) int32 limbs of vals in Montgomery form on `device`."""
    arr = torch.tensor([_words(v * r_mod_p % p) for v in vals], dtype=torch.int64).T
    return torch.where(arr >= 1 << 31, arr - (1 << 32), arr).to(torch.int32).contiguous().to(device)


@functools.lru_cache(maxsize=None)
def _linear_table(p: int, r_mod_p: int, c: int, cp: int, device: str) -> torch.Tensor:
    vals = [pow(c, i + 1, p) for i in range(cp)] + [pow(c, cp << k, p) for k in range(7)]
    return _mont_table(p, r_mod_p, vals, device)


def linear_table(F, c: int, n: int, device) -> torch.Tensor:
    """(8, cp + 7) Montgomery constants of K9's plain version for a row of
    length n (cp = scan_chunk(n)): c^(i+1) for i < cp, then c^(cp * 2^k)
    for k < 7. Built on the host and copied to `device` once per (field, c,
    cp)."""
    return _linear_table(F.p, F.r_mod_p, c % F.p, scan_chunk(n), str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _linear_kernel_table(p: int, r_mod_p: int, c: int, cp: int, sc: int,
                         device: str) -> torch.Tensor:
    vals = ([pow(c, i + 1, p) for i in range(cp)] + [pow(c, cp << k, p) for k in range(7)]
            + [pow(c, sc << k, p) for k in range(5)])
    return _mont_table(p, r_mod_p, vals, device)


def linear_kernel_table(F, c: int, n: int, team: int, device) -> torch.Tensor:
    """(8, cp + 12) Montgomery constants of the K9 kernel for a row of
    length n (cp = scan_chunk(n)) with `team` threads a lane chunk (sc =
    ceil(cp / team) positions each): c^(i+1) for i < cp, c^(cp * 2^k) for
    k < 7 (the lane scan's levels), then c^(sc * 2^k) for k < 5 (the
    team's). Built on the host and copied to `device` once per (field, c,
    cp, sc)."""
    cp = scan_chunk(n)
    return _linear_kernel_table(F.p, F.r_mod_p, c % F.p, cp, -(-cp // team),
                                str(torch.device(device)))


def linear_scan_plain(F, x: torch.Tensor, c: int) -> torch.Tensor:
    _check(x)
    rows, n = _rows_n(x)
    P = field16(F, x.device)
    cp = scan_chunk(n)
    tab = to16(linear_table(F, c, n, x.device))
    zero = torch.zeros((16, 1, 1), dtype=torch.int64, device=x.device)
    a = torch.nn.functional.pad(to16(x.reshape(NL, rows, n)), (0, LANES * cp - n))
    a = a.view(16, rows, LANES, cp)
    cm = P.col(tab[:, 0], 2)
    s = zero.expand(16, rows, LANES)
    parts = []
    for i in range(cp):
        s = add16(P, a[..., i], mul16(P, cm, s))
        parts.append(s)
    for k in range(7):
        s = add16(P, s, mul16(P, P.col(tab[:, cp + k], 2), _shift_lanes(s, 1 << k, zero)))
    excl = _shift_lanes(s, 1, zero)
    out = add16(P, torch.stack(parts, dim=-1), mul16(P, tab[:, None, None, :cp], excl[..., None]))
    return from16(out.reshape(16, rows, LANES * cp)[..., :n]).reshape(x.shape)


def _linear_scan_launch(F, x: torch.Tensor, c: int, team: int) -> torch.Tensor:
    """K9's three kernels on (8, ..., n) CUDA rows with `team` threads a
    lane chunk (a power of two up to FIELD_SCAN_TEAM_MAX); counts nothing."""
    dev = x.device
    rows, n = _rows_n(x)
    tab = linear_kernel_table(F, c, n, team, dev)
    # the team offsets (rows, LANES, team), then the lane values (rows, LANES)
    scratch = torch.empty(NL * rows * LANES * (team + 1), dtype=torch.int32, device=dev)
    out = torch.empty_like(x)
    _launch(LIBRARY.load().field, "pst_linear_scan", "pst_field_error_string", dev,
            _field_words(F), x.data_ptr(), tab.data_ptr(), tab.shape[1], scratch.data_ptr(),
            out.data_ptr(), rows, n, scan_chunk(n), team.bit_length() - 1)
    return out


def linear_scan(F, x: torch.Tensor, c: int) -> torch.Tensor:
    """Inclusive recurrence s_j = x_j + c * s_(j-1) along the last axis, for
    a static int c; x in Montgomery form. On the card a team of threads
    shares each lane chunk (field_scan_team)."""
    dev = _check(x)
    if dev.type == "cpu":
        return linear_scan_plain(F, x, c)
    rows, n = _rows_n(x)
    out = _linear_scan_launch(F, x, c, field_scan_team(rows, scan_chunk(n), _sm_count(dev)))
    LAUNCHES["linear_scan"] += 1
    return out


# K12's, K9's and K5's kernels, in the order of pst_scan_attrs
FIELD_SCAN_KERNELS = ("K12 parts S 1", "K12 parts S > 1", "K12 lanes", "K9 parts S 1",
                      "K9 parts S > 1", "K9 lanes", "K9 combine", "K5")


def field_scan_attrs() -> dict[str, tuple[int, ...]]:
    """(registers, local bytes, static and dynamic shared bytes) of each K12,
    K9 and K5 kernel (FIELD_SCAN_KERNELS), from cudaFuncGetAttributes."""
    lib = LIBRARY.load().field
    out = {}
    for which, name in enumerate(FIELD_SCAN_KERNELS):
        buf = (ctypes.c_int * 4)()
        rc = lib.pst_scan_attrs(which, buf)
        if rc:
            raise RuntimeError(f"pst_scan_attrs: CUDA error {rc}")
        out[name] = tuple(buf)
    return out


def _ec_scan_plain(F, x, y, z, mixed: bool, fused: bool):
    """Phases 1-2 (and 3 when fused) of the row scan with one thread a lane
    chunk, as k_ec_parts with S = 1, k_ec_lane_offsets and k_ec_combine."""
    rows, n = _rows_n(x)
    P = field16(F, x.device)
    cp = scan_chunk(n)
    npad = LANES * cp
    ins = [
        torch.nn.functional.pad(t.reshape(NL, rows, n), (0, npad - n)).view(NL, rows, LANES, cp)
        for t in (x, y, z)
    ]
    parts = [torch.empty((NL, rows, LANES, cp), dtype=torch.int32, device=x.device)
             for _ in range(3)]
    step = ec_madd16 if mixed else ec_add16
    # A lane's carry starts from the identity (0, 0, 0) and adds each of its
    # positions, as k_ec_parts does. The complete add of two points at
    # infinity returns its first operand, so where a lane starts with points
    # at infinity its partial sums hold (0, 0, 0), not the input's limbs of
    # the identity (the MSM's are (R, R, 0)); the TPU kernel seeds each lane
    # from its first element and keeps those limbs, so there the limbs differ
    # from its own and the group elements agree. Lanes above the last one that
    # holds data stay the identity, and an add of the identity returns the
    # other operand exactly, so the plain version adds only where both
    # operands may hold a point: the kernel's values, with less work when a
    # row is short.
    live = -(-n // cp)
    carry = (torch.zeros((16, rows, LANES), dtype=torch.int64, device=x.device),) * 3
    for c in range(cp):
        head = step(P, tuple(t[..., :live] for t in carry),
                    tuple(to16(t[..., :live, c]) for t in ins))
        carry = tuple(torch.cat([h, t[..., live:]], -1) for h, t in zip(head, carry))
        for dst, v in zip(parts, carry):
            dst[..., c] = from16(v)
    zero = torch.zeros((16, 1, 1), dtype=torch.int64, device=x.device)
    excl = tuple(_shift_lanes(t, 1, zero) for t in carry)
    hi, s = live, 1  # lanes above hi hold the identity
    while s < LANES:
        top = min(LANES, hi + s + 1)
        new = ec_add16(P, tuple(t[..., s:top] for t in excl), tuple(t[..., : top - s] for t in excl))
        excl = tuple(torch.cat([t[..., :s], u, t[..., top:]], -1) for t, u in zip(excl, new))
        hi = min(LANES - 1, hi + s)
        s *= 2
    batch = x.shape[1:-1]
    if not fused:
        partial = tuple(t.reshape(NL, *batch, npad) for t in parts)
        return partial, tuple(from16(t).reshape(NL, *batch, LANES) for t in excl), cp
    # phase 3 on the n live positions only (the output drops the padding)
    pe = tuple(t[..., None].expand(16, rows, LANES, cp).reshape(16, rows, npad)[..., :n]
               for t in excl)
    ps = tuple(to16(t).reshape(16, rows, npad)[..., :n] for t in parts)
    return tuple(from16(t).reshape(x.shape) for t in ec_add16(P, pe, ps))


def ec_prefix_scan_parts_plain(F, x, y, z, mixed: bool = False):
    _check(x, y, z)
    return _ec_scan_plain(F, x, y, z, mixed, fused=False)


# K6 geometry (csrc/curve_kernels.cu k_ec_parts): the threads of one SM
# that a team split aims to fill (three blocks of 128 at the kernel's
# register cap), and the largest team.
PARTS_SM_THREADS = 3 * 128
PARTS_TEAM_MAX = 16


@functools.lru_cache(maxsize=None)
def parts_geometry(rows: int, cp: int, sms: int) -> tuple[int, int]:
    """(S, KT) of K6 for `rows` rows of lane chunks of cp positions on a card
    of `sms` SMs: S threads share each lane chunk and KT columns are staged
    a copy. One thread a chunk (S = 1, no extra work) unless the rows fill
    less than a quarter of the card; then S doubles while the threads still
    fit in one pass and each keeps at least 8 positions. KT = 16 (64-byte
    store runs) for one thread a chunk of 64 positions or more, else 4."""
    lanes, slots = rows * LANES, sms * PARTS_SM_THREADS
    s = 1
    if 4 * lanes < slots:
        while s < PARTS_TEAM_MAX and 2 * s * lanes <= slots and cp >= 16 * s:
            s *= 2
    return s, 16 if s == 1 and cp >= 64 else 4


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# K6's kernels: (team, kt) of each k_ec_parts instantiation, and
# k_ec_lane_offsets as kt 0
PARTS_KERNELS = {"S 1 KT 16": (1, 16), "S 1 KT 4": (1, 4), "S > 1 KT 4": (2, 4),
                 "lane offsets": (1, 0)}


def ec_prefix_scan_parts_attrs() -> dict[str, tuple[int, ...]]:
    """(registers, local bytes, static and dynamic shared bytes) of each K6
    kernel (PARTS_KERNELS; k_ec_parts mixed then general), from
    cudaFuncGetAttributes."""
    lib = LIBRARY.load().curve
    out = {}
    for name, (team, kt) in PARTS_KERNELS.items():
        for mixed in ((1, 0) if kt else (0,)):
            buf = (ctypes.c_int * 4)()
            rc = lib.pst_ec_scan_parts_attrs(team.bit_length() - 1, kt, mixed, buf)
            if rc:
                raise RuntimeError(f"pst_ec_scan_parts_attrs: CUDA error {rc}")
            key = name if not kt else f"{name} {'mixed' if mixed else 'general'}"
            out[key] = tuple(buf)
    return out


def _ec_parts_launch(F, x, y, z, mixed: bool, team: int, kt: int):
    """K6's two kernels on (8, ..., n) CUDA rows with `team` threads a lane
    chunk (a power of two up to PARTS_TEAM_MAX) and tile width kt (4, or 16
    with team = 1); counts nothing."""
    dev = x.device
    rows, n = _rows_n(x)
    cp = scan_chunk(n)
    batch = x.shape[1:-1]
    partial = tuple(torch.empty((NL, *batch, LANES * cp), dtype=torch.int32, device=dev)
                    for _ in range(3))
    excl = tuple(torch.empty((NL, *batch, LANES), dtype=torch.int32, device=dev)
                 for _ in range(3))
    lib = LIBRARY.load().curve
    _launch(lib, "pst_ec_scan_parts", "pst_curve_error_string", dev,
            _field_words(F), *_ptrs((x, y, z)), *_ptrs(partial),
            *_ptrs(excl), rows, n, cp, int(mixed), team.bit_length() - 1, kt)
    return partial, excl, cp


def ec_prefix_scan_parts(F, x, y, z, mixed: bool = False):
    """Blocked Jacobian prefix scan, phases 1-2, along the last axis.

    Returns (partial, excl, cp): partial leaves (8, ..., LANES * cp) and
    excl leaves (8, ..., LANES); the inclusive prefix of position j is
    excl[..., j // cp] + partial[..., j]. mixed=True requires affine-encoded
    input (z in {0, R}) and uses mixed additions in the chunk scan. The
    kernel's values are the plain version's as group elements; the limbs
    differ where a team of threads shares a chunk (parts_geometry)."""
    dev = _check(x, y, z)
    if dev.type == "cpu":
        return ec_prefix_scan_parts_plain(F, x, y, z, mixed)
    rows, n = _rows_n(x)
    team, kt = parts_geometry(rows, scan_chunk(n), _sm_count(dev))
    out = _ec_parts_launch(F, x, y, z, mixed, team, kt)
    LAUNCHES["ec_prefix_scan_parts"] += 1
    return out


def ec_prefix_scan_fused_plain(F, x, y, z):
    _check(x, y, z)
    return _ec_scan_plain(F, x, y, z, mixed=False, fused=True)


@functools.lru_cache(maxsize=None)
def ec_scan_scratch(rows: int, n: int) -> tuple[int, int]:
    """(cp, words) of K7's scratch for `rows` rows of n positions, in the
    launcher's order: K6's partial sums of x, y and z at every position of
    the LANES lane chunks of cp (NL * rows * LANES * cp words each), then
    their LANES lane offsets (NL * rows * LANES words each)."""
    cp = scan_chunk(n)
    return cp, 3 * NL * rows * LANES * (cp + 1)


def ec_prefix_scan_fused_attrs() -> tuple[int, ...]:
    """(registers, local bytes, static and dynamic shared bytes) of K7's
    combine kernel, from cudaFuncGetAttributes (its scan kernels are K6's:
    ec_prefix_scan_parts_attrs)."""
    buf = (ctypes.c_int * 4)()
    rc = LIBRARY.load().curve.pst_ec_scan_fused_attrs(buf)
    if rc:
        raise RuntimeError(f"pst_ec_scan_fused_attrs: CUDA error {rc}")
    return tuple(buf)


def _ec_fused_launch(F, x, y, z, team: int, kt: int):
    """K7's three kernels on (8, ..., n) CUDA rows: K6's (general adds,
    `team` threads a lane chunk, tile width kt) into scratch, then the
    combine; counts nothing."""
    dev = x.device
    rows, n = _rows_n(x)
    cp, words = ec_scan_scratch(rows, n)
    # one allocation for the scratch and one for the output, their parts
    # addressed by the launcher: the opening's tail rounds wait for the
    # host, and every allocation, view and argument is host time
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    out = torch.empty((3, *x.shape), dtype=torch.int32, device=dev)
    _launch(LIBRARY.load().curve, "pst_ec_scan_fused", "pst_curve_error_string", dev,
            _field_words(F), x.data_ptr(), y.data_ptr(), z.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), rows, n, cp, team.bit_length() - 1, kt)
    return out.unbind(0)


def ec_prefix_scan_fused(F, x, y, z):
    """Inclusive Jacobian prefix scan along the last axis; (x, y, z).

    On the card: K6's kernels (general adds, the team size and tile width of
    parts_geometry) write the lane chunks' partial sums and the lane
    offsets to scratch, and a combine kernel adds them, one thread a
    position. The values are the plain version's as group elements, and its
    limbs where one thread scans a chunk (S = 1)."""
    dev = _check(x, y, z)
    if dev.type == "cpu":
        return ec_prefix_scan_fused_plain(F, x, y, z)
    rows, n = _rows_n(x)
    team, kt = parts_geometry(rows, scan_chunk(n), _sm_count(dev))
    out = _ec_fused_launch(F, x, y, z, team, kt)
    LAUNCHES["ec_prefix_scan_fused"] += 1
    return out


# ---------------------------------------------------------------------------
# K8 combine_windows
# ---------------------------------------------------------------------------


def combine_windows_plain(F, c, wx, wy, wz):
    """K8's Horner chain; `c` the window width, or one for each of the b
    columns (a sequence: a column stops doubling after its own c)."""
    _check(wx, wy, wz)
    P = field16(F, wx.device)
    win = [to16(t) for t in (wx, wy, wz)]
    acc = tuple(torch.zeros_like(t[:, 0]) for t in win)  # the identity
    cs = None if isinstance(c, int) else torch.tensor(list(c), device=wx.device)
    for w in range(wx.shape[1] - 1, -1, -1):
        for k in range(c if cs is None else int(cs.max())):
            twice = ec_double16(P, acc)
            acc = twice if cs is None else tuple(
                torch.where(k < cs, d, a) for d, a in zip(twice, acc))
        acc = ec_add16(P, acc, tuple(t[:, w] for t in win))
    return tuple(from16(t.contiguous()) for t in acc)


def combine_windows_attrs() -> tuple[int, ...]:
    """(registers, local bytes, static and dynamic shared bytes) of the K8
    kernel, from cudaFuncGetAttributes."""
    buf = (ctypes.c_int * 4)()
    rc = LIBRARY.load().curve.pst_combine_windows_attrs(buf)
    if rc:
        raise RuntimeError(f"pst_combine_windows_attrs: CUDA error {rc}")
    return tuple(buf)


def combine_windows(F, c: int, wx, wy, wz):
    """Pippenger window recombination sum_w 2^(cw) * win_w for every column:
    (8, W, b) Jacobian window sums -> (8, b). Horner from the top window:
    c doublings, then a general add of the next window (csrc/k8_combine.cuh:
    one warp a column, a level's products on four lanes)."""
    dev = _check(wx, wy, wz)
    if wx.dim() != 3:
        raise ValueError(f"window sums are (8, W, b), got {tuple(wx.shape)}")
    if c < 1:
        raise ValueError(f"window size must be positive, got {c}")
    if dev.type == "cpu":
        return combine_windows_plain(F, c, wx, wy, wz)
    W, b = wx.shape[1], wx.shape[2]
    out = tuple(torch.empty((NL, b), dtype=torch.int32, device=dev) for _ in range(3))
    lib = LIBRARY.load().curve
    _launch(lib, "pst_combine_windows", "pst_curve_error_string", dev,
            _field_words(F), *_ptrs((wx, wy, wz)), *_ptrs(out), W, b, c)
    LAUNCHES["combine_windows"] += 1
    return out


# ---------------------------------------------------------------------------
# K10 sponge_squeeze2, bits128, K11 endo_inv
# ---------------------------------------------------------------------------


def _words(x: int) -> list[int]:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(NL)]


@functools.lru_cache(maxsize=None)
def _sponge_consts(params, device: str) -> torch.Tensor:
    p = params.field.p
    rmod = (1 << 256) % p
    rcs = [v for row in params.round_constants[: params.rounds_full] for v in row]
    mds = [v for row in params.mds for v in row]
    cols = [_words(v % p * rmod % p) for v in rcs + mds]
    arr = torch.tensor(cols, dtype=torch.int64).T.contiguous()
    return torch.where(arr >= 1 << 31, arr - (1 << 32), arr).to(torch.int32).to(device)


def sponge_consts(params, device) -> torch.Tensor:
    """(8, 3 * rounds + 9) Montgomery constants of one Poseidon parameter
    set on `device`: rc[r][j] in column 3r + j, then mds[i][j] in column
    3 * rounds + 3i + j. Built once per (parameter set, device)."""
    if params.initial_ark or params.sbox != 7 or params.sponge_width != 3:
        raise ValueError(f"sponge_squeeze2 runs the kimchi permutation, not {params.name}")
    return _sponge_consts(params, str(torch.device(device)))


def _sponge_args(nrounds: int, state, xs, ys, consts) -> torch.device:
    dev = _check(state, xs, ys, consts, same_shape=False)
    if (state.shape, xs.shape, ys.shape) != ((NL, 3), (NL, 2), (NL, 2)):
        raise ValueError("sponge_squeeze2 takes state (8, 3) and xs, ys (8, 2)")
    if consts.shape != (NL, 3 * nrounds + 9):
        raise ValueError(f"constants {tuple(consts.shape)} do not match {nrounds} rounds")
    return dev


def sponge_squeeze2_plain(F, nrounds: int, state, xs, ys, consts):
    _sponge_args(nrounds, state, xs, ys, consts)
    P = field16(F, state.device)
    c16 = to16(consts)
    rc = c16[:, : 3 * nrounds].reshape(16, nrounds, 3)
    mds = c16[:, 3 * nrounds :]  # (16, 9), mds[i][j] in column 3i + j
    x16, y16 = to16(xs), to16(ys)
    zero = torch.zeros_like(x16[:, :1])

    def permute(s):
        for r in range(nrounds):
            x2 = mul16(P, s, s)
            x3 = mul16(P, x2, s)
            t = mul16(P, mul16(P, x3, x3), s)  # x^7
            prod = mul16(P, mds, t.repeat(1, 3)).view(16, 3, 3)
            s = add16(P, add16(P, add16(P, prod[..., 0], prod[..., 1]), prod[..., 2]), rc[:, r])
        return s

    st = to16(state)
    for k in range(2):
        st = permute(add16(P, st, torch.cat([x16[:, k : k + 1], y16[:, k : k + 1], zero], 1)))
    one_std = torch.zeros_like(zero)
    one_std[0] = 1
    return from16(st.contiguous()), from16(mul16(P, st[:, :1], one_std).contiguous())


def sponge_squeeze2(F, nrounds: int, state, xs, ys, consts):
    """Two sponge steps of the IPA round and the challenge read, over the
    base field F: absorb (x_L, y_L), permute, absorb (x_R, y_R), permute;
    returns (state' (8, 3) Montgomery, chal (8, 1) = REDC(state'[0]),
    canonical). Points at infinity arrive as (0, 0). F is a Pasta field."""
    dev = _sponge_args(nrounds, state, xs, ys, consts)
    _require_pasta(F, "sponge_squeeze2")
    if dev.type == "cpu":
        return sponge_squeeze2_plain(F, nrounds, state, xs, ys, consts)
    st = torch.empty_like(state)
    chal = torch.empty((NL, 1), dtype=torch.int32, device=dev)
    lib = LIBRARY.load().field
    _launch(lib, "pst_sponge_squeeze2", "pst_field_error_string", dev,
            _field_words(F), *_ptrs((state, xs, ys, consts)), nrounds, st.data_ptr(),
            chal.data_ptr())
    LAUNCHES["sponge_squeeze2"] += 1
    return st, chal


def chain_attrs() -> dict[str, tuple[int, ...]]:
    """Registers, local (stack) bytes, static and dynamic shared memory of
    the kernels on chain_field.cuh's product: K10, K4, K11 and the latency
    chain of product_chain."""
    lib = LIBRARY.load().field
    out = {}
    for which, name in enumerate(("k_sponge_squeeze2", "k_mont_pow", "k_endo_inv",
                                  "k_product_chain")):
        vals = (ctypes.c_int * 4)()
        rc = lib.pst_chain_attrs(which, vals)
        if rc != 0:
            raise RuntimeError(f"pst_chain_attrs: CUDA error {rc}")
        out[name] = tuple(vals)
    return out


# Kinds of pst_product_chain: a measurement of one product's latency, not a
# kernel of the path; and the chain of K11's inverse (times R^3 mod p).
PRODUCT_CHAINS = {"fe_mul (CIOS, any field)": 0, "fe_mul_lat": 1, "fe_sqr_lat": 2,
                  "fe_dot3_lat": 3}
INVERSE_CHAIN = 4


def product_chain(F, kind: int, x: torch.Tensor, steps: int) -> torch.Tensor:
    """One thread's chain of `steps` dependent products of one kind (on the
    card): a = a * x1, a^2, dot3(a, x1, a, x2, a, x3) or (INVERSE_CHAIN)
    inv(a) * x1 from a = x0, x (8, 4). Returns a (8, 1)."""
    dev = _check(x)
    if dev.type != "cuda" or x.shape != (NL, 4):
        raise ValueError("product_chain takes (8, 4) operands on the card")
    _require_pasta(F, "product_chain")
    out = torch.empty((NL, 1), dtype=torch.int32, device=dev)
    _launch(LIBRARY.load().field, "pst_product_chain", "pst_field_error_string", dev,
            _field_words(F), kind, x.data_ptr(), steps, out.data_ptr())
    return out


def bits128(chal: torch.Tensor) -> torch.Tensor:
    """(8, 1) canonical limbs -> the low 128 bits as a (128,) int32 tensor,
    least significant first (a torch op on the tensor's device)."""
    j = torch.arange(128, device=chal.device)
    words = chal[:4, 0].to(torch.int64) & 0xFFFFFFFF
    return ((words[j // 32] >> (j % 32)) & 1).to(torch.int32)


def _endo_args(bits, per_lane: bool = False) -> torch.device:
    """Challenge bits: (128,) int32, or (128, m) (m challenges) where
    `per_lane` allows it (the plain versions)."""
    shape_ok = tuple(bits.shape) == (128,) or (per_lane and bits.dim() == 2
                                              and bits.shape[0] == 128)
    if bits.dtype != torch.int32 or not shape_ok or not bits.is_contiguous():
        raise ValueError(f"challenge bits are a contiguous (128,) int32 tensor, got {bits.shape}")
    if bits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {bits.device}")
    return bits.device


def endo_inv_plain(F, endo: int, bits):
    """(u, u^-1), (8, 1); or (8, m) for bits (128, m), m challenges."""
    _endo_args(bits, per_lane=True)
    P = field16(F, bits.device)
    one = P.col(P.one16, 1)
    a = b = add16(P, one, one)
    hot = bits.to(torch.bool)
    for i in range(63, -1, -1):
        a = add16(P, a, a)
        b = add16(P, b, b)
        r0, r1 = hot[2 * i], hot[2 * i + 1]
        a_s = torch.where(r0, add16(P, a, one), sub16(P, a, one))
        b_s = torch.where(r0, add16(P, b, one), sub16(P, b, one))
        a, b = torch.where(r1, a_s, a), torch.where(r1, b, b_s)
    endo16 = torch.tensor(limbs16(endo % F.p * F.r_mod_p % F.p), device=bits.device)[:, None]
    u = add16(P, mul16(P, a, endo16), b)
    return from16(u.contiguous()), from16(pow16(P, u, F.p - 2).contiguous())


@functools.lru_cache(maxsize=None)
def _endo_consts(p: int, r_mod_p: int, endo: int):
    """K11's host constants: the integers endo R^2, R^2 and R^3 mod p, as 24
    words (csrc/inv_field.cuh EndoConsts)."""
    r2 = r_mod_p * r_mod_p % p
    words = _words(endo % p * r2 % p) + _words(r2) + _words(r2 * r_mod_p % p)
    return (ctypes.c_uint32 * (3 * NL))(*words)


def endo_inv(F, endo: int, bits):
    """ScalarChallenge.to_field of the 128 challenge bits (least significant
    first) and the inverse of the result: (u, u^-1), (8, 1) each,
    Montgomery, over the scalar field F (a Pasta field). endo: the curve's
    endo_r. On the card the closed form of the recurrence and a binary-GCD
    inverse (csrc/inv_field.cuh)."""
    dev = _endo_args(bits)
    _require_pasta(F, "endo_inv")
    if dev.type == "cpu":
        return endo_inv_plain(F, endo, bits)
    consts = _endo_consts(F.p, F.r_mod_p, endo)
    u = torch.empty((NL, 1), dtype=torch.int32, device=dev)
    u_inv = torch.empty_like(u)
    lib = LIBRARY.load().field
    _launch(lib, "pst_endo_inv", "pst_field_error_string", dev,
            _field_words(F), ctypes.addressof(consts), bits.data_ptr(), u.data_ptr(),
            u_inv.data_ptr())
    LAUNCHES["endo_inv"] += 1
    return u, u_inv


# ---------------------------------------------------------------------------
# Launch counts
# ---------------------------------------------------------------------------

WRAPPERS = {
    "mont_mul": mont_mul,
    "jacobian_add": jacobian_add,
    "jacobian_double": jacobian_double,
    "mont_pow": mont_pow,
    "mont_prefix_scan": mont_prefix_scan,
    "ec_prefix_scan_parts": ec_prefix_scan_parts,
    "ec_prefix_scan_fused": ec_prefix_scan_fused,
    "combine_windows": combine_windows,
    "linear_scan": linear_scan,
    "sponge_squeeze2": sponge_squeeze2,
    "endo_inv": endo_inv,
    "mont_prefix_scan_parts": mont_prefix_scan_parts,
    "endo_ladder": endo_ladder,
}

# Kernel launches per wrapper: each wrapper adds one where it launches its
# kernel on the card, and nowhere else (the plain versions count nothing).
LAUNCHES = dict.fromkeys(WRAPPERS, 0)


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
