"""SRS: deterministic generator derivation, device bases, commitments.

Counterpart of proof_systems_tpu/poly_commitment/srs.py:
  - point derivation g[i] = to_group(bits(blake2b512(be32(i)))) and the
    blinder h from b"srs_misc" || be32(0) (poly-commitment/src/ipa.rs),
    exact on the host and cached on disk in the port's own format;
  - commitments are MSMs over the pre-scaled windows of g ++ [h] on the
    device, the hiding term w*H fused in as one more (h, w) pair per chunk;
  - the commitments to the first m Lagrange basis polynomials of a domain
    (the verifier's public-input commitment) are one unscaled b = m MSM
    over g, cached in memory and on disk;
  - load_reference_srs reads the reference's `srs/*.srs` files.

The caches are plain uint8 arrays (count, 64): x || y, 32 bytes
little-endian each (all zero for infinity in the Lagrange cache), under the
repo's gitignored build directory by default.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import multiprocessing
import os
import pathlib

import numpy as np
import torch

from .. import BUILD_DIR
from ..curves import CurveParams
from ..ops import limb, msm, poly
from ..ops.curve_ops import APoint, JPoint, device_curve
from ..runtime import check_device, resolve_device
from .commitment import PolyComm

DEFAULT_CACHE_DIR = BUILD_DIR / "srs"
# Host derivation costs about a millisecond a point (a square root per
# candidate x); from this depth on it is spread over a process pool.
_POOL_MIN_DEPTH = 4096


def _random_point(curve: CurveParams, digest: bytes) -> tuple[int, int]:
    """point_of_random_bytes (ipa.rs:129-160): 31 bytes -> 248 bits
    (LSB-first per byte) -> big-endian integer -> SvdW to_group."""
    val = 0
    for k in range(31):
        for j in range(8):
            val = (val << 1) | ((digest[k] >> j) & 1)
    return curve.to_group(val)


def derive_g(curve: CurveParams, i: int) -> tuple[int, int]:
    h = hashlib.blake2b(digest_size=64)
    h.update(i.to_bytes(4, "big"))
    return _random_point(curve, h.digest())


def derive_h(curve: CurveParams) -> tuple[int, int]:
    h = hashlib.blake2b(digest_size=64)
    h.update(b"srs_misc")
    h.update((0).to_bytes(4, "big"))
    return _random_point(curve, h.digest())


def _derive_range(curve: CurveParams, lo: int, hi: int) -> list[tuple[int, int]]:
    return [derive_g(curve, i) for i in range(lo, hi)]


def derive_points(curve: CurveParams, depth: int) -> list[tuple[int, int]]:
    """g[0..depth), in a spawn process pool for large depths."""
    if depth < _POOL_MIN_DEPTH:
        return _derive_range(curve, 0, depth)
    workers = os.cpu_count() or 1
    step = -(-depth // (8 * workers))
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        futs = [
            pool.submit(_derive_range, curve, lo, min(lo + step, depth))
            for lo in range(0, depth, step)
        ]
        return [pt for f in futs for pt in f.result()]


def _points_to_bytes(g: list[tuple[int, int]]) -> np.ndarray:
    buf = b"".join(x.to_bytes(32, "little") + y.to_bytes(32, "little") for x, y in g)
    return np.frombuffer(buf, dtype=np.uint8).reshape(len(g), 64)


def _points_from_bytes(arr: np.ndarray) -> list[tuple[int, int]]:
    raw = arr.tobytes()
    return [
        (
            int.from_bytes(raw[64 * i : 64 * i + 32], "little"),
            int.from_bytes(raw[64 * i + 32 : 64 * i + 64], "little"),
        )
        for i in range(arr.shape[0])
    ]


def _save_points(path: pathlib.Path, pts) -> None:
    """Write points ((x, y) | None, infinity as (0, 0), which is not on the
    curve) through a temporary file, so a reader never sees half a file."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp.npy")
    np.save(tmp, _points_to_bytes([(0, 0) if pt is None else pt for pt in pts]))
    os.replace(tmp, path)


class SRS:
    """The universal IPA structured reference string for one curve, with
    its device bases on one device."""

    def __init__(self, curve: CurveParams, g, h, device: torch.device, cache_dir=None):
        """cache_dir: where lagrange_commitments keeps its results on disk
        (SRS.create passes its own); None keeps them in memory only."""
        self.curve = curve
        self.g = list(g)
        self.h = h
        self.device = device
        self.cache_dir = None if cache_dir is None else pathlib.Path(cache_dir)
        self._g_dev: APoint | None = None
        self._gh_dev: APoint | None = None
        self._hg_dev: APoint | None = None
        self._scaled: dict[int, JPoint] = {}
        # domain size -> affine commit(L_i) of its first rows
        self._lagrange: dict[int, list] = {}

    @classmethod
    def create(cls, curve: CurveParams, depth: int, device=None, cache_dir=None) -> "SRS":
        """Deterministic SRS, the same points as ipa.rs create_parallel.
        Derived on the host once, then read from `cache_dir`."""
        dev = resolve_device(device)
        cache_dir = pathlib.Path(cache_dir or DEFAULT_CACHE_DIR)
        path = cache_dir / f"srs_{curve.name.lower()}_{depth}.npy"
        if path.exists():
            g = _points_from_bytes(np.load(path))
        else:
            g = derive_points(curve, depth)
            _save_points(path, g)
        return cls(curve, g, derive_h(curve), dev, cache_dir)

    def __len__(self) -> int:
        return len(self.g)

    @property
    def g_dev(self) -> APoint:
        if self._g_dev is None:
            self._g_dev = device_curve(self.curve).pack_affine(self.g, device=self.device)
        return self._g_dev

    @property
    def gh_dev(self) -> APoint:
        """g ++ [h]: the basis for commitments with fused hiding."""
        if self._gh_dev is None:
            self._gh_dev = device_curve(self.curve).pack_affine(
                self.g + [self.h], device=self.device
            )
        return self._gh_dev

    @property
    def hg_dev(self) -> APoint:
        """[h] ++ g: the fixed head of the verifier's MSM basis, packed once
        per SRS (verify_batch packs only the per-proof points per call)."""
        if self._hg_dev is None:
            self._hg_dev = device_curve(self.curve).pack_affine(
                [self.h] + self.g, device=self.device
            )
        return self._hg_dev

    def scaled_basis(self, c: int) -> JPoint:
        """Pre-scaled windows 2^(cw)*(g ++ [h]), (8, W, n + 1), cached per
        window size (fixed per SRS, so commits skip the Horner chain)."""
        if c not in self._scaled:
            dc = device_curve(self.curve)
            self._scaled[c] = msm.scale_basis(dc, self.gh_dev, c, msm.num_windows(c))
        return self._scaled[c]

    # -- committing --------------------------------------------------------

    def lagrange_commitments(self, domain, m: int) -> list:
        """Commitments to the first m Lagrange basis polynomials of `domain`
        (ipa.rs:648-660 get_lagrange_basis, restricted to the public rows,
        which is all the verifier reads): L_i has the coefficients
        n^-1 * omega^(-ij), so the m rows are one gather of the power vector
        of omega^-1, scaled by n^-1 on the device, and commit(L_i) is one
        unscaled MSM with b = m over g. Cached in memory per domain size and
        on disk in cache_dir, so the verifier's public commitment costs m
        host scalar multiplications (verifier.rs:833)."""
        n = domain.n
        if n != len(self.g):
            raise NotImplementedError(
                f"Lagrange commitments of a {n}-point domain over a {len(self.g)}-point "
                "SRS: public inputs on a chunked domain fail in the JAX package too "
                "(ROADMAP Queue 3)")
        have = self._lagrange.get(n)
        if have is not None and len(have) >= m:
            return have[:m]
        path = None
        if self.cache_dir is not None:
            path = self.cache_dir / f"lagrange_{self.curve.name.lower()}_{n}_{m}.npy"
        if path is not None and path.exists():
            pts = [None if pt == (0, 0) else pt for pt in _points_from_bytes(np.load(path))]
        else:
            F = limb.device_field(self.curve.scalar)
            pw = poly.powers_dev(F, domain.group_gen_inv, n, device=self.device)
            i = torch.arange(m, device=self.device)
            j = torch.arange(n, device=self.device)
            rows = limb.mont_mul(F, pw[:, (i[:, None] * j) % n],
                                 F.const_mont(domain.n_inv, (1, 1), device=self.device))
            pts = msm.msm(self.curve, limb.from_mont(F, rows), points=self.g_dev,
                          device=self.device)
            if path is not None:
                _save_points(path, pts)
        self._lagrange[n] = pts
        return pts[:m]

    def mask(self, comm: PolyComm, blinders: list[int]) -> PolyComm:
        """Hiding on the host: chunk_i + blinders_i * H (ipa.rs mask_custom)."""
        c = self.curve
        return PolyComm(
            [c.add(ch, c.scalar_mul(w, self.h)) for ch, w in zip(comm.chunks, blinders)]
        )

    def _commit_rows(self, rows: torch.Tensor) -> list:
        """MSMs of (8, B, n + 1) standard-form scalar rows over g ++ [h]."""
        c = msm.default_window_bits(len(self.g) + 1)
        return msm.msm(self.curve, rows, c=c, scaled=self.scaled_basis(c), device=self.device)

    def commit_coeffs_host(self, polys: list[list[int]], num_chunks: int = 1) -> list[PolyComm]:
        """Commit host coefficient vectors (non-hiding)."""
        n = len(self.g)
        rows, layout = [], []
        for pi, coeffs in enumerate(polys):
            chunks = max(-(-len(coeffs) // n), 1, num_chunks)
            for ci in range(chunks):
                seg = coeffs[ci * n : (ci + 1) * n]
                rows.append(seg + [0] * (n + 1 - len(seg)))  # h term: w = 0
                layout.append(pi)
        p = self.curve.scalar.p
        scal = limb.ints_to_limbs([x % p for row in rows for x in row], shape=(len(rows), n + 1))
        results = self._commit_rows(torch.from_numpy(scal).to(self.device))
        out = [PolyComm([]) for _ in polys]
        for pi, pt in zip(layout, results):
            out[pi].chunks.append(pt)
        return out

    def commit_coeffs_dev(
        self, coeffs_mont: torch.Tensor, num_chunks: int = 1, blinders=None
    ) -> list[PolyComm]:
        """Commit (8, b, L) Montgomery coefficient rows on the SRS's device.

        Each row is one polynomial; L may exceed the SRS size, giving
        ceil(L/n) chunks (at least num_chunks). blinders: optional per-row
        lists of per-chunk ints; w*H is fused into the MSM as one more
        (h, w) term per chunk row (w = 0 when not hiding)."""
        check_device(coeffs_mont, self.device, "coefficients")
        n = len(self.g)
        b, L = coeffs_mont.shape[1], coeffs_mont.shape[2]
        nchunks = max(-(-L // n), num_chunks)
        std = limb.from_mont(limb.device_field(self.curve.scalar), coeffs_mont)
        pad = nchunks * n - L
        if pad:
            std = torch.cat([std, torch.zeros_like(std[..., :1]).expand(-1, -1, pad)], dim=-1)
        rows = std.reshape(limb.NLIMBS, b * nchunks, n)
        if blinders is None:
            flat = [0] * (b * nchunks)
        else:
            flat = [int(w) % self.curve.scalar.p for row in blinders for w in row]
            if len(flat) != b * nchunks:
                raise ValueError(f"{len(flat)} blinders for {b * nchunks} chunks")
        wb = torch.from_numpy(limb.ints_to_limbs(flat, shape=(b * nchunks, 1))).to(self.device)
        results = self._commit_rows(torch.cat([rows, wb], dim=-1))
        return [PolyComm(results[i * nchunks : (i + 1) * nchunks]) for i in range(b)]


def load_reference_srs(path, curve: CurveParams, limit: int | None = None):
    """Parse a reference `srs/*.srs` file (rmp-serde of [Vec<G>, G] with
    33-byte arkworks compressed points) into host affine points (g, h).

    Flag byte (arkworks SWFlags): 0x40 = infinity, 0x80 = y is the
    lexicographically larger root, 0x00 = the smaller one."""
    data = pathlib.Path(path).read_bytes()
    if data[:2] != b"\x92\xdd":
        raise ValueError(f"{path}: not an rmp [Vec<G>, G] SRS file")
    n = int.from_bytes(data[2:6], "big")
    f = curve.base

    def read_point(off):
        if data[off : off + 2] != b"\xc4\x21":
            raise ValueError(f"{path}: no 33-byte point at offset {off}")
        raw = data[off + 2 : off + 35]
        flag = raw[32]
        if flag & 0x40:
            return None
        x = int.from_bytes(raw[:32], "little")
        y = f.sqrt(curve.curve_eqn(x))
        if y is None:
            raise ValueError(f"{path}: x at offset {off} is not on {curve.name}")
        big, small = max(y, f.p - y), min(y, f.p - y)
        return (x, big) if flag & 0x80 else (x, small)

    count = n if limit is None else min(limit, n)
    g = [read_point(6 + 35 * i) for i in range(count)]
    return g, read_point(6 + 35 * n)  # fixed 35-byte stride per point
