#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's commit, evaluation, opening and
verification path, and a whole Kimchi proof, on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the CUDA kernels of proof_systems_tpu_torch/csrc (nvcc, sm_90a;
     one process a translation unit, all started together, one library)
     and the native host library (MSM, Poseidon); print build times (each
     unit's too) and ptxas's register, stack and spill lines of every
     function (the full ptxas log goes to build/kernels/<hash>/ptxas.log);
  2. print the card; one thread's chain of dependent products on the card
     for field.cuh's CIOS fe_mul and for chain_field.cuh's product, square
     and dot3 (us a step), and the registers and local memory of K10, K4
     and K11 (none may keep a stack); K11's binary-GCD inverse against pow
     on 0, 1, 2, p - 1, p - 2, R, R^2 and 2^255 mod p and random values in
     Fp and Fq, and its latency (us an inverse);
  3. warm-up run of the main path, recording every kernel's largest call
     (K2's, K5's, K7's, K12's and the endo ladder's at every call shape,
     K4's at every shape and exponent length, K9's at every shape and
     length of c), and of the public-input path and the k = 11 bench path
     (phase 4) and of the Lagrange commitments alone, whose calls are
     recorded apart and checked as well where their shape is new (K6, K2,
     K7 and K8 at b = 5 over 2^16, K4 on 5 points, the k = 11 tail);
     then each
     kernel against its plain PyTorch version on those inputs and on edge
     cases (field and transcript kernels, K2, K3, K8 and the ladder exact,
     K6 as group elements, K7 as group elements and exact where one thread
     scans a lane chunk; K6 and K7 also on rows that split each lane chunk
     over a team of threads; K12 and K9 on rows whose lanes a team of
     threads shares, K12 with padded lanes and zeros at a member's first
     position; K5 on rows around a warp, a block and its longest row; K8
     also on its fallback and identity windows; K11 over both scalar
     fields; the ladder on both curves with all-zero and all-one bits and
     a point at infinity), with the kernel's and the plain version's times, K6's
     and K7's team size and tile width, the registers and local memory of
     K6's kernels, K7's combine, K5's, K12's and K9's kernels (which must
     keep no stack), K5's block and chain, K12's and K9's team size and
     chain, K11's binary-GCD steps, K8's
     registers, local memory and chain
     (products, levels, time a product), and the registers and local
     memory of K2, K3 and the ladder, for K10 and K4 the us a dependent
     level of their chains and for K11 the us a binary-GCD step;
  4. the main path at k = 16 on Vesta, with launch counts zeroed just
     before and read just after: SRS.create(2^16), the scaled basis of
     g ++ [h], iNTT of 15 random witness columns, their 15 hiding commits
     and one b = 1 commit; the 16 polynomials evaluated at zeta and
     zeta*omega (eval_at2), opened together (ipa.open_proof: 5 fold steps,
     11 masked rounds at 2048 points) and the opening verified
     (ipa.verify_batch); then the proof path: the bench circuit of
     2^k - 10 Const(1) generic gates through ConstraintSystem.create,
     ProverIndex, verifier_index, create_proof of the packed witness,
     verify and serialize_proof; then the launches of one opening, one
     verification, one proof and one proof's verification, and the
     steady-state stage times (the proof split by the tracer's checkpoints
     in a separate, synchronised proof; the Python garbage collector's
     passes inside the timed proofs); then each kernel's device time
     and launches over one more proof and one more verification (CUDA
     events around every wrapper call, the garbage collector held off),
     and the time of K6, K7, K8, K2, K4 and the endo ladder at each call
     shape; then, each with the counts
     zeroed just before and read just after, the public-input path at
     k = 16 (5 public generic gates in rows 0-4, then Const(1) gates:
     ConstraintSystem.create, ProverIndex, SRS.lagrange_commitments at
     b = 5 into an empty cache directory, from memory and from disk,
     create_proof of a host witness with seeded public values, verify;
     every kernel but K3 must launch: K3 builds the scaled basis, once per
     SRS), and bench_torch's own set-up and proof at
     k = 11, where n = IPA_FOLD_TAIL and the opening has no fold step (the
     endo ladder must not launch, every kernel of the tail rounds must),
     verified, its size 4,949 bytes; then eleven more phases, each with the
     counts zeroed just before and read just after (a proof's must launch
     every kernel but K3, a verification's what one verification does) and
     with each kernel's largest call on it held against the plain version
     (a call shape held before, in any phase, is not held again): a k = 16
     proof of the bench
     circuit carrying 2 recursion challenges of 16 seeded scalars (their
     commitments against the native host MSM; rejected when a challenge
     changes); a chunked proof of 2^17 - 10 Const(1) gates over the same
     2^16 points (2 chunks, zk_rows 5, 14 t chunks; rejected at ft_eval1 + 1;
     its index_s, and prove_ms and peak device memory of one more proof);
     the lookup circuit at k = 16 (32,768 Lookup rows of three lookups into
     the table (x, x^2) of 4,096 entries, then Const(1) gates) with a fixed
     and with a runtime table, the host time of the lookup argument's
     stages apart (rejected with a changed sorted evaluation; a value not
     in the table, or a runtime table under another id, raises ValueError);
     the committed proofs of the gadget circuits (tests/vectors/
     proof_gates_2^5.bin: one each of the Poseidon, CompleteAdd, VarBaseMul,
     EndoMul and EndoMulScalar gadgets and a ForeignFieldAdd chain;
     proof_optional_2^13.bin and vk_optional_2^13.bin: a multi-range-check,
     Xor, Rot64, ForeignFieldAdd, ForeignFieldMul, And and Not over both
     fixed tables), each proved by the port byte for byte as the JAX
     package did on the CPU, verified and rejected with a changed selector
     evaluation; the gate mix of foreign-field ECDSA and Keccak gadgets at
     k = 16 (gate_mix.gate_mix_circuit: 1,771 blocks of a ForeignFieldMul
     with its multi-range-checks, a ForeignFieldAdd chain, Xor, Rot64, And
     and Not), its index_s, the host time of the lookup argument's stages
     apart, rejected with a changed ForeignFieldMul selector evaluation,
     and one more proof's prove_ms, peak device memory and quotient split
     (d8 transforms, walk); o1vm's column prover at k = 16 (a cyclic trace
     with a boundary row, a LogUp instance of 131,072 lookups into a 2^16
     range table, a MultiLogUp over the 4-bit bitwise table with the joint
     combiner: each verified, rejected with a changed zeta evaluation, its
     phase-1 commitments against the native host MSM, prove_col_ms with the
     host's phi and h stages apart, verify_col_ms, peak memory, launches;
     every kernel but K3 and K9 must launch; `--only column` runs this
     phase alone); o1vm's Keccak-f proof of tests/test_keccak.py's
     statement (n = 32, 4,225 columns), field by field the JAX package's
     proof tests/vectors/column_keccak_2^5, verified, rejected with a
     changed final and a changed initial state, prove_keccak_ms and
     verify_keccak_ms with the host sponge's absorptions apart (`--only
     keccak`); o1vm's RV32IM proofs: tests/test_riscv.py's program at
     n = 256, field by field tests/vectors/column_riscv_2^8, verified,
     rejected with regs[3] = 14, then rv_loop_program (every instruction, a
     loop of n / 2 steps) at Layout(4) over 2^12 rows (2^14 alone), where
     every kernel but K3 and K9 must launch, verified, rejected with a
     changed final register, prove_rv_ms with the host's execute,
     build_columns, phase1_columns and phase2_host apart (`--only riscv`;
     with it, `--log-n` sets that domain); o1vm's MIPS proofs:
     tests/test_mips.py's program at n = 256, field by field
     tests/vectors/column_mips_2^8, verified, rejected with regs[5] = 43 and
     with init_memory[32] = 9; the Cannon snapshot of
     tests/vectors/column_mips_cannon_2^9 run by the port's CannonVM, proved
     at n = 512 field by field equal to the vector with the VM's final
     registers, verified, rejected with the preimage's last byte changed;
     then mips_loop_program (every op and syscall kind, a loop of n / 2
     steps ending in exit_group) at Layout(4) over 2^12 rows (2^14 alone),
     where every kernel but K3 and K9 must launch, verified, rejected with a
     changed final register, prove_mips_ms with the same host stages apart
     (`--only mips`; with it, `--log-n` sets that domain); the
     foreign-field MSM circuit: tests/test_msm_circuit.py's statement at
     n = 256 field by field tests/vectors/column_msm_2^8, then Layout()
     (16-bit limbs, 256-bit elements, 519 committed columns) over secp256k1
     at n = 2^16 with 16 seeded points and scalars, its result the host's
     double-and-add sum, verified, rejected with a changed result and
     changed scalars, every kernel but K3 and K9 launched, prove_msm_ms
     with build_columns, phase1_columns and phase2_host apart, verify_msm_ms
     and a peak under 80 GiB (`--only msm [--points K]`); arrabbiata
     folding: tests/test_ivc.py's statement (n = 256, two steps, decide),
     both decider proofs (Vesta / Fp, Pallas / Fq) field by field
     tests/vectors/column_ivc_*_2^8, then six IVC steps over both curves
     (two folds a side) and the decider, each side's proof rejected with a
     changed evaluation, the steps', folds' and each side's decision's
     times, then folding/cli.py's `execute --zkapp square -n 4
     --srs-size 8` (every kernel but K3, K9 and the endo ladder launched:
     at n = 256 the opening has no fold step; `--only folding`);
     one batch_verify over the bench, public-input, recursion, lookup and
     chunked proofs beside the five single verifications (rejected when one
     has ft_eval1 + 1); and the bench, lookup, chunked and gate-mix
     verifier indexes through to_file into build/vk/ and from_file (equal
     digests, each verifies its proof);
  5. every commitment against the native host MSM over g ++ [h], the iNTT
     against the CPU plain path, one b = 1 MSM at c = 10; the evaluations
     against host Horner; every round's L and R, sg, a0 and b0 against the
     host's masked-scalar rounds over the original basis (native MSM); the
     verifier's rejection of z1 + 1 and of a changed evaluation; the
     proof's 15 witness, z and 7 t commitments against the native host
     MSM, its zero quotient remainder, its 5,306 bytes at k = 16, the
     verifier's rejection of ft_eval1 + 1 and of a changed witness
     evaluation, and the fixed 2^5 circuit's proof on the card
     byte-identical to tests/vectors/proof_2^5.bin; the public-input
     proof's rejection with a public value + 1, the prover's public
     commitment equal to the verifier's masked -sum p_i L_i, and the 5
     Lagrange commitments equal to the native host MSM over g;
  6. the seconds of each part (the build, the plain checks, each phase and
     its plain checks apart), the kernels' JSON line, the card line, and the
     result line.

The plain checks compute the plain versions of calls that share a batch key
(K4's exponent, the ladder's and K11's curve, K8's c and windows, a row
scan's length) in one plain call and split the outputs back
(plain_outputs): each kernel call is still held against the plain version
on its own inputs.

Exits non-zero without a CUDA device. Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import concurrent.futures
import gc
import json
import random
import re
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
LOG_N = 16
GOLDEN_PROOF = "tests/vectors/proof_2^5.bin"  # the fixed 2^5 circuit's proof
COLUMNS = 15  # kimchi witness columns
BW = 3.35e12  # H100 SXM HBM3, bytes/s (data sheet)
# 32-bit integer multiply-adds: 64 per SM per clock on sm_90 (half the 128
# float32 lanes that give the data sheet's 67 TFLOP/s at 1.98 GHz), 132 SMs.
IMAD_RATE = 64 * 132 * 1.98e9
# A CIOS Montgomery product of 8x32-bit limbs: 64 + 64 wide multiply-adds
# and 8 for the reduction factors. Products per curve operation:
IMADS_PER_PRODUCT = 136
PRODUCTS = {"add": 16, "madd": 11, "dbl": 7}
# chain_field.cuh's product for the Pasta moduli (K4, K10, K11): 32-bit
# multiply-adds of the partial products and of the 8 reduction steps (3
# each: m times words 1-3 of p)
LAT_IMADS = {"mul": 64 + 24, "sqr": 36 + 24, "dot3": 3 * 64 + 24}
# The endo ladder a point: phi(x), the first add and doubling, 64 steps of a
# doubling and an add
LADDER_PRODUCTS = 1 + PRODUCTS["add"] + PRODUCTS["dbl"] + 64 * (PRODUCTS["dbl"] + PRODUCTS["add"])
# K11's inverse (csrc/inv_field.cuh): batches of binary-GCD steps on 64-bit
# approximations, and 32-bit integer operations: a step's test, compare,
# subtractions, selects and shifts (16), a batch's update of a and b (2 x 8
# words x 2 multiply-adds) and of u and v mod p (2 x 8 x 3)
INV_BATCHES, INV_STEPS = 17, 30
INV_OPS = INV_BATCHES * (INV_STEPS * 16 + 2 * 8 * 2 + 2 * 8 * 3)

CSRC = "proof_systems_tpu_torch/csrc/"
PALLAS = "proof_systems_tpu/ops/pallas_field.py"
# kernel -> (CUDA source, the TPU code it replaces)
SOURCES = {
    "mont_mul": (CSRC + "field_kernels.cu", f"{PALLAS}:398"),
    "jacobian_add": (CSRC + "curve_kernels.cu", f"{PALLAS}:412"),
    "jacobian_double": (CSRC + "curve_kernels.cu", f"{PALLAS}:439"),
    "mont_pow": (CSRC + "field_kernels.cu", f"{PALLAS}:481"),
    "mont_prefix_scan": (CSRC + "scan_kernels.cu", f"{PALLAS}:1019"),
    "ec_prefix_scan_parts": (CSRC + "ec_scan_kernels.cu", f"{PALLAS}:1333"),
    "ec_prefix_scan_fused": (CSRC + "ec_scan_kernels.cu", f"{PALLAS}:1410"),
    "combine_windows": (CSRC + "k8_kernels.cu", f"{PALLAS}:560"),
    "linear_scan": (CSRC + "scan_kernels.cu", f"{PALLAS}:1069"),
    "sponge_squeeze2": (CSRC + "transcript_kernels.cu", f"{PALLAS}:646"),
    "endo_inv": (CSRC + "transcript_kernels.cu", f"{PALLAS}:742"),
    "mont_prefix_scan_parts": (CSRC + "scan_kernels.cu", f"{PALLAS}:956"),
    # the fori_loop of K2 (pallas_field.py:412) and K3 (:439)
    "endo_ladder": (CSRC + "ladder_kernels.cu", "proof_systems_tpu/poly_commitment/ipa.py:566"),
}
# The call of a kernel reported in the JSON line where the main path makes
# two kinds (the others are printed): K6's mixed bucket scan.
JSON_KEY = {"ec_prefix_scan_parts": "ec_prefix_scan_parts[mixed]"}
# Kernels recorded and checked at every call shape (K4 at every shape and
# exponent length, K9 at every shape and length of c); the JSON line
# reports the largest call.
BY_SHAPE = ("jacobian_add", "ec_prefix_scan_fused", "endo_ladder", "mont_pow",
            "mont_prefix_scan", "mont_prefix_scan_parts", "linear_scan")


T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's header ("== ...") also gets the seconds since
    the script started."""
    if msg.startswith("=="):
        msg += f" (t = {time.perf_counter() - T0:.1f} s)"
    print(msg, flush=True)


# Seconds of each part of the script's wall time, printed as it ends and
# together at the end (`part`).
PARTS: dict[str, float] = {}


def part(name: str, secs: float) -> None:
    PARTS[name] = PARTS.get(name, 0.0) + secs
    log(f"part {name}: {secs:.1f} s")


def part_since(name: str, mark: float) -> float:
    """part(name) of the seconds since `mark`; returns the new mark."""
    now = time.perf_counter()
    part(name, now - mark)
    return now


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def elapsed_ms(fn, device, reps: int = 1) -> float:
    """Mean time of `reps` calls: CUDA events on the card."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    sync(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall(fn, device):
    """(result, seconds) of fn on the host clock, ending in a synchronize."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Recording the main path's kernel calls
# ---------------------------------------------------------------------------


def shape_of(t: torch.Tensor) -> str:
    """A limb tensor's batch shape, as 24x15x4096."""
    return "x".join(str(d) for d in t.shape[1:])


def kernel_of(key: str) -> str:
    """The wrapper name of a Recorder key (name[variant...]@field[tag])."""
    return key.split("[")[0].split("@")[0]


class Recorder:
    """Wraps the kernel wrappers in ops.kernels and keeps, per kernel and
    field (and per K6 variant, each b = 1 window size of K8, and each call
    shape of K2, K7 and the endo ladder apart), a copy of the inputs of its
    largest call."""

    def __init__(self, kernels) -> None:
        self.kernels = kernels
        self.calls: dict[str, tuple] = {}
        self.saved = {}

    def __enter__(self):
        for name, fn in self.kernels.WRAPPERS.items():
            self.saved[name] = fn
            setattr(self.kernels, name, self._spy(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.kernels, name, fn)

    def _spy(self, name, fn):
        def wrapper(*args, **kw):
            key = name + ("[mixed]" if kw.get("mixed") else "")
            if name == "combine_windows" and args[2].shape[2] == 1:
                key += f"[b=1,c={args[1]}]"  # single chains: sg, the verifier
            if name == "mont_pow":
                key = k4_label(*args)
            elif name == "linear_scan":
                key = k9_label(*args)
            elif name in BY_SHAPE:
                key += f"[{shape_of(next(a for a in args if torch.is_tensor(a)))}]"
            key += "@" + args[0].params.name  # a call over Fp and one over Fq are two
            size = sum(a.numel() for a in args if torch.is_tensor(a))
            if size > self.calls.get(key, (0,))[0]:
                copy = [a.clone() if torch.is_tensor(a) else a for a in args]
                self.calls[key] = (size, copy, dict(kw))
            return fn(*args, **kw)

        return wrapper


class Clock:
    """Wraps functions with CUDA events, so that a stage splits into the
    device time of each wrapped function (summed per label over its calls)
    and the rest. targets: (owner, attribute, label) triples; the owner is a
    module or an object whose attribute the code under test looks up at
    call time; a label is a string or a function of the call's arguments
    that returns one. An interval runs from the start event to the end
    event on the stream, so it also holds any wait for the host inside the
    wrapped function."""

    def __init__(self, targets) -> None:
        self.targets = targets
        self.events: list[tuple[str, torch.cuda.Event, torch.cuda.Event]] = []

    def __enter__(self):
        self.saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in self.targets]
        for (owner, attr, label), (_, _, fn) in zip(self.targets, self.saved):
            setattr(owner, attr, self._timed(label, fn))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self.saved:
            setattr(owner, attr, fn)

    def _timed(self, label, fn):
        def wrapper(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.events.append((label(*args, **kw) if callable(label) else label, start, end))
            return out

        return wrapper

    def totals(self) -> dict[str, float]:
        torch.cuda.synchronize()
        out = dict.fromkeys((label for _, _, label in self.targets if isinstance(label, str)), 0.0)
        for label, start, end in self.events:
            out[label] = out.get(label, 0.0) + start.elapsed_time(end)
        return out

    def calls(self) -> dict[str, int]:
        return dict(collections.Counter(label for label, _, _ in self.events))


class GcPauses:
    """The Python garbage collector's passes while entered, as (generation,
    seconds) each: host time that a CUDA-event interval open at that moment
    would count as its kernel's."""

    def __enter__(self):
        self.passes: list[tuple[int, float]] = []
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)

    def _callback(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.passes.append((info["generation"], time.perf_counter() - self._t0))

    def summary(self) -> str:
        full = [s for g, s in self.passes if g == 2]
        longest = max((s for _, s in self.passes), default=0.0)
        return (f"{len(self.passes)} passes, {sum(s for _, s in self.passes) * 1e3:.1f} ms "
                f"(generation 2: {len(full)}, {sum(full) * 1e3:.1f} ms); longest "
                f"{longest * 1e3:.1f} ms")


def k6_label(F, x, y, z, mixed=False) -> str:
    """A K6 call's label: its variant and shape."""
    return f"ec_prefix_scan_parts[{'mixed' if mixed else 'general'} {shape_of(x)}]"


def k2_label(F, px, *_) -> str:
    """A K2 call's label: its shape."""
    return f"jacobian_add[{shape_of(px)}]"


def k7_label(F, x, *_) -> str:
    """A K7 call's label: its shape."""
    return f"ec_prefix_scan_fused[{shape_of(x)}]"


def ladder_label(F, endo_q, x, *_) -> str:
    """An endo ladder call's label: its points."""
    return f"endo_ladder[{shape_of(x)}]"


def k4_label(F, a, e) -> str:
    """A K4 call's label: its shape and the exponent's length."""
    return f"mont_pow[{shape_of(a)} e {e.bit_length()} bits]"


def k5_label(F, x) -> str:
    """A K5 call's label: its shape."""
    return f"mont_prefix_scan[{shape_of(x)}]"


def k12_label(F, x) -> str:
    """A K12 call's label: its shape."""
    return f"mont_prefix_scan_parts[{shape_of(x)}]"


def k9_label(F, x, c) -> str:
    """A K9 call's label: its shape and the length of c (the prover's
    boundary divisions: c = 1 and omega^(n - zk))."""
    return f"linear_scan[{shape_of(x)} c {c.bit_length()} bits]"


def k8_label(F, c, wx, wy, wz) -> str:
    """A K8 call's label: its windows, columns and window size."""
    return f"combine_windows[{wx.shape[1]}x{wx.shape[2]} c={c}]"


# kernels whose time kernel_times also splits by call shape: short name, label
SHAPE_LABELS = {"ec_prefix_scan_parts": ("K6", k6_label), "combine_windows": ("K8", k8_label),
                "jacobian_add": ("K2", k2_label), "endo_ladder": ("ladder", ladder_label),
                "ec_prefix_scan_fused": ("K7", k7_label), "mont_pow": ("K4", k4_label),
                "mont_prefix_scan": ("K5", k5_label), "mont_prefix_scan_parts": ("K12", k12_label),
                "linear_scan": ("K9", k9_label)}


def kernel_times(result, device) -> None:
    """Each kernel's device time and launches over one proof and over one
    verification of it, largest first, and the time of K6, K7, K8, K2, K4,
    K5, K12, K9 and the endo ladder at each call shape. The garbage
    collector runs before each and not during it: a pass inside a wrapper
    call would count its host time as that kernel's (proof_times logs the
    passes of the timed proofs)."""
    from proof_systems_tpu_torch.ops import kernels

    targets = [(kernels, name, SHAPE_LABELS[name][1] if name in SHAPE_LABELS else name)
               for name in kernels.WRAPPERS]
    for label, fn in (("proof", lambda: prove(result)),
                      ("proof verification", lambda: verify_proof(result, result["kproof"]))):
        sync(device)
        kernels.reset_launch_counts()
        gc.collect()
        gc.disable()
        try:
            with Clock(targets) as clock:
                fn()
        finally:
            gc.enable()
        counts = kernels.launch_counts()
        ms, calls = clock.totals(), clock.calls()
        per_kernel = {name: [sum(v for k, v in d.items() if k.split("[")[0] == name)
                             for d in (ms, calls)] for name in kernels.WRAPPERS}
        log(f"kernel time over one {label}: {sum(ms.values()):.3f} ms in all")
        for name, (t, n) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0]):
            log(f"  {label} kernel {name:24s} {t:10.3f} ms  launches {counts[name]:5d}  "
                f"calls timed {n:5d}")
        for key in sorted((k for k in ms if "[" in k), key=lambda k: -ms[k]):
            name, shape = key[:-1].split("[")
            log(f"  {label} {SHAPE_LABELS[name][0]} {shape:22s} {calls[key]:3d} calls  "
                f"{ms[key]:10.3f} ms  {ms[key] / calls[key]:.4f} ms a call")


# ---------------------------------------------------------------------------
# Comparisons
# ---------------------------------------------------------------------------


def u32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int64) & 0xFFFFFFFF


def field_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest limb difference between two canonical field tensors."""
    return int((u32(a) - u32(b)).abs().max()) if a.numel() else 0


def point_err(F, p, q) -> int:
    """0 iff the Jacobian tuples p, q are the same group elements: the
    infinity flags agree and X1*Z2^2 = X2*Z1^2, Y1*Z2^3 = Y2*Z1^3 (the
    products through K1, checked exactly against its plain version first)."""
    from proof_systems_tpu_torch.ops import limb

    pinf, qinf = limb.is_zero(F, p[2]), limb.is_zero(F, q[2])
    if not torch.equal(pinf, qinf):
        return 1 << 32
    z1z1, z2z2 = limb.mont_sqr(F, p[2]), limb.mont_sqr(F, q[2])
    ex = (u32(limb.mont_mul(F, p[0], z2z2)) - u32(limb.mont_mul(F, q[0], z1z1))).abs()
    ey = (
        u32(limb.mont_mul(F, p[1], limb.mont_mul(F, z2z2, q[2])))
        - u32(limb.mont_mul(F, q[1], limb.mont_mul(F, z1z1, p[2])))
    ).abs()
    live = ~pinf[None]
    return int(torch.where(live, torch.maximum(ex, ey), 0).max()) if ex.numel() else 0


def outputs_err(name: str, F, got, want) -> int:
    if name in ("mont_mul", "mont_pow", "mont_prefix_scan", "linear_scan"):
        return field_err(got, want)
    if name == "mont_prefix_scan_parts":
        (gp, ge, gc), (wp, we, wc) = got, want
        return max(field_err(gp, wp), field_err(ge, we)) if gc == wc else 1 << 32
    if name in ("combine_windows", "sponge_squeeze2", "endo_inv", "jacobian_add",
                "jacobian_double", "endo_ladder"):  # limb for limb
        return max(field_err(a, b) for a, b in zip(got, want))
    if name == "ec_prefix_scan_parts":
        (gp, ge, gc), (wp, we, wc) = got, want
        if gc != wc:
            return 1 << 32
        return max(point_err(F, gp, wp), point_err(F, ge, we))
    # ec_prefix_scan_fused: limb for limb where one thread scans a lane chunk
    err = point_err(F, got, want)
    if scan_team(got[0])[0] == 1:
        err = max(err, *(field_err(a, b) for a, b in zip(got, want)))
    return err


def pow_digit_count(e: int) -> int:
    return (e.bit_length() + 3) // 4


def pow_imads(e: int) -> int:
    """Multiply-adds of one a^e (csrc/chain_field.cuh fe_pow_lat): the
    table's 7 squares and 7 products, then 4 squares and a product for each
    digit after the first."""
    steps = max(pow_digit_count(e) - 1, 0)
    return 7 * (LAT_IMADS["sqr"] + LAT_IMADS["mul"]) + steps * (4 * LAT_IMADS["sqr"]
                                                                + LAT_IMADS["mul"])


def pow_levels(e: int) -> tuple[int, int]:
    """(products, dependent levels) of one a^e: the table's 14 products, of
    which the first digit's entry waits for its depth in the tree, then 5
    levels a digit after the first."""
    nd = pow_digit_count(e)
    if nd == 0:
        return 14, 0
    return 14 + 5 * (nd - 1), pow_tab_depth(e >> (4 * (nd - 1))) + 5 * (nd - 1)


def pow_tab_depth(k: int) -> int:
    """Depth of table entry k >= 2: tab[2j] = tab[j]^2, tab[2j+1] = tab[2j] a."""
    if k < 2:
        return 0
    return pow_tab_depth(k // 2) + 1 + (k & 1)


def bound_ms(name: str, args, kw) -> tuple[float, str]:
    """Least time for the call's work on an H100 SXM: bytes moved (inputs
    once, outputs once) over HBM bandwidth, or 32-bit multiply-adds over
    the integer rate, whichever is larger."""
    t = [a for a in args if torch.is_tensor(a)]
    elems = t[0][0].numel()
    fe = 32  # bytes per field element
    # the work of the function, not of a design: a full scan (the parallel
    # one: reduce, then offsets) 2 operations a position; phases 1-2 one a
    # position, and an exclusive scan of a row's 128 lane totals, 126 at
    # least (no Hillis-Steele levels)
    lane_scan = 128 - 2
    if name == "combine_windows":  # W windows x b columns in, b out; W - 1 Horner steps
        c, (W, b) = args[1], t[0].shape[1:]
        nbytes = 3 * fe * (W * b + b)
        products = b * k8_chain(W, c)[0]
    elif name == "sponge_squeeze2":  # 2 permutations of 3 x (x^7, a row of the MDS)
        nbytes = fe * sum(a[0].numel() for a in t) + fe * 4
        imads = 2 * args[1] * 3 * (2 * LAT_IMADS["sqr"] + 2 * LAT_IMADS["mul"]
                                   + LAT_IMADS["dot3"]) + LAT_IMADS["mul"]
        products = imads / IMADS_PER_PRODUCT
    elif name == "endo_inv":  # u = REDC(a endo R^2 + b R^2), the inverse, one product
        nbytes = 4 * 128 + 2 * fe
        products = (2 * 64 + 24 + LAT_IMADS["mul"] + INV_OPS) / IMADS_PER_PRODUCT
    elif name == "mont_mul":
        nbytes, products = 3 * fe * elems, elems
    elif name == "mont_pow":
        nbytes, products = 2 * fe * elems, elems * pow_imads(args[2]) / IMADS_PER_PRODUCT
    elif name == "mont_prefix_scan":  # a full scan, on chain_field.cuh's product
        nbytes, products = 2 * fe * elems, 2 * elems * LAT_IMADS["mul"] / IMADS_PER_PRODUCT
    elif name == "mont_prefix_scan_parts":  # partial and excl out
        from proof_systems_tpu_torch.ops.kernels import scan_geometry

        n = t[0].shape[-1]
        rows = elems // n
        nbytes = fe * (elems + rows * 128 * scan_geometry(n)[2] + rows * 128)
        products = elems + lane_scan * rows
    elif name == "linear_scan":  # a full scan of s_j = x_j + c * s_(j-1)
        nbytes = 2 * fe * elems
        products = 2 * elems
    elif name == "jacobian_add":
        nbytes, products = 9 * fe * elems, PRODUCTS["add"] * elems
    elif name == "jacobian_double":
        nbytes, products = 6 * fe * elems, PRODUCTS["dbl"] * elems
    elif name == "endo_ladder":  # the points in and out, the 128 bits
        nbytes, products = 6 * fe * elems + 4 * 128, LADDER_PRODUCTS * elems
    elif name == "ec_prefix_scan_parts":
        n = t[0].shape[-1]
        rows = elems // n
        npad = 128 * (-(-n // 128))
        step = PRODUCTS["madd"] if kw.get("mixed") else PRODUCTS["add"]
        nbytes = 3 * fe * (elems + rows * npad + rows * 128)
        products = step * elems + PRODUCTS["add"] * lane_scan * rows
    else:  # ec_prefix_scan_fused: a full scan
        nbytes = 6 * fe * elems
        products = 2 * PRODUCTS["add"] * elems
    t_bytes = nbytes / BW
    t_ops = products * IMADS_PER_PRODUCT / IMAD_RATE
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# K6 edge rows (rows, n): n = 1; n < 128 (cp = 1); 8,321 (cp = 66, a team
# of 8 threads a chunk, 9 positions each); b = 1 with 24 rows of 65,537 (a
# team of 16, 33 positions each). The row of 300 (cp = 3) is above.
K6_EDGE_SHAPES = [(2, 1), (2, 100), (2, 8321), (24, 65537)]


def k6_rows(dc, pts, rows: int, n: int, mixed: bool, device):
    """(8, rows, n) K6 input gathered on the card from the host points
    `pts` (pts[0] = P, finite): lane 3 only P, P at positions 3 and 4 of its
    chunk, lane 5 only P, -P there, lane 6 only P, P at 1 and 2 (each pair
    across a sub-chunk boundary: the doubling and negation fallbacks), lane
    7 all identities (a whole team), identities at 3 and 4 of lane 9, the
    other positions random points of `pts`; doubled (z != R) for the
    general variant."""
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.ops.kernels import scan_chunk

    table = [None, pts[0], Vesta.neg(pts[0])] + [p for p in pts[5:] if p is not None][:61]
    cp = scan_chunk(n)
    gen = torch.Generator().manual_seed(SEED + rows * n)
    idx = torch.randint(3, len(table), (rows, n), generator=gen)
    for lane, pairs in [(3, [(3, 1), (4, 1)]), (5, [(3, 1), (4, 2)]), (6, [(1, 1), (2, 1)]),
                        (7, [])]:
        idx[:, lane * cp:lane * cp + cp] = 0
        for j, k in pairs:
            if j < cp and lane * cp + j < n:
                idx[:, lane * cp + j] = k
    for j in (3, 4):
        if j < cp:
            idx[:, 9 * cp + j:9 * cp + j + 1] = 0
    J = dc.to_jacobian(dc.pack_affine(table, device=device))
    if not mixed:
        J = dc.double(J)
    flat = idx.reshape(-1).to(device)
    return [t[:, flat].reshape(8, rows, n).contiguous() for t in J]


# K8 edge rows (W, b, c), on the columns of k8_windows: W = 1, c = 1, b = 33
# and b = 130 (more than one block of columns)
K8_EDGE_SHAPES = [(4, 5, 3), (1, 4, 4), (3, 5, 1), (3, 33, 2), (2, 130, 2)]


def k8_windows(curve, dc, rng, W: int, b: int, c: int, device):
    """(8, W, b) general Jacobian window sums (z != R) from random points of
    `curve`: column 0 all identities; where W >= 2, in column 1 window W - 2
    is 2^c times window W - 1, so the first add meets the accumulator itself
    (the doubling fallback), and in column 2 its negation (the infinity
    fallback); where W >= 3, in column 3 window W - 3 is 2^c times the
    accumulator after window W - 2 (the doubling fallback mid-chain);
    identities scattered over the other columns."""
    def times2c(pt):
        for _ in range(c):
            pt = curve.double(pt)
        return pt

    pool = [curve.scalar_mul(rng.randrange(1, curve.scalar.p), curve.generator) for _ in range(32)]
    host = [[rng.choice(pool) for _ in range(b)] for _ in range(W)]  # host[w][col]
    for w in range(W):
        host[w][0] = None
        for col in range(4, b):
            if (w + col) % 5 == 3:
                host[w][col] = None
    if W >= 2 and b >= 3:
        host[W - 2][1] = times2c(host[W - 1][1])
        host[W - 2][2] = curve.neg(times2c(host[W - 1][2]))
    if W >= 3 and b >= 4:
        host[W - 3][3] = times2c(curve.add(times2c(host[W - 1][3]), host[W - 2][3]))
    J = dc.double(dc.to_jacobian(dc.pack_affine([pt for row in host for pt in row], device=device)))
    return [t.reshape(8, W, b).contiguous() for t in J]


def edge_cases(device, curve_params):
    """Small inputs with the special values: 0, 1, p-1, 2^254-1 for the
    field kernels, and K4 on one element 0, 1 or p - 1 with e = p - 2, 21
    (an alpha exponent of the permutation) and 0; two rows of 300 for K9
    with c = 0, 1 (a prefix sum), random and omega^(n - 3), and n = 1; two
    rows of 8,321 (C = 66, Cp = 70) with a zero element for K12; K12's and
    K9's edge rows (k12_k9_edge_cases); P+P, P+(-P), infinity on either
    side for the curve kernels; identities inside a scan row of length 300;
    K6's team geometry on the rows of k6_rows, both variants, and K7 on
    the general ones; an infinity window partial for K8, and its edge rows
    (k8_windows: identity columns, the doubling and infinity fallbacks, W =
    1, c = 1, b = 33 and 130); L at infinity, (0, 0), for K10; all-zero and
    all-one challenge bits for K11 (and four random ones, over both scalar
    fields) and the endo ladder, which also meets a point at infinity, on
    both curves; K5 on two rows of each K5_EDGE_ROWS length in Fp and Fq."""
    from proof_systems_tpu_torch.fields import Fp, Fq
    from proof_systems_tpu_torch.ops import limb
    from proof_systems_tpu_torch.ops.curve_ops import device_curve

    rng = random.Random(SEED + 1)
    cases = []
    for fld in (Fp, Fq):
        F = limb.device_field(fld)
        edge = [0, 1, fld.p - 1, (1 << 254) - 1]
        xs = edge + [rng.randrange(fld.p) for _ in range(60)]
        ys = edge[::-1] + [rng.randrange(fld.p) for _ in range(60)]
        a = F.pack_mont(xs, device=device)
        b = F.pack_mont(ys, device=device)
        cases += [
            ("mont_mul", [F, a, b], {}),
            ("mont_pow", [F, a, fld.p - 2], {}),
            ("mont_pow", [F, a, 5], {}),
            ("mont_prefix_scan", [F, a.reshape(8, 2, 32).contiguous()], {}),
        ]
        cases += [("mont_prefix_scan", [F, F.pack_mont([rng.randrange(fld.p) for _ in range(2 * n)],
                                                     shape=(2, n), device=device)], {})
                  for n in K5_EDGE_ROWS]
        # K4 on one element, as a proof calls it: 0 (-> 0 but for e = 0), 1, p - 1
        cases += [("mont_pow", [F, F.pack_mont([v], device=device), e], {})
                  for v in (0, 1, fld.p - 1) for e in (fld.p - 2, 21, 0)]

    F = limb.device_field(Fp)

    def two_rows(n, zero_at=None):
        xs = [rng.randrange(Fp.p) for _ in range(2 * n)]
        if zero_at is not None:
            xs[zero_at] = 0
        return F.pack_mont(xs, shape=(2, n), device=device)

    r300 = two_rows(300)
    omega = Fp.root_of_unity(LOG_N)
    cases += [("linear_scan", [F, r300, c], {})
              for c in (0, 1, rng.randrange(Fp.p), pow(omega, (1 << LOG_N) - 3, Fp.p))]
    cases += [
        ("linear_scan", [F, two_rows(1), 5], {}),
        ("mont_prefix_scan_parts", [F, two_rows(8321, zero_at=8321 + 40)], {}),
    ]
    cases += k12_k9_edge_cases(F, rng, device)
    dc = device_curve(curve_params)
    g = curve_params.generator
    pts = [curve_params.scalar_mul(rng.randrange(1, curve_params.scalar.p), g) for _ in range(300)]
    qs = [curve_params.scalar_mul(rng.randrange(1, curve_params.scalar.p), g) for _ in range(300)]
    qs[0] = pts[0]
    qs[1] = curve_params.neg(pts[1])
    pts[2] = qs[3] = None
    pts[4] = qs[4] = None
    pts[150] = pts[151] = None
    P = dc.to_jacobian(dc.pack_affine(pts, device=device))
    Q = dc.to_jacobian(dc.pack_affine(qs, device=device))
    row = [t.reshape(8, 1, 300).contiguous() for t in P]
    cases += [
        ("jacobian_add", [dc.F, *P, *Q], {}),
        ("jacobian_double", [dc.F, *P], {}),
        ("ec_prefix_scan_parts", [dc.F, *row], {"mixed": True}),
        ("ec_prefix_scan_parts", [dc.F, *row], {"mixed": False}),
        ("ec_prefix_scan_fused", [dc.F, *row], {}),
    ]
    cases += [("ec_prefix_scan_parts", [dc.F, *k6_rows(dc, pts, rows, n, mixed, device)],
               {"mixed": mixed})
              for rows, n in K6_EDGE_SHAPES for mixed in (True, False)]
    cases += [("ec_prefix_scan_fused", [dc.F, *k6_rows(dc, pts, rows, n, False, device)], {})
              for rows, n in K6_EDGE_SHAPES]
    want_add = [curve_params.add(p, q) for p, q in zip(pts, qs)]

    from proof_systems_tpu_torch.poseidon import fq_kimchi
    from proof_systems_tpu_torch.ops import kernels

    wins = [t[:, :48].reshape(8, 24, 2).contiguous() for t in dc.double(P)]  # pts[2] is infinity
    Fb = limb.device_field(fq_kimchi.field)
    state = Fb.pack_mont([rng.randrange(Fb.p) for _ in range(3)], device=device)
    xs = Fb.pack_mont([0, qs[5][0]], device=device)
    ys = Fb.pack_mont([0, qs[5][1]], device=device)
    from proof_systems_tpu_torch.curves import Pallas
    cases += [
        ("combine_windows", [dc.F, 11, *wins], {}),
        ("combine_windows", [dc.F, 2, *(w[:, :3].contiguous() for w in wins)], {}),
    ] + [
        ("combine_windows", [dc.F, c, *k8_windows(curve_params, dc, rng, W, b, c, device)], {})
        for W, b, c in K8_EDGE_SHAPES
    ] + [
        ("sponge_squeeze2", [Fb, fq_kimchi.rounds_full, state, xs, ys,
                             kernels.sponge_consts(fq_kimchi, device)], {}),
    ] + [
        ("endo_inv", [limb.device_field(c.scalar), c.endos[1],
                      torch.tensor(bits, dtype=torch.int32, device=device)], {})
        for c in (curve_params, Pallas)
        for bits in ([0] * 128, [1] * 128, *([rng.randrange(2) for _ in range(128)]
                                           for _ in range(4)))
    ]
    cases += ladder_edge_cases(rng, device)
    return cases, (dc, P, Q, want_add)


# K5 edge rows, two each: around a warp, a block of 128, the rule's blocks
# of 256 and 512 threads, and the longest row (n = 1, 2 and 2,048-8,192
# are main-path shapes, checked there too)
K5_EDGE_ROWS = [1, 2, 3, 31, 32, 33, 127, 128, 129, 2047, 2048, 8191, 8192]
# K12 edge rows (rows, n) with the wrapper's team of 32: the smallest K12
# row (C = Cp = 65: 3 positions a member, the 22nd 2, the last ten none),
# 65,537 (Cp = 528 > C = 513, padded lanes: 17 a member, the last 1) on one
# row and three
K12_EDGE_SHAPES = [(1, 8193), (1, 65537), (3, 65537)]
# K9 edge rows (rows, n): n < 128 (one thread a lane), one past 128, 8,321
# (cp = 66: 3 positions a member, the last ten none) and 65,537 (cp = 513:
# 17 a member, the 31st 3, the last none)
K9_EDGE_SHAPES = [(2, 127), (3, 129), (1, 8321), (1, 65537)]


def k12_k9_edge_cases(F, rng, device) -> list:
    """K12 on K12_EDGE_SHAPES with a zero at a team member's first position
    and at a lane's first (in the last row); K9 on K9_EDGE_SHAPES with c =
    0, 1, p - 1, random and omega^(n - 3) (at 65,537 the last two)."""
    p = F.p
    cases = []
    for rows, n in K12_EDGE_SHAPES:
        team, cp = field_scan_shape("mont_prefix_scan_parts", rows, n, device)
        sc = -(-cp // team)
        xs = [rng.randrange(p) for _ in range(rows * n)]
        base = (rows - 1) * n
        xs[base + 5 * cp + min(team - 1, (cp - 1) // sc) * sc] = 0
        xs[base + 9 * cp] = 0
        cases.append(("mont_prefix_scan_parts", [F, F.pack_mont(xs, shape=(rows, n),
                                                                 device=device)], {}))
    omega = F.params.root_of_unity(LOG_N)
    for rows, n in K9_EDGE_SHAPES:
        x = F.pack_mont([rng.randrange(p) for _ in range(rows * n)], shape=(rows, n),
                        device=device)
        cs = [0, 1, p - 1, rng.randrange(p), pow(omega, n - 3, p)]
        cases += [("linear_scan", [F, x, c], {}) for c in (cs[3:] if n > 8321 else cs)]
    return cases


def ladder_edge_cases(rng, device) -> list:
    """The endo ladder on 40 points of Vesta and of Pallas, the first at
    infinity, with all-zero, all-one and random challenge bits."""
    from proof_systems_tpu_torch.curves import Pallas, Vesta
    from proof_systems_tpu_torch.ops.curve_ops import device_curve

    cases = []
    for curve in (Vesta, Pallas):
        dc = device_curve(curve)
        pts = [None] + [curve.scalar_mul(rng.randrange(1, curve.scalar.p), curve.generator)
                        for _ in range(39)]
        P = dc.to_jacobian(dc.pack_affine(pts, device=device))
        for bits in ([0] * 128, [1] * 128, [rng.randrange(2) for _ in range(128)]):
            t = torch.tensor(bits, dtype=torch.int32, device=device)
            cases.append(("endo_ladder", [dc.F, curve.endos[0], *P, t], {}))
    return cases


def prefix_dispatch_check(device) -> None:
    """limb.prefix_mul on both sides of its dispatch, C = 64 chunks of 128
    (K5) and C = 65 (K12 + K1), against the host's prefix products."""
    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.ops import limb

    F = limb.device_field(Fp)
    rng = random.Random(SEED + 4)
    for n in (64 * 128, 64 * 128 + 1):
        xs = [rng.randrange(Fp.p) for _ in range(n)]
        acc, want = 1, []
        for x in xs:
            acc = acc * x % Fp.p
            want.append(acc)
        if F.unpack_mont(limb.prefix_mul(F, F.pack_mont(xs, device=device))) != want:
            raise AssertionError(f"prefix_mul at n = {n} differs from the host products")
    log("kernels: prefix_mul at C = 64 (K5) and C = 65 (K12 + K1) equals the host products")


def prefix_compare(kernels, args, device, reps: int) -> None:
    """K5 alone against K12 + K1 (limb.prefix_mul's dispatch) on the row of
    K12's largest main-path call."""
    from proof_systems_tpu_torch.ops import limb

    F, x = args
    k5 = elapsed_ms(lambda: kernels.mont_prefix_scan(F, x), device, reps)
    both = elapsed_ms(lambda: limb.prefix_mul(F, x), device, reps)
    log(f"prefix products of {x.shape[-1]} in one row: K5 alone {k5:.4f} ms, "
        f"K12 + K1 (prefix_mul) {both:.4f} ms")


def k8_chain(W: int, c: int) -> tuple[int, int]:
    """(dependent products, levels) of one K8 column: the chain skips the
    top window's c doublings and its add to the identity, and the kernel
    runs a doubling's 7 products in 3 levels and an add's 16 in 5."""
    return (W - 1) * (7 * c + 16), (W - 1) * (3 * c + 5)


def chain_levels(name: str, args) -> tuple[int, int]:
    """(products, dependent levels) of one thread's chain in K4 (one
    element) or K10 (a lane: x^2, then x^4 and x^3, then x^7, then its MDS
    row as one dot3, a round; the last product is the challenge's REDC)."""
    if name == "mont_pow":
        return pow_levels(args[2])
    rounds = 2 * args[1]
    return 5 * rounds + 1, 4 * rounds + 1


def chain_note(name: str, args, ms: float) -> str:
    """The dependent products one thread of a row scan runs (K7: adds; K12
    and K9: with their team size S and sub-chunk sc); for K8 one column's
    chain, its levels and the time a product and a level."""
    from proof_systems_tpu_torch.ops.kernels import scan_chunk

    if name == "combine_windows":
        products, levels = k8_chain(args[2].shape[1], args[1])
        return (f"; chain {products} dependent products in {levels} levels a column, "
                f"{ms * 1e3 / products:.4f} us a product, {ms * 1e3 / levels:.4f} us a level")
    if name == "mont_pow" and args[1][0].numel() > 32:
        return ""  # a batch: throughput, not one chain
    if name in ("mont_pow", "sponge_squeeze2"):
        products, levels = chain_levels(name, args)
        return (f"; chain {products} products in {levels} dependent levels, "
                f"{ms * 1e3 / levels:.4f} us a level")
    if name == "endo_inv":  # u's reduction, the binary GCD, the product by R^3
        steps = INV_BATCHES * INV_STEPS
        return (f"; chain u (2 products, one reduction), {INV_BATCHES} batches of {INV_STEPS} "
                f"binary-GCD steps ({steps}) each ending in its update of a, b, u, v, then "
                f"1 product: {ms * 1e3 / steps:.4f} us a step")
    if name == "ec_prefix_scan_fused":  # a team reduces, scans its totals, rescans
        team, cp = scan_team(args[1])[0], scan_chunk(args[1].shape[-1])
        sc = -(-cp // team)
        chain = cp if team == 1 else 2 * sc + team.bit_length() - 1
        return f"; chain {chain} + 7 + 1 dependent adds a position"
    if name == "mont_prefix_scan":  # reduce, warp scan, warp totals' scan, offset, rescan
        from proof_systems_tpu_torch.ops.kernels import prefix_geometry

        threads, sc, lanes_log2 = prefix_geometry(args[1].shape[-1])
        warps = (threads // 32).bit_length() - 1
        chain = f"{sc} + {lanes_log2} + {warps} + {int(warps > 0)} + {sc}"
        return f"; T = {threads}, sc = {sc}: chain {chain} products"
    if name not in ("linear_scan", "mont_prefix_scan_parts"):
        return ""
    x = args[1]
    team, cp = field_scan_shape(name, x[0].numel() // x.shape[-1], x.shape[-1], x.device)
    sc, lg = -(-cp // team), team.bit_length() - 1
    if name == "mont_prefix_scan_parts":  # reduce, team scan, rescan; the lane kernel
        chain = f"{sc} + {lg} + {sc} + 7 products" if team > 1 else f"{sc} + 7 products"
    else:  # the local recurrence, team scan, lane total; the lane kernel; the combine
        chain = f"{sc} + {lg} + 1 steps, 7, then 2 products a position"
    return f"; S = {team}, sc = {sc}: chain {chain}"


def field_scan_shape(name: str, rows: int, n: int, device) -> tuple[int, int]:
    """(S, cp): the team size that K12's or K9's wrapper derives for `rows`
    rows of n on `device` (132 SMs on the CPU, where the plain versions
    run), and the positions of a lane."""
    from proof_systems_tpu_torch.ops import kernels

    cp = kernels.scan_geometry(n)[2] if name == "mont_prefix_scan_parts" else kernels.scan_chunk(n)
    cuda = torch.device(device).type == "cuda"
    sms = torch.cuda.get_device_properties(device).multi_processor_count if cuda else 132
    return kernels.field_scan_team(rows, cp, sms), cp


def field_scan_note(kernels) -> str:
    """The registers and local (stack) bytes of K12's, K9's and K5's
    kernels."""
    return "; ".join(f"{name}: {regs} registers, {local} B local"
                     for name, (regs, local, *_) in kernels.field_scan_attrs().items())


def scan_team(x: torch.Tensor) -> tuple[int, int]:
    """(S, KT) that K6's and K7's wrappers derive for the rows of x, on the
    card of x (132 SMs on the CPU, where the plain versions run)."""
    from proof_systems_tpu_torch.ops import kernels

    n = x.shape[-1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count if x.is_cuda else 132
    return kernels.parts_geometry(x[0].numel() // n, kernels.scan_chunk(n), sms)


def k6_note(kernels, args) -> str:
    """K6's team size and tile width at this call, and the registers and
    local (stack) bytes of its kernels."""
    team, kt = scan_team(args[1])
    attrs = ", ".join(f"{name}: {regs} registers, {local} B local"
                      for name, (regs, local, *_) in kernels.ec_prefix_scan_parts_attrs().items())
    return f"K6 here: team S = {team}, tile KT = {kt}; {attrs}"


def k7_note(kernels, args) -> str:
    """K7's team size and tile width at this call (its scan kernels are
    K6's), and the registers and local (stack) bytes of its combine."""
    team, kt = scan_team(args[1])
    regs, local, *_ = kernels.ec_prefix_scan_fused_attrs()
    return (f"K7 here: K6's kernels with team S = {team}, tile KT = {kt}, then the combine, "
            f"one thread a position: {regs} registers, {local} B local")


def product_latency(kernels, device) -> None:
    """One thread's chain of dependent products on the card, for the
    product the kernels had before chain_field.cuh (field.cuh's CIOS fe_mul)
    and for its product, square and dot3, from one call: us a step from the
    difference of two chain lengths. Then the registers and local (stack)
    bytes of K10, K4, K11 and the chain kernel; K10 and K4 must keep
    nothing on a stack."""
    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.ops import limb

    F = limb.device_field(Fp)
    rng = random.Random(SEED + 6)
    x = F.pack_mont([rng.randrange(Fp.p) for _ in range(4)], device=device)
    short, long = 256, 2304
    outs = {}
    for name, kind in kernels.PRODUCT_CHAINS.items():
        ms = [elapsed_ms(lambda: kernels.product_chain(F, kind, x, n), device, 5)
              for n in (short, long)]
        outs[kind] = kernels.product_chain(F, kind, x, long)
        log(f"product latency: {name:26s} {(ms[1] - ms[0]) * 1e3 / (long - short):.4f} us a step")
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError("fe_mul_lat's chain differs from fe_mul's")
    attrs = kernels.chain_attrs()
    log("chain kernels: " + "; ".join(f"{name}: {regs} registers, {local} B local"
                                      for name, (regs, local, *_) in attrs.items()))
    stacked = [n for n in ("k_sponge_squeeze2", "k_mont_pow", "k_endo_inv") if attrs[n][1] != 0]
    if stacked:
        raise AssertionError(f"{stacked} keep a stack frame")
    inverse_checks(kernels, device)


def inverse_checks(kernels, device) -> None:
    """K11's inverse on the card (product_chain's INVERSE_CHAIN: one thread,
    a = inv(a) * R^3 mod p) against pow on 0, 1, 2, p - 1, p - 2, R, R^2 and
    2^255 mod p as integers and on random values, in Fp and Fq; then its
    latency, from the difference of two chain lengths."""
    from proof_systems_tpu_torch.fields import Fp, Fq
    from proof_systems_tpu_torch.ops import limb

    rng = random.Random(SEED + 7)
    for fld in (Fp, Fq):
        F = limb.device_field(fld)
        p, r = fld.p, (1 << 256) % fld.p
        r3 = r * r % p * r % p
        for x in [0, 1, 2, p - 1, p - 2, r, r * r % p, (1 << 255) % p] + [
                rng.randrange(p) for _ in range(8)]:
            ops = F.pack([x, r3, 0, 0], device=device)
            [got] = F.unpack(kernels.product_chain(F, kernels.INVERSE_CHAIN, ops, 1))
            if got != (pow(x, -1, p) * r * r % p if x else 0):
                raise AssertionError(f"K11's inverse of {x:#x} in {fld.name} differs from pow")
    log("inverse (K11, binary GCD): equal to pow on the edge values and 8 random ones, Fp and Fq")
    F = limb.device_field(Fp)
    ops = F.pack([rng.randrange(Fp.p), (1 << 256) % Fp.p * ((1 << 512) % Fp.p) % Fp.p, 0, 0],
                 device=device)
    short, long = 16, 144
    ms = [elapsed_ms(lambda: kernels.product_chain(F, kernels.INVERSE_CHAIN, ops, n), device, 3)
          for n in (short, long)]
    log(f"product latency: {'inverse (binary GCD) * R^3':26s} "
        f"{(ms[1] - ms[0]) * 1e3 / (long - short):.4f} us a step")


def group_law_note(kernels) -> str:
    """The registers and local (stack) bytes of K2, K3 and the endo ladder."""
    return "; ".join(f"{name}: {regs} registers, {local} B local"
                     for name, (regs, local, *_) in kernels.group_law_attrs().items())


def k8_note(kernels) -> str:
    """K8's lanes and the registers and local (stack) bytes of its kernel."""
    regs, local, *_ = kernels.combine_windows_attrs()
    return (f"K8 here: one warp a column, a level's products on 4 lanes; {regs} registers, "
            f"{local} B local")


# The plain curve kernels hold a few kilobytes of float64 temporaries a lane
# they compute side by side: every position for K2 and K3, which are
# elementwise, and up to LANES a row for K6 and K7, which scan each row
# along its last axis. A call wider than this runs its plain version on
# slices of its rows, so that short rows in their thousands (the Keccak
# commit's bucket reduction) fit beside the kernel's own output; long rows
# (the main path's commits) stay whole, as wide as the float64 path wants.
PLAIN_WIDTH = 1 << 22
# A kernel's time is the mean of enough calls to fill about this many ms
# (at least 3, at most 20).
TIMED_MS = 30
SLICED_PLAIN = {"ec_prefix_scan_parts": 3, "ec_prefix_scan_fused": 3, "jacobian_add": 6,
                "jacobian_double": 3}  # kernel -> its point tensors after the field
ELEMENTWISE_PLAIN = {"mont_mul": 2, "mont_pow": 1}  # kernel -> its operand tensors


def plain_call(ref, name: str, args, kw):
    """The plain version of a recorded call: K2's, K3's, K6's and K7's on
    slices of rows at most PLAIN_WIDTH lanes wide, K1's and K4's on slices
    of at most PLAIN_WIDTH elements (their temporaries are tens of bytes an
    element), concatenated."""
    from proof_systems_tpu_torch.ops import kernels

    if name in ELEMENTWISE_PLAIN and args[1][0].numel() > PLAIN_WIDTH:
        ops = [t.reshape(8, -1) for t in args[1 : 1 + ELEMENTWISE_PLAIN[name]]]
        parts = [ref(args[0], *(t[:, lo : lo + PLAIN_WIDTH].contiguous() for t in ops),
                     *args[1 + ELEMENTWISE_PLAIN[name] :], **kw)
                 for lo in range(0, ops[0].shape[1], PLAIN_WIDTH)]
        return torch.cat(parts, dim=1).reshape(args[1].shape)
    x = args[1] if name in SLICED_PLAIN else None
    if x is None:
        return ref(*args, **kw)
    n, lead = x.shape[-1], x.shape[1:-1]
    row_width = n if name.startswith("jacobian") else min(n, kernels.LANES)
    step = max(1, PLAIN_WIDTH // row_width)
    nrows = x[0].numel() // n
    if nrows <= step:
        return ref(*args, **kw)
    rows = [t.reshape(t.shape[0], nrows, n) for t in args[1 : 1 + SLICED_PLAIN[name]]]
    parts = [ref(args[0], *(t[:, lo : lo + step].contiguous() for t in rows), **kw)
             for lo in range(0, nrows, step)]

    def cat(items):
        if torch.is_tensor(items[0]):
            t = torch.cat(items, dim=1)
            return t.reshape(t.shape[0], *lead, t.shape[-1])
        if isinstance(items[0], tuple):
            return tuple(cat([it[i] for it in items]) for i in range(len(items[0])))
        if any(it != items[0] for it in items):
            raise AssertionError(f"{name}: the slices' plain versions disagree on {items}")
        return items[0]

    return cat(parts)


# Kernels whose plain versions run several recorded calls as one call: the
# plain versions are chains of small torch ops, whose time is the number of
# ops and host round trips, nearly whatever the width, so calls that share a
# batch key (batch_key) are joined along their lanes or rows (join_calls),
# computed once and split back (split_outputs). The inputs of every call
# are its own, and each call's kernel output is held against its own slice.
ROW_KERNELS = ("ec_prefix_scan_parts", "ec_prefix_scan_fused", "mont_prefix_scan_parts",
               "mont_prefix_scan", "linear_scan")


def batch_key(name: str, args, kw):
    """The calls of one kernel that one plain call can compute together
    share this key (None: the call runs alone)."""
    F = id(args[0])
    if name == "mont_pow":
        return F, args[2]
    if name in ("endo_ladder", "endo_inv"):
        return F, args[1]
    if name == "combine_windows":
        return (F,)
    if name == "linear_scan":
        return F, args[2], args[1].shape[-1]
    if name in ROW_KERNELS:
        return F, bool(kw.get("mixed", False)), args[1].shape[-1]
    return None


def join_calls(name: str, calls):
    """(args, kw) of one plain call that computes the calls `calls` [(args,
    kw)] side by side: flattened elements (K4), lanes with their own
    challenge bits (the ladder, K11), columns with their own window width,
    under identity windows up to the most windows (K8), or rows (the
    scans)."""
    args0, kw0 = calls[0]
    if name == "mont_pow":
        return [args0[0], torch.cat([a[1].reshape(8, -1) for a, _ in calls], -1), args0[2]], kw0
    if name == "endo_ladder":
        pts = [torch.cat([a[i] for a, _ in calls], -1) for i in (2, 3, 4)]
        bits = torch.cat([a[5][:, None].expand(128, a[2].shape[-1]) for a, _ in calls], -1)
        return [args0[0], args0[1], *pts, bits.contiguous()], kw0
    if name == "endo_inv":
        return [args0[0], args0[1], torch.stack([a[2] for a, _ in calls], -1)], kw0
    if name == "combine_windows":  # identity windows on top; a window width a column
        W = max(a[2].shape[1] for a, _ in calls)
        wins = [torch.cat([torch.nn.functional.pad(a[i], (0, 0, 0, W - a[i].shape[1]))
                           for a, _ in calls], 2) for i in (2, 3, 4)]
        return [args0[0], [a[1] for a, _ in calls for _ in range(a[2].shape[2])], *wins], kw0
    n, npts = args0[1].shape[-1], 3 if name.startswith("ec_") else 1
    ts = [torch.cat([a[i].reshape(8, -1, n) for a, _ in calls], 1) for i in range(1, 1 + npts)]
    return [args0[0], *ts, *args0[1 + npts:]], kw0


def split_outputs(name: str, out, calls) -> list:
    """The joined plain call's output `out`, cut into each call's."""
    def cut(t, sizes, shapes):
        flat, parts, off = t.reshape(8, -1, t.shape[-1]), [], 0
        for size, shape in zip(sizes, shapes):
            parts.append(flat[:, off : off + size].reshape(8, *shape, t.shape[-1]))
            off += size
        return parts

    if name == "mont_pow":
        sizes = [a[1][0].numel() for a, _ in calls]
        offs = np.cumsum([0] + sizes)
        return [out[:, o : o + m].reshape(a[1].shape) for (a, _), o, m in zip(calls, offs, sizes)]
    if name in ("endo_ladder", "endo_inv", "combine_windows"):
        sizes = [1 if name == "endo_inv" else a[2].shape[-1] for a, _ in calls]
        offs = np.cumsum([0] + sizes)
        return [tuple(t[..., o : o + m] for t in out) for o, m in zip(offs, sizes)]
    x = [a[1] for a, _ in calls]
    sizes, shapes = [t[0].numel() // t.shape[-1] for t in x], [t.shape[1:-1] for t in x]

    def rows(obj):  # tensors (8, rows, m) cut by rows, tuples item by item
        if torch.is_tensor(obj):
            return cut(obj, sizes, shapes)
        if isinstance(obj, tuple):
            return list(zip(*(rows(o) for o in obj)))
        return [obj] * len(calls)

    return rows(out)


def plain_outputs(kernels, calls, device):
    """Yields, a batch key at a time, (i, output, seconds, calls joined) of
    the plain version for each call i of `calls` [(name, args, kw)]: the
    calls of a batch key computed by one plain call (plain_call), timed on
    the host clock. A group's outputs are dropped before the next group's
    are computed, so the caller holds each call as it comes."""
    groups: dict = {}
    for i, (name, args, kw) in enumerate(calls):
        key = batch_key(name, args, kw)
        groups.setdefault(("alone", i) if key is None else (name, key), []).append(i)
    for idx in groups.values():
        name = calls[idx[0]][0]
        ref = getattr(kernels, name + "_plain")
        members = [(calls[i][1], calls[i][2]) for i in idx]
        if len(idx) == 1:
            got, secs = wall(lambda: plain_call(ref, name, *members[0]), device)
            parts = [got]
        else:
            args, kw = join_calls(name, members)
            got, secs = wall(lambda: plain_call(ref, name, args, kw), device)
            parts = split_outputs(name, got, members)
            del args
        del got
        for i, part in zip(idx, parts):
            yield i, part, secs, len(idx)
        del parts


def hold(kernels, key: str, args, kw, want, plain_s: float, joined: int, device
         ) -> tuple[dict, int]:
    """One recorded call of a kernel against its plain version's output
    `want` on the same inputs (fatal if they differ), timed; returns its JSON
    row (launches 0; plain_ms the time of the plain call that computed it,
    with `joined` calls) and the repetitions it was timed over."""
    name = kernel_of(key)
    kern = kernels.WRAPPERS[name]
    got = kern(*args, **kw)
    err = outputs_err(name, args[0], got, want)
    if err:
        raise AssertionError(f"{key}: kernel != plain at a recorded path shape (max err {err})")
    once = elapsed_ms(lambda: kern(*args, **kw), device)
    reps = int(min(20, max(3, TIMED_MS / max(once, 1e-3))))
    ms = elapsed_ms(lambda: kern(*args, **kw), device, reps)
    b_ms, b_by = bound_ms(name, args, kw)
    shape = "x".join(str(s) for s in next(a for a in args if torch.is_tensor(a)).shape)
    calls = f" ({joined} calls)" if joined > 1 else ""
    log(f"kernel {key:28s} shape {shape:22s} {ms:10.4f} ms  plain {plain_s * 1e3:10.1f} ms"
        f"{calls}  bound {b_ms:.3g} ms ({b_by})  max_abs_err {err}{chain_note(name, args, ms)}")
    return {"name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_s * 1e3, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}, reps


def check_kernels(kernels, recorded, device, curve_params) -> list[dict]:
    """Each kernel against its plain version on the recorded main-path
    inputs (timed) and on the edge cases, the plain versions of calls that
    share a batch key computed together."""
    rows = {}
    (cases, (dc, P, Q, want_add)), secs = wall(lambda: edge_cases(device, curve_params), device)
    log(f"kernels: {len(cases)} edge cases made in {secs:.1f} s")
    got = dc.unpack_jacobian(type(P)(*kernels.WRAPPERS["jacobian_add"](dc.F, *P, *Q)))
    if got != want_add:
        raise AssertionError("jacobian_add edge cases disagree with the host curve")
    prefix_dispatch_check(device)
    keys = sorted(recorded)
    calls = cases + [(kernel_of(k), recorded[k][1], recorded[k][2]) for k in keys]

    sizes, edge_s = {}, collections.defaultdict(set)
    for i, want, plain_s, joined in plain_outputs(kernels, calls, device):
        if i < len(cases):  # an edge case: compared, not timed
            name, args, kw = cases[i]
            err = outputs_err(name, args[0], kernels.WRAPPERS[name](*args, **kw), want)
            if err:
                raise AssertionError(f"{name} edge cases: kernel != plain (max err {err})")
            edge_s[name].add(plain_s)
            continue
        key = keys[i - len(cases)]
        size, args, kw = recorded[key]
        name = kernel_of(key)
        row, reps = hold(kernels, key, args, kw, want, plain_s, joined, device)
        if name == "ec_prefix_scan_parts":
            log("  " + k6_note(kernels, args))
        if name == "ec_prefix_scan_fused":
            log("  " + k7_note(kernels, args))
        if name == "combine_windows":
            log("  " + k8_note(kernels))
        reported = name in BY_SHAPE or re.sub(r"@\w+", "", key) == JSON_KEY.get(name, name)
        if reported and size > sizes.get(name, 0):
            rows[name], sizes[name] = row, size
        if name == "mont_prefix_scan_parts":
            prefix_compare(kernels, args, device, reps)
    missing = set(kernels.WRAPPERS) - set(rows)
    if missing:
        raise AssertionError(f"the main path never called {sorted(missing)}")
    log("kernels: edge cases agree with the plain versions (and K2 with the host curve); "
        "the plain calls that held them, s: "
        + json.dumps({k: round(sum(v), 2) for k, v in sorted(edge_s.items())}))
    log("group law kernels: " + group_law_note(kernels))
    log("field scan kernels (K5, K12, K9): " + field_scan_note(kernels))
    local = [k for k, (_, b, *_) in kernels.field_scan_attrs().items() if b]
    if local:
        raise AssertionError(f"{local} keep a stack frame")
    return [rows[n] for n in kernels.WRAPPERS]


# ---------------------------------------------------------------------------
# The main path
# ---------------------------------------------------------------------------


def random_std_limbs(p: int, shape, seed: int, device) -> torch.Tensor:
    """Uniform-ish canonical values below 2^254 < p, as (8, *shape) limbs."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(8, *shape), dtype=np.uint64)
    w[7] %= p >> 224
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(device)


def main_path(log_n: int, device, cache_dir=None):
    """SRS -> scaled basis -> iNTT of the witness -> 15 hiding commits and
    one b = 1 commit, through the port's entry points."""
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.ops import limb, msm, ntt
    from proof_systems_tpu_torch.poly_commitment.srs import SRS

    n = 1 << log_n
    F = limb.device_field(Fp)
    times = {}
    srs, times["srs_create_s"] = wall(
        lambda: SRS.create(Vesta, n, device=device, cache_dir=cache_dir), device)
    c = msm.default_window_bits(n + 1)
    _, times["scaled_basis_s"] = wall(lambda: srs.scaled_basis(c), device)
    plan = ntt.ntt_plan(Fp, log_n, device=device)
    w_evals = limb.to_mont(F, random_std_limbs(Fp.p, (COLUMNS, n), SEED, device))
    w_coeffs, times["intt_s"] = wall(lambda: plan.intt_t(w_evals, plan.inv_twiddles), device)
    rng = random.Random(SEED)
    blinders = [[rng.randrange(Fp.p)] for _ in range(COLUMNS)]
    comms, times["commit15_s"] = wall(lambda: srs.commit_coeffs_dev(w_coeffs, 1, blinders), device)
    z_coeffs = limb.to_mont(F, random_std_limbs(Fp.p, (1, n), SEED + 2, device))
    z_blinder = [[rng.randrange(Fp.p)]]
    z_comm, times["commit1_s"] = wall(lambda: srs.commit_coeffs_dev(z_coeffs, 1, z_blinder), device)
    run = dict(srs=srs, c=c, plan=plan, F=F, w_evals=w_evals, w_coeffs=w_coeffs,
               blinders=blinders, comms=comms, z_coeffs=z_coeffs, z_blinder=z_blinder,
               z_comm=z_comm, times=times)
    run.update(open_and_verify(run, log_n, device))
    run.update(prove_path(run, log_n, device))
    return run


def prove_path(run, log_n: int, device) -> dict:
    """The bench circuit of 2^k - 10 Const(1) generic gates through
    ConstraintSystem.create, ProverIndex and verifier_index (timed apart),
    create_proof of the witness packed in Montgomery form, verify and
    serialize_proof over the path's SRS (bench.py:51-96)."""
    from proof_systems_tpu_torch.circuits.builders import bench_circuit, bench_witness
    from proof_systems_tpu_torch.circuits.constraints import ConstraintSystem
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.prover_index import ProverIndex
    from proof_systems_tpu_torch.serialization import serialize_proof

    n = 1 << log_n
    times, F = run["times"], run["F"]

    def build():
        cs = ConstraintSystem.create(Fp, bench_circuit(Fp, n - 10), public=0,
                                     max_poly_size=n, device=device)
        return ProverIndex(cs, Vesta, run["srs"])

    index, times["index_s"] = wall(build, device)
    vk, times["vk_s"] = wall(index.verifier_index, device)
    host_witness = bench_witness(n - 10)
    out = dict(index=index, vk=vk, witness=F.pack_mont(
        [v for col in host_witness for v in col], shape=(COLUMNS, n - 10), device=device))
    out["proof_debug"] = {}
    out["kproof"], times["prove_s"] = wall(lambda: prove({**run, **out}, out["proof_debug"]), device)
    ok, times["verify_proof_s"] = wall(lambda: verify_proof(out, out["kproof"]), device)
    if not ok:
        raise AssertionError(f"verify rejected the honest proof at k = {log_n}")
    out["proof_bytes"] = len(serialize_proof(Vesta, out["kproof"]))
    return out


def prove(run, debug=None):
    from proof_systems_tpu_torch.prover import create_proof
    from proof_systems_tpu_torch.utils.rng import TestRng

    return create_proof(run["index"], run["witness"], TestRng(SEED), debug=debug)


def verify_proof(run, proof, seed=SEED + 1) -> bool:
    from proof_systems_tpu_torch.utils.rng import TestRng
    from proof_systems_tpu_torch.verifier import verify as kimchi_verify

    return kimchi_verify(run["vk"], proof, [], TestRng(seed))


# The public-input path: m public generic gates in rows 0..m-1. Five makes the
# Lagrange commitments a b >= 2 MSM whose to_affine batch is not a power of
# two (K4's elementwise inverse).
PUBLIC_M = 5
# The bench path's k: n = 2,048 = IPA_FOLD_TAIL, an opening without a fold step.
BENCH_K = 11
# The kernels of an opening's tail rounds, which a k = 11 proof must launch.
TAIL_KERNELS = ("mont_mul", "jacobian_add", "mont_pow", "mont_prefix_scan",
                "ec_prefix_scan_parts", "ec_prefix_scan_fused", "combine_windows",
                "sponge_squeeze2", "endo_inv")


def lagrange_once(run, log_n: int, device) -> list:
    """The public path's Lagrange commitments alone, on a new SRS over the
    path's points with no disk cache (so that the b = PUBLIC_M MSM runs and
    its calls are recorded apart from the proof's larger ones)."""
    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.ops import ntt
    from proof_systems_tpu_torch.poly_commitment.srs import SRS

    srs = run["srs"]
    fresh = SRS(srs.curve, srs.g, srs.h, device)
    return fresh.lagrange_commitments(ntt.ntt_plan(Fp, log_n, device=device), PUBLIC_M)


def public_path(run, log_n: int, device) -> dict:
    """The public-input circuit over the path's SRS: PUBLIC_M public generic
    gates, then Const(1) gates up to 2^k - 10 rows, through
    ConstraintSystem.create and ProverIndex; the Lagrange commitments of
    the public rows (a first call into an empty cache directory, a call
    from memory, and one from disk on a new SRS over the same points); a
    proof of a host witness with seeded public values in column 0, its
    verification, and the prover's public commitment (spied on the SRS)."""
    import pathlib
    import tempfile

    from proof_systems_tpu_torch.circuits.builders import GenericGateSpec, create_generic_gadget
    from proof_systems_tpu_torch.circuits.constraints import ConstraintSystem
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.poly_commitment.srs import SRS
    from proof_systems_tpu_torch.prover import create_proof
    from proof_systems_tpu_torch.prover_index import ProverIndex
    from proof_systems_tpu_torch.utils.rng import TestRng
    from proof_systems_tpu_torch.verifier import verify as kimchi_verify

    n, m, srs, times = 1 << log_n, PUBLIC_M, run["srs"], run["times"]
    gates = [create_generic_gadget(Fp, r, GenericGateSpec.pub(Fp)) for r in range(m)] + [
        create_generic_gadget(Fp, r, GenericGateSpec.const(Fp, 1)) for r in range(m, n - 10)]

    def build():
        cs = ConstraintSystem.create(Fp, gates, public=m, max_poly_size=n, device=device)
        return ProverIndex(cs, Vesta, srs)

    index, times["index_pub_s"] = wall(build, device)
    vk = index.verifier_index()
    rng = random.Random(SEED + 7)
    public = [rng.randrange(Fp.p) for _ in range(m)]
    witness = [[0] * (n - 10) for _ in range(COLUMNS)]
    witness[0] = public + [1] * (n - 10 - m)

    saved_dir = srs.cache_dir
    with tempfile.TemporaryDirectory() as tmp:
        srs.cache_dir = pathlib.Path(tmp)
        lag, times["lagrange_first_s"] = wall(
            lambda: srs.lagrange_commitments(vk.domain, m), device)
        again, times["lagrange_cached_s"] = wall(
            lambda: srs.lagrange_commitments(vk.domain, m), device)
        fresh = SRS(srs.curve, srs.g, srs.h, device, cache_dir=tmp)
        from_disk, times["lagrange_disk_s"] = wall(
            lambda: fresh.lagrange_commitments(vk.domain, m), device)
    srs.cache_dir = saved_dir
    if not lag == again == from_disk:
        raise AssertionError("the cached Lagrange commitments differ from the first call's")

    calls = []
    commit = srs.commit_coeffs_dev

    def spy(coeffs, num_chunks=1, blinders=None):
        out = commit(coeffs, num_chunks, blinders)
        calls.append(out)
        return out

    srs.commit_coeffs_dev = spy  # an instance attribute over the method
    proof, prove_s = wall(lambda: create_proof(index, witness, TestRng(SEED + 8)), device)
    del srs.commit_coeffs_dev
    times["prove_pub_ms"] = prove_s * 1e3
    ok, verify_s = wall(lambda: kimchi_verify(vk, proof, public, TestRng(SEED + 9)), device)
    times["verify_pub_ms"] = verify_s * 1e3
    if not ok:
        raise AssertionError(f"verify rejected the honest public-input proof at k = {log_n}")
    return dict(pub_vk=vk, public=public, pub_proof=proof, lagrange=lag, pub_comm=calls[0][0])


def public_checks(pub, nat) -> None:
    """The public-input proof: rejected with a public value + 1; the
    prover's public commitment (iNTT, then a b = 1 commit with H) equals the
    verifier's masked -sum p_i L_i; the Lagrange commitments equal the
    native host MSM of their coefficients n^-1 omega^(-ij) over g."""
    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.utils.rng import TestRng
    from proof_systems_tpu_torch.verifier import to_batch
    from proof_systems_tpu_torch.verifier import verify as kimchi_verify

    vk, proof, public = pub["pub_vk"], pub["pub_proof"], pub["public"]
    changed = [(public[0] + 1) % Fp.p] + public[1:]
    if kimchi_verify(vk, proof, changed, TestRng(SEED + 10)):
        raise AssertionError("verify accepted the public-input proof with a changed public value")
    verifier_comm = to_batch(vk, proof, public).evaluations[0].commitment
    if pub["pub_comm"].chunks != verifier_comm.chunks:
        raise AssertionError("the prover's public commitment differs from the verifier's")
    log(f"check: the k = {vk.domain.log_n} proof with {len(public)} public inputs verifies and is "
        "rejected with a public value + 1; the prover's public commitment equals the verifier's "
        "-sum p_i L_i + H")

    t0 = time.perf_counter()
    p, n = Fp.p, vk.domain.n
    w_inv, n_inv = pow(vk.domain.group_gen, -1, p), pow(n, -1, p)
    jobs = []
    for i in range(len(public)):
        w, c, row = pow(w_inv, i, p), n_inv, []
        for _ in range(n):
            row.append(c)
            c = c * w % p
        jobs.append(row)
    g = vk.srs.g
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        want = list(pool.map(lambda sc: nat.msm(sc, g), jobs))
    if pub["lagrange"] != want:
        raise AssertionError("the Lagrange commitments differ from the host MSM")
    log(f"check: the {len(public)} Lagrange commitments equal the host MSM over g "
        f"({time.perf_counter() - t0:.1f} s on the host)")


def bench_path(device, cache_dir=None) -> dict:
    """bench_torch's own set-up and proof at k = BENCH_K, the proof's launch
    counts (zeroed just before it), its verification and its size."""
    import bench_torch
    from proof_systems_tpu_torch.ops import kernels
    from proof_systems_tpu_torch.serialization import serialize_proof
    from proof_systems_tpu_torch.utils.rng import TestRng

    index, witness = bench_torch.setup(BENCH_K, device, cache_dir)
    kernels.reset_launch_counts()
    proof, seconds = bench_torch.prove_once(index, witness, TestRng(SEED + 11))
    counts = kernels.launch_counts()
    verify_s = bench_torch.verify_once(index, proof, TestRng(SEED + 12))
    return dict(counts=counts, prove_ms=seconds * 1e3, verify_ms=verify_s * 1e3,
                proof_bytes=len(serialize_proof(index.curve, proof)), rounds=len(proof.proof.lr))


# ---------------------------------------------------------------------------
# Recursion challenges, a chunked proof, lookups, batch verification and the
# verifier index on disk
# ---------------------------------------------------------------------------

# Recursion challenges a proof carries (a Pickles step proof carries its
# predecessors' IPA challenges), each of log_n seeded scalars.
RECURSION_CHALLENGES = 2
# The lookup circuit (tests/test_lookup.py:18-31, scaled): LOOKUP_ROWS Lookup
# rows of three lookups into the table (x, x^2) of LOOKUP_TABLE entries,
# table id 0 (or a runtime table of LOOKUP_TABLE entries), then Const(1)
# generic gates up to 2^k - 20 gates.
LOOKUP_ROWS, LOOKUP_TABLE = 32768, 4096
# The one kernel a proof need not launch: K3 builds the scaled basis, once
# per SRS.
NOT_ON_A_PROOF = ("jacobian_double",)
# The kernels the column phase must launch: a proof's but K9, which only the
# Kimchi prover's divisions by (x - c) run.
COLUMN_KERNELS = ("mont_mul", "jacobian_add", "mont_pow", "mont_prefix_scan",
                  "ec_prefix_scan_parts", "ec_prefix_scan_fused", "combine_windows",
                  "sponge_squeeze2", "endo_inv", "mont_prefix_scan_parts", "endo_ladder")


def counted(kernels, tag: str, fn, device, expect) -> tuple:
    """Run one path with every launch count zeroed just before and read just
    after, under a Recorder (its calls are held against the plain versions
    afterwards); fatal if a kernel of `expect` was launched no time."""
    sync(device)
    kernels.reset_launch_counts()
    with Recorder(kernels) as rec:
        out = fn()
    sync(device)
    counts = kernels.launch_counts()
    log(f"{tag} launches: {json.dumps(counts)}")
    zero = [k for k in expect if counts[k] == 0]
    if zero and device.type == "cuda":  # the CPU's plain versions launch nothing
        raise AssertionError(f"kernels not launched on the {tag} path: {zero}")
    return out, counts, rec.calls


def call_sig(key: str, args, kw) -> str:
    """A recorded call's key with the shape of every tensor it took and the
    value of every other argument (the field, c, endo_q, nrounds, mixed):
    the identity of a call, held against the plain version once."""

    def one(a) -> str:
        if torch.is_tensor(a):
            return "x".join(map(str, a.shape))
        return getattr(a, "__name__", None) or repr(a)

    parts = [one(a) for a in args] + [f"{k}={one(v)}" for k, v in sorted(kw.items())]
    return f"{key}@{','.join(parts)}"


def check_path_calls(kernels, recorded: dict, tag: str, device, checked: set) -> None:
    """Each call shape of a path's kernels (a kernel's largest call, and
    every call shape of the kernels recorded by shape, BY_SHAPE) against
    its plain version, unless an earlier check held that shape
    (`checked`: call_sig of every call held so far); the plain versions of
    calls that share a batch key computed together."""
    if device.type == "cuda":  # the plain versions' temporaries need the cached blocks
        torch.cuda.empty_cache()
    keys = []
    for key in sorted(recorded):
        sig = call_sig(key, recorded[key][1], recorded[key][2])
        if sig not in checked:
            keys.append(key)
            checked.add(sig)
    calls = [(kernel_of(k), recorded[k][1], recorded[k][2]) for k in keys]
    for i, want, plain_s, joined in plain_outputs(kernels, calls, device):
        _, args, kw = recorded[keys[i]]
        hold(kernels, f"{keys[i]}[{tag}]", args, kw, want, plain_s, joined, device)


def recursion_path(run, log_n: int, device, nat) -> dict:
    """The bench circuit's index with RECURSION_CHALLENGES recursion
    challenges of log_n seeded scalars: each commitment is the port's
    commit of b_poly_coefficients over the SRS (held against the native host
    MSM over g); a proof of the packed witness, verified, and rejected when
    one challenge changes."""
    import copy

    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.poly_commitment.commitment import b_poly_coefficients
    from proof_systems_tpu_torch.proof import RecursionChallenge
    from proof_systems_tpu_torch.prover import create_proof
    from proof_systems_tpu_torch.utils.rng import TestRng

    rng, srs, times = random.Random(SEED + 20), run["srs"], run["times"]
    challenges, jobs = [], []
    for _ in range(RECURSION_CHALLENGES):
        chals = [rng.randrange(Fp.p) for _ in range(log_n)]
        coeffs = b_poly_coefficients(Fp, chals)
        challenges.append(RecursionChallenge(chals=chals,
                                             comm=srs.commit_coeffs_host([coeffs])[0]))
        jobs.append(coeffs)
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        want = list(pool.map(lambda sc: nat.msm(sc, srs.g), jobs))
    if [rc.comm.chunks for rc in challenges] != [[w] for w in want]:
        raise AssertionError("the recursion challenges' commitments differ from the host MSM")
    proof, prove_s = wall(lambda: create_proof(run["index"], run["witness"], TestRng(SEED + 21),
                                               prev_challenges=challenges), device)
    times["prove_rec_ms"] = prove_s * 1e3
    ok, verify_s = wall(lambda: verify_proof(run, proof, SEED + 22), device)
    times["verify_rec_ms"] = verify_s * 1e3
    if not ok:
        raise AssertionError("verify rejected the honest proof with recursion challenges")
    bad = copy.deepcopy(proof)
    bad.prev_challenges[0].chals[0] = (bad.prev_challenges[0].chals[0] + 1) % Fp.p
    if verify_proof(run, bad, SEED + 23):
        raise AssertionError("verify accepted a changed recursion challenge")
    log(f"check: {RECURSION_CHALLENGES} recursion challenges of {log_n} scalars: their "
        "commitments equal the host MSM over g; the proof verifies and is rejected when one "
        "challenge changes")
    return dict(rec_proof=proof)


def chunked_path(run, log_n: int, device) -> dict:
    """The bench circuit of 2^(k+1) - 10 Const(1) gates over the path's
    2^k-point SRS (2 chunks, zk_rows 5, 14 t chunks): ConstraintSystem.create
    and ProverIndex (timed), a proof of the packed witness (all ones),
    verified, rejected at ft_eval1 + 1."""
    import copy

    from proof_systems_tpu_torch.circuits.builders import bench_circuit
    from proof_systems_tpu_torch.circuits.constraints import ConstraintSystem
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.prover import create_proof
    from proof_systems_tpu_torch.prover_index import ProverIndex
    from proof_systems_tpu_torch.utils.rng import TestRng
    from proof_systems_tpu_torch.verifier import verify as kimchi_verify

    n2, times, F = 1 << (log_n + 1), run["times"], run["F"]

    def build():
        cs = ConstraintSystem.create(Fp, bench_circuit(Fp, n2 - 10), public=0,
                                     max_poly_size=1 << log_n, device=device)
        return ProverIndex(cs, Vesta, run["srs"])

    index, times["index_chunked_s"] = wall(build, device)
    if (index.num_chunks, index.cs.zk_rows, index.cs.domain.d1.n) != (2, 5, n2):
        raise AssertionError(f"the chunked index has {index.num_chunks} chunks, zk_rows "
                             f"{index.cs.zk_rows}, domain {index.cs.domain.d1.n}")
    vk = index.verifier_index()
    witness = F.one_mont((COLUMNS, n2 - 10), device=device)  # bench_witness, packed
    proof, prove_s = wall(lambda: create_proof(index, witness, TestRng(SEED + 24)), device)
    times["prove_chunked_ms"] = prove_s * 1e3
    ok, verify_s = wall(lambda: kimchi_verify(vk, proof, [], TestRng(SEED + 25)), device)
    times["verify_chunked_ms"] = verify_s * 1e3
    shape = ([len(c.chunks) for c in proof.commitments.w_comm],
             len(proof.commitments.t_comm.chunks))
    if not ok or shape != ([2] * COLUMNS, 14):
        raise AssertionError(f"the chunked proof: verified {ok}, chunks {shape}")
    bad = copy.deepcopy(proof)
    bad.ft_eval1 = (bad.ft_eval1 + 1) % Fp.p
    if kimchi_verify(vk, bad, [], TestRng(SEED + 26)):
        raise AssertionError("verify accepted the chunked proof with ft_eval1 + 1")
    log(f"check: the chunked proof (domain 2^{log_n + 1} over 2^{log_n} points: 2 chunks a "
        "witness commitment, 14 t chunks, zk_rows 5) verifies and is rejected at ft_eval1 + 1")
    return dict(chunked_index=index, chunked_vk=vk, chunked_proof=proof, chunked_witness=witness)


def chunked_steady(run, device) -> None:
    """prove_ms and the peak device memory of one more chunked proof, with
    no recorder holding copies of kernel inputs."""
    from proof_systems_tpu_torch.prover import create_proof
    from proof_systems_tpu_torch.utils.rng import TestRng

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    _, prove_s = wall(lambda: create_proof(run["chunked_index"], run["chunked_witness"],
                                           TestRng(SEED + 24)), device)
    run["times"]["prove_chunked_steady_ms"] = prove_s * 1e3
    if device.type == "cuda":
        peak = (torch.cuda.max_memory_allocated(device) - base) / 2**30
        run["times"]["chunked_proof_peak_gib"] = peak


def lookup_circuit(n: int, runtime: bool):
    """(gates, witness, fixed tables, runtime configs, runtime tables) of the
    lookup circuit at 2^k = n rows: LOOKUP_ROWS Lookup rows of three lookups,
    then Const(1) gates up to n - 20 gates. Fixed: the table (x, x^2) of
    LOOKUP_TABLE entries, id 0; runtime: a table of id 0 whose first column
    is 0..LOOKUP_TABLE - 1 and whose seeded second column comes at prove time."""
    from proof_systems_tpu_torch.circuits.builders import GenericGateSpec, create_generic_gadget
    from proof_systems_tpu_torch.circuits.gate import CircuitGate, GateType, new_wires
    from proof_systems_tpu_torch.circuits.lookup import LookupTable, RuntimeTableCfg
    from proof_systems_tpu_torch.fields import Fp

    rng = random.Random(SEED + (31 if runtime else 30))
    if runtime:
        second = [rng.randrange(Fp.p) for _ in range(LOOKUP_TABLE)]
    else:
        second = [i * i for i in range(LOOKUP_TABLE)]
    gates = [CircuitGate(GateType.Lookup, new_wires(r), []) for r in range(LOOKUP_ROWS)] + [
        create_generic_gadget(Fp, r, GenericGateSpec.const(Fp, 1))
        for r in range(LOOKUP_ROWS, n - 20)]
    witness = [[0] * (n - 20) for _ in range(COLUMNS)]
    witness[0][LOOKUP_ROWS:] = [1] * (n - 20 - LOOKUP_ROWS)
    for r in range(LOOKUP_ROWS):  # column 0 holds the table id, 0
        for slot in range(3):
            idx = rng.randrange(LOOKUP_TABLE)
            witness[1 + 2 * slot][r] = idx
            witness[2 + 2 * slot][r] = second[idx]
    if runtime:
        cfg = RuntimeTableCfg(id=0, first_column=list(range(LOOKUP_TABLE)))
        return gates, witness, None, [cfg], [(0, second)]
    return gates, witness, [LookupTable(0, [list(range(LOOKUP_TABLE)), second])], None, None


class HostClock:
    """Wraps functions with the host clock (seconds summed over calls), as
    Clock does with CUDA events: the lookup argument's host stages."""

    def __init__(self, owner, names) -> None:
        self.owner, self.names = owner, names
        self.seconds = dict.fromkeys(names, 0.0)

    def __enter__(self):
        self.saved = {name: getattr(self.owner, name) for name in self.names}
        for name, fn in self.saved.items():
            setattr(self.owner, name, self._timed(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.owner, name, fn)

    def _timed(self, name, fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.seconds[name] += time.perf_counter() - t0
            return out

        return wrapper


def lookup_path(run, log_n: int, device, runtime: bool) -> dict:
    """The lookup circuit (fixed or runtime table) over the path's SRS:
    ConstraintSystem.create and ProverIndex (timed), a proof of the host
    witness with the host time of the lookup argument's stages (the
    combined table, the sorted multiset and its zk rows, the aggregation)
    apart from the rest, verified, rejected with a changed sorted
    evaluation; a looked-up value not in the table (fixed) or a runtime
    table under another id (runtime) raises ValueError, as in the JAX
    package."""
    import copy

    from proof_systems_tpu_torch.circuits import lookup as lookup_mod
    from proof_systems_tpu_torch.circuits.constraints import ConstraintSystem
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.prover import create_proof
    from proof_systems_tpu_torch.prover_index import ProverIndex
    from proof_systems_tpu_torch.utils.rng import TestRng
    from proof_systems_tpu_torch.verifier import verify as kimchi_verify

    n, times, tag = 1 << log_n, run["times"], "runtime" if runtime else "lookup"
    gates, witness, fixed, configs, tables = lookup_circuit(n, runtime)

    def build():
        cs = ConstraintSystem.create(Fp, gates, public=0, max_poly_size=n,
                                     fixed_lookup_tables=fixed, runtime_tables=configs,
                                     device=device)
        return ProverIndex(cs, Vesta, run["srs"])

    index, times[f"index_{tag}_s"] = wall(build, device)
    if index.cs.domain.d1.n != n or index.cs.lookup_cs is None:
        raise AssertionError(f"the {tag} index: domain {index.cs.domain.d1.n}")
    vk = index.verifier_index()
    host = ("combined_table_d1", "sorted_multiset", "zk_patch", "aggregation")
    with HostClock(lookup_mod, host) as clock:
        proof, prove_s = wall(lambda: create_proof(index, witness, TestRng(SEED + 32),
                                                   runtime_tables=tables), device)
    times[f"prove_{tag}_ms"] = prove_s * 1e3
    times[f"prove_{tag}_host_lookup_ms"] = sum(clock.seconds.values()) * 1e3
    times[f"prove_{tag}_rest_ms"] = (prove_s - sum(clock.seconds.values())) * 1e3
    for name, secs in clock.seconds.items():
        times[f"prove_{tag}_{name}_ms"] = secs * 1e3
    ok, verify_s = wall(lambda: kimchi_verify(vk, proof, [], TestRng(SEED + 33)), device)
    times[f"verify_{tag}_ms"] = verify_s * 1e3
    if not ok:
        raise AssertionError(f"verify rejected the honest {tag} proof")
    bad = copy.deepcopy(proof)
    bad.evals.lookup_sorted[0].zeta[0] = (bad.evals.lookup_sorted[0].zeta[0] + 1) % Fp.p
    if kimchi_verify(vk, bad, [], TestRng(SEED + 34)):
        raise AssertionError(f"verify accepted the {tag} proof with a changed sorted evaluation")
    wrong = [list(c) for c in witness]
    if runtime:
        tables, why = [(1, tables[0][1])], "inconsistent"
    else:
        wrong[2][1], why = 9999, "not in table"  # (x, 9999) is no entry of (x, x^2)
    try:
        create_proof(index, wrong, TestRng(SEED + 35), runtime_tables=tables)
    except ValueError as e:
        if why not in str(e):
            raise
    else:
        raise AssertionError(f"the {tag} prover accepted a bad witness ({why})")
    log(f"check: the {tag} proof ({LOOKUP_ROWS} Lookup rows, a table of {LOOKUP_TABLE} "
        f"entries, k = {log_n}) verifies and is rejected with a changed sorted evaluation; "
        f"the prover raises ValueError ({why}) as the JAX package does")
    return {f"{tag}_index": index, f"{tag}_vk": vk, f"{tag}_proof": proof}


VECTOR_PROOFS = {"always-on gadgets": ("tests/vectors/proof_gates_2^5.bin", 32),
                 "optional gates": ("tests/vectors/proof_optional_2^13.bin", 1 << 13)}
VECTOR_VK = "tests/vectors/vk_optional_2^13.bin"


def vectors_path(run, device) -> dict:
    """The committed proofs of the gadget circuits, made by the JAX package
    on the CPU (tests/test_torch_gates_prove.py, test_torch_optional_vectors.py):
    gate_mix.always_on_circuit over 32 points and gate_mix.optional_circuit
    over 8,192 (both fixed lookup tables), each over the first points of the
    path's SRS with TestRng of its seed. The port's proof bytes and, for the
    optional circuit, its verifier-index file must equal the vectors; each
    proof verifies and is rejected with one selector evaluation changed."""
    import copy
    import pathlib

    from proof_systems_tpu_torch.circuits import gate_mix
    from proof_systems_tpu_torch.circuits.constraints import ConstraintSystem
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.poly_commitment.srs import SRS
    from proof_systems_tpu_torch.prover import create_proof
    from proof_systems_tpu_torch.prover_index import ProverIndex
    from proof_systems_tpu_torch.serialization import serialize_proof
    from proof_systems_tpu_torch.utils.rng import TestRng
    from proof_systems_tpu_torch.verifier import verify as kimchi_verify

    root = pathlib.Path(__file__).resolve().parent
    times = run["times"]
    for tag, (gates, witness), seed, changed in (
            ("always-on gadgets", gate_mix.always_on_circuit(gate_mix.ALWAYS_ON_SEED),
             gate_mix.ALWAYS_ON_SEED, "poseidon_selector"),
            ("optional gates", gate_mix.optional_circuit(gate_mix.OPTIONAL_SEED),
             gate_mix.OPTIONAL_SEED, "rot_selector")):
        vector, n = VECTOR_PROOFS[tag]
        srs = SRS(Vesta, run["srs"].g[:n], run["srs"].h, device)
        key = tag.split()[0].replace("-", "_")

        def build():
            cs = ConstraintSystem.create(Fp, gates, public=0, max_poly_size=n, device=device)
            return ProverIndex(cs, Vesta, srs)

        index, times[f"index_vector_{key}_s"] = wall(build, device)
        proof, prove_s = wall(lambda: create_proof(index, witness, TestRng(seed)), device)
        times[f"prove_vector_{key}_ms"] = prove_s * 1e3
        if serialize_proof(Vesta, proof) != (root / vector).read_bytes():
            raise AssertionError(f"the {tag} proof differs from {vector}")
        vk = index.verifier_index()
        if tag == "optional gates":
            out = root / "build" / "vk"
            out.mkdir(parents=True, exist_ok=True)
            vk.to_file(out / "vk_optional_2^13.bin")
            if (out / "vk_optional_2^13.bin").read_bytes() != (root / VECTOR_VK).read_bytes():
                raise AssertionError(f"the optional verifier-index file differs from {VECTOR_VK}")
        if not kimchi_verify(vk, proof, [], TestRng(seed + 1)):
            raise AssertionError(f"verify rejected the {tag} vector proof")
        bad = copy.deepcopy(proof)
        pt = getattr(bad.evals, changed)
        pt.zeta[0] = (pt.zeta[0] + 1) % Fp.p
        if kimchi_verify(vk, bad, [], TestRng(seed + 2)):
            raise AssertionError(f"verify accepted the {tag} proof with a changed {changed}")
        log(f"check: the {tag} proof (n = {n}) equals {vector} byte for byte"
            + (f", its verifier-index file {VECTOR_VK}" if tag == "optional gates" else "")
            + f"; it verifies and is rejected with a changed {changed} evaluation")
    return {}


# The gate mix of foreign-field ECDSA and Keccak gadgets at full width
# (gate_mix.gate_mix_circuit), as many blocks as keep the domain at 2^k.
OPT_SEED = SEED + 60


def lookup_count(lcs) -> int:
    """The lookups a witness makes: one a lookup of each pattern's row."""
    return sum(sum(sel) * len(pat.lookups()) for pat, sel in lcs.selectors_d1.items())


def optional_path(run, log_n: int, device) -> dict:
    """The gate mix at k = log_n over the path's SRS: ConstraintSystem.create
    and ProverIndex (timed), a proof of the fillers' witness with the host
    time of the lookup argument's stages apart from the rest, verified,
    rejected with a changed ForeignFieldMul selector evaluation."""
    import copy

    from proof_systems_tpu_torch.circuits import gate_mix
    from proof_systems_tpu_torch.circuits import lookup as lookup_mod
    from proof_systems_tpu_torch.circuits.constraints import ConstraintSystem
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.prover import create_proof
    from proof_systems_tpu_torch.prover_index import ProverIndex
    from proof_systems_tpu_torch.utils.rng import TestRng
    from proof_systems_tpu_torch.verifier import verify as kimchi_verify

    n, times = 1 << log_n, run["times"]
    (gates, witness, blocks), fill_s = wall(
        lambda: gate_mix.gate_mix_circuit(n - 3, OPT_SEED), device)
    times["opt_witness_fill_s"] = fill_s

    def build():
        cs = ConstraintSystem.create(Fp, gates, public=0, max_poly_size=n, device=device)
        return ProverIndex(cs, Vesta, run["srs"])

    index, times["index_opt_s"] = wall(build, device)
    cs = index.cs
    if cs.domain.d1.n != n or len(cs.feature_flags) != 6:
        raise AssertionError(f"the gate-mix index: domain {cs.domain.d1.n}, "
                             f"flags {sorted(g.name for g in cs.feature_flags)}")
    lookups = lookup_count(cs.lookup_cs)
    log(f"gate mix: {blocks} blocks of {gate_mix.BLOCK_ROWS} rows ({len(gates)} gates), "
        f"{lookups} lookups, patterns {[p.value for p in cs.lookup_cs.info.patterns]}")
    vk = index.verifier_index()
    host = ("combined_table_d1", "sorted_multiset", "zk_patch", "aggregation")
    with HostClock(lookup_mod, host) as clock:
        proof, prove_s = wall(lambda: create_proof(index, witness, TestRng(OPT_SEED)), device)
    times["prove_opt_ms"] = prove_s * 1e3
    times["prove_opt_host_lookup_ms"] = sum(clock.seconds.values()) * 1e3
    times["prove_opt_rest_ms"] = (prove_s - sum(clock.seconds.values())) * 1e3
    for name, secs in clock.seconds.items():
        times[f"prove_opt_{name}_ms"] = secs * 1e3
    ok, verify_s = wall(lambda: kimchi_verify(vk, proof, [], TestRng(OPT_SEED + 1)), device)
    times["verify_opt_ms"] = verify_s * 1e3
    if not ok:
        raise AssertionError("verify rejected the honest gate-mix proof")
    bad = copy.deepcopy(proof)
    pt = bad.evals.foreign_field_mul_selector
    pt.zeta[0] = (pt.zeta[0] + 1) % Fp.p
    if kimchi_verify(vk, bad, [], TestRng(OPT_SEED + 2)):
        raise AssertionError("verify accepted the gate-mix proof with a changed "
                             "foreign_field_mul_selector evaluation")
    log(f"check: the gate-mix proof (k = {log_n}, {blocks} blocks, {lookups} lookups, every "
        "optional gate) verifies and is rejected with a changed foreign_field_mul_selector "
        "evaluation")
    return dict(optional_index=index, optional_vk=vk, optional_proof=proof,
                optional_witness=witness)


def optional_steady(run, device) -> None:
    """prove_ms and the peak device memory of one more gate-mix proof with no
    recorder holding copies of kernel inputs; then one proof with the tracer
    on (a synchronize before every checkpoint) and CUDA events around the
    quotient's d8 transforms and its walk."""
    from proof_systems_tpu_torch.circuits import expr
    from proof_systems_tpu_torch.prover import create_proof
    from proof_systems_tpu_torch.utils.rng import TestRng
    from proof_systems_tpu_torch.utils.tracing import TRACER

    index, times = run["optional_index"], run["times"]

    def prove():
        return create_proof(index, run["optional_witness"], TestRng(OPT_SEED))

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    _, prove_s = wall(prove, device)
    times["prove_opt_steady_ms"] = prove_s * 1e3
    if device.type == "cuda":
        times["opt_proof_peak_gib"] = (torch.cuda.max_memory_allocated(device) - base) / 2**30
        d8 = index.cs.domain.d8
        TRACER.enable(hook=lambda: sync(device))
        with Clock([(d8, "ntt_t", "d8_ntt"), (d8, "intt_t", "d8_ntt"),
                    (expr, "eval_dev", "walk")]) as clock:
            prove()
        TRACER.disable()
        for label, ms in clock.totals().items():
            times[f"prove_opt_quotient_{label}_ms"] = ms
        stage_of, stage = {cp: st for st, cp in PROOF_STAGES}, None
        for name, secs in TRACER.intervals():
            stage = stage_of.get(name, stage)
            times[f"prove_opt_{stage}_ms"] = times.get(f"prove_opt_{stage}_ms", 0.0) + secs * 1e3


def peak_gib(device, reset: bool = False) -> float:
    """Peak device memory since the last reset, GiB (0 on the CPU); with
    reset, start a new peak."""
    if device.type != "cuda":
        return 0.0
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.max_memory_allocated(device) / 2**30


# The column phase (o1vm/pickles.py, o1vm/logup.py) at k = 16: the toy cyclic
# trace of tests/test_o1vm_pickles.py widened to 2^16 rows with a boundary row;
# a LogupInstance over range_table(16, 2^16) with two lookups a row; a
# MultiLogup over bitwise_table(1, bits=4) with the joint combiner.
COL_SEED = SEED + 90
COL_LOOKUPS_PER_ROW = 2
COL_BITWISE_BITS = 4


def column_cases(n: int, device):
    """The three column proofs' inputs: name -> (columns (8, C, n) on the
    device, constraints, prove keywords, verify keywords, a make_host
    function that builds the beta columns' host inputs or None, and the
    phase-1 column count whose commitments are held against the host MSM)."""
    from proof_systems_tpu_torch.circuits import expr as E
    from proof_systems_tpu_torch.circuits.domains import EvaluationDomains
    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.o1vm import logup
    from proof_systems_tpu_torch.o1vm.pickles import col
    from proof_systems_tpu_torch.ops import limb

    p, F = Fp.p, limb.device_field(Fp)
    rng = random.Random(COL_SEED)
    omega = EvaluationDomains.create(Fp, n, device=device).d1.group_gen
    cell = lambda i, row=E.CURR: E.Cell(col(i), row)  # noqa: E731
    cases = {}

    c0 = [1] * n
    for i in range(1, n):
        c0[i] = c0[i - 1] * omega % p
    c1 = [rng.randrange(p) for _ in range(n)]
    c2 = [a * b % p for a, b in zip(c0, c1)]
    cases["cyclic"] = dict(
        cols=F.pack_mont(c0 + c1 + c2, shape=(3, n), device=device),
        constraints=[cell(2) - cell(0) * cell(1), cell(0, E.NEXT) - E.Literal(omega) * cell(0),
                     E.UnnormalizedLagrangeBasis(0) * (cell(0) - E.Literal(1))],
        kw={}, vkw={}, host=3)

    bits = min(16, n.bit_length() - 1)  # 16 at k = 16; smaller domains for rehearsals
    table = logup.range_table(bits, n)
    lookups = [[rng.randrange(1 << bits) for _ in range(COL_LOOKUPS_PER_ROW)] for _ in range(n)]
    inst = logup.LogupInstance(Fp, lookups, table)
    cols1 = inst.phase1_columns()
    cases["logup"] = dict(
        cols=F.pack_mont([v for c in cols1 for v in c], shape=(len(cols1), n), device=device),
        constraints=[inst.constraint()], kw=dict(make_beta_columns=inst.make_beta_columns(F, device)),
        vkw=dict(num_beta_columns=1), host=len(cols1))

    wbits = COL_BITWISE_BITS if 4 << (2 * COL_BITWISE_BITS) <= n else 2
    mask = (1 << wbits) - 1
    fns = (lambda a, b: a & b, lambda a, b: a | b, lambda a, b: a ^ b,
           lambda a, b: mask - (a | b))
    trace = [[], [], [], []]
    for _ in range(n):
        op, x, y = rng.randrange(4), rng.randrange(mask + 1), rng.randrange(mask + 1)
        for t, v in zip(trace, (op, x, y, fns[op](x, y))):
            t.append(v)
    spec = logup.LookupSpec(1, E.Literal(1), [cell(j) for j in range(4)])
    ml = logup.MultiLogup(Fp, [spec], [logup.bitwise_table(1, bits=wbits)], n, 4)
    cases["multilogup"] = dict(
        cols=None, trace=trace, ml=ml, constraints=ml.constraints(),
        kw=dict(make_beta_columns=ml.make_phase2(F, device), with_joint_combiner=True),
        vkw=dict(num_beta_columns=ml.num_phase2, with_joint_combiner=True), host=0)
    return cases


def column_path(run, log_n: int, device, nat) -> dict:
    """o1vm's column prover at k = 16 over the path's SRS, three proofs
    (column_cases): each proved (prove_col_ms, with the host's phase-1, phi
    and h stages apart, peak device memory, launches), verified
    (verify_col_ms), and rejected with one changed zeta evaluation; the
    cyclic trace's and the LogUp instance's phase-1 commitments against
    the native host MSM over g ++ [h] (blinder 1); the MultiLogup's table
    columns found by verify_tables."""
    import copy

    from proof_systems_tpu_torch.circuits.domains import EvaluationDomains
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.o1vm import logup
    from proof_systems_tpu_torch.o1vm.pickles import prove_columns, verify_columns
    from proof_systems_tpu_torch.ops import kernels, limb
    from proof_systems_tpu_torch.utils.rng import TestRng

    n, srs, times = 1 << log_n, run["srs"], run["times"]
    F = limb.device_field(Fp)
    domain = EvaluationDomains.create(Fp, n, device=device)
    t0 = time.perf_counter()
    cases = column_cases(n, device)
    times["col_inputs_s"] = time.perf_counter() - t0
    basis = srs.g + [srs.h]
    card = card_line() if device.type == "cuda" else "CPU"
    out = {}
    for k, (name, case) in enumerate(cases.items()):
        host = ("phi_column",) if name == "logup" else ()
        with HostClock(logup, host) as clock, HostClock(logup.MultiLogup,
                                                        ("phase1_columns", "phase2_host")) as mclock:
            if case["cols"] is None:  # the MultiLogup's phase 1 runs on the host first
                cols1 = case["ml"].phase1_columns(case["trace"])
                case["cols"] = F.pack_mont([v for c in cols1 for v in c],
                                           shape=(len(cols1), n), device=device)
            peak_gib(device, reset=True)
            before = kernels.launch_counts()
            proof, prove_s = wall(lambda: prove_columns(
                domain, srs, Vesta, case["cols"], case["constraints"], TestRng(COL_SEED + k),
                device=device, **case["kw"]), device)
        counts = {key: v - before[key] for key, v in kernels.launch_counts().items()}
        peak = peak_gib(device)
        host_s = {**clock.seconds, **mclock.seconds}
        times[f"prove_col_{name}_ms"] = prove_s * 1e3
        for stage, secs in host_s.items():
            if secs:
                times[f"prove_col_{name}_{stage}_ms"] = secs * 1e3
        times[f"prove_col_{name}_rest_ms"] = (prove_s - host_s.get("phi_column", 0.0)
                                              - host_s.get("phase2_host", 0.0)) * 1e3
        times[f"peak_col_{name}_gib"] = peak
        log(f"column {name}: {case['cols'].shape[1]} phase-1 columns, {len(proof.commitments)} "
            f"in all, launches {json.dumps(counts)}")
        ok, verify_s = wall(lambda: verify_columns(domain, srs, Vesta, case["constraints"], proof,
                                                   TestRng(COL_SEED + 10 + k), **case["vkw"]),
                            device)
        times[f"verify_col_{name}_ms"] = verify_s * 1e3
        if not ok:
            raise AssertionError(f"verify_columns rejected the honest {name} proof")
        bad = copy.deepcopy(proof)
        bad.zeta_evaluations[0] = (bad.zeta_evaluations[0] + 1) % Fp.p
        if verify_columns(domain, srs, Vesta, case["constraints"], bad, TestRng(COL_SEED + 20 + k),
                          **case["vkw"]):
            raise AssertionError(f"verify_columns accepted the {name} proof with a changed "
                                 "zeta evaluation")
        if case["host"]:
            coeffs = limb.from_mont(F, domain.d1.intt(case["cols"][:, : case["host"]]))
            rows = limb.limbs_to_ints(coeffs)
            jobs = [rows[i * n:(i + 1) * n] + [1] for i in range(case["host"])]
            with concurrent.futures.ThreadPoolExecutor(8) as pool:
                want = list(pool.map(lambda sc: nat.msm(sc, basis), jobs))
            if [c.chunks for c in proof.commitments[: case["host"]]] != [[w] for w in want]:
                raise AssertionError(f"the {name} commitments differ from the host MSM")
        if name == "multilogup" and not case["ml"].verify_tables(domain, srs, proof):
            raise AssertionError("verify_tables did not find the bitwise table in the proof")
        inside = ", ".join(f"{stage} {secs * 1e3:.1f}" for stage, secs in host_s.items()
                           if secs and stage != "phase1_columns")
        before_ms = host_s.get("phase1_columns", 0.0) * 1e3
        log(f"column {name}: prove_col_ms {prove_s * 1e3:.1f} (on the host: {inside or 'none'})"
            + (f", phase1_columns before it {before_ms:.1f}" if before_ms else "")
            + f", verify_col_ms {verify_s * 1e3:.1f}, peak {peak:.2f} GiB [{card}]")
        log(f"check: the {name} column proof (n = {n}) verifies and is rejected with a changed "
            "zeta evaluation" + (f"; its {case['host']} phase-1 commitments equal the host MSM"
                                 if case["host"] else "; verify_tables finds the table"))
        out[f"col_{name}_proof"] = proof
        del case["cols"]
    return out


# o1vm's Keccak-f and RV32IM proofs (o1vm/keccak.py, o1vm/riscv.py). The
# vector cases are the JAX package's proofs on the CPU at the inputs of its
# heavy end-to-end tests (tests/test_torch_column_vectors.py); the full-width
# RV32IM case runs rv_loop_program for n / 2 steps at the default Layout(4)
# on a domain of 2^RV_LOG_N rows.
COLUMN_VECTORS = {"keccak": "tests/vectors/column_keccak_2^5",
                  "riscv": "tests/vectors/column_riscv_2^8",
                  "mips": "tests/vectors/column_mips_2^8",
                  "mips_cannon": "tests/vectors/column_mips_cannon_2^9"}
RV_LOG_N = 14
# the full-width RV32IM case's domain inside the whole script, which also
# runs MIPS's at 2^MIPS_LOG_N (`--only riscv` runs RV_LOG_N or --log-n)
RV_COMBINED_LOG_N = 12
RV_SEED = SEED + 110
# The kernels an n = 32 Keccak proof launches: the column phase's but the
# endo ladder (an opening of 32 points has no fold step) and K12 (its rows of
# 256 elements go to K5).
KECCAK_KERNELS = tuple(k for k in COLUMN_KERNELS
                       if k not in ("endo_ladder", "mont_prefix_scan_parts"))


def rv_loop_program():
    """A loop of RV32IM instructions, run until execute's default of n / 2
    steps: every instruction of riscv.OPS (the ALU with registers and
    immediates, shifts by constants and by registers of 0 to 31, the M
    extension with DIVU and REMU by zero every 32nd pass, word, half-word
    and byte stores and loads over 16 words, every branch taken and not,
    JAL, and JALR to an odd target), then a jump back."""
    from proof_systems_tpu_torch.o1vm.riscv import Instr as I  # noqa: E741

    body = [
        I("ADDI", rd=1, rs1=1, imm=1), I("ADD", rd=2, rs1=2, rs2=1), I("SUB", rd=4, rs1=3, rs2=2),
        I("SLT", rd=5, rs1=4, rs2=1), I("SLTU", rd=6, rs1=4, rs2=1), I("SLTI", rd=7, rs1=4, imm=-2),
        I("SLTIU", rd=8, rs1=1, imm=100), I("XOR", rd=9, rs1=2, rs2=4),
        I("OR", rd=10, rs1=9, rs2=1), I("AND", rd=11, rs1=10, rs2=2),
        I("XORI", rd=12, rs1=11, imm=-1), I("ORI", rd=13, rs1=1, imm=0x700),
        I("ANDI", rd=14, rs1=2, imm=255), I("SLLI", rd=15, rs1=1, imm=4),
        I("SRLI", rd=16, rs1=2, imm=3), I("SRAI", rd=17, rs1=4, imm=2),
        I("ANDI", rd=18, rs1=1, imm=31), I("SLL", rd=19, rs1=2, rs2=18),
        I("SRL", rd=20, rs1=4, rs2=18), I("SRA", rd=21, rs1=4, rs2=18), I("AUIPC", rd=22, imm=1),
        I("MUL", rd=23, rs1=2, rs2=4), I("MULH", rd=24, rs1=4, rs2=2),
        I("MULHU", rd=25, rs1=4, rs2=2), I("MULHSU", rd=26, rs1=4, rs2=2),
        I("DIV", rd=27, rs1=4, rs2=1), I("DIVU", rd=28, rs1=2, rs2=18),
        I("REM", rd=29, rs1=4, rs2=1), I("REMU", rd=30, rs1=2, rs2=18),
        I("ANDI", rd=31, rs1=1, imm=15), I("SLLI", rd=31, rs1=31, imm=2),
        I("SW", rs1=31, rs2=2, imm=64), I("LW", rd=5, rs1=31, imm=64),
        I("SB", rs1=31, rs2=4, imm=65), I("LB", rd=6, rs1=31, imm=65),
        I("SH", rs1=31, rs2=9, imm=66), I("LHU", rd=7, rs1=31, imm=66),
        I("LBU", rd=8, rs1=31, imm=67), I("LH", rd=9, rs1=31, imm=66),
        I("BEQ", rs1=1, rs2=0, imm=8), I("BNE", rs1=1, rs2=0, imm=8),
        I("ADDI", rd=10, rs1=0, imm=77),
        I("BLT", rs1=4, rs2=1, imm=8), I("ADDI", rd=10, rs1=10, imm=1),
        I("BGE", rs1=4, rs2=1, imm=8), I("ADDI", rd=11, rs1=11, imm=1),
        I("BLTU", rs1=1, rs2=4, imm=8), I("ADDI", rd=12, rs1=12, imm=1),
        I("BGEU", rs1=1, rs2=4, imm=8), I("ADDI", rd=13, rs1=13, imm=1),
        I("JAL", rd=14, imm=8), I("ADDI", rd=14, rs1=0, imm=99),
        I("AUIPC", rd=15, imm=0), I("JALR", rd=16, rs1=15, imm=13),
        I("ADDI", rd=16, rs1=0, imm=99), I("FENCE"), I("ECALL"),
    ]
    head = [I("ADDI", rd=1, rs1=0, imm=0), I("LUI", rd=2, imm=0x12345),
            I("ADDI", rd=3, rs1=0, imm=-7)]
    return head + body + [I("JAL", rd=0, imm=-4 * len(body))]


# MIPS's full-width case: mips_loop_program over 2^MIPS_LOG_N rows at the
# default Layout(4), its preimage oracle one key of MIPS_KEY_WORD eight times;
# inside the whole script over 2^MIPS_COMBINED_LOG_N rows, for its clock
# (`--only mips` runs MIPS_LOG_N or --log-n).
MIPS_LOG_N = 14
MIPS_COMBINED_LOG_N = 12
MIPS_SEED = SEED + 130
MIPS_KEY_WORD = 0x0A0B0C0D
MIPS_KEY_ADDR = 0x4300
MIPS_PREIMAGES = {MIPS_KEY_WORD.to_bytes(4, "big") * 8: b"o1vm on H100"}


def mips_loop_program(steps: int):
    """A MIPS program of exactly `steps` steps whose last is exit_group: a
    head (constants, the preimage key stored and written to fd 6 eight
    times), a loop body run as often as it fits, SYNC padding, then
    exit_group(3). The body runs every op of mips.OPS: the ALU with
    registers and immediates, shifts by constants and by registers of 0 to
    31, MULT/MULTU, DIV and DIVU (by zero every 32nd pass), MTHI/MTLO,
    MOVZ/MOVN, word and sub-word loads and stores (LWL/LWR/SWL/SWR, LL/SC)
    over 16 words (data from 0x4000, above the code, which the Cannon VM
    keeps in the same memory; LBU and LHU read values below their top bit,
    which the JAX package's constraints, copied, cannot prove: ROADMAP
    Queue 3), every branch taken or not, J, JAL, JR and JALR; then a
    syscall of each kind but exit (mmap with and without an address, brk,
    clone, the fcntl cases, stdout, hint and bad-fd writes, stdin, hint and
    bad-fd reads, an unknown number) and a preimage key write of one word
    (the key stays MIPS_KEY_WORD eight times) with four reads of its stream,
    one unaligned."""
    from proof_systems_tpu_torch.o1vm import mips
    from proof_systems_tpu_torch.o1vm.mips import Instr as I  # noqa: E741

    def build(passes: int, pad: int):
        head = [I("ADDIU", rt=27, rs=0, imm=-1), I("ADDIU", rt=28, rs=0, imm=1),
                I("ADDIU", rt=3, rs=0, imm=passes),
                I("LUI", rt=5, imm=MIPS_KEY_WORD >> 16),
                I("ORI", rt=5, rs=5, imm=MIPS_KEY_WORD & 0xFFFF),
                I("SW", rt=5, rs=0, imm=MIPS_KEY_ADDR),
                I("ADDIU", rt=4, rs=0, imm=6), I("ADDIU", rt=5, rs=0, imm=MIPS_KEY_ADDR),
                I("ADDIU", rt=6, rs=0, imm=4)]
        for _ in range(8):
            head += [I("ADDIU", rt=2, rs=0, imm=mips.SYS_WRITE), I("SYSCALL")]
        top = len(head)
        body = [
            I("ADDIU", rt=1, rs=1, imm=1), I("ADDU", rd=8, rs=1, rt=1), I("ADD", rd=9, rs=8, rt=1),
            I("SUBU", rd=10, rs=0, rt=1), I("SUB", rd=11, rs=9, rt=8),
            I("ADDI", rt=12, rs=10, imm=-5), I("LUI", rt=13, imm=0x7654),
            I("ORI", rt=13, rs=13, imm=0x4321), I("ADDU", rd=13, rs=13, rt=1),
            I("SLT", rd=14, rs=10, rt=1), I("SLTU", rd=14, rs=10, rt=1),
            I("SLTI", rt=14, rs=10, imm=-3), I("SLTIU", rt=14, rs=1, imm=50),
            I("SLL", rd=15, rt=13, imm=3), I("SRL", rd=15, rt=13, imm=5),
            I("SRA", rd=15, rt=10, imm=7), I("ANDI", rt=16, rs=1, imm=31),
            I("SLLV", rd=17, rs=16, rt=13), I("SRLV", rd=17, rs=16, rt=13),
            I("SRAV", rd=17, rs=16, rt=10), I("MULT", rs=10, rt=13), I("MFLO", rd=18),
            I("MFHI", rd=19), I("MULTU", rs=10, rt=13), I("MFHI", rd=19),
            I("AND", rd=20, rs=13, rt=1), I("OR", rd=20, rs=20, rt=10),
            I("XOR", rd=21, rs=20, rt=13), I("NOR", rd=21, rs=21, rt=1),
            I("ANDI", rt=22, rs=13, imm=0xFF0F), I("XORI", rt=22, rs=22, imm=0x5555),
            I("DIV", rs=10, rt=16), I("MFLO", rd=18), I("DIVU", rs=13, rt=16), I("MFHI", rd=19),
            I("MTHI", rs=1), I("MTLO", rs=13), I("MFLO", rd=18),
            I("MOVZ", rd=23, rs=13, rt=16), I("MOVN", rd=23, rs=1, rt=16), I("SYNC"),
            I("ANDI", rt=24, rs=1, imm=15), I("SLL", rd=24, rt=24, imm=2),
            I("SW", rt=13, rs=24, imm=0x4100), I("LW", rt=25, rs=24, imm=0x4100),
            I("SB", rt=10, rs=24, imm=0x4101), I("LB", rt=25, rs=24, imm=0x4101),
            I("LBU", rt=25, rs=24, imm=0x4100), I("SH", rt=10, rs=24, imm=0x4102),
            I("LH", rt=25, rs=24, imm=0x4102), I("LHU", rt=25, rs=24, imm=0x4100),
            I("LWL", rt=25, rs=24, imm=0x4102), I("LWR", rt=25, rs=24, imm=0x4101),
            I("SWL", rt=13, rs=24, imm=0x4141), I("SWR", rt=13, rs=24, imm=0x4142),
            I("LL", rt=26, rs=24, imm=0x4140), I("SC", rt=26, rs=24, imm=0x4144),
            # branches: each delay slot runs, a taken branch skips one op
            I("BEQ", rs=1, rt=0, imm=1), I("SYNC"),
            I("BNE", rs=28, rt=0, imm=1), I("ADDIU", rt=29, rs=0, imm=1),
            I("ADDIU", rt=29, rs=0, imm=99),
            I("BLTZ", rs=27, imm=1), I("SYNC"), I("SYNC"),
            I("BGEZ", rs=27, imm=1), I("SYNC"),
            I("BLEZ", rs=0, imm=1), I("SYNC"), I("SYNC"),
            I("BGTZ", rs=27, imm=1), I("SYNC"),
            I("BLTZAL", rs=27, imm=1), I("SYNC"), I("SYNC"),
            I("BGEZAL", rs=28, imm=1), I("SYNC"), I("SYNC"),
        ]
        at = top + len(body)  # word index of the next op
        body += [I("J", imm=at + 3), I("SYNC"), I("SYNC"),
                 I("JAL", imm=at + 6), I("SYNC"), I("SYNC"),
                 I("ADDIU", rt=30, rs=0, imm=4 * (at + 10)), I("JR", rs=30), I("SYNC"),
                 I("SYNC"),
                 I("ADDIU", rt=30, rs=0, imm=4 * (at + 14)), I("JALR", rd=29, rs=30),
                 I("SYNC"), I("SYNC")]

        def call(num, *sets):
            """Set the (register, value) pairs, then v0 = num and SYSCALL."""
            return [I("ADDIU", rt=r, rs=0, imm=v) for r, v in sets] + [
                I("ADDIU", rt=2, rs=0, imm=num), I("SYSCALL")]

        body += (call(mips.SYS_MMAP, (4, 0), (5, 5000)) + call(mips.SYS_MMAP, (4, 0x3000))
                 + call(mips.SYS_BRK) + call(mips.SYS_CLONE)
                 + call(mips.SYS_FCNTL, (4, 5), (5, 3)) + call(mips.SYS_FCNTL, (4, 1))
                 + call(mips.SYS_FCNTL, (4, 9)) + call(mips.SYS_FCNTL, (5, 1))
                 + call(mips.SYS_WRITE, (4, 1), (5, 0x4200), (6, 5))
                 + call(mips.SYS_WRITE, (4, 4)) + call(mips.SYS_WRITE, (4, 9))
                 + call(mips.SYS_READ, (4, 0)) + call(mips.SYS_READ, (4, 3))
                 + call(mips.SYS_READ, (4, 9)) + call(4999)
                 + call(mips.SYS_WRITE, (4, 6), (5, MIPS_KEY_ADDR), (6, 4))
                 + call(mips.SYS_READ, (4, 5), (5, 0x4220)) + call(mips.SYS_READ, (5, 0x4224))
                 + call(mips.SYS_READ, (5, 0x422A)) + call(mips.SYS_READ, (5, 0x422C)))
        back = top - (top + len(body) + 2)  # the BNE's target, relative to its delay slot
        body += [I("ADDIU", rt=3, rs=3, imm=-1), I("BNE", rs=3, rt=0, imm=back), I("SYNC")]
        return head + body + [I("SYNC")] * pad + [
            I("ADDIU", rt=2, rs=0, imm=mips.SYS_EXIT), I("ADDIU", rt=4, rs=0, imm=3),
            I("SYSCALL")]

    def count(program):
        rows, state = mips.execute(program, 1 << 20, preimages=MIPS_PREIMAGES)
        assert state["exited"], "the loop program did not reach exit_group"
        return len(rows)

    base = count(build(1, 0))
    per_pass = count(build(2, 0)) - base
    passes = 1 + (steps - base) // per_pass
    program = build(passes, steps - base - (passes - 1) * per_pass)
    assert passes >= 1 and count(program) == steps
    return program


def mips_encode(ins) -> int:
    """A MIPS instruction word of an Instr (the inverse of mips.decode), for
    loading a program into the Cannon VM's memory."""
    r_funct = {"SLL": 0x00, "SRL": 0x02, "SRA": 0x03, "SLLV": 0x04, "SRLV": 0x06, "SRAV": 0x07,
               "JR": 0x08, "JALR": 0x09, "MOVZ": 0x0A, "MOVN": 0x0B, "SYSCALL": 0x0C,
               "SYNC": 0x0F, "MFHI": 0x10, "MTHI": 0x11, "MFLO": 0x12, "MTLO": 0x13,
               "MULT": 0x18, "MULTU": 0x19, "DIV": 0x1A, "DIVU": 0x1B, "ADD": 0x20,
               "ADDU": 0x21, "SUB": 0x22, "SUBU": 0x23, "AND": 0x24, "OR": 0x25, "XOR": 0x26,
               "NOR": 0x27, "SLT": 0x2A, "SLTU": 0x2B}
    i_opcode = {"BEQ": 0x04, "BNE": 0x05, "BLEZ": 0x06, "BGTZ": 0x07, "ADDI": 0x08,
                "ADDIU": 0x09, "SLTI": 0x0A, "SLTIU": 0x0B, "ANDI": 0x0C, "ORI": 0x0D,
                "XORI": 0x0E, "LUI": 0x0F, "LB": 0x20, "LH": 0x21, "LWL": 0x22, "LW": 0x23,
                "LBU": 0x24, "LHU": 0x25, "LWR": 0x26, "SB": 0x28, "SH": 0x29, "SWL": 0x2A,
                "SW": 0x2B, "SWR": 0x2E, "LL": 0x30, "SC": 0x38}
    regimm = {"BLTZ": 0x00, "BGEZ": 0x01, "BLTZAL": 0x10, "BGEZAL": 0x11}
    if ins.op in r_funct:
        sa = ins.imm if ins.op in ("SLL", "SRL", "SRA") else 0
        return (ins.rs << 21) | (ins.rt << 16) | (ins.rd << 11) | (sa << 6) | r_funct[ins.op]
    if ins.op in regimm:
        return (0x01 << 26) | (ins.rs << 21) | (regimm[ins.op] << 16) | (ins.imm & 0xFFFF)
    if ins.op in ("J", "JAL"):
        return ({"J": 0x02, "JAL": 0x03}[ins.op] << 26) | ins.imm
    return (i_opcode[ins.op] << 26) | (ins.rs << 21) | (ins.rt << 16) | (ins.imm & 0xFFFF)


def column_vector(name: str) -> tuple[bytes, dict]:
    """A committed column-proof vector: its .bin bytes and its .json."""
    import pathlib

    stem = pathlib.Path(__file__).resolve().parent / COLUMN_VECTORS[name]
    return stem.with_suffix(".bin").read_bytes(), json.loads(stem.with_suffix(".json").read_text())


def keccak_path(run, device) -> dict:
    """o1vm's Keccak-f proof of tests/test_keccak.py's statement (n = 32,
    4,225 columns, the first 32 points of the path's SRS, TestRng(61)):
    every field equal to tests/vectors/column_keccak_2^5 (the JAX package's
    proof), final state as its statement says; verified, rejected with a
    changed final and a changed initial state. prove_keccak_ms and
    verify_keccak_ms with the host sponge's absorptions apart, and the
    proof's peak device memory."""
    from proof_systems_tpu_torch.circuits.domains import EvaluationDomains
    from proof_systems_tpu_torch.convert import column_proof_fields
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.o1vm import keccak
    from proof_systems_tpu_torch.poly_commitment.srs import SRS
    from proof_systems_tpu_torch.poseidon.sponge import FqSponge
    from proof_systems_tpu_torch.serialization import serialize_column_proof
    from proof_systems_tpu_torch.utils.rng import TestRng

    raw, st = column_vector("keccak")
    n, times = st["n"], run["times"]
    srs = SRS(Vesta, run["srs"].g[:n], run["srs"].h, device)
    domain = EvaluationDomains.create(Fp, n, device=device)
    peak_gib(device, reset=True)
    with HostClock(FqSponge, ("absorb_g",)) as clock:
        (proof, final), secs = wall(lambda: keccak.prove_keccak(
            domain, srs, Vesta, st["state0"], TestRng(61), device=device), device)
    times["peak_keccak_gib"] = peak_gib(device)
    times["prove_keccak_ms"] = secs * 1e3
    times["prove_keccak_absorb_ms"] = clock.seconds["absorb_g"] * 1e3
    if final != st["final"]:
        raise AssertionError("prove_keccak's final state differs from the vector's")
    if serialize_column_proof(Vesta, column_proof_fields(proof)) != raw:
        raise AssertionError(f"the Keccak proof differs from {COLUMN_VECTORS['keccak']}")

    def verify(state0, fin, seed):
        return keccak.verify_keccak(domain, srs, Vesta, proof, state0, fin, TestRng(seed),
                                    device=device)

    with HostClock(FqSponge, ("absorb_g",)) as clock:
        ok, secs = wall(lambda: verify(st["state0"], final, 62), device)
    times["verify_keccak_ms"] = secs * 1e3
    times["verify_keccak_absorb_ms"] = clock.seconds["absorb_g"] * 1e3
    if not ok:
        raise AssertionError("verify_keccak rejected the honest proof")
    bad = [row[:] for row in final]
    bad[1][2] ^= 1 << 7
    bad0 = [row[:] for row in st["state0"]]
    bad0[0][0] ^= 1
    if verify(st["state0"], bad, 63) or verify(bad0, final, 64):
        raise AssertionError("verify_keccak accepted a changed final or initial state")
    log(f"keccak: {len(proof.commitments)} columns, prove_keccak_ms {times['prove_keccak_ms']:.1f}"
        f" (host absorptions {times['prove_keccak_absorb_ms']:.1f}), verify_keccak_ms "
        f"{times['verify_keccak_ms']:.1f} (host absorptions {times['verify_keccak_absorb_ms']:.1f})"
        f", peak {times['peak_keccak_gib']:.2f} GiB")
    log(f"check: the Keccak-f proof (n = {n}) equals {COLUMN_VECTORS['keccak']} field by field; "
        "it verifies and is rejected with a changed final and a changed initial state")
    return {}


def riscv_path(run, device, log_n: int = RV_LOG_N) -> dict:
    """o1vm's RV32IM execution proofs. The vector case: tests/test_riscv.py's
    program at Layout(2), n = 256, TestRng(81), every field equal to
    tests/vectors/column_riscv_2^8, its statement as the vector's; verified,
    rejected with regs[3] = 14. The full-width case: rv_loop_program at the
    default Layout(4) over 2^log_n rows (n / 2 steps), every kernel but K3
    and K9 launched, verified, rejected with a changed final register;
    prove_rv_ms with the host's execute, build_columns, phase1_columns and
    phase2_host apart, verify_rv_ms and the proof's peak device memory."""
    from proof_systems_tpu_torch.circuits.domains import EvaluationDomains
    from proof_systems_tpu_torch.convert import column_proof_fields
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.o1vm import logup, riscv
    from proof_systems_tpu_torch.ops import kernels
    from proof_systems_tpu_torch.poly_commitment.srs import SRS
    from proof_systems_tpu_torch.serialization import serialize_column_proof
    from proof_systems_tpu_torch.utils.rng import TestRng

    times = run["times"]

    def setup(n):
        return (EvaluationDomains.create(Fp, n, device=device),
                SRS(Vesta, run["srs"].g[:n], run["srs"].h, device))

    def rejects_changed_register(domain, srs, proof, statement, r, seed):
        bad = dict(statement, final=dict(statement["final"], regs=list(statement["final"]["regs"])))
        bad["final"]["regs"][r] = 14 if r == 3 else (bad["final"]["regs"][r] + 1) % riscv.TWO32
        return not riscv.verify_execution(domain, srs, Vesta, proof, bad, TestRng(seed),
                                          device=device)

    raw, st = column_vector("riscv")
    n = st["n"]
    want = riscv.statement_from_json(st["statement"])
    domain, srs = setup(n)
    (proof, statement), secs = wall(lambda: riscv.prove_execution(
        domain, srs, Vesta, want["program"], n, TestRng(81),
        L=riscv.Layout(want["bitwise_bits"]), device=device), device)
    times["prove_rv_vector_ms"] = secs * 1e3
    if riscv.statement_to_json(statement) != st["statement"]:
        raise AssertionError("prove_execution's statement differs from the vector's")
    if serialize_column_proof(Vesta, column_proof_fields(proof)) != raw:
        raise AssertionError(f"the RV32IM proof differs from {COLUMN_VECTORS['riscv']}")
    if not riscv.verify_execution(domain, srs, Vesta, proof, statement, TestRng(82),
                                  device=device):
        raise AssertionError("verify_execution rejected the honest vector proof")
    if not rejects_changed_register(domain, srs, proof, statement, 3, 83):
        raise AssertionError("verify_execution accepted the vector statement with regs[3] = 14")
    log(f"check: the RV32IM proof (n = {n}, Layout({want['bitwise_bits']})) equals "
        f"{COLUMN_VECTORS['riscv']} field by field; it verifies and is rejected with regs[3] = 14")

    n = 1 << log_n
    domain, srs = setup(n)
    program = rv_loop_program()
    before = kernels.launch_counts()
    peak_gib(device, reset=True)
    with HostClock(riscv, ("execute", "build_columns")) as clock, HostClock(
            logup.MultiLogup, ("phase1_columns", "phase2_host")) as mclock:
        (proof, statement), secs = wall(lambda: riscv.prove_execution(
            domain, srs, Vesta, program, n, TestRng(RV_SEED), device=device), device)
    times["peak_rv_gib"] = peak_gib(device)
    counts = {k: v - before[k] for k, v in kernels.launch_counts().items()}
    times["prove_rv_ms"] = secs * 1e3
    host_s = {**clock.seconds, **mclock.seconds}
    for stage, s in host_s.items():
        times[f"prove_rv_{stage}_ms"] = s * 1e3
    times["prove_rv_rest_ms"] = (secs - sum(host_s.values())) * 1e3
    zero = [k for k, v in counts.items() if v == 0 and k not in ("jacobian_double", "linear_scan")]
    if zero and device.type == "cuda":  # the CPU's plain versions launch nothing
        raise AssertionError(f"kernels not launched by the RV32IM proof at n = {n}: {zero}")
    if statement["k_steps"] != n // 2:
        raise AssertionError(f"the loop ran {statement['k_steps']} steps, not {n // 2}")
    ok, secs = wall(lambda: riscv.verify_execution(domain, srs, Vesta, proof, statement,
                                                   TestRng(RV_SEED + 1), device=device), device)
    times["verify_rv_ms"] = secs * 1e3
    if not ok:
        raise AssertionError(f"verify_execution rejected the honest proof at n = {n}")
    if not rejects_changed_register(domain, srs, proof, statement, 2, RV_SEED + 2):
        raise AssertionError("verify_execution accepted a changed final register")
    inside = ", ".join(f"{stage} {s * 1e3:.1f}" for stage, s in host_s.items())
    log(f"riscv: n = {n}, {statement['k_steps']} steps, {len(proof.commitments)} columns, "
        f"prove_rv_ms {times['prove_rv_ms']:.1f} (on the host: {inside}), verify_rv_ms "
        f"{times['verify_rv_ms']:.1f}, peak {times['peak_rv_gib']:.2f} GiB, launches "
        f"{json.dumps(counts)}")
    log(f"check: the RV32IM proof of rv_loop_program (n = {n}, Layout(4)) launches every kernel "
        "but K3 and K9, verifies and is rejected with a changed final register")
    return {}


def mips_path(run, device, log_n: int = MIPS_LOG_N) -> dict:
    """o1vm's MIPS execution proofs. The vector case: tests/test_mips.py's
    nine instructions at Layout(2), n = 256, TestRng(71), every field equal
    to tests/vectors/column_mips_2^8, its statement as the vector's;
    verified, rejected with regs[5] = 43 and with init_memory[32] = 9. The
    Cannon snapshot: the vector column_mips_cannon_2^9's segment (pc0 =
    0x1000, a preimage key write, reads of its stream, exit_group(3)) run by
    the port's CannonVM on the host, then proved at n = 512, TestRng(81):
    every field equal to the vector, the final registers the VM's, verified,
    rejected when the preimage's last byte changes. The full-width case:
    mips_loop_program at the default Layout(4) over 2^log_n rows (n / 2
    steps, exit_group last), every kernel but K3 and K9 launched, verified,
    rejected with a changed final register; prove_mips_ms with the host's
    execute, build_columns, phase1_columns and phase2_host apart,
    verify_mips_ms and the proof's peak device memory."""
    from proof_systems_tpu_torch.circuits.domains import EvaluationDomains
    from proof_systems_tpu_torch.convert import column_proof_fields
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.o1vm import cannon, logup, mips
    from proof_systems_tpu_torch.ops import kernels
    from proof_systems_tpu_torch.poly_commitment.srs import SRS
    from proof_systems_tpu_torch.serialization import serialize_column_proof
    from proof_systems_tpu_torch.utils.rng import TestRng

    times = run["times"]

    def setup(n):
        return (EvaluationDomains.create(Fp, n, device=device),
                SRS(Vesta, run["srs"].g[:n], run["srs"].h, device))

    def verify(domain, srs, proof, statement, seed):
        return mips.verify_execution(domain, srs, Vesta, proof, statement, TestRng(seed),
                                     device=device)

    def with_final_reg(statement, r, value):
        return dict(statement, final=dict(statement["final"], regs=[
            value if i == r else v for i, v in enumerate(statement["final"]["regs"])]))

    def prove_vector(name, seed, **kw):
        raw, st = column_vector(name)
        want = mips.statement_from_json(st["statement"])
        domain, srs = setup(st["n"])
        (proof, statement), secs = wall(lambda: mips.prove_execution(
            domain, srs, Vesta, want["program"], st["n"], TestRng(seed),
            L=mips.Layout(want["bitwise_bits"]), pc0=want["init"]["pc"],
            preimages=want["preimages"], device=device, **kw), device)
        times[f"prove_{name}_vector_ms"] = secs * 1e3
        if mips.statement_to_json(statement) != st["statement"]:
            raise AssertionError(f"prove_execution's statement differs from the {name} vector's")
        if serialize_column_proof(Vesta, column_proof_fields(proof)) != raw:
            raise AssertionError(f"the MIPS proof differs from {COLUMN_VECTORS[name]}")
        if not verify(domain, srs, proof, statement, seed + 1):
            raise AssertionError(f"verify_execution rejected the honest {name} vector proof")
        return domain, srs, proof, statement

    domain, srs, proof, statement = prove_vector("mips", 71)
    bad_memory = dict(statement, init_memory={**statement["init_memory"], 32: 9})
    if verify(domain, srs, proof, with_final_reg(statement, 5, 43), 73) or verify(
            domain, srs, proof, bad_memory, 74):
        raise AssertionError("verify_execution accepted regs[5] = 43 or init_memory[32] = 9")
    log(f"check: the MIPS proof (n = 256, Layout(2)) equals {COLUMN_VECTORS['mips']} field by "
        "field; it verifies and is rejected with regs[5] = 43 and with init_memory[32] = 9")

    want = mips.statement_from_json(column_vector("mips_cannon")[1]["statement"])
    pc0, data = want["init"]["pc"], {a: v for a, v in want["init_memory"].items() if v}
    state = cannon.State(memory={}, pc=pc0, next_pc=pc0 + 4)
    vm = cannon.CannonVM(state, oracle=cannon.InMemoryPreImageOracle(want["preimages"]))
    for w, ins in enumerate(want["program"]):
        vm.mem.write_word(pc0 + 4 * w, mips_encode(ins))
    for addr, val in data.items():
        vm.mem.write_word(addr, val)
    vm.run(max_steps=100)
    domain, srs, proof, statement = prove_vector("mips_cannon", 81, memory=data)
    fin = statement["final"]
    if not (state.exited and fin["exited"] and fin["regs"] == state.registers
            and (fin["hi"], fin["lo"], fin["pk"], fin["exit_code"]) == (
                state.hi, state.lo, state.preimage_key, state.exit)):
        raise AssertionError("the Cannon VM's final state differs from the proof's statement")
    key = next(iter(statement["preimages"]))
    data_bytes = statement["preimages"][key]
    bad = dict(statement, preimages={key: data_bytes[:-1] + bytes([data_bytes[-1] ^ 1])})
    if verify(domain, srs, proof, bad, 83):
        raise AssertionError("verify_execution accepted a changed preimage")
    log(f"check: the Cannon snapshot (pc0 = {pc0:#x}, exit {state.exit} after {state.step} "
        f"steps of the CannonVM) proves at n = 512 equal to {COLUMN_VECTORS['mips_cannon']} "
        "field by field, with the VM's final registers; it verifies and is rejected with the "
        "preimage's last byte changed")

    n = 1 << log_n
    domain, srs = setup(n)
    program = mips_loop_program(n // 2)
    before = kernels.launch_counts()
    peak_gib(device, reset=True)
    with HostClock(mips, ("execute", "build_columns")) as clock, HostClock(
            logup.MultiLogup, ("phase1_columns", "phase2_host")) as mclock:
        (proof, statement), secs = wall(lambda: mips.prove_execution(
            domain, srs, Vesta, program, n, TestRng(MIPS_SEED), preimages=MIPS_PREIMAGES,
            device=device), device)
    times["peak_mips_gib"] = peak_gib(device)
    counts = {k: v - before[k] for k, v in kernels.launch_counts().items()}
    times["prove_mips_ms"] = secs * 1e3
    host_s = {**clock.seconds, **mclock.seconds}
    for stage, s in host_s.items():
        times[f"prove_mips_{stage}_ms"] = s * 1e3
    times["prove_mips_rest_ms"] = (secs - sum(host_s.values())) * 1e3
    zero = [k for k, v in counts.items() if v == 0 and k not in ("jacobian_double", "linear_scan")]
    if zero and device.type == "cuda":  # the CPU's plain versions launch nothing
        raise AssertionError(f"kernels not launched by the MIPS proof at n = {n}: {zero}")
    if statement["k_steps"] != n // 2 or not statement["final"]["exited"]:
        raise AssertionError(f"the loop ran {statement['k_steps']} steps, not {n // 2} to its exit")
    ok, secs = wall(lambda: verify(domain, srs, proof, statement, MIPS_SEED + 1), device)
    times["verify_mips_ms"] = secs * 1e3
    if not ok:
        raise AssertionError(f"verify_execution rejected the honest MIPS proof at n = {n}")
    regs = statement["final"]["regs"]
    if verify(domain, srs, proof, with_final_reg(statement, 8, (regs[8] + 1) % mips.TWO32),
              MIPS_SEED + 2):
        raise AssertionError("verify_execution accepted a changed final register")
    inside = ", ".join(f"{stage} {s * 1e3:.1f}" for stage, s in host_s.items())
    log(f"mips: n = {n}, {statement['k_steps']} steps, {len(proof.commitments)} columns, "
        f"prove_mips_ms {times['prove_mips_ms']:.1f} (on the host: {inside}), verify_mips_ms "
        f"{times['verify_mips_ms']:.1f}, peak {times['peak_mips_gib']:.2f} GiB, launches "
        f"{json.dumps(counts)}")
    log(f"check: the MIPS proof of mips_loop_program (n = {n}, Layout(4), exit_group last) "
        "launches every kernel but K3 and K9, verifies and is rejected with a changed final "
        "register")
    return {}


# ---------------------------------------------------------------------------
# The foreign-field MSM circuit and arrabbiata folding
# ---------------------------------------------------------------------------

COLUMN_VECTORS.update({"msm": "tests/vectors/column_msm_2^8",
                       "ivc_vesta": "tests/vectors/column_ivc_vesta_2^8",
                       "ivc_pallas": "tests/vectors/column_ivc_pallas_2^8"})
# The MSM circuit's production case: Layout() over secp256k1 (SEC 2, 2.4.1),
# MSM_POINTS points and scalars from numpy.random.default_rng(MSM_SEED), on
# a domain of 2^MSM_LOG_N rows (the 2^16-entry range table sets it).
MSM_LOG_N = 16
MSM_POINTS = 16
MSM_SEED = SEED + 150
SECP_F = (1 << 256) - (1 << 32) - 977
SECP_ORDER = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
SECP_G = (0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
          0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8)
# The folding phase: six IVC steps over both curves at n = 2^FOLD_LOG_N (two
# folds a side), the vector statement of tests/test_ivc.py, then the CLI.
FOLD_LOG_N = 8
FOLD_STEPS = 6
FOLD_SEED = SEED + 170
CLI_STEPS = 4
# At n = 2^8 the IPA opening has no fold step (n <= ipa.IPA_FOLD_TAIL), so the
# folding phase cannot launch the endo ladder, as the k = 11 bench path, and
# no row of prefix products is longer than K5's 8,192 (d8 has 2,048 points),
# so K12 does not launch either.
FOLD_KERNELS = tuple(k for k in COLUMN_KERNELS
                     if k not in ("endo_ladder", "mont_prefix_scan_parts"))


def secp_add(p, q):
    """Affine secp256k1 addition on Python ints, None the identity: the
    MSM phase's independent host reference (not msm_circuit's planner)."""
    f = SECP_F
    if p is None:
        return q
    if q is None:
        return p
    if p[0] == q[0]:
        if (p[1] + q[1]) % f == 0:
            return None
        lam = 3 * p[0] * p[0] * pow(2 * p[1], -1, f) % f
    else:
        lam = (q[1] - p[1]) * pow(q[0] - p[0], -1, f) % f
    x = (lam * lam - p[0] - q[0]) % f
    return x, (lam * (p[0] - x) - p[1]) % f


def secp_mul(k: int, p):
    """k * p by double-and-add from the low bit."""
    acc = None
    while k:
        if k & 1:
            acc = secp_add(acc, p)
        p = secp_add(p, p)
        k >>= 1
    return acc


def msm_statement(k: int, seed: int = MSM_SEED):
    """k secp256k1 points (G, then G times multipliers below 2^63) and k
    scalars below the group order, all from numpy.random.default_rng(seed)."""
    rng = np.random.default_rng(seed)
    points = [SECP_G] + [secp_mul(int(m), SECP_G)
                         for m in rng.integers(1, 1 << 63, size=k - 1, dtype=np.int64)]
    scalars = [int.from_bytes(rng.bytes(32), "little") % SECP_ORDER for _ in range(k)]
    return scalars, points


def msm_path(run, device, points: int = MSM_POINTS) -> dict:
    """The foreign-field MSM circuit. The vector case: tests/
    test_msm_circuit.py's statement (TOY_LAYOUT, scalars [11, 6] over
    toy_points(2), n = 256, TestRng(41)), every field equal to
    tests/vectors/column_msm_2^8, verified. The production case: Layout()
    (16-bit limbs, 256-bit elements, 519 committed columns) over secp256k1
    at n = 2^16, msm_statement(points): the result equal to the host sum of
    per-point double-and-add products, the proof verified, rejected with a
    changed result and with a changed scalar; prove_msm_ms with the host's
    build_columns, phase1_columns and phase2_host apart, verify_msm_ms and
    the proof's peak device memory (under the card's 80 GiB); every kernel
    but K3 and K9 launched."""
    from proof_systems_tpu_torch import msm_circuit
    from proof_systems_tpu_torch.circuits.domains import EvaluationDomains
    from proof_systems_tpu_torch.convert import column_proof_fields
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.o1vm import logup
    from proof_systems_tpu_torch.ops import kernels
    from proof_systems_tpu_torch.poly_commitment.srs import SRS
    from proof_systems_tpu_torch.serialization import serialize_column_proof
    from proof_systems_tpu_torch.utils.rng import TestRng

    times = run["times"]

    def setup(n):
        return (EvaluationDomains.create(Fp, n, device=device),
                SRS(Vesta, run["srs"].g[:n], run["srs"].h, device))

    raw, st = column_vector("msm")
    toy = msm_circuit.ForeignCurve(*st["curve"])
    toy_layout = msm_circuit.Layout(*st["layout"])
    toy_points = [tuple(pt) for pt in st["points"]]
    domain, srs = setup(st["n"])
    (proof, result), secs = wall(lambda: msm_circuit.prove_msm(
        domain, srs, Vesta, toy, st["scalars"], toy_points, TestRng(41), L=toy_layout,
        device=device), device)
    times["prove_msm_vector_ms"] = secs * 1e3
    if list(result) != st["result"]:
        raise AssertionError("prove_msm's result differs from the vector's")
    if serialize_column_proof(Vesta, column_proof_fields(proof)) != raw:
        raise AssertionError(f"the MSM proof differs from {COLUMN_VECTORS['msm']}")
    if not msm_circuit.verify_msm(domain, srs, Vesta, toy, st["scalars"], toy_points, result,
                                  proof, TestRng(42), L=toy_layout, device=device):
        raise AssertionError("verify_msm rejected the honest vector proof")
    log(f"check: the MSM proof (n = {st['n']}, {toy_layout.lb}-bit limbs, {toy_layout.fbits}-bit "
        f"elements) equals {COLUMN_VECTORS['msm']} field by field and verifies")

    n = 1 << MSM_LOG_N
    domain, srs = setup(n)
    curve = msm_circuit.ForeignCurve(SECP_F, 0, 7)
    scalars, pts = msm_statement(points)
    want = None
    for s, pt in zip(scalars, pts):
        want = secp_add(want, secp_mul(s, pt))
    before = kernels.launch_counts()
    peak_gib(device, reset=True)
    with HostClock(msm_circuit, ("build_columns",)) as clock, HostClock(
            logup.MultiLogup, ("phase1_columns", "phase2_host")) as mclock:
        (proof, result), secs = wall(lambda: msm_circuit.prove_msm(
            domain, srs, Vesta, curve, scalars, pts, TestRng(MSM_SEED), device=device), device)
    times["peak_msm_gib"] = peak_gib(device)
    counts = {k: v - before[k] for k, v in kernels.launch_counts().items()}
    times["prove_msm_ms"] = secs * 1e3
    host_s = {**clock.seconds, **mclock.seconds}
    for stage, s in host_s.items():
        times[f"prove_msm_{stage}_ms"] = s * 1e3
    times["prove_msm_rest_ms"] = (secs - sum(host_s.values())) * 1e3
    if tuple(result) != want:
        raise AssertionError("the circuit's MSM differs from the host's double-and-add sum")
    zero = [k for k, v in counts.items() if v == 0 and k not in ("jacobian_double", "linear_scan")]
    if zero and device.type == "cuda":  # the CPU's plain versions launch nothing
        raise AssertionError(f"kernels not launched by the MSM proof at n = {n}: {zero}")
    if device.type == "cuda" and times["peak_msm_gib"] >= 80:
        raise AssertionError(f"the MSM proof peaked at {times['peak_msm_gib']:.2f} GiB")
    nrows = len(msm_circuit.plan_msm(curve, scalars, pts)[1])
    ok, secs = wall(lambda: msm_circuit.verify_msm(domain, srs, Vesta, curve, scalars, pts,
                                                   result, proof, TestRng(MSM_SEED + 1),
                                                   device=device), device)
    times["verify_msm_ms"] = secs * 1e3
    if not ok:
        raise AssertionError(f"verify_msm rejected the honest proof at n = {n}")
    bad_result = ((result[0] + 1) % SECP_F, result[1])
    bad_scalars = [scalars[0] ^ 1] + scalars[1:]
    for what, s, r, seed in (("result", scalars, bad_result, 2), ("scalars", bad_scalars, result, 3)):
        if msm_circuit.verify_msm(domain, srs, Vesta, curve, s, pts, r, proof,
                                  TestRng(MSM_SEED + seed), device=device):
            raise AssertionError(f"verify_msm accepted a changed {what}")
    inside = ", ".join(f"{stage} {s * 1e3:.1f}" for stage, s in host_s.items())
    log(f"msm: n = {n}, {points} points, {nrows} EC-op rows, {len(proof.commitments)} columns, "
        f"prove_msm_ms {times['prove_msm_ms']:.1f} (on the host: {inside}), verify_msm_ms "
        f"{times['verify_msm_ms']:.1f}, peak {times['peak_msm_gib']:.2f} GiB, launches "
        f"{json.dumps(counts)}")
    log(f"check: the MSM circuit at Layout() over secp256k1 (n = {n}, {points} points) proves "
        "the host's double-and-add sum, verifies, and is rejected with a changed result and "
        "with a changed scalar")
    return {}


def folding_path(run, device) -> dict:
    """Arrabbiata folding with IVC over both Pasta curves at n = 2^8 (the
    full verifier circuit: 15 absorbs, 196 rows, 33 columns, D = 6). The
    vector case: tests/test_ivc.py's heavy statement (TestRng(9), two steps
    from z = 2, decide with TestRng(10)): each side's decider proof, Vesta /
    Fp and Pallas / Fq, equal to tests/vectors/column_ivc_*_2^8 field by
    field. The full run: FOLD_STEPS steps from z = 2 (two folds a side),
    every accumulator satisfied, its commitments open and its fixed columns
    pinned, then the decider's two column proofs verified, and one rejected
    with a changed zeta evaluation; the steps', folds' and deciders' times.
    Then folding/cli.py's `execute --zkapp square -n CLI_STEPS --srs-size 8`
    with its JSON line."""
    import contextlib
    import io

    from proof_systems_tpu_torch.circuits.domains import EvaluationDomains
    from proof_systems_tpu_torch.convert import column_proof_fields, column_proof_from_fields
    from proof_systems_tpu_torch.curves import Pallas, Vesta
    from proof_systems_tpu_torch.fields import Fp, Fq
    from proof_systems_tpu_torch.folding import arrabbiata, cli, ivc
    from proof_systems_tpu_torch.poly_commitment.srs import SRS, derive_points, derive_h
    from proof_systems_tpu_torch.serialization import serialize_column_proof
    from proof_systems_tpu_torch.utils.rng import TestRng

    times = run["times"]
    n = 1 << FOLD_LOG_N
    srs = {Vesta: SRS(Vesta, run["srs"].g[:n], run["srs"].h, device),
           Pallas: SRS(Pallas, derive_points(Pallas, n), derive_h(Pallas), device)}
    domains = {f: EvaluationDomains.create(f, n, device=device) for f in (Fp, Fq)}

    iv = ivc.IVC(srs[Vesta], srs[Pallas], n=n, rng=TestRng(9))
    iv.run(2, steps=2)
    proofs = []
    ok, secs = wall(lambda: iv.decide(domains, TestRng(10), proofs), device)
    if not ok:
        raise AssertionError("decide rejected the vector statement's accumulators")
    for (proof, _), curve, name in zip(proofs, (Vesta, Pallas), ("ivc_vesta", "ivc_pallas")):
        raw, st = column_vector(name)
        if serialize_column_proof(curve, column_proof_fields(proof)) != raw:
            raise AssertionError(f"the {curve.name} decider proof differs from "
                                 f"{COLUMN_VECTORS[name]}")
        side = iv.sides[curve is Pallas]
        if (side.acc.u, side.acc.alphas, side.kappa) != (st["u"], st["alphas"], st["kappa"]):
            raise AssertionError(f"the {curve.name} accumulator differs from the vector's")
    log(f"check: both decider proofs of tests/test_ivc.py's statement (Vesta / Fp, Pallas / Fq, "
        f"n = {n}) equal {COLUMN_VECTORS['ivc_vesta']} and {COLUMN_VECTORS['ivc_pallas']} field "
        "by field")

    iv = ivc.IVC(srs[Vesta], srs[Pallas], n=n, rng=TestRng(FOLD_SEED))
    peak_gib(device, reset=True)
    with HostClock(arrabbiata.FoldingScheme, ("fold_committed",)) as fclock:
        z, step_ms = 2, []
        for i in range(FOLD_STEPS):
            (z, _), secs = wall(lambda: iv.step(i, z), device)
            step_ms.append(secs * 1e3)
    times["fold_steps_ms"] = sum(step_ms)
    times["fold_folds_ms"] = fclock.seconds["fold_committed"] * 1e3
    proofs, marks = [], [time.perf_counter()]
    real_verify = arrabbiata.decider_verify

    def verify_marked(*args, **kw):  # a side's decision ends with its verification
        out = real_verify(*args, **kw)
        sync(device)
        marks.append(time.perf_counter())
        return out

    arrabbiata.decider_verify = verify_marked
    try:
        ok, secs = wall(lambda: iv.decide(domains, TestRng(FOLD_SEED + 1), proofs), device)
    finally:
        arrabbiata.decider_verify = real_verify
    times["decide_ms"] = secs * 1e3
    times["decide_vesta_ms"], times["decide_pallas_ms"] = (
        (b - a) * 1e3 for a, b in zip(marks, marks[1:]))
    if not ok:
        raise AssertionError("decide rejected the accumulators of the honest IVC run")
    for (proof, cons), side in zip(proofs, iv.sides):
        fields = column_proof_fields(proof)
        fields["zeta_evaluations"][0] = (fields["zeta_evaluations"][0] + 1) % side.field.p
        if arrabbiata.decider_verify(side.env, column_proof_from_fields(fields), cons,
                                     domains[side.field], side.scheme.srs, side.curve,
                                     TestRng(FOLD_SEED + 2)):
            raise AssertionError(f"the {side.curve.name} decider accepted a changed evaluation")
    times["peak_fold_gib"] = peak_gib(device)
    log(f"folding: n = {n}, {FOLD_STEPS} steps (ms: {', '.join(f'{t:.1f}' for t in step_ms)}), "
        f"folds {times['fold_folds_ms']:.1f} ms in all, decide_ms {times['decide_ms']:.1f} "
        f"(Vesta / Fp {times['decide_vesta_ms']:.1f}, Pallas / Fq "
        f"{times['decide_pallas_ms']:.1f}), peak {times['peak_fold_gib']:.2f} GiB, z = {z:#x}")
    log(f"check: {FOLD_STEPS} IVC steps over Vesta / Fp and Pallas / Fq fold, both accumulators "
        "are decided (relation, commitments, fixed columns, a column proof each) and each decider "
        "rejects a changed evaluation")

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        (line, secs) = wall(lambda: cli.execute("square", CLI_STEPS, FOLD_LOG_N, device=device),
                            device)
    times["cli_ms"] = secs * 1e3
    printed = json.loads(out.getvalue().strip().splitlines()[-1])
    steps = [ln for ln in err.getvalue().splitlines() if ln.startswith("Iteration ")]
    if printed != line or not line["decider_ok"] or len(steps) != CLI_STEPS:
        raise AssertionError(f"the arrabbiata CLI printed {printed} after {len(steps)} steps")
    log(f"cli: {json.dumps(printed)}")
    return {}


def batch_path(run, device) -> dict:
    """One batch_verify over five proofs of four circuits on the path's SRS
    (the bench proof, the public-input proof, the recursion proof, the lookup
    proof and the chunked proof) beside the five single verifications; the
    batch is rejected when one proof has ft_eval1 + 1."""
    import copy

    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.utils.rng import TestRng
    from proof_systems_tpu_torch.verifier import batch_verify
    from proof_systems_tpu_torch.verifier import verify as kimchi_verify

    batch = [(run["vk"], run["kproof"], []), (run["pub_vk"], run["pub_proof"], run["public"]),
             (run["vk"], run["rec_proof"], []), (run["lookup_vk"], run["lookup_proof"], []),
             (run["chunked_vk"], run["chunked_proof"], [])]
    singles = 0.0
    for i, item in enumerate(batch):
        ok, secs = wall(lambda: kimchi_verify(*item, TestRng(SEED + 40 + i)), device)
        if not ok:
            raise AssertionError(f"proof {i} of the batch does not verify alone")
        singles += secs
    ok, secs = wall(lambda: batch_verify(batch, TestRng(SEED + 45)), device)
    run["times"]["batch_verify_ms"] = secs * 1e3
    run["times"]["single_verify_sum_ms"] = singles * 1e3
    if not ok:
        raise AssertionError("batch_verify rejected five honest proofs")
    bad = copy.deepcopy(run["lookup_proof"])
    bad.ft_eval1 = (bad.ft_eval1 + 1) % Fp.p
    altered = batch[:3] + [(run["lookup_vk"], bad, [])] + batch[4:]
    if batch_verify(altered, TestRng(SEED + 46)):
        raise AssertionError("batch_verify accepted a batch with one proof at ft_eval1 + 1")
    log(f"check: batch_verify accepts the {len(batch)} proofs (bench, public, recursion, lookup, "
        "chunked) and rejects the batch when one has ft_eval1 + 1")
    return {}


def vk_file_path(run, device) -> dict:
    """The bench, lookup, chunked and gate-mix verifier indexes through
    to_file into build/ and from_file against the path's SRS: the digests
    are equal and each reloaded index verifies its proof."""
    import pathlib

    from proof_systems_tpu_torch.utils.rng import TestRng
    from proof_systems_tpu_torch.verifier import verify as kimchi_verify
    from proof_systems_tpu_torch.verifier_index import VerifierIndex

    out = pathlib.Path(__file__).resolve().parent / "build" / "vk"
    out.mkdir(parents=True, exist_ok=True)
    for i, tag in enumerate(("bench", "lookup", "chunked", "optional")):
        vk, proof = ((run["vk"], run["kproof"]) if tag == "bench" else
                     (run[f"{tag}_vk"], run[f"{tag}_proof"]))
        path = out / f"vk_{tag}.bin"
        _, write_s = wall(lambda: vk.to_file(path), device)
        back, read_s = wall(lambda: VerifierIndex.from_file(path, run["srs"]), device)
        run["times"][f"vk_file_{tag}_write_s"], run["times"][f"vk_file_{tag}_read_s"] = (
            write_s, read_s)
        if back.digest() != vk.digest():
            raise AssertionError(f"the {tag} verifier index read back has another digest")
        if not kimchi_verify(back, proof, [], TestRng(SEED + 50 + i)):
            raise AssertionError(f"the {tag} verifier index read back rejects its proof")
        log(f"check: the {tag} verifier index ({path.stat().st_size} bytes) reads back with its "
            "digest and verifies its proof")
    return {}


def ipa_inputs(log_n: int) -> dict:
    """The evaluation points (zeta, zeta*omega), polyscale and evalscale."""
    from proof_systems_tpu_torch.fields import Fp

    rng = random.Random(SEED + 5)
    zeta = rng.randrange(Fp.p)
    return dict(elm=[zeta, zeta * Fp.root_of_unity(log_n) % Fp.p],
                polyscale=rng.randrange(Fp.p), evalscale=rng.randrange(Fp.p))


def batch_of(run, proof, evals=None, cip=None) -> list:
    """The one-proof batch of verify_batch, with a fresh transcript."""
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.poly_commitment import ipa
    from proof_systems_tpu_torch.poseidon import FqSponge, fq_kimchi

    evals = run["evals"] if evals is None else evals
    return [ipa.BatchEvaluationProof(
        sponge=FqSponge(fq_kimchi, Vesta),
        evaluations=[ipa.Evaluation(c, e) for c, e in zip(run["all_comms"], evals)],
        evaluation_points=run["elm"], polyscale=run["polyscale"], evalscale=run["evalscale"],
        opening=proof, combined_inner_product=run["cip"] if cip is None else cip,
    )]


def open_proof(run):
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.poly_commitment import ipa
    from proof_systems_tpu_torch.poseidon import FqSponge, fq_kimchi
    from proof_systems_tpu_torch.utils.rng import TestRng

    return ipa.open_proof(run["srs"], run["plnms"], run["elm"], run["polyscale"],
                          run["evalscale"], FqSponge(fq_kimchi, Vesta), TestRng(SEED))


def verify(run, proof, evals=None, cip=None, seed=SEED + 1) -> bool:
    from proof_systems_tpu_torch.poly_commitment import ipa
    from proof_systems_tpu_torch.utils.rng import TestRng

    return ipa.verify_batch(run["srs"], batch_of(run, proof, evals, cip), TestRng(seed))


def evaluate(run):
    from proof_systems_tpu_torch.ops import poly

    F, n, dev = run["F"], len(run["srs"]), run["coeffs"].device
    za, zb = (poly.powers_dev(F, x, n, device=dev) for x in run["elm"])
    return poly.eval_at2(F, run["coeffs"], za, zb)


def open_and_verify(run, log_n: int, device) -> dict:
    """The 16 committed polynomials (15 witness columns and the z-shaped
    b = 1 one) evaluated at zeta and zeta*omega, opened with a fresh Fq
    transcript and verified, through the port's entry points."""
    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.poly_commitment.commitment import combined_inner_product

    times = run["times"]
    out = ipa_inputs(log_n)
    out["coeffs"] = torch.cat([run["w_coeffs"], run["z_coeffs"]], dim=1)
    out["all_comms"] = run["comms"] + run["z_comm"]
    blinders = run["blinders"] + run["z_blinder"]
    out["plnms"] = [(out["coeffs"][:, i], blinders[i]) for i in range(len(blinders))]
    (ev_a, ev_b), times["eval2_s"] = wall(lambda: evaluate({**run, **out}), device)
    out["evals"] = [[[a], [b]] for a, b in zip(ev_a, ev_b)]
    out["cip"] = combined_inner_product(Fp, out["polyscale"], out["evalscale"], out["evals"])
    both = {**run, **out}
    out["proof"], times["open_s"] = wall(lambda: open_proof(both), device)
    ok, times["verify_s"] = wall(lambda: verify(both, out["proof"]), device)
    if not ok:
        raise AssertionError("verify_batch on the card rejected the honest opening")
    return out


def steady_times(run, device, reps: int = 3) -> dict:
    """Stage times after warm-up (the SRS and plan exist)."""
    from proof_systems_tpu_torch.ops import msm
    from proof_systems_tpu_torch.ops.curve_ops import device_curve

    srs, plan, c = run["srs"], run["plan"], run["c"]
    dc = device_curve(srs.curve)
    out = {}
    out["intt_ms"] = elapsed_ms(
        lambda: plan.intt_t(run["w_evals"], plan.inv_twiddles), device, reps)
    out["scaled_basis_ms"] = elapsed_ms(
        lambda: msm.scale_basis(dc, srs.gh_dev, c, msm.num_windows(c)), device, reps)
    out["commit15_ms"] = elapsed_ms(
        lambda: srs.commit_coeffs_dev(run["w_coeffs"], 1, run["blinders"]), device, reps)
    out["commit1_ms"] = elapsed_ms(
        lambda: srs.commit_coeffs_dev(run["z_coeffs"], 1, run["z_blinder"]), device, reps)
    # the torch ops in front of K6 in the 15-column commit: digits, sort, gather
    scal = random_std_limbs(run["F"].p, (COLUMNS, len(srs) + 1), SEED + 3, device)
    scaled = srs.scaled_basis(c)
    out["commit15_sort_gather_ms"] = elapsed_ms(
        lambda: msm.gather_points(dc, scaled, msm.sort_digits(msm.window_digits(scal, c))[0]),
        device, reps)

    from proof_systems_tpu_torch.poly_commitment import ipa

    out["eval2_ms"] = elapsed_ms(lambda: evaluate(run), device, reps)
    opens = []
    with Clock([(ipa, "_ipa_fold_step", "fold"), (ipa, "_ipa_tail_rounds", "tail")]) as clock:
        for _ in range(reps):
            opens.append(wall(lambda: open_proof(run), device)[1] * 1e3)
    stages = clock.totals()
    out["open_ms"] = sum(opens) / reps
    out["open_fold_steps_ms"] = stages["fold"] / reps
    out["open_tail_ms"] = stages["tail"] / reps
    out["open_host_ms"] = out["open_ms"] - out["open_fold_steps_ms"] - out["open_tail_ms"]
    out["verify_ms"] = elapsed_ms(lambda: verify(run, run["proof"]), device, reps)
    out.update(proof_times(run, device, reps))
    return out


# The prover's checkpoints (utils/tracing.py) that open each stage of a proof.
PROOF_STAGES = [
    ("witness_commit", "create_recursive"),
    ("z", "commit_to_witness_columns"),
    ("quotient", "z_permutation_aggregation_polynomial"),
    ("t_commit", "commit_quotient"),
    ("evaluations", "lagrange_basis_eval_zeta_poly"),
    ("ft", "compute_ft_poly"),
    ("opening", "create_aggregated_ipa"),
]


def proof_times(run, device, reps: int) -> dict:
    """prove_ms over `reps` proofs with the tracer off; the stage split
    from one more proof with the tracer on and a synchronize before every
    checkpoint, where CUDA events also time the quotient's d8 transforms
    and its AST walk; verify_proof_ms; the peak device memory of one
    proof."""
    from proof_systems_tpu_torch.utils.tracing import TRACER

    out = {}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    with GcPauses() as pauses:
        out["prove_ms"] = sum(wall(lambda: prove(run), device)[1] for _ in range(reps)) * 1e3 / reps
    log(f"python gc inside the {reps} timed proofs: {pauses.summary()}")
    if device.type == "cuda":
        out["proof_peak_gib"] = (torch.cuda.max_memory_allocated(device) - base) / 2**30
    TRACER.enable(hook=lambda: sync(device))
    if device.type == "cuda":  # the quotient's d8 transforms and walk
        from proof_systems_tpu_torch.circuits import expr

        d8 = run["index"].cs.domain.d8
        with Clock([(d8, "ntt_t", "d8_ntt"), (d8, "intt_t", "d8_ntt"),
                    (expr, "eval_dev", "walk")]) as clock:
            prove(run)
        for label, ms in clock.totals().items():
            out[f"prove_quotient_{label}_ms"] = ms
    else:
        prove(run)
    TRACER.disable()
    spans = TRACER.intervals()
    stage_of = {cp: stage for stage, cp in PROOF_STAGES}
    if [name for name, _ in spans if name in stage_of] != list(stage_of):
        raise AssertionError("the prover's checkpoints are missing or out of order")
    stage = None
    for name, secs in spans:
        log(f"trace {name:40s} {secs * 1e3:10.3f} ms")
        stage = stage_of.get(name, stage)
        out[f"prove_{stage}_ms"] = out.get(f"prove_{stage}_ms", 0.0) + secs * 1e3
    out["verify_proof_ms"] = sum(
        wall(lambda: verify_proof(run, run["kproof"]), device)[1] for _ in range(reps)) * 1e3 / reps
    return out


def golden_checks(run, device, log_n: int) -> None:
    """Every commitment against the native host MSM over g ++ [h]; the iNTT
    against the CPU plain path; one b = 1 MSM at c = 10."""
    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.native import native_curve
    from proof_systems_tpu_torch.ops import limb, msm, ntt

    srs, F = run["srs"], run["F"]
    nat = native_curve(srs.curve)
    if nat is None:
        raise AssertionError("the native host MSM did not build (g++)")
    n = 1 << log_n
    basis = srs.g + [srs.h]
    rows = limb.limbs_to_ints(limb.from_mont(F, run["w_coeffs"]))
    jobs = [rows[i * n:(i + 1) * n] + [run["blinders"][i][0]] for i in range(COLUMNS)]
    zrow = limb.limbs_to_ints(limb.from_mont(F, run["z_coeffs"])) + [run["z_blinder"][0][0]]
    jobs.append(zrow)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        want = list(pool.map(lambda s: nat.msm(s, basis), jobs))
    got = [c.chunks[0] for c in run["comms"]] + [run["z_comm"][0].chunks[0]]
    if got != want:
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        raise AssertionError(f"commitments {bad} differ from the host MSM")
    log(f"check: 16 commitments (15 witness, b=1 z shape) equal the host MSM over "
        f"g ++ [h] ({time.perf_counter() - t0:.1f} s on the host)")

    cpu_plan = ntt.ntt_plan(Fp, log_n, device="cpu")
    t0 = time.perf_counter()
    cpu = cpu_plan.intt_t(run["w_evals"].cpu(), cpu_plan.inv_twiddles)
    if not torch.equal(cpu, run["w_coeffs"].cpu()):
        raise AssertionError("iNTT on the card differs from the CPU plain path")
    log(f"check: iNTT of {COLUMNS} columns equals the CPU plain path exactly "
        f"({time.perf_counter() - t0:.1f} s on the CPU)")

    c10 = 10
    scal = torch.from_numpy(limb.ints_to_limbs(zrow, shape=(1, n + 1))).to(device)
    got10 = msm.msm(srs.curve, scal, c=c10, scaled=srs.scaled_basis(c10), device=device)
    if got10 != [want[-1]]:
        raise AssertionError("b = 1, c = 10 MSM differs from the host MSM")
    log("check: b = 1 MSM at c = 10 over g ++ [h] equals the host MSM")

    polys = [job[:n] for job in jobs]
    ipa_checks(run, polys, nat)
    proof_checks(run, device, log_n, nat)
    public_checks(run, nat)


def horner(p: int, coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


def ipa_checks(run, polys: list[list[int]], nat) -> None:
    """The evaluations against host Horner; the opening against the host's
    masked-scalar rounds (ipa.py:296-325 of the JAX package) over the
    original g ++ [h, U], with the challenges replayed from the proof's
    L/R points; the verifier's rejections."""
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.poly_commitment.commitment import (
        b_poly_coefficients, combined_inner_product, shift_scalar)
    from proof_systems_tpu_torch.poseidon import FqSponge, fq_kimchi
    from proof_systems_tpu_torch.utils.rng import TestRng

    f = Vesta.scalar
    p = f.p
    srs, proof, elm = run["srs"], run["proof"], run["elm"]
    n = len(srs)
    rounds = n.bit_length() - 1

    t0 = time.perf_counter()
    want = [[[horner(p, c, x)] for x in elm] for c in polys]
    if want != run["evals"]:
        raise AssertionError("eval_at2 differs from host Horner")
    log(f"check: {len(polys)} polynomials at zeta and zeta*omega equal host Horner "
        f"({time.perf_counter() - t0:.1f} s on the host)")

    t0 = time.perf_counter()
    a, scale = [0] * n, 1
    for c in polys:
        a = [(x + scale * y) % p for x, y in zip(a, c)]
        scale = scale * run["polyscale"] % p
    b, scale = [0] * n, 1
    for x in elm:
        pw = 1
        for j in range(n):
            b[j] = (b[j] + scale * pw) % p
            pw = pw * x % p
        scale = scale * run["evalscale"] % p
    sponge = FqSponge(fq_kimchi, Vesta)
    sponge.absorb_fr([shift_scalar(Vesta, run["cip"])])
    u_base = Vesta.to_group(sponge.challenge_fq())
    chals, chal_invs = proof.challenges(Vesta, sponge)
    rng = TestRng(SEED)
    blinders = [(rng.field(p), rng.field(p)) for _ in range(rounds)]
    d, r_delta = rng.field(p), rng.field(p)
    mask, jobs = [1] * n, []
    for k in range(rounds):
        m = len(a) // 2
        a_lo, a_hi, b_lo, b_hi = a[:m], a[m:], b[:m], b[m:]
        sh = rounds - 1 - k
        ip_l = sum(x * y for x, y in zip(a_hi, b_lo)) % p
        ip_r = sum(x * y for x, y in zip(a_lo, b_hi)) % p
        jobs.append([0 if j >> sh & 1 else mask[j] * a_hi[j % m] % p for j in range(n)]
                    + [blinders[k][0], ip_l])
        jobs.append([mask[j] * a_lo[j % m] % p if j >> sh & 1 else 0 for j in range(n)]
                    + [blinders[k][1], ip_r])
        u, u_inv = chals[k], chal_invs[k]
        a = [(x + u_inv * y) % p for x, y in zip(a_lo, a_hi)]
        b = [(x + u * y) % p for x, y in zip(b_lo, b_hi)]
        mask = [mask[j] * u % p if j >> sh & 1 else mask[j] for j in range(n)]
    basis = srs.g + [srs.h, u_base]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        lr = list(pool.map(lambda s: nat.msm(s, basis), jobs))
    if [pt for pair in proof.lr for pt in pair] != lr:
        bad = [k for k in range(rounds) if tuple(lr[2 * k : 2 * k + 2]) != proof.lr[k]]
        raise AssertionError(f"L/R of rounds {bad} differ from the host rounds")
    s_vec = b_poly_coefficients(f, chals)
    if s_vec != mask or nat.msm(s_vec, srs.g) != proof.sg:
        raise AssertionError("sg differs from <b_poly_coefficients(chals), g>")
    sponge.absorb_g([proof.delta])
    c = sponge.challenge().to_field(Vesta.endos[1], f)
    if proof.z1 != (a[0] * c + d) % p:
        raise AssertionError("a0 (through z1 = a0*c + d) differs from the host rounds")
    delta = Vesta.add(Vesta.scalar_mul(d, Vesta.add(proof.sg, Vesta.scalar_mul(b[0], u_base))),
                      Vesta.scalar_mul(r_delta, srs.h))
    if proof.delta != delta:
        raise AssertionError("b0 (through delta) differs from the host rounds")
    log(f"check: L and R of all {rounds} rounds, sg, a0 and b0 equal the host's masked "
        f"rounds over g ++ [h, U] ({time.perf_counter() - t0:.1f} s on the host)")

    from proof_systems_tpu_torch.poly_commitment import ipa

    bad = ipa.OpeningProof(**{**vars(proof), "z1": (proof.z1 + 1) % p})
    if verify(run, bad, seed=SEED + 2):
        raise AssertionError("verify_batch accepted z1 + 1")
    evals = [[list(pt) for pt in ev] for ev in run["evals"]]
    evals[0][1][0] = (evals[0][1][0] + 1) % p
    cip = combined_inner_product(f, run["polyscale"], run["evalscale"], evals)
    if verify(run, proof, evals, cip, seed=SEED + 3):
        raise AssertionError("verify_batch accepted a changed evaluation")
    log("check: verify_batch on the card accepts the opening and rejects z1 + 1 and a "
        "changed evaluation (cip recomputed)")
    if run["coeffs"].device.type == "cuda":
        residency_check(run)


def proof_size(log_n: int) -> int:
    """Serialized bytes of a lookup-free proof with 2^k points and one chunk
    (tests/test_serialization.py proof_size_model): 5,306 at k = 16; each
    IPA round is 71 bytes, and the round list's header grows by 2 bytes
    from 16 rounds on."""
    return 5306 + 71 * (log_n - 16) - (2 if log_n < 16 else 0)


def proof_checks(run, device, log_n: int, nat) -> None:
    """The proof of the main path: a second proof of the same inputs repeats
    it exactly, and its 15 witness, z and 7 t commitments equal the native
    host MSM of the fetched coefficients and blinders over g ++ [h]; its
    quotient's remainder is zero; its size; the verifier's rejections; and
    the fixed 2^5 circuit proved on the card byte for byte."""
    import copy
    import pathlib

    from proof_systems_tpu_torch.ops import limb
    from proof_systems_tpu_torch.fields import Fp

    if not run["proof_debug"]["quotient_rem_zero"]:
        raise AssertionError("the quotient's remainder by the vanishing polynomial is not zero")
    if run["proof_bytes"] != proof_size(log_n):
        raise AssertionError(f"proof is {run['proof_bytes']} bytes, expected {proof_size(log_n)}")
    log(f"check: the k = {log_n} proof verifies, its quotient remainder is zero, and it "
        f"serializes to {run['proof_bytes']} bytes")

    srs, n = run["srs"], 1 << log_n
    calls = []
    commit = srs.commit_coeffs_dev

    def spy(coeffs, num_chunks=1, blinders=None):
        out = commit(coeffs, num_chunks, blinders)
        calls.append((coeffs, num_chunks, blinders, out))
        return out

    srs.commit_coeffs_dev = spy  # an instance attribute over the method
    again = prove(run)
    del srs.commit_coeffs_dev
    if again != run["kproof"]:
        raise AssertionError("a second proof of the same inputs differs")
    t0 = time.perf_counter()
    F, basis, jobs, got = limb.device_field(Fp), srs.g + [srs.h], [], []
    for coeffs, num_chunks, blinders, out in calls:
        rows = limb.limbs_to_ints(limb.from_mont(F, coeffs))
        b, L = coeffs.shape[1], coeffs.shape[2]
        chunks = max(-(-L // n), num_chunks)
        for i in range(b):
            row = rows[i * L : (i + 1) * L]
            row += [0] * (chunks * n - L)
            for ci in range(chunks):
                jobs.append(row[ci * n : (ci + 1) * n] + [blinders[i][ci]])
            got += out[i].chunks
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        want = list(pool.map(lambda sc: nat.msm(sc, basis), jobs))
    if [len(c[3]) for c in calls] != [COLUMNS, 1, 1] or got != want:
        raise AssertionError("the proof's commitments differ from the host MSM")
    log(f"check: the proof repeats exactly; its {COLUMNS} witness, z and "
        f"{len(calls[2][3][0].chunks)} t commitments equal the host MSM over g ++ [h] "
        f"({time.perf_counter() - t0:.1f} s on the host)")

    bad = copy.deepcopy(run["kproof"])
    bad.ft_eval1 = (bad.ft_eval1 + 1) % Fp.p
    if verify_proof(run, bad, SEED + 2):
        raise AssertionError("verify accepted ft_eval1 + 1")
    bad = copy.deepcopy(run["kproof"])
    bad.evals.w[0].zeta[0] = (bad.evals.w[0].zeta[0] + 1) % Fp.p
    if verify_proof(run, bad, SEED + 3):
        raise AssertionError("verify accepted a changed witness evaluation")
    log("check: verify rejects the proof with ft_eval1 + 1 and with a changed witness evaluation")

    golden = golden_proof(device)
    want = (pathlib.Path(__file__).resolve().parent / GOLDEN_PROOF).read_bytes()
    if golden != want:
        raise AssertionError(f"the fixed 2^5 circuit's proof differs from {GOLDEN_PROOF}")
    log(f"check: the fixed 2^5 circuit proved on the card is byte-identical to {GOLDEN_PROOF} "
        f"({len(golden)} bytes)")


def golden_proof(device) -> bytes:
    """The fixed circuit of tests/test_serialization.py:122-136: 22 Const(1)
    gates over a 32-point derived SRS, bench_witness(22), TestRng(5)."""
    from proof_systems_tpu_torch.circuits.builders import bench_circuit, bench_witness
    from proof_systems_tpu_torch.circuits.constraints import ConstraintSystem
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.poly_commitment.srs import SRS, derive_g, derive_h
    from proof_systems_tpu_torch.prover import create_proof
    from proof_systems_tpu_torch.prover_index import ProverIndex
    from proof_systems_tpu_torch.serialization import serialize_proof
    from proof_systems_tpu_torch.utils.rng import TestRng

    srs = SRS(Vesta, [derive_g(Vesta, i) for i in range(32)], derive_h(Vesta), device)
    cs = ConstraintSystem.create(Fp, bench_circuit(Fp, 22), public=0, max_poly_size=32,
                                 device=device)
    proof = create_proof(ProverIndex(cs, Vesta, srs), bench_witness(22), TestRng(5))
    return serialize_proof(Vesta, proof)


def residency_check(run) -> None:
    """The rounds of an opening wait for the host nowhere: CUDA's sync debug
    mode is "error" inside every fold step and the tail, so a torch op that
    synchronises there raises. The opening must repeat exactly."""
    from proof_systems_tpu_torch.poly_commitment import ipa

    saved = (ipa._ipa_fold_step, ipa._ipa_tail_rounds)

    def strict(fn):
        def wrapper(*args, **kw):
            torch.cuda.set_sync_debug_mode("error")
            out = fn(*args, **kw)
            torch.cuda.set_sync_debug_mode("default")
            return out

        return wrapper

    # a failure here ends the script, so nothing is restored on that path
    ipa._ipa_fold_step, ipa._ipa_tail_rounds = (strict(fn) for fn in saved)
    proof = open_proof(run)
    ipa._ipa_fold_step, ipa._ipa_tail_rounds = saved
    if vars(proof) != vars(run["proof"]):
        raise AssertionError("a second opening of the same inputs differs")
    log("check: no host synchronisation inside the rounds (sync debug mode 'error' "
        "around each fold step and the tail); the opening repeats exactly")


def new_paths(kernels, result, device, log_n: int, checked: set, verify_kernels) -> None:
    """The recursion, chunked, lookup (a fixed and a runtime table),
    optional-gate vector, gate-mix, batch and verifier-index-file paths,
    each counted (every kernel of a k = 16 proof but K3 must launch; the
    vectors, the batch and the files launch what a verification does), then
    each one's kernel calls held against the plain versions."""
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.native import native_curve

    every = [k for k in kernels.WRAPPERS if k not in NOT_ON_A_PROOF]
    times = result["times"]
    nat = native_curve(Vesta)
    phases = [
        ("recursion", f"k = {log_n}, {RECURSION_CHALLENGES} challenges", every,
         lambda: recursion_path(result, log_n, device, nat), ("prove_rec_ms", "verify_rec_ms")),
        ("chunked", f"domain 2^{log_n + 1} over 2^{log_n} points", every,
         lambda: chunked_path(result, log_n, device),
         ("index_chunked_s", "prove_chunked_ms", "verify_chunked_ms")),
        ("lookup", f"k = {log_n}, a fixed and a runtime table", every,
         lambda: {**lookup_path(result, log_n, device, runtime=False),
                  **lookup_path(result, log_n, device, runtime=True)}, None),
        ("optional vector", "the gadget circuits' committed proofs, n = 32 and 8,192",
         verify_kernels, lambda: vectors_path(result, device), None),
        ("optional gates", f"k = {log_n}, the gate mix of ECDSA and Keccak gadgets", every,
         lambda: optional_path(result, log_n, device), None),
        ("column", f"o1vm's column prover, k = {log_n}: a cyclic trace, LogUp, MultiLogUp",
         COLUMN_KERNELS, lambda: column_path(result, log_n, device, nat), None),
        ("keccak", "o1vm's Keccak-f proof, n = 32, the JAX package's vector", KECCAK_KERNELS,
         lambda: keccak_path(result, device), None),
        ("riscv", f"o1vm's RV32IM proofs, n = 256 (the JAX package's vector) and "
         f"2^{RV_COMBINED_LOG_N}", COLUMN_KERNELS,
         lambda: riscv_path(result, device, RV_COMBINED_LOG_N), None),
        ("mips", f"o1vm's MIPS proofs, n = 256 and 512 (the JAX package's vectors) and "
         f"2^{MIPS_COMBINED_LOG_N}", COLUMN_KERNELS,
         lambda: mips_path(result, device, MIPS_COMBINED_LOG_N), None),
        ("msm", f"the foreign-field MSM circuit, n = 256 (the JAX package's vector) and "
         f"Layout() over secp256k1 at 2^{MSM_LOG_N}, {MSM_POINTS} points", COLUMN_KERNELS,
         lambda: msm_path(result, device), None),
        ("folding", f"arrabbiata IVC over Vesta / Fp and Pallas / Fq, n = 2^{FOLD_LOG_N}, "
         f"{FOLD_STEPS} steps, the deciders (the JAX package's vectors) and the CLI",
         FOLD_KERNELS, lambda: folding_path(result, device), None),
        ("batch", "five proofs of four circuits", verify_kernels,
         lambda: batch_path(result, device), ("batch_verify_ms", "single_verify_sum_ms")),
        ("vk files", "bench, lookup, chunked, gate mix", verify_kernels,
         lambda: vk_file_path(result, device), None),
    ]
    for tag, what, expect, fn, keys in phases:
        log(f"== {tag} path, {what}, counted")
        before = set(times)
        (out, _, calls), secs = wall(lambda: counted(kernels, tag, fn, device, expect), device)
        part(tag, secs)
        result.update(out)
        for k in keys or sorted(set(times) - before):
            log(f"{tag} path {k}: {times[k]:.4f}")
        _, secs = wall(lambda: check_path_calls(kernels, calls, tag.replace(" ", "_"), device,
                                                checked), device)
        part(f"{tag} plain checks", secs)
        del calls
        if tag in ("chunked", "optional gates"):
            before = set(times)
            (chunked_steady if tag == "chunked" else optional_steady)(result, device)
            for k in sorted(set(times) - before):
                log(f"{tag} path {k}: {times[k]:.4f}")


def phase_alone(name: str, device, log_n: int, points: int = MSM_POINTS) -> None:
    """One phase by itself (`--only column`, `keccak`, `riscv`, `mips`, `msm`
    or `folding`): SRS.create(2^k) on the card, the phase counted, its
    kernel calls held against the plain versions, every number printed; no
    result line. For riscv and mips, 2^k is also the full-width case's
    domain; msm runs `points` points at 2^16."""
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.native import native_curve
    from proof_systems_tpu_torch.ops import kernels
    from proof_systems_tpu_torch.poly_commitment.srs import SRS

    result = dict(srs=SRS.create(Vesta, 1 << log_n, device=device), times={})
    fn, expect = {
        "column": (lambda: column_path(result, log_n, device, native_curve(Vesta)),
                   COLUMN_KERNELS),
        "keccak": (lambda: keccak_path(result, device), KECCAK_KERNELS),
        "riscv": (lambda: riscv_path(result, device, log_n), COLUMN_KERNELS),
        "mips": (lambda: mips_path(result, device, log_n), COLUMN_KERNELS),
        "msm": (lambda: msm_path(result, device, points), COLUMN_KERNELS),
        "folding": (lambda: folding_path(result, device), FOLD_KERNELS)}[name]
    log(f"== {name} path alone, k = {log_n}, counted")
    _, _, calls = counted(kernels, name, fn, device, expect)
    for k in sorted(result["times"]):
        log(f"{name} path {k}: {result['times'][k]:.4f}")
    check_path_calls(kernels, calls, name, device, set())


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def run(device, log_n: int = LOG_N, cache_dir=None) -> list[dict]:
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.ops import kernels

    mark = time.perf_counter()
    if device.type == "cuda":
        log("== one product's latency")
        product_latency(kernels, device)

    log(f"== warm-up main path, k = {log_n}, recording kernel inputs")
    with Recorder(kernels) as rec:
        warm, warm_s = wall(lambda: main_path(log_n, device, cache_dir), device)
    log(f"warm-up main path: {warm_s:.2f} s (includes SRS derivation or cache read)")
    # the other paths' calls are recorded apart, so that their own shapes
    # (K6, K2, K7 and K8 at b = PUBLIC_M, K4 on PUBLIC_M points; the k = 11
    # tail) are held against the plain versions too
    # (a call shape that the main path recorded already is checked once)
    recorded = dict(rec.calls)
    checked = {call_sig(k, c[1], c[2]) for k, c in rec.calls.items()}  # held against the plain
    for tag, fn in (("lagrange", lambda: lagrange_once(warm, log_n, device)),
                    ("public", lambda: public_path(warm, log_n, device)),
                    (f"k{BENCH_K}", lambda: bench_path(device, cache_dir))):
        with Recorder(kernels) as rec:
            _, secs = wall(fn, device)
        log(f"warm-up {tag} path: {secs:.2f} s")
        recorded.update({f"{key}[{tag}]": call for key, call in rec.calls.items()
                         if call_sig(key, call[1], call[2]) not in checked})
        checked.update(call_sig(k, c[1], c[2]) for k, c in rec.calls.items())
    del warm, rec

    mark = part_since("warm-up", mark)
    log("== kernels against their plain versions")
    table = check_kernels(kernels, recorded, device, Vesta)
    del recorded
    mark = part_since("plain checks", mark)

    log(f"== main path, k = {log_n}, Vesta, counted")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launch_counts()
    result = main_path(log_n, device, cache_dir)
    sync(device)
    counts = kernels.launch_counts()
    for k, v in result["times"].items():
        log(f"main path {k}: {v:.4f}")
    log(f"main path launches: {json.dumps(counts)}")
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        log(f"main path peak device memory: {peak:.2f} GiB")
    zero = [k for k, v in counts.items() if v == 0]
    if zero and device.type == "cuda":  # the CPU's plain versions launch nothing
        raise AssertionError(f"kernels not launched on the main path: {zero}")
    for row in table:
        row["launches"] = counts[row["name"]]

    mark = part_since("main path", mark)
    log(f"== public-input path, k = {log_n}, m = {PUBLIC_M}, counted")
    kernels.reset_launch_counts()
    result.update(public_path(result, log_n, device))
    sync(device)
    counts = kernels.launch_counts()
    log(f"public path launches: {json.dumps(counts)}")
    for k in ("index_pub_s", "lagrange_first_s", "lagrange_cached_s", "lagrange_disk_s",
              "prove_pub_ms", "verify_pub_ms"):
        log(f"public path {k}: {result['times'][k]:.4f}")
    zero = [k for k, v in counts.items() if v == 0 and k != "jacobian_double"]
    if zero and device.type == "cuda":  # K3 builds the scaled basis, made once per SRS
        raise AssertionError(f"kernels not launched on the public-input path: {zero}")

    mark = part_since("public path", mark)
    log(f"== bench path, k = {BENCH_K} (bench_torch.setup, prove_once), counted")
    bench = bench_path(device, cache_dir)
    log(f"bench path launches per proof: {json.dumps(bench['counts'])}")
    log(f"bench path k = {BENCH_K}: prove_ms {bench['prove_ms']:.3f}  verify_ms "
        f"{bench['verify_ms']:.3f}  proof_bytes {bench['proof_bytes']}  rounds {bench['rounds']}")
    if bench["counts"]["endo_ladder"] != 0:
        raise AssertionError(f"the k = {BENCH_K} opening ran a fold step (endo ladder launched)")
    missing = [k for k in TAIL_KERNELS if bench["counts"][k] == 0]
    if missing and device.type == "cuda":
        raise AssertionError(f"kernels of the tail not launched at k = {BENCH_K}: {missing}")
    if bench["proof_bytes"] != proof_size(BENCH_K) or bench["rounds"] != BENCH_K:
        raise AssertionError(
            f"the k = {BENCH_K} proof is {bench['proof_bytes']} bytes with {bench['rounds']} "
            f"rounds, expected {proof_size(BENCH_K)} and {BENCH_K}")
    log(f"check: the k = {BENCH_K} proof verifies with no fold step (0 endo ladder launches, "
        f"{BENCH_K} tail rounds) and serializes to {bench['proof_bytes']} bytes")

    mark = part_since("bench path", mark)
    kernels.reset_launch_counts()
    result["srs"].commit_coeffs_dev(result["w_coeffs"], 1, result["blinders"])
    log(f"launches per 15-column commit: {json.dumps(kernels.launch_counts())}")
    kernels.reset_launch_counts()
    open_proof(result)
    log(f"launches per opening: {json.dumps(kernels.launch_counts())}")
    kernels.reset_launch_counts()
    verify(result, result["proof"])
    log(f"launches per verification: {json.dumps(kernels.launch_counts())}")
    kernels.reset_launch_counts()
    prove(result)
    log(f"launches per proof: {json.dumps(kernels.launch_counts())}")
    kernels.reset_launch_counts()
    verify_proof(result, result["kproof"])
    verify_kernels = [k for k, v in kernels.launch_counts().items() if v]
    log(f"launches per proof verification: {json.dumps(kernels.launch_counts())}")
    log(f"proof_bytes: {result['proof_bytes']}")
    for k, v in steady_times(result, device).items():
        log(f"steady {k}: {v:.3f}")
    if device.type == "cuda":
        kernel_times(result, device)
    part_since("launches, steady times and kernel times", mark)
    new_paths(kernels, result, device, log_n, checked, verify_kernels)

    mark = time.perf_counter()
    log("== checks")
    golden_checks(result, device, log_n)
    part_since("checks", mark)
    return table


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-n", type=int,
                    help=f"log2 of the SRS depth and domain (default {LOG_N}; from 14 on "
                         "every kernel is on the path); with --only riscv or mips, of the "
                         f"full-width RV32IM or MIPS domain (default {RV_LOG_N}, {MIPS_LOG_N})")
    ap.add_argument("--only", choices=["column", "keccak", "riscv", "mips", "msm", "folding"],
                    help="run one phase by itself and print its numbers (no result line)")
    ap.add_argument("--points", type=int, default=MSM_POINTS,
                    help=f"with --only msm, the MSM's points (default {MSM_POINTS})")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from proof_systems_tpu_torch.native import native_curve
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.ops import kernels

    device = torch.device("cuda")
    log("== build")
    lib = kernels.LIBRARY.load()
    log(f"build: CUDA kernels {lib.build_seconds:.1f} s (0 = already built); each unit's nvcc: "
        + ", ".join(f"{src} {secs:.1f} s" for src, secs in lib.unit_seconds.items()))
    part("build", lib.build_seconds)
    for line in lib.ptxas_log.splitlines():
        if any(k in line for k in ("entry function", "Function properties", "registers",
                                    "spill")) or line.startswith("=="):
            log("ptxas: " + line.strip())
    t0 = time.perf_counter()
    if native_curve(Vesta) is None:
        raise AssertionError("the native host MSM did not build (g++)")
    log(f"build: native host MSM {time.perf_counter() - t0:.1f} s")
    part("native build", time.perf_counter() - t0)

    card = card_line()
    log(f"== card: {torch.cuda.get_device_name(0)} | {card}")
    log_n = args.log_n or {"riscv": RV_LOG_N, "mips": MIPS_LOG_N, "msm": MSM_LOG_N,
                           "folding": FOLD_LOG_N}.get(args.only, LOG_N)
    if args.only:
        phase_alone(args.only, device, log_n, args.points)
        log(f"== card: {card}")
        return 0
    table = run(device, log_n)
    log(f"parts: {json.dumps({k: round(v, 1) for k, v in PARTS.items()})}")
    log(f"part build and plain checks: {PARTS['build'] + PARTS['plain checks']:.1f} s; "
        f"whole script {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
