"""PyTorch + CUDA port of proof_systems_tpu (slice 1: the witness-commit
path; slice 2: evaluation, IPA opening and batch verification; slice 3: the
circuit layer and whole proofs: prove, verify, serialize).

The JAX package `proof_systems_tpu` is the reference; this package imports
neither it nor JAX. Field elements are Montgomery integers with R = 2^256
held as (8, ...) int32 tensors of 32-bit limbs (limb-major, little-endian).
"""

from pathlib import Path

# Repo-root `build/` (gitignored): the CUDA kernel libraries, the native host
# library and the SRS point cache are made there at first use.
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
