"""PyTorch + CUDA port of proof_systems_tpu (slice 1: the witness-commit
path; slice 2: evaluation, IPA opening and batch verification; slice 3: the
circuit layer and whole proofs: prove, verify, serialize; later slices:
lookups, chunked proofs, recursion, the optional gates, o1vm's column
prover and LogUp). `prove` and `verify` below are the package-level entry
points of the JAX package's `__init__`.

The JAX package `proof_systems_tpu` is the reference; this package imports
neither it nor JAX. Field elements are Montgomery integers with R = 2^256
held as (8, ...) int32 tensors of 32-bit limbs (limb-major, little-endian).
"""

from pathlib import Path

# Repo-root `build/` (gitignored): the CUDA kernel libraries, the native host
# library and the SRS point cache are made there at first use.
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"


def _on(device, where, what: str) -> None:
    """Refuse an index that does not live on the device the call names (the
    card unless the caller passes device="cpu")."""
    from .runtime import resolve_device

    dev = resolve_device(device)
    if where.type != dev.type:
        raise ValueError(f"{what} is on {where}, expected {dev}")


def prove(index, witness, rng, prev_challenges=(), runtime_tables=None, device=None):
    """Create a kimchi proof (see prover.create_proof) on `device`."""
    from .prover import create_proof

    _on(device, index.device, "the prover index")
    return create_proof(index, witness, rng, prev_challenges, runtime_tables=runtime_tables)


def verify(vk, proof, public_input, rng, device=None):
    """Verify a kimchi proof (see verifier.verify) on `device`."""
    from .verifier import verify as _verify

    _on(device, vk.srs.device, "the verifier index's SRS")
    return _verify(vk, proof, public_input, rng)
