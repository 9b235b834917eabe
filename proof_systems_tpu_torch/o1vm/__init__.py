"""o1vm: zkVM proving (reference: o1vm/), on the card.

Counterpart of proof_systems_tpu/o1vm. pickles.py is the generic
fixed-column prover/verifier (o1vm/src/pickles/{prover,verifier}.rs) and
logup.py the LogUp lookup argument over it; interpreters build column
traces and constraint expressions on top of them: keccak.py (the Keccak-f
permutation) and riscv.py (RV32IM execution).
"""

from .keccak import prove_keccak, verify_keccak
from .pickles import ColumnProof, prove_columns, verify_columns
from .riscv import prove_execution, verify_execution

__all__ = ["ColumnProof", "prove_columns", "verify_columns", "prove_keccak", "verify_keccak",
           "prove_execution", "verify_execution"]
