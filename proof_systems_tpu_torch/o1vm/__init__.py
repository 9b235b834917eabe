"""o1vm: zkVM proving (reference: o1vm/), on the card.

Counterpart of proof_systems_tpu/o1vm. pickles.py is the generic
fixed-column prover/verifier (o1vm/src/pickles/{prover,verifier}.rs) and
logup.py the LogUp lookup argument over it; interpreters build column
traces and constraint expressions on top of them.
"""

from .pickles import ColumnProof, prove_columns, verify_columns

__all__ = ["ColumnProof", "prove_columns", "verify_columns"]
