"""o1vm: zkVM proving (reference: o1vm/), on the card.

Counterpart of proof_systems_tpu/o1vm. pickles.py is the generic
fixed-column prover/verifier (o1vm/src/pickles/{prover,verifier}.rs) and
logup.py the LogUp lookup argument over it; interpreters build column
traces and constraint expressions on top of them: keccak.py (the Keccak-f
permutation), riscv.py (RV32IM execution) and mips.py (MIPS execution, with
cannon.py's Cannon witness runner, elf.py's loader and cli.py's
`cannon run`). `prove_execution` / `verify_execution` are RV32IM's;
MIPS's are `prove_mips` / `verify_mips` (mips.prove_execution and
mips.verify_execution).
"""

from .keccak import prove_keccak, verify_keccak
from .mips import prove_execution as prove_mips
from .mips import verify_execution as verify_mips
from .pickles import ColumnProof, prove_columns, verify_columns
from .riscv import prove_execution, verify_execution

__all__ = ["ColumnProof", "prove_columns", "verify_columns", "prove_keccak", "verify_keccak",
           "prove_execution", "verify_execution", "prove_mips", "verify_mips"]
