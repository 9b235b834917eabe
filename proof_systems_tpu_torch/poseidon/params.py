"""Poseidon sponge parameters for the Pasta fields.

Counterpart of proof_systems_tpu/poseidon/params.py. The constant tables in
data/*.json are byte-for-byte copies of the JAX package's (lifted from the
reference's generated sage output, poseidon/src/pasta/*.rs) and are read
lazily. The shape constants mirror poseidon/src/constants.rs:
  - kimchi: width 3, rate 2, 55 full rounds, sbox x^7, full MDS, no initial ark
  - legacy: width 3, rate 2, 63 full rounds, sbox x^5, full MDS, initial ark
"""

from __future__ import annotations

import functools
import json
import pathlib
from dataclasses import dataclass

from ..fields import FieldParams, Fp, Fq

_DATA = pathlib.Path(__file__).parent / "data"


@dataclass(frozen=True)
class PoseidonParams:
    name: str
    field: FieldParams
    rounds_full: int
    sbox: int
    initial_ark: bool
    sponge_width: int = 3
    sponge_rate: int = 2

    @functools.cached_property
    def _tables(self) -> tuple[tuple[tuple[int, ...], ...], tuple[tuple[int, ...], ...]]:
        raw = json.loads((_DATA / f"{self.name}.json").read_text())
        mds = tuple(tuple(int(x) for x in row) for row in raw["mds"])
        rcs = tuple(tuple(int(x) for x in row) for row in raw["round_constants"])
        return mds, rcs

    @property
    def mds(self) -> tuple[tuple[int, ...], ...]:
        return self._tables[0]

    @property
    def round_constants(self) -> tuple[tuple[int, ...], ...]:
        return self._tables[1]


fp_kimchi = PoseidonParams("fp_kimchi", Fp, rounds_full=55, sbox=7, initial_ark=False)
fq_kimchi = PoseidonParams("fq_kimchi", Fq, rounds_full=55, sbox=7, initial_ark=False)
fp_legacy = PoseidonParams("fp_legacy", Fp, rounds_full=63, sbox=5, initial_ark=True)
fq_legacy = PoseidonParams("fq_legacy", Fq, rounds_full=63, sbox=5, initial_ark=True)
# arrabbiata's IVC instance: width 3, 60 full rounds, x^5
# (arrabbiata/src/curve.rs:24-33, poseidon_3_60_0_5_5_{fp,fq}.rs)
fp_3_60_0_5_5 = PoseidonParams("fp_3_60_0_5_5", Fp, rounds_full=60, sbox=5, initial_ark=False)
fq_3_60_0_5_5 = PoseidonParams("fq_3_60_0_5_5", Fq, rounds_full=60, sbox=5, initial_ark=False)
