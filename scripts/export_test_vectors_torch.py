#!/usr/bin/env python
"""Poseidon test-vector exporter on the PyTorch port's sponge.

Usage:
    python scripts/export_test_vectors_torch.py [hex|b10] [fp_kimchi|fq_kimchi|fp_legacy|fq_legacy] [out.json]

The same arguments and the same JSON ({name, test_vectors: [{input,
output}]}) as scripts/export_test_vectors.py, computed by
proof_systems_tpu_torch.poseidon on the host: no card, no JAX.
"""

import hashlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from proof_systems_tpu_torch.poseidon import fp_kimchi, fp_legacy, fq_kimchi, fq_legacy
from proof_systems_tpu_torch.poseidon.sponge import ArithmeticSponge

PARAMS = {
    "fp_kimchi": fp_kimchi,
    "fq_kimchi": fq_kimchi,
    "fp_legacy": fp_legacy,
    "fq_legacy": fq_legacy,
}


def deterministic_inputs(p: int, count: int, width: int) -> list[list[int]]:
    """Reproducible pseudo-random field elements (blake2b counter)."""
    out = []
    for i in range(count):
        row = []
        for j in range(width):
            h = hashlib.blake2b(f"pst-vector-{i}-{j}".encode(), digest_size=32).digest()
            row.append(int.from_bytes(h, "little") % p)
        out.append(row)
    return out


def hash_vector(params, inputs: list[int]) -> int:
    sponge = ArithmeticSponge(params)
    for x in inputs:
        sponge.absorb(x)
    return sponge.squeeze()


def vectors_doc(mode: str, name: str) -> dict:
    params = PARAMS[name]
    p = params.field.p

    def enc(x: int) -> str:
        return x.to_bytes(32, "little").hex() if mode == "hex" else str(x)

    vectors = []
    for nin in range(6):
        for row in deterministic_inputs(p, 2, nin):
            vectors.append(
                {"input": [enc(v) for v in row], "output": enc(hash_vector(params, row))}
            )
    return {"name": name, "test_vectors": vectors}


def main() -> int:
    mode = sys.argv[1] if len(sys.argv) > 1 else "hex"
    name = sys.argv[2] if len(sys.argv) > 2 else "fp_kimchi"
    doc = vectors_doc(mode, name)
    out = json.dumps(doc, indent=2)
    if len(sys.argv) > 3:
        Path(sys.argv[3]).write_text(out)
        print(f"wrote {len(doc['test_vectors'])} vectors to {sys.argv[3]}")
    else:
        print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
