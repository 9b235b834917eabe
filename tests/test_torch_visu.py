"""The port's circuit visualiser (utils/visu.py) and its Poseidon
test-vector exporter (scripts/export_test_vectors_torch.py) against the
JAX package's: the same HTML page and text dump on the same circuit and
witness, and the same JSON for every parameter set and mode."""

import json
import pathlib
import subprocess
import sys

import pytest

from proof_systems_tpu.circuits.builders import bench_circuit as jbench_circuit
from proof_systems_tpu.circuits.constraints import ConstraintSystem as JConstraintSystem
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.utils import visu as jvisu
from proof_systems_tpu_torch.circuits.builders import bench_circuit, bench_witness
from proof_systems_tpu_torch.circuits.constraints import ConstraintSystem
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.utils import visu

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _witness(n: int, gates: int) -> list[list[int]]:
    w = bench_witness(gates)
    for col in w:
        col.extend([0] * (n - len(col)))
    w[3][1] = Fp.p - 5  # a negative value and a wide one, printed short
    w[4][2] = (1 << 200) + 12345
    return w


@pytest.mark.parametrize("gates", [8, 70])
def test_visualize_and_witness_text_match(gates):
    cs = ConstraintSystem.create(Fp, bench_circuit(Fp, gates), public=2, max_poly_size=128,
                                 device="cpu")
    jcs = JConstraintSystem.create(JFp, jbench_circuit(JFp, gates), public=2, max_poly_size=128)
    w = _witness(cs.domain.d1.n, gates)
    page = visu.visualize(cs, w)
    assert "<table>" in page and "Generic" in page and "wired" in page
    assert page == jvisu.visualize(jcs, w)
    assert visu.visualize(cs) == jvisu.visualize(jcs)
    txt = visu.witness_text(cs, w)
    assert "Generic" in txt
    assert txt == jvisu.witness_text(jcs, w)
    assert visu.witness_text(cs, w, max_rows=4) == jvisu.witness_text(jcs, w, max_rows=4)


def _export(script: str, mode: str, name: str, out: pathlib.Path) -> dict:
    r = subprocess.run([sys.executable, f"scripts/{script}", mode, name, str(out)],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return json.loads(out.read_text())


@pytest.mark.parametrize("mode", ["hex", "b10"])
@pytest.mark.parametrize("name", ["fp_kimchi", "fp_legacy", "fq_kimchi", "fq_legacy"])
def test_exporters_agree(tmp_path, mode, name):
    doc = _export("export_test_vectors_torch.py", mode, name, tmp_path / "torch.json")
    assert doc["name"] == name and len(doc["test_vectors"]) == 12
    assert doc == _export("export_test_vectors.py", mode, name, tmp_path / "jax.json")


def test_exporter_stdout_loads_no_jax():
    code = ("import runpy, sys\n"
            "sys.argv = ['x', 'hex', 'fq_legacy']\n"
            "runpy.run_path('scripts/export_test_vectors_torch.py', run_name='__main__')\n"
            "bad = {k.split('.')[0] for k in sys.modules} & {'jax', 'jaxlib', 'proof_systems_tpu'}\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout)["name"] == "fq_legacy"
