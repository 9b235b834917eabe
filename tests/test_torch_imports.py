"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the caller asks for the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "proof_systems_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "bench_torch.py",
    ROOT / "scripts" / "export_test_vectors_torch.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "proof_systems_tpu")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), f"{path}: imports {names}"


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import proof_systems_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "import bench_torch\n"
        "tops = {k.split('.')[0] for k in sys.modules}\n"
        "bad = tops & {'jax', 'jaxlib', 'proof_systems_tpu'}\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('proof_systems_tpu_torch')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 18


# The host modules of the optional gates, the witness builders, the checker
# and the snarky front end (each a copy of the JAX package's host code).
HOST_MODULES = ["circuits.polynomials.optional_gates", "circuits.polynomials.optional_witness",
                "circuits.polynomials.witness_gen", "circuits.checker", "circuits.snarky",
                "circuits.gate_mix", "o1vm", "o1vm.pickles", "o1vm.logup", "o1vm.keccak",
                "o1vm.riscv", "o1vm.mips", "o1vm.cannon", "o1vm.elf", "o1vm.cli", "msm_circuit",
                "folding", "folding.mvpoly", "folding.arrabbiata", "folding.ivc", "folding.cli",
                "mina", "mina.base58", "mina.hasher", "mina.signer", "mina.tx_type", "pairing",
                "pairing.bn254", "poly_commitment.kzg", "utils.visu"]
# The multi-device layer on torch.distributed.
MESH_MODULES = ["parallel", "parallel.auto", "parallel.ntt", "parallel.mesh", "parallel.spawn",
                "parallel.dryrun"]


@pytest.mark.parametrize("module", HOST_MODULES + MESH_MODULES)
def test_host_module_loads_no_jax(module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('proof_systems_tpu_torch.{module}')\n"
        "bad = {k.split('.')[0] for k in sys.modules} & {'jax', 'jaxlib', 'proof_systems_tpu'}\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr


def _stub_vk_file(path) -> None:
    """A verifier-index file of the 32-point bench domain whose commitments
    are all the point at infinity (written on the host, no MSM)."""
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.ops import ntt
    from proof_systems_tpu_torch.poly_commitment.commitment import PolyComm
    from proof_systems_tpu_torch.verifier_index import VerifierIndex

    zero = PolyComm([None])
    VerifierIndex(
        curve=Vesta, domain=ntt.ntt_plan(Fp, 5, device="cpu"), max_poly_size=32, zk_rows=3,
        public=0, sigma_comm=[zero] * 7, coefficients_comm=[zero] * 15, generic_comm=zero,
        psm_comm=zero, complete_add_comm=zero, mul_comm=zero, emul_comm=zero,
        endomul_scalar_comm=zero, shift=[1] * 7, endo=0, zkpm_eval=None, srs=None,
        linearization_expr=None, alphas=None, zk_w=0,
    ).to_file(path)


def _entry_points(tmp_path):
    import numpy as np

    from proof_systems_tpu_torch import convert, verifier
    from proof_systems_tpu_torch.circuits import gate_mix
    from proof_systems_tpu_torch.circuits.constraints import ConstraintSystem
    from proof_systems_tpu_torch.circuits.gate import CircuitGate, GateType, new_wires
    from proof_systems_tpu_torch.circuits.lookup import LookupTable
    from proof_systems_tpu_torch.curves import Vesta
    from proof_systems_tpu_torch.fields import Fp
    from proof_systems_tpu_torch.ops import limb, msm, ntt
    from proof_systems_tpu_torch.poly_commitment.srs import SRS, derive_g, derive_h
    from proof_systems_tpu_torch.serialization import deserialize_proof
    from proof_systems_tpu_torch.utils.rng import TestRng
    from proof_systems_tpu_torch.verifier_index import VerifierIndex

    scal = torch.zeros((limb.NLIMBS, 1, 4), dtype=torch.int32)
    lookup_gates = [CircuitGate(GateType.Lookup, new_wires(r), []) for r in range(4)]
    table = LookupTable(0, [list(range(4)), [i * i for i in range(4)]])
    g, h = [derive_g(Vesta, i) for i in range(32)], derive_h(Vesta)

    def batch_verify():
        # an SRS made without a device: verification goes to the card
        path = tmp_path / "vk.bin"
        _stub_vk_file(path)
        vk = VerifierIndex.from_file(path, SRS(Vesta, g, h, torch.device("cpu")))
        vk.srs = SRS(Vesta, g, h, None)
        proof = deserialize_proof(Vesta, (ROOT / "tests/vectors/proof_2^5.bin").read_bytes())
        return verifier.batch_verify([(vk, proof, [])], TestRng(0))

    def from_file():
        path = tmp_path / "vk.bin"
        _stub_vk_file(path)
        return VerifierIndex.from_file(path, SRS(Vesta, g, h, None))

    def column_proof():
        from proof_systems_tpu_torch.circuits import expr as E
        from proof_systems_tpu_torch.circuits.domains import EvaluationDomains
        from proof_systems_tpu_torch.o1vm.pickles import col, prove_columns

        cpu = torch.device("cpu")
        cols = limb.device_field(Fp).pack_mont([1] * 4, shape=(1, 4), device=cpu)
        return prove_columns(EvaluationDomains.create(Fp, 4, device=cpu),
                             SRS(Vesta, g[:4], h, cpu), Vesta, cols,
                             [E.Cell(col(0), E.CURR) - E.Literal(1)], TestRng(0))

    def logup_instance():
        from proof_systems_tpu_torch.circuits.domains import EvaluationDomains
        from proof_systems_tpu_torch.o1vm import logup

        cpu = torch.device("cpu")
        inst = logup.LogupInstance(Fp, [[i % 4] for i in range(4)], logup.range_table(2, 4))
        return inst.prove(EvaluationDomains.create(Fp, 4, device=cpu), SRS(Vesta, g[:4], h, cpu),
                          Vesta, TestRng(0))

    def o1vm_entry(name):
        """keccak's, riscv's and mips's entry points on a 32-row CPU domain
        and SRS, the device left to its default."""
        from proof_systems_tpu_torch.circuits.domains import EvaluationDomains
        from proof_systems_tpu_torch.o1vm import keccak, mips, riscv

        cpu = torch.device("cpu")
        domain, srs = EvaluationDomains.create(Fp, 32, device=cpu), SRS(Vesta, g, h, cpu)
        state0 = [[0] * 5 for _ in range(5)]
        program = [riscv.Instr("ADDI", rd=1, rs1=0, imm=1)]
        statement = dict(program=program, k_steps=1, regs0=[0] * 32, init_memory={},
                         bitwise_bits=2, final=dict(regs=[0, 1] + [0] * 30, pc=4, memory={},
                                                    last_access={}))
        return {
            "prove_keccak": lambda: keccak.prove_keccak(domain, srs, Vesta, state0, TestRng(0)),
            "verify_keccak": lambda: keccak.verify_keccak(domain, srs, Vesta, None, state0,
                                                          keccak.keccak_f(state0), TestRng(0)),
            "prove_execution": lambda: riscv.prove_execution(domain, srs, Vesta, program, 32,
                                                             TestRng(0), L=riscv.Layout(2)),
            "verify_execution": lambda: riscv.verify_execution(domain, srs, Vesta, None,
                                                               statement, TestRng(0)),
            "prove_mips": lambda: mips.prove_execution(
                domain, srs, Vesta, [mips.Instr("ADDIU", rt=1, rs=0, imm=1)], 32, TestRng(0),
                L=mips.Layout(2)),
            "verify_mips": lambda: mips.verify_execution(domain, srs, Vesta, None, {},
                                                         TestRng(0)),
        }[name]()

    def msm_entry(name):
        """msm_circuit's and folding's entry points on CPU domains and SRSs,
        the device left to its default."""
        from proof_systems_tpu_torch import msm_circuit
        from proof_systems_tpu_torch.circuits import expr as E
        from proof_systems_tpu_torch.circuits.domains import EvaluationDomains
        from proof_systems_tpu_torch.folding import arrabbiata, cli

        cpu = torch.device("cpu")
        domain, srs = EvaluationDomains.create(Fp, 32, device=cpu), SRS(Vesta, g, h, cpu)
        curve, L = msm_circuit.ForeignCurve((1 << 63) - 25, 5, 7), msm_circuit.Layout(8, 64)
        env = arrabbiata.FoldingEnv(Fp, 1, [E.Cell(0, E.CURR) - E.Literal(1)])
        inst = env.fresh([[1] * 32], alpha=3)
        return {
            "prove_msm": lambda: msm_circuit.prove_msm(domain, srs, Vesta, curve, [1], [(1, 2)],
                                                       TestRng(0), L=L),
            "verify_msm": lambda: msm_circuit.verify_msm(domain, srs, Vesta, curve, [1],
                                                         [(1, 2)], (1, 2), None, TestRng(0),
                                                         L=L),
            "decider_prove": lambda: arrabbiata.decider_prove(env, inst, domain, srs, Vesta,
                                                              TestRng(0)),
            "arrabbiata execute": lambda: cli.execute("square", 1, 8, decide=False),
        }[name]()

    def dryrun():
        from proof_systems_tpu_torch.parallel.dryrun import dryrun_multichip

        return dryrun_multichip(2)

    def package_prove():
        import proof_systems_tpu_torch as port
        from proof_systems_tpu_torch.circuits.builders import bench_circuit, bench_witness
        from proof_systems_tpu_torch.prover_index import ProverIndex

        cpu = torch.device("cpu")
        cs = ConstraintSystem.create(Fp, bench_circuit(Fp, 6), public=0, max_poly_size=32,
                                     device=cpu)
        return port.prove(ProverIndex(cs, Vesta, SRS(Vesta, g, h, cpu)), bench_witness(6),
                          TestRng(0))

    return {
        "prove_columns": column_proof,
        "LogupInstance.prove": logup_instance,
        "prove": package_prove,
        "SRS.create": lambda: SRS.create(Vesta, 4),
        "ntt_plan": lambda: ntt.ntt_plan(Fp, 3),
        "msm.msm": lambda: msm.msm(Vesta, scal),
        "convert.limbs_from_numpy": lambda: convert.limbs_from_numpy(np.zeros((16, 2), np.uint32)),
        "ConstraintSystem.create[lookup]": lambda: ConstraintSystem.create(
            Fp, lookup_gates, fixed_lookup_tables=[table]),
        "ConstraintSystem.create[optional]": lambda: ConstraintSystem.create(
            Fp, gate_mix.optional_circuit(gate_mix.OPTIONAL_SEED)[0]),
        "VerifierIndex.from_file": from_file,
        "batch_verify": batch_verify,
        "dryrun_multichip": dryrun,
        **{name: (lambda name=name: o1vm_entry(name))
           for name in ("prove_keccak", "verify_keccak", "prove_execution", "verify_execution",
                        "prove_mips", "verify_mips")},
        **{name: (lambda name=name: msm_entry(name))
           for name in ("prove_msm", "verify_msm", "decider_prove", "arrabbiata execute")},
    }


@pytest.mark.parametrize("name", ["prove_columns", "LogupInstance.prove", "prove",
                                  "SRS.create", "ntt_plan", "msm.msm", "convert.limbs_from_numpy",
                                  "ConstraintSystem.create[lookup]",
                                  "ConstraintSystem.create[optional]", "VerifierIndex.from_file",
                                  "batch_verify", "prove_keccak", "verify_keccak",
                                  "prove_execution", "verify_execution", "prove_mips",
                                  "verify_mips", "prove_msm", "verify_msm", "decider_prove",
                                  "arrabbiata execute", "dryrun_multichip"])
def test_entry_points_default_to_cuda(name, tmp_path):
    """With no device given, an entry point asks for the card; without one
    it raises instead of running on the CPU. The verifier's entry points run
    on their SRS's device, which is the card when the SRS names none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points(tmp_path)[name]()


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_package_level_prove_and_verify():
    """The JAX package's package-level prove and verify have counterparts
    of the same parameters, and a device besides."""
    import inspect

    import proof_systems_tpu_torch as port

    assert list(inspect.signature(port.prove).parameters) == [
        "index", "witness", "rng", "prev_challenges", "runtime_tables", "device"]
    assert list(inspect.signature(port.verify).parameters) == [
        "vk", "proof", "public_input", "rng", "device"]
    from proof_systems_tpu_torch.o1vm import ColumnProof, prove_columns, verify_columns

    assert "device" in inspect.signature(prove_columns).parameters
    assert ColumnProof.__dataclass_fields__.keys() == {
        "commitments", "zeta_evaluations", "zeta_omega_evaluations", "quotient_commitment",
        "quotient_evaluations", "opening"}
    assert callable(verify_columns)
    from proof_systems_tpu_torch.o1vm import (
        mips,
        prove_execution,
        prove_keccak,
        prove_mips,
        riscv,
        verify_execution,
        verify_keccak,
        verify_mips,
    )

    for fn in (prove_keccak, verify_keccak, prove_execution, verify_execution, prove_mips,
               verify_mips):
        assert list(inspect.signature(fn).parameters)[-1] == "device", fn.__name__
    # RV32IM's names stay RV32IM's; MIPS's are its own
    assert (prove_execution, verify_execution) == (riscv.prove_execution, riscv.verify_execution)
    assert (prove_mips, verify_mips) == (mips.prove_execution, mips.verify_execution)
    from proof_systems_tpu.o1vm import mips as jmips

    assert list(inspect.signature(prove_mips).parameters)[:-1] == list(
        inspect.signature(jmips.prove_execution).parameters)
