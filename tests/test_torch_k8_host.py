"""K8's CUDA source run on the CPU: csrc/k8_combine.cuh compiled with the
host C++ compiler against a stand-in cuda_runtime.h (tests/cuda_host/)
that emulates one warp with 32 threads, against the old one-thread Horner
chain through field.cuh's ec_double and ec_add, limb for limb, in the base
fields of Vesta and Pallas: an all-identity column, the add's doubling
fallback at the first add and mid-chain, its infinity fallback, W = 1 and
c = 1. The card runs the same source (tests/test_torch_cuda.py); nvcc may
still refuse what g++ takes."""

import pathlib
import subprocess

import numpy as np
import pytest

from proof_systems_tpu_torch.curves import Pallas, Vesta
from proof_systems_tpu_torch.ops import limb
from torch_host_harness import run_pinned

HERE = pathlib.Path(__file__).resolve().parent
CSRC = HERE.parent / "proof_systems_tpu_torch" / "csrc"


@pytest.mark.parametrize("curve", [Vesta, Pallas], ids=["Vesta", "Pallas"])
def test_k8_device_code_on_the_host(tmp_path, curve):
    F = limb.device_field(curve.base)
    params = tmp_path / "params.bin"
    np.array(list(F.kernel_params), dtype=np.uint32).tofile(params)
    exe = tmp_path / "k8_host"
    subprocess.run(["g++", "-std=c++20", "-O1", "-w", "-I", str(HERE / "cuda_host"),
                    "-I", str(CSRC), "-o", str(exe), str(HERE / "cuda_host" / "k8_host.cpp"),
                    "-lpthread"], check=True, capture_output=True, timeout=300)
    out = run_pinned([exe, params])
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("equal") == 3, out.stdout
