"""The masked top-k kernel's tensor-core core, compiled with g++ against
``scripts/cuda_cpu_shim.h`` and run on the CPU at tiny shapes (one thread
per CUDA thread; ldmatrix and mma.sync m16n8k16 bf16 with the PTX ISA's
fragment layouts): each case of ``scripts/cuda_cpu_rehearsal.py``'s bf16
subset and of its float32/int8 subset against the plain version. It holds
the fragment layouts (the PTX ISA's on bf16 rows, the k-permutation on
float32 and int8 rows), the exact split of float32 queries and float32
rows, the exact widening of int8 rows and the per-slice choice of 1 or 3
query parts without a card.

Tolerances: values within 1e-4, ids equal wherever neighbouring values
differ by more than 1e-5 (the card's phase-2 check); exact tie order on
the tie case."""
import importlib.util
import os
import shutil
import tempfile

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "cuda_cpu_rehearsal", os.path.join(ROOT, "scripts", "cuda_cpu_rehearsal.py"))
rehearsal = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(rehearsal)


@pytest.fixture(scope="module")
def topk_lib():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source against the CPU shim")
    with tempfile.TemporaryDirectory() as tmp:
        yield rehearsal.build(os.path.join(rehearsal.CSRC, "topk.cu"), tmp)


@pytest.mark.parametrize("case", rehearsal.BF16_CASES, ids=[c[0] for c in rehearsal.BF16_CASES])
def test_bf16_core_matches_plain_on_cpu_shim(topk_lib, case):
    rehearsal.rehearse_topk(topk_lib, [case])


@pytest.mark.parametrize("case", rehearsal.F32_INT8_CASES,
                         ids=[c[0] for c in rehearsal.F32_INT8_CASES])
def test_f32_int8_core_matches_plain_on_cpu_shim(topk_lib, case):
    rehearsal.rehearse_topk(topk_lib, [case])
