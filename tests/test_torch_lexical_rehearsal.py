"""The sparse lexical arm's kernels (``ops/csrc/lexical.cu``: the scatter of
the live (query, bucket) pairs' postings in float64 and the stable top-m
over the rows they touched), compiled with g++ against
``scripts/cuda_cpu_shim.h`` and run on the CPU at tiny shapes: each case of
``scripts/cuda_cpu_rehearsal.py``'s ``LEX_CASES`` against the plain
version. Values, ids (dead entries included) and the signals read from the
float64 sums are bitwise equal: ties (the lower row first), a row in
several of a query's buckets, zero-weight and pad columns, buckets with
fill 0 and fill P, scrubbed holes, a query with no live bucket, an
all-gated query, fewer live rows than m, U of 16, 64 and 128."""
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
def lexical_lib():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source against the CPU shim")
    with tempfile.TemporaryDirectory() as tmp:
        yield rehearsal.build(os.path.join(rehearsal.CSRC, "lexical.cu"), tmp)


@pytest.mark.parametrize("case", rehearsal.LEX_CASES, ids=[c[0] for c in rehearsal.LEX_CASES])
def test_lexical_kernels_match_plain_on_cpu_shim(lexical_lib, case):
    rehearsal.rehearse_lexical(lexical_lib, [case])
