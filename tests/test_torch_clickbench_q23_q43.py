"""ClickBench Q23-Q43 through the PyTorch port against the JAX reference
at generate_hits(200_000, 3) (Q1-Q22 in test_torch_clickbench.py).

Comparison rule: torch_clickbench_common.py.
"""

import jax  # noqa: F401  (the reference runs on the CPU, x64, per conftest)
import pytest

from sail_tpu_torch.benchmarks import clickbench
from torch_clickbench_common import check_query, hits_sessions

QUERIES = clickbench.load_queries()


@pytest.fixture(scope="module")
def both():
    return hits_sessions()


@pytest.mark.parametrize("q", range(23, 44))
def test_query_matches_reference(both, q):
    check_query(*both, QUERIES[q - 1])
