"""Tests of the benchmark's harness, on the CPU at tiny sizes.

    python -m pytest benchmarks/tests -q

Tests that need the card carry the ``chip`` marker and skip without one
(decided inside the test); on the card's machine:

    python -m pytest benchmarks/tests -q -m chip
"""

import pytest

from tinybench import make_tiny_bench


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_bench(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="session")
def tiny_manifest(tiny_root):
    from harness.manifest import Manifest

    return Manifest(tiny_root, tiny_root / "benchmarks")
