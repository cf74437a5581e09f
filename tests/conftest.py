"""Shared fixtures + collection guards. NOTE: no XLA_FLAGS here — tests run
on the single real CPU device; multi-device tests spawn subprocesses with
their own flags."""
import importlib.util
import sys

import numpy as np
import pytest

# ``hypothesis`` may be absent (the container cannot pip-install); register a
# deterministic fallback BEFORE test modules import it. requirements-dev.txt
# installs the real thing where possible.
if importlib.util.find_spec("hypothesis") is None:
    import pathlib

    _spec = importlib.util.spec_from_file_location(
        "hypothesis", pathlib.Path(__file__).parent / "_hypothesis_fallback.py"
    )
    _mod = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_mod)
    sys.modules.setdefault("hypothesis", _mod)

import repro.core.graph as G

# ``repro.dist`` landed in PR 5 (ISSUE 5); the guard stays so a broken or
# partially-checked-out tree degrades to skips instead of collection errors.
# Tests that reach for it at runtime (subprocess snippets, launch/cells)
# import ``requires_dist`` from this conftest — a no-op while the package
# imports cleanly.
HAS_DIST = importlib.util.find_spec("repro.dist") is not None
collect_ignore = []
if not HAS_DIST:
    collect_ignore += ["test_fault_tolerance.py", "test_elastic.py"]

requires_dist = pytest.mark.skipif(
    not HAS_DIST, reason="repro.dist not yet implemented (see ROADMAP.md Open items)"
)


def pytest_report_header(config):
    if not HAS_DIST:
        return (
            "repro.dist missing: ignoring test_fault_tolerance.py / "
            "test_elastic.py, skipping dist-dependent tests"
        )
    return None


@pytest.fixture(scope="session")
def small_graphs():
    return {
        "karate": G.karate_club(),
        "rmat10": G.rmat(10, 8, seed=1),
        "grid": G.grid_2d(13, 17),
        "star": G.star(64),
        "chain": G.chain(40),
    }


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU with nvcc; skips where torch.cuda.is_available() is "
        "false (see tests/test_torch_cuda.py for the command that runs them on a card)",
    )
