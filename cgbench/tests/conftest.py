"""The benchmark's own tests.  Run from the repository root:

    python -m pytest -q -p no:cacheprovider cgbench/tests

Tests marked ``cuda`` need a CUDA card and skip without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")
