"""The benchmark's tests: ``python -m pytest gpubench/tests -q`` from
the root of the repository. They import no JAX; tests that need the
card are marked ``cuda`` and skip without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skipped where there is none")
