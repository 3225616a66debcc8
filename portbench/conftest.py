"""pytest settings of the benchmark's own tests (``pytest portbench``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one (the check "
        "is made inside the test)")
