"""The `card` marker: tests that need a CUDA device, skipped on the CPU by
a check inside each test."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skipped on the CPU)")
