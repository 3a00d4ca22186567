"""Shared pytest settings: registers the ``cuda`` marker of the tests
that need an NVIDIA GPU (they skip without one)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where CUDA is absent")
