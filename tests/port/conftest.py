"""Settings of the PyTorch port's tests.

Tests that need a CUDA card carry the ``cuda`` marker and live in
test_torch_on_card.py, which imports no JAX so that it also runs on a
machine without it (``python -m pytest --noconftest -m cuda
tests/port/test_torch_on_card.py``).
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device and nvcc; skipped without them")
