import os

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips, with its reason, "
        "where there is none")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    """The CUDA device, or a skip where the machine has none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _tmpdir_env(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    yield
    os.environ.pop("LDDL_TPU_METRICS_DIR", None)
