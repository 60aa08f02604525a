import sys
from pathlib import Path

# allow running pytest without PYTHONPATH=src
SRC = Path(__file__).resolve().parent.parent / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's Hopper kernels); "
        "skips where torch.cuda.is_available() is false")
