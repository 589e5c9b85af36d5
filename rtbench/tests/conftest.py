"""CPU tests of the benchmark's own code: python -m pytest rtbench/tests
(from the root of a checkout).  They import no JAX and need no card, nvcc
or triton; a test that needs the card carries the `cuda` marker and skips
here, deciding so inside the test."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (runs on the chip only)")
