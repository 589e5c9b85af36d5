"""The cache's fused evaluator against rtf_tpu's past bounce 0
(bounces=3): tests/test_torch_cache_fused.py's check, in a file of its own
so that each holds one interpret-mode call."""
import pytest

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_cache_fused import check_fused_evaluator  # noqa: E402
from test_torch_common import one_torch_thread  # noqa: E402,F401


def test_fused_evaluator_matches_past_bounce0():
    check_fused_evaluator(3)
