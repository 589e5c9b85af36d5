"""The hybrid GI sample wave (gi_mode 'photon': hemisphere children with
photon-volume terms at every bounce they reach, the primary's volume
terms below the first hit and a caustic volume at it) against
interpret-mode rtf_tpu.render.fused.fused_gi_wave with the same volumes
and the reference's hemisphere draws.  Tolerances as in
test_torch_gi_wave.py."""
import pytest

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import one_torch_thread  # noqa: E402,F401
from test_torch_gi_rows import _cfg  # noqa: E402
from test_torch_gi_wave import assert_gi_close, run_gi  # noqa: E402


def test_gi_wave_photon_volume_matches_fused_gi_wave():
    from rtf_tpu.scene.procedural import box_scene
    cfg = _cfg(gi_mode="photon", hemisphere_samples=2, gi_stratify=False)
    assert cfg.photon_volume
    assert_gi_close(*run_gi(box_scene(32, 24, mesh_subdiv=1), cfg, 77, 5,
                            volumes=True))
