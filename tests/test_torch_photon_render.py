"""The photon pipeline as a whole on the CPU: rtf_tpu's photon and caustic
passes (render/renderer.py::prepare_photon_grid, prepare_caustic_grid) on
the 32x24 box (mesh_subdiv=1, mesh_algo="pallas_interpret"; 2,000 global
photons over 4 bounces, 6,000 caustic photons over 3), carried across as
numpy photon maps and rebuilt into the port's grids, then:

* the wavefront with photon_volume=False, pm_direct (the exact gather at
  every hit) and the caustic grid (its exact gather at primary hits), the
  'both' split, hard shadows, 1 spp (no draw at all), per pixel against
  rtf_tpu's wavefront: atol 2e-4 with at most 0.5% of pixels outside
  (the rule of test_torch_wavefront_render.py), z within rtol 1e-4;
* the hemisphere modes in the mean only (tests/test_torch_photon_hybrid.py
  and test_torch_photon_exact.py, which take this file's `maps`);
* `render` given no map shoots its own and adds light over hemisphere GI
  on the same waves;
* the scenes that the port refused before the photon pass was ported
  render (test_torch_common.py::test_unsupported_scenes_raise and
  test_torch_gi_render.py::test_gi_refusals_raise had them), and so does a
  caustic grid on the wavefront."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import (  # noqa: E402,F401
    one_torch_thread, port_scene_from_jax)

PASS = dict(photon_count=2000, photon_bounces=4, caustic_count=6000,
            caustic_bounces=3)
HEMI = dict(min_samples=8, max_samples=8, bounces=2, shadow_min=1,
            shadow_max=1, hemisphere_samples=4)


@pytest.fixture(scope="module")
def maps():
    """(jax scene, port scene, jax grids, port grids)."""
    from rtf_tpu.render import renderer as JR
    from rtf_tpu.render.config import RenderConfig as JConfig
    from rtf_tpu.scene.build import build_scene
    from rtf_tpu.scene.procedural import box_scene
    from rtf_tpu_torch.gi.grid import build_photon_grid
    from rtf_tpu_torch.gi.photon import photon_map_from_arrays
    jscene = dataclasses.replace(build_scene(box_scene(32, 24, mesh_subdiv=1)),
                                 mesh_algo="pallas_interpret")
    scene = port_scene_from_jax(jscene)
    cfg = JConfig(**PASS)
    key = jax.random.PRNGKey(0)
    jgrids = (JR.prepare_photon_grid(jscene, cfg, key),
              JR.prepare_caustic_grid(jscene, cfg, key))
    grids = tuple(
        build_photon_grid(photon_map_from_arrays(
            np.asarray(g.pos), np.asarray(g.dir), np.asarray(g.power),
            int(g.n_valid), device="cpu"), g.cell_size, scene.world_min,
            scene.world_max) for g in jgrids)
    for g, j in zip(grids, jgrids):
        assert g.max_occupancy == j.max_occupancy
        np.testing.assert_array_equal(g.cell_count.numpy(),
                                      np.asarray(j.cell_count))
    assert int(grids[1].n_valid) > 100
    return jscene, scene, jgrids, grids


def _renders(maps, **kw):
    from rtf_tpu.render.config import RenderConfig as JConfig
    from rtf_tpu.render.renderer import render as jrender
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import render
    jscene, scene, jgrids, grids = maps
    want = jrender(jscene, JConfig(**PASS, **kw), gi_grid=jgrids[0],
                   caustic_grid=jgrids[1])
    got = render(scene, RenderConfig(**PASS, **kw), device="cpu",
                 gi_grid=grids[0], caustic_grid=grids[1])
    assert np.isfinite(got.radiance).all()
    return got, want


def test_exact_gather_wavefront_matches_jax(maps):
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.scene_tables import render_path
    kw = dict(min_samples=1, max_samples=1, bounces=2, shadow_min=1,
              shadow_max=1, gi_mode="pm_direct", photon_volume=False,
              split_mode="both")
    assert render_path(maps[1], RenderConfig(**kw), maps[3][1]) \
        == ("wavefront", "gi_mode='pm_direct' not kernelized")
    got, want = _renders(maps, **kw)
    np.testing.assert_array_equal(got.z >= 1e29, want.z >= 1e29)
    hit = got.z < 1e29
    np.testing.assert_allclose(got.z[hit], want.z[hit], rtol=1e-4)
    err = np.abs(got.radiance - want.radiance).max(-1)
    assert (err > 2e-4).mean() <= 0.005, float(err.max())
    # the caustic term lights some primary hits
    _, scene, _, grids = maps
    from rtf_tpu_torch.render.renderer import render
    plain = render(scene, RenderConfig(**PASS, **kw), device="cpu",
                   gi_grid=grids[0])
    assert (got.radiance > plain.radiance + 1e-4).any()


def test_render_shoots_its_own_photons():
    """No map handed in: `render` shoots cfg.photon_count photons from the
    seed, bakes its volume and adds its term to the same waves as
    hemisphere GI (the fused path)."""
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import render
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    scene = build_scene(box_scene(32, 24, mesh_subdiv=1), device="cpu")
    cfg = RenderConfig(**PASS, **HEMI, split_mode="rr")
    hemi = render(scene, cfg.with_(gi_mode="hemisphere"), device="cpu")
    photon = render(scene, cfg.with_(gi_mode="photon"), device="cpu")
    again = render(scene, cfg.with_(gi_mode="photon"), device="cpu")
    assert np.isfinite(photon.radiance).all()
    assert (photon.radiance >= hemi.radiance - 1e-5).all()
    assert photon.radiance.mean() > hemi.radiance.mean() + 1e-3
    np.testing.assert_array_equal(photon.radiance, again.radiance)


@pytest.mark.parametrize("case", [
    "gi", "photon_no_volume", "photon_volume_false", "pm_direct",
    "pm_direct_volume_false", "caustic_grid_wavefront",
    "caustic_grid_photon_volume_false"])
def test_formerly_refused_photon_scenes_render(case):
    """'gi' (pm_direct without a map) and 'photon_no_volume' (photon GI
    without one) were test_unsupported_scenes_raise's cases, the next
    three test_gi_refusals_raise's: each now shoots its own map, or
    samples the volume handed in on the wavefront as rtf_tpu does.  A
    caustic grid on the wavefront gathers exactly, and on 'rr' with
    photon_volume=False sends the frame to the wavefront."""
    from test_torch_gi_volume import VOLUME
    from rtf_tpu_torch.gi.volume import load_volume
    from rtf_tpu_torch.render.config import RenderConfig
    from rtf_tpu_torch.render.renderer import prepare_caustic_grid, render
    from rtf_tpu_torch.render.scene_tables import render_path
    from rtf_tpu_torch.scene.build import build_scene
    from rtf_tpu_torch.scene.procedural import box_scene
    scene = build_scene(box_scene(8, 6, mesh_subdiv=0), device="cpu")
    cfg = RenderConfig(min_samples=8, max_samples=8, bounces=1,
                       shadow_min=1, shadow_max=1, hemisphere_samples=2,
                       **PASS)
    both = cfg.with_(split_mode="both")
    rr = cfg.with_(split_mode="rr")
    kw = {}
    if case == "gi":
        cfg = cfg.with_(gi_mode="pm_direct")
    elif case == "photon_no_volume":
        cfg = both.with_(gi_mode="photon")
    elif case == "photon_volume_false":
        cfg = rr.with_(gi_mode="photon", photon_volume=False)
        kw = dict(gi_vol=load_volume(VOLUME, device="cpu"))
    elif case == "pm_direct":
        cfg = rr.with_(gi_mode="pm_direct")
    elif case == "pm_direct_volume_false":
        cfg = rr.with_(gi_mode="pm_direct", photon_volume=False)
        kw = dict(gi_vol=load_volume(VOLUME, device="cpu"))
    elif case == "caustic_grid_wavefront":
        kw = dict(caustic_grid=prepare_caustic_grid(scene, both, 1))
        cfg = both
    else:
        kw = dict(caustic_grid=prepare_caustic_grid(scene, rr, 1))
        cfg = rr.with_(gi_mode="hemisphere", photon_volume=False)
    assert render_path(scene, cfg, kw.get("caustic_grid"))[0] \
        == "wavefront"
    res = render(scene, cfg, device="cpu", **kw)
    assert np.isfinite(res.radiance).all() and res.radiance.mean() > 0.0
    if case.startswith("caustic"):
        assert int(kw["caustic_grid"].n_valid) > 0
        base = render(scene, cfg, device="cpu")
        assert res.radiance.mean() > base.radiance.mean()
