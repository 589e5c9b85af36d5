"""The port's texture sampling (rtf_tpu_torch/ops/texture.py), on the flat
tables of render/scene_tables.py, against rtf_tpu.ops.texture on the
textured box's own texture tables (a JAX scene carried across with
port_scene_from_jax).  Both sides compute in float32 with the same
operations, so the tolerance is atol 1e-6."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_torch_common import port_scene_from_jax, textured_desc  # noqa: E402

ATOL = 1e-6


@pytest.fixture(scope="module")
def scenes():
    from rtf_tpu.scene.build import build_scene
    from rtf_tpu_torch.render.scene_tables import scene_tables
    jscene = build_scene(textured_desc(port=False, background=True))
    return jscene, scene_tables(port_scene_from_jax(jscene))


def _close(port, ref):
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("which", ["file", "checker"])
def test_sample_texmap_matches_jax(scenes, which):
    """Every texture map of that kind (and lanes without a map) at seeded
    uv in [-3, 3]: the transform, the tiling of negative uv, bilinear
    weights and the +1 neighbour that wraps to 0."""
    import jax.numpy as jnp
    from rtf_tpu.ops.texture import sample_texmap_ch as jsample
    from rtf_tpu_torch.ops.texture import sample_texmap_ch
    jscene, tables = scenes
    kinds = np.asarray(jscene.textures.kind)[np.asarray(jscene.texmaps.tex)]
    maps = np.flatnonzero(kinds == (0 if which == "file" else 1))
    assert len(maps) >= (3 if which == "file" else 1)
    rng = np.random.RandomState(5)
    n = 8192
    tm = rng.choice(np.append(maps, -1), n).astype(np.int32)
    u, v = (rng.uniform(-3, 3, n).astype(np.float32) for _ in range(2))
    # just below 1: on a map without a transform, w * u rounds to w
    u[:64] = np.float32(1.0) - np.float32(2.0 ** -24)
    ref = jsample(jscene, jnp.asarray(tm), jnp.asarray(u), jnp.asarray(v))
    port = sample_texmap_ch(tables, torch.as_tensor(tm).long(),
                            torch.as_tensor(u), torch.as_tensor(v))
    _close(port, ref)
    assert float(port[0][tm >= 0].std()) > 0.05   # textures, not flat


@pytest.mark.parametrize("l2", [False, True])
def test_env_uv_matches_jax(l2):
    import jax.numpy as jnp
    from rtf_tpu.ops.texture import env_uv_ch as juv
    from rtf_tpu_torch.ops.texture import env_uv_ch
    rng = np.random.RandomState(11)
    d = rng.normal(size=(3, 4096)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    d[0:2, :8] = 0.0                                  # x = y = 0
    d[2, :8] = [1, -1, 0.5, -0.5, 0, 1, -1, 2]
    ref = juv(*(jnp.asarray(x) for x in d), l2=l2)
    port = env_uv_ch(*(torch.as_tensor(x) for x in d), l2=l2)
    _close(port, ref)
    assert np.isfinite(port[0].numpy()).all()


def test_sample_background_matches_jax(scenes):
    """Finalize's uvw = (x/W, y/H, 0) over a 40x30 grid, then seeded uv."""
    import jax.numpy as jnp
    from rtf_tpu.ops.texture import sample_background as jbg
    from rtf_tpu_torch.ops.texture import sample_background
    jscene, tables = scenes
    assert tables.bg_tm >= 0
    idx = np.arange(40 * 30)
    u = np.concatenate([(idx % 40).astype(np.float32) / 40,
                        np.random.RandomState(2).uniform(-2, 2, 1000)])
    v = np.concatenate([(idx // 40).astype(np.float32) / 30,
                        np.random.RandomState(3).uniform(-2, 2, 1000)])
    u, v = u.astype(np.float32), v.astype(np.float32)
    ref = jbg(jscene, jnp.stack([jnp.asarray(u), jnp.asarray(v),
                                 jnp.zeros_like(jnp.asarray(u))], -1))
    port = sample_background(tables, torch.tensor(np.array(jscene.bg_color)),
                             torch.as_tensor(u), torch.as_tensor(v))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    assert float(port.std()) > 0.05
