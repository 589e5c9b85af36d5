"""The port's GI helpers against rtf_tpu, without interpret mode: the
irradiance-volume sampler (rtf_tpu_torch/gi/volume.py) and the volume
terms on the committed scene_b volume, and the hemisphere directions fed
jax.random's own uniforms (render/gi.py::hemisphere_dirs against
fused.py::_hemisphere_dirs_ch).  Tolerances: 1e-5 relative on the volume
(the same operations in the same order), 2e-6 on unit directions (JAX
normalizes with rsqrt, the port with 1/sqrt)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytestmark = pytest.mark.usefixtures("one_torch_thread")

from test_torch_common import ROOT  # noqa: E402
from test_torch_common import one_torch_thread  # noqa: E402,F401

VOLUME = ROOT / "artifacts" / "cache" / \
    "sceneb_vol_v1_p1000000_k400_r1_o2048_s7.npz"


def _volumes():
    import jax.numpy as jnp
    from rtf_tpu.gi.volume import IrradianceVolume
    from rtf_tpu_torch.gi.volume import load_volume
    d = np.load(VOLUME)
    ref = IrradianceVolume(table=jnp.asarray(d["table"]),
                           origin=jnp.asarray(d["origin"]),
                           dims=tuple(int(x) for x in d["dims"]),
                           cell=float(d["cell"]))
    return ref, load_volume(VOLUME, device="cpu")


def _points(vol, n, seed):
    """n points over the volume and a fifth of its extent around it, so
    that some clamp to each border."""
    rng = np.random.RandomState(seed)
    lo = np.asarray(vol.origin, np.float64)
    ext = np.asarray(vol.dims, np.float64) * vol.cell
    return (lo[:, None] + ext[:, None]
            * rng.uniform(-0.2, 1.2, (3, n))).astype(np.float32)


def test_sample_volume_matches_jax():
    from rtf_tpu.gi.volume import sample_volume_ch as jsample
    from rtf_tpu_torch.gi.volume import sample_volume_ch
    ref, vol = _volumes()
    assert vol.dims == (60, 60, 45) and vol.table.shape == (6, 171166)
    p = _points(ref, 100_000, 0)
    outside = ((p < np.asarray(ref.origin)[:, None])
               | (p > np.asarray(ref.origin)[:, None]
                  + np.asarray(ref.dims)[:, None] * ref.cell)).any(0)
    assert 0.2 < outside.mean() < 0.9
    je, jd = jsample(ref, tuple(p))
    pe, pd = sample_volume_ch(vol, torch.as_tensor(p))
    je, jd = np.stack([np.asarray(x) for x in je]), \
        np.stack([np.asarray(x) for x in jd])
    assert je.max() > 0.1 and np.isfinite(pe.numpy()).all()
    np.testing.assert_allclose(pe.numpy(), je, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pd.numpy(), jd, rtol=1e-5, atol=1e-6)


def test_volume_terms_match_jax():
    """Two bounces of queries, one batched lookup: w * E * max(0, -n.D)
    summed over the bounces; zero weights (missed lanes) give zero."""
    import jax.numpy as jnp
    from rtf_tpu.render.fused import _volume_terms
    from rtf_tpu_torch.render.gi import volume_terms
    ref, vol = _volumes()
    n = 20_000
    rng = np.random.RandomState(1)
    queries_np = []
    for b in range(2):
        p = _points(ref, n, 10 + b)
        nrm = rng.normal(size=(3, n)).astype(np.float32)
        nrm /= np.linalg.norm(nrm, axis=0)
        w = rng.rand(3, n).astype(np.float32)
        w[:, ::3] = 0.0
        queries_np.append((p, nrm, w))
    jt = _volume_terms([tuple(tuple(jnp.asarray(c) for c in x) for x in q)
                        for q in queries_np], ref)
    pt = volume_terms([tuple(torch.as_tensor(x) for x in q)
                       for q in queries_np], vol)
    jt = np.stack([np.asarray(c) for c in jt])
    assert pt.shape == (3, n) and jt.max() > 0.05
    np.testing.assert_allclose(pt.numpy(), jt, rtol=1e-5, atol=1e-7)
    assert (pt.numpy()[:, ::3] == 0).all()
    assert volume_terms([], vol) is None


@pytest.mark.parametrize("stratum", [None, (3, 8)])
def test_hemisphere_dirs_match_jax(stratum):
    """The same uniforms (jax.random's, drawn as _hemisphere_dirs_ch draws
    them) through both; normals on both sides of the basis switch at
    n.x = 0.4."""
    import jax.numpy as jnp
    from rtf_tpu.render.fused import _hemisphere_dirs_ch
    from rtf_tpu_torch.render.gi import hemisphere_dirs
    m = 4096
    rng = np.random.RandomState(2)
    n3 = rng.normal(size=(3, m)).astype(np.float32)
    n3 /= np.linalg.norm(n3, axis=0)
    n3[:, :4] = np.eye(3, 4, dtype=np.float32)   # axes, and a zero normal
    assert 0.2 < (n3[0] < 0.4).mean() < 0.9
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    u_phi = np.array(jax.random.uniform(k1, (m,)))
    ysq = np.array(jax.random.uniform(k2, (m,)))
    jstratum = None if stratum is None else (jnp.int32(stratum[0]),
                                             stratum[1])
    (jd, jw) = _hemisphere_dirs_ch(tuple(jnp.asarray(c) for c in n3), key,
                                   stratum=jstratum)
    pd, pw = hemisphere_dirs(torch.as_tensor(n3), torch.as_tensor(u_phi),
                             torch.as_tensor(ysq), stratum=stratum)
    jd = np.stack([np.asarray(c) for c in jd])
    np.testing.assert_allclose(pd.numpy(), jd, atol=2e-6)
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), atol=2e-6)
    assert (pw.numpy() >= 0).all() and np.asarray(jw).mean() > 0.3
