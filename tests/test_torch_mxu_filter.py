"""The dense closest hit's face tables and its tensor-core sign filter
(ops/mesh_hit_mxu.py: `pack_faces`, `ray_frags`, `filter_margins`,
`filter_survivors`), on the CPU in the kernel's arithmetic.

The packer keeps the faces whose normal is not zero, in matrix order, with
their 22 rows exact; its fragments are the sign blocks scaled by a power
of two (every entry below 1 in magnitude, the largest at least 1/2 unless
the exponent is clamped) and rounded to TF32.  The filter, emulated with
the exact sums of the TF32 values (every product of two TF32 values and
their six-term sums are exact in float64), never rejects a pair that
`plucker_pair` accepts at the kernel's EPS = 2^-7; EPS / 4 = 2^-9 is safe
too (the TF32 error bound is 2^-9.99), so the negative control is EPS /
256 = 2^-15, which rejects some valid pairs on the edge- and vertex-aimed
rays.
Re-checking only the survivors and folding them by the least (t, face)
gives `mesh_closest_hit_mxu_plain`'s outputs bit for bit."""
import numpy as np
import pytest
import torch

from rtf_tpu_torch.ops import mesh_hit_mxu as X
from rtf_tpu_torch.ops.mxu_pack import plucker_bary, plucker_pair
from test_torch_common import (  # noqa: F401
    dense_rays, icosphere_faces, one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _faces(case):
    """(a, b, c, tile): the subdiv-3 icosphere (1280 faces, three 512-face
    tiles); "degenerate": its first 700 faces in 128-face tiles with faces
    3 (a == b) and 9 (all corners equal) degenerate; "far": the icosphere
    moved 1000 along every axis."""
    if case == "far":
        return (*icosphere_faces(3, 1000.0), 512)
    a, b, c = icosphere_faces(3)
    if case == "degenerate":
        a, b, c = (x[:700].copy() for x in (a, b, c))
        b[3] = a[3]
        b[9] = c[9] = a[9]
        return a, b, c, 128
    return a, b, c, 512


def _rays16(o, d, t_init=1e30):
    r, _ = X.pack_rays16(torch.as_tensor(o), torch.as_tensor(d),
                         torch.full((len(o),), t_init))
    return r


def _filtered_closest(rays16, trim, face0=0, eps=X.EPS):
    """The kernel's algorithm in plain PyTorch: the pairs the filter passes
    through plucker_pair, a valid pair with t < t_init folded by the least
    t, then the least face; returns the plain version's five outputs and
    the count of valid pairs that the filter rejected."""
    pack = X.pack_faces(trim)
    f = pack.rows.shape[0]
    a, live = X.ray_frags(rays16)
    surv = X.filter_survivors(X.filter_margins(a, X.unpack_frags(
        pack.frags, f)), live, eps)
    cols = [pack.rows[:, k][None, :] for k in range(22)]
    d3, c3, o3 = (tuple(rays16[:, k:k + 1] for k in range(b, b + 3))
                  for b in (0, 3, 6))
    t, valid, sa, sb, sc, dn = plucker_pair(cols, d3, c3, o3)
    missed = int((valid & live[:, None] & ~surv).sum())
    ok = surv & valid & (t < rays16[:, 10:11])
    tv = torch.where(ok, t, torch.inf)
    t_min = tv.amin(1)
    ids = torch.arange(f)
    c = torch.amin(torch.where(ok & (tv == t_min[:, None]), ids, f),
                   1).clamp(max=max(f - 1, 0))
    hit = ok.any(1)
    pick = c[:, None]
    ba, bb = plucker_bary(*(x.gather(1, pick)[:, 0] for x in (sa, sb, sc)))
    zero = torch.zeros_like(ba)
    return (torch.where(hit, t_min, rays16[:, 10]),
            torch.where(hit, face0 + pack.fmap[c], -1).to(torch.int32),
            torch.where(hit, (dn.gather(1, pick)[:, 0] <= 0.0).float(), zero),
            torch.where(hit, ba, zero), torch.where(hit, bb, zero)), missed


@pytest.mark.parametrize("case", ["icosphere", "degenerate", "far"])
def test_pack_faces_unpacks_to_matrix_cols(case):
    a, b, c, tile = _faces(case)
    trim = torch.as_tensor(X.pack_tri_matrix(a, b, c, tile))
    pack = X.pack_faces(trim)
    cols = torch.stack([x.reshape(-1) for x in X._matrix_cols(trim)], 1)
    keep = (cols[:, 18:21] != 0).any(1)
    want = torch.nonzero(keep).squeeze(1)
    f = len(want)
    assert f == len(a) - (2 if case == "degenerate" else 0)
    assert torch.equal(pack.fmap, want.to(torch.int32))
    assert torch.equal(pack.rows[:, :22], cols[want])
    assert not pack.rows[:, 22:].any()
    # the fragments: TF32 values (13 low bits clear), the scaled sign
    # blocks rounded, zero past the last face
    g = -(-f // 128) * 16
    assert pack.frags.shape == (g, 192)
    assert not (pack.frags.view(torch.int32) & 0x1FFF).any()
    w = X.unpack_frags(pack.frags, f).reshape(f, 18)
    exact = cols[want, :18]
    scaled = torch.ldexp(exact.double(), -pack.exps[:, None].double())
    assert torch.equal(w, X.tf32_round(scaled.float()))
    assert float(scaled.abs().amax()) < 1.0
    assert float(scaled.abs().amax(1).min()) >= 0.5
    assert bool(((w.double() - scaled).abs()
                 <= 2.0 ** -11 * scaled.abs()).all())
    assert not X.unpack_frags(pack.frags, g * 8)[f:].any()
    # rows 6 and 7: -EPS and (1, -1, 0) on a face, (1, -1, 0) twice on
    # padding
    p0 = pack.frags[:, :128].reshape(g * 8, 4, 4)
    p1 = pack.frags[:, 128:].reshape(g * 8, 4, 2)
    rows67 = torch.stack([p0[:, 2:4, 1], p0[:, 2:4, 3], p1[:, 2:4, 1]], 1)
    reject = torch.tensor([1.0, -1.0, 0.0])
    assert bool((rows67[:f, :, 0] == -X.EPS).all())
    assert bool((rows67[:, :, 1] == reject).all())
    assert bool((rows67[f:, :, 0] == reject).all())


def test_ray_frags_scales_and_live():
    """The rows (d, o x d) scaled below an L1 norm of 1, rounded to TF32;
    zero rows where the norm is zero or not finite; live where t_init >
    1e-3 (not for 0, 1e-3 or NaN)."""
    o, d = dense_rays("scattered", *icosphere_faces(1), n=64)
    r = _rays16(o, d, 100.0)
    r[1, 0:6] = 0.0
    r[2, 0] = float("inf")
    r[3, 4] = float("nan")
    r[5, 10], r[6, 10], r[7, 10] = 0.0, 1e-3, float("nan")
    a, live = X.ray_frags(r)
    assert live.tolist()[:8] == [True] * 5 + [False] * 3
    assert not live[64:].any()            # pack_rays16's padding
    assert not a[1:4].any() and not a[64:].any()
    l1 = a[:64].abs().sum(1)
    ok = torch.ones(64, dtype=torch.bool)
    ok[1:4] = False
    assert bool((l1[ok] <= 1.0 + 2.0 ** -9).all())
    assert bool((l1[ok] >= 0.5 - 2.0 ** -9).all())
    assert torch.equal(a, X.tf32_round(a))


@pytest.mark.parametrize("kind,case", [
    ("scattered", "icosphere"), ("edge", "icosphere"),
    ("vertex", "icosphere"), ("edge", "degenerate"), ("vertex", "far")])
def test_filter_is_sound(kind, case):
    """No valid pair rejected at EPS, and the survivors alone give the
    plain version's outputs bit for bit (face0 = 77)."""
    a, b, c, tile = _faces(case)
    o, d = dense_rays(kind, a, b, c, n=2000)
    rays16 = _rays16(o, d)
    trim = torch.as_tensor(X.pack_tri_matrix(a, b, c, tile))
    got, missed = _filtered_closest(rays16, trim, 77)
    plain = X.mesh_closest_hit_mxu_plain(rays16, trim, 77)
    assert missed == 0
    assert int((plain[1] >= 0).sum()) > 100
    for g_, p in zip(got, plain):
        assert torch.equal(g_, p)


@pytest.mark.parametrize("kind", ["edge", "vertex"])
def test_filter_negative_control(kind):
    """At EPS / 256 the filter rejects valid pairs, so the soundness test
    can fail; at EPS / 4 it still rejects none."""
    a, b, c, tile = _faces("icosphere")
    rays16 = _rays16(*dense_rays(kind, a, b, c))
    trim = torch.as_tensor(X.pack_tri_matrix(a, b, c, tile))
    assert _filtered_closest(rays16, trim, eps=X.EPS / 4)[1] == 0
    assert _filtered_closest(rays16, trim, eps=X.EPS / 256)[1] > 0


def test_face_pack_is_kept_per_matrix():
    """The wrapper packs a matrix once: the same tensor gives the same
    pack until it is written to; another tensor is packed anew."""
    a, b, c = icosphere_faces(1)
    trim = torch.as_tensor(X.pack_tri_matrix(a, b, c))
    p0 = X._face_pack(trim)
    assert X._face_pack(trim) is p0
    trim[0, 0, 0] += 1.0
    p1 = X._face_pack(trim)
    assert p1 is not p0 and not torch.equal(p1.rows, p0.rows)
    other = trim.clone()
    assert X._face_pack(other) is not p1
