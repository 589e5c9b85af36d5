"""The MXU wave kernel's one-loop walk (csrc/box_walk.cuh::walk_warp)
emulated warp by warp on the MXU tables of test_torch_mxu_tree.py's cases:
32-lane warps in step, one slab test a traversing lane an iteration at its
own level, a leaf held until at least 3 in 8 of the warp's lanes in the
loop hold one (the kernel's rule; also until all do), then the holding
lanes' faces in one loop; caps are each lane's best t when it makes the
test.  Every ray's winner (t, key) equals the plain least-(t, key)
(test_torch_mxu_tree.py's `_winners`, the plain `_mesh_closest_mxu`),
every shadow ray's answer the plain `_mesh_anyhit_mxu`'s, and each lane's
own slab and face tests equal those of the nested walk (`walk`), emulated
the same way.  Prints the emulated lane use of the walk's and the face
loops' warp-iterations beside the nested walk's (what the kernel's
STAT_WALK_* and STAT_PAIR_* read on the card).  Port only (no JAX)."""
import numpy as np
import pytest
import torch

from test_torch_common import one_torch_thread  # noqa: F401
from test_torch_mxu_tree import CASES, _rays, _tables, _winners

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WARP = 32
DONE = 3
RULE = 3          # csrc/box_walk.cuh: faces once 3 in 8 lanes hold a leaf


class Counts:
    """Warp-iterations and their active lanes, of the slab tests (walk)
    and of the face loops (pair), summed over warps; and per lane its slab
    and face tests."""

    def __init__(self, n):
        self.walk = [0, 0]
        self.pair = [0, 0]
        self.slabs = torch.zeros(n, dtype=torch.int64)
        self.faces = torch.zeros(n, dtype=torch.int64)

    def step(self, which, lanes):
        """One iteration of every warp with a lane in `lanes` [n]."""
        per = lanes.view(-1, WARP).sum(1)
        acc = self.walk if which == "walk" else self.pair
        acc[0] += int((per > 0).sum())
        acc[1] += int(per.sum())

    def use(self, which):
        it, lanes = self.walk if which == "walk" else self.pair
        return 100.0 * lanes / (WARP * max(it, 1))


class Walk:
    """One mesh instance of the MXU tables for n lanes (n a multiple of
    32): the boxes, the face test and the lane state that both walks
    share.  `closest` lanes keep the least (t, key) below `best`; else a
    lane stops at its first face with 1e-14 < t < cap."""

    def __init__(self, tab, k, lo3, ld3, ild3, walking, closest, best,
                 counts):
        from rtf_tpu_torch.ops.mxu_pack import cross_od
        self.tab, self.closest, self.cnt = tab, closest, counts
        self.lo3, self.ld3, self.ild3 = lo3, ld3, ild3
        self.c3 = cross_od(lo3, ld3)
        self.oct = ((ld3[0] >= 0).long() * 4 + (ld3[1] >= 0).long() * 2
                    + (ld3[2] >= 0).long())
        n = lo3[0].shape[0]
        root = tab.roots[k]
        self.g0, self.ng = int(root[6]), int(root[7])
        self.walking = walking.clone()
        self.best = best              # closest: the lanes' best t; any: cap
        self.bkey = torch.full((n,), -1, dtype=torch.int64)
        self.bface = torch.full((n,), -1, dtype=torch.int64)
        self.stopped = torch.zeros(n, dtype=torch.bool)

    def slab(self, rows, table, lanes):
        """The slab test of [0, cap) on table[rows] for lanes (a mask)."""
        from rtf_tpu_torch.render import wave as W
        box = table[rows]
        sub = lambda x: tuple(v[lanes] for v in x)      # noqa: E731
        self.cnt.slabs[lanes] += 1
        return W._slab([box[:, a] for a in range(3)],
                       [box[:, 3 + a] for a in range(3)], sub(self.lo3),
                       sub(self.ild3), self.best[lanes])

    def faces(self, lanes, fa, fb, key0):
        """Each lane of `lanes` tests its faces fa to fb in order, all in
        step: the face loop of both walks."""
        from rtf_tpu_torch.ops.mxu_pack import plucker_pair
        for i in range(int(torch.where(lanes, fb - fa, 0).max())):
            on = lanes & (fa + i < fb) & ~self.stopped
            if not bool(on.any()):
                break
            self.cnt.step("pair", on)
            self.cnt.faces[on] += 1
            idx = torch.nonzero(on)[:, 0]
            f = fa[idx] + i
            sub = lambda x: tuple(v[idx] for v in x)    # noqa: E731
            t, valid, *_ = plucker_pair(
                [self.tab.faces[f, c] for c in range(22)], sub(self.ld3),
                sub(self.c3), sub(self.lo3))
            if self.closest:
                key = key0[idx] + f
                b = self.best[idx]
                win = valid & ((t < b) | ((t == b) & (key < self.bkey[idx])))
                w = idx[win]
                self.best[w], self.bkey[w], self.bface[w] = \
                    t[win], key[win], f[win]
            else:
                self.stopped[idx[valid & (t > 1e-14) & (t < self.best[idx])]] \
                    = True

    def tile_leaves(self, j, lanes):
        """An entered tile's leaf count, key0 and near-to-far leaf order."""
        tn = self.tab.tnodes
        o = self.oct[lanes]
        nl = (tn[j, 7].long() + 15) // 16
        key0 = tn[j, 8 + o].long() * 128 - tn[j, 6].long()
        return nl, key0, tn[j, 16 + o].long()


def nested(w):
    """`walk`: the groups, within an entered group its tiles, within an
    entered tile its leaves, each entered leaf's faces at once, the
    warp's lanes reconverging after each loop."""
    tab, n = w.tab, w.walking.shape[0]
    zero = torch.zeros(n, dtype=torch.int64)
    for s in range(w.ng):
        act = w.walking & ~w.stopped
        if not bool(act.any()):
            break
        w.cnt.step("walk", act)
        g = tab.groups[w.g0 + s, 8 + w.oct[act]].long()
        ing = act.clone()
        ing[act] = w.slab(g, tab.groups, act)
        if not bool(ing.any()):
            continue
        gi = torch.nonzero(ing)[:, 0]
        grow = tab.groups[w.g0 + s, 8 + w.oct[gi]].long()
        j0, nj, tord = zero.clone(), zero.clone(), zero.clone()
        j0[gi] = tab.groups[grow, 6].long()
        nj[gi] = tab.groups[grow, 7].long()
        tord[gi] = tab.groups[grow, 16 + w.oct[gi]].long()
        for q in range(int(nj.max())):
            act_t = ing & (q < nj) & ~w.stopped
            if not bool(act_t.any()):
                break
            w.cnt.step("walk", act_t)
            j = j0[act_t] + ((tord[act_t] >> (3 * q)) & 7)
            int_ = act_t.clone()
            int_[act_t] = w.slab(j, tab.tnodes, act_t)
            if not bool(int_.any()):
                continue
            jt = zero.clone()
            jt[act_t] = j
            nl, key0, lord = zero.clone(), zero.clone(), zero.clone()
            nl[int_], key0[int_], lord[int_] = w.tile_leaves(jt[int_], int_)
            for r in range(int(nl.max())):
                act_l = int_ & (r < nl) & ~w.stopped
                if not bool(act_l.any()):
                    break
                w.cnt.step("walk", act_l)
                leaf = 8 * jt[act_l] + ((lord[act_l] >> (3 * r)) & 7)
                inl = act_l.clone()
                inl[act_l] = w.slab(leaf, tab.leaves, act_l)
                fa, fb = zero.clone(), zero.clone()
                rows = torch.zeros(n, dtype=torch.int64)
                rows[act_l] = leaf
                fa[inl] = tab.leaves[rows[inl], 6].long()
                fb[inl] = fa[inl] + tab.leaves[rows[inl], 7].long()
                w.faces(inl, fa, fb, key0)


def one_loop(w, eighths=RULE):
    """`walk_warp`: every iteration each traversing lane makes one slab
    test at its own level (0 group, 1 tile, 2 leaf) and advances; a lane
    that enters a leaf holds it; a warp runs its holding lanes' faces once
    at least `eighths` in 8 of its lanes in the loop hold one (8: every
    lane), or none is left traversing."""
    from rtf_tpu_torch.render import wave as W
    tab, n = w.tab, w.walking.shape[0]
    z = lambda: torch.zeros(n, dtype=torch.int64)    # noqa: E731
    lvl = torch.where(w.walking & (w.ng > 0), 0, DONE)
    s, q, r, j0, nj, j, nl, key0, tord, lord, fa, fb = (z() for _ in
                                                        range(12))
    while True:
        held = fa < fb
        inloop = ~((lvl == DONE) & ~held) & ~w.stopped
        if not bool(inloop.any()):
            return
        trav = inloop & ~held
        hold = (inloop & held).view(-1, WARP).sum(1)
        faces_now = ((hold > 0) & (8 * hold >= eighths * inloop.view(
            -1, WARP).sum(1))) | ~trav.view(-1, WARP).any(1)
        faces_now = faces_now.repeat_interleave(WARP)
        go = trav & ~faces_now
        if bool(go.any()):
            w.cnt.step("walk", go)
            idx = torch.nonzero(go)[:, 0]
            lv, o = lvl[idx], w.oct[idx]
            row = torch.where(
                lv == 0, tab.groups[w.g0 + s[idx], 8 + o].long(),
                torch.where(lv == 1, j0[idx] + ((tord[idx] >> (3 * q[idx]))
                                                & 7),
                            8 * j[idx] + ((lord[idx] >> (3 * r[idx])) & 7)))
            box = torch.where((lv == 0)[:, None], tab.groups[row.clamp(
                max=tab.groups.shape[0] - 1), 0:8],
                torch.where((lv == 1)[:, None], tab.tnodes[row.clamp(
                    max=tab.tnodes.shape[0] - 1), 0:8],
                    tab.leaves[row.clamp(max=tab.leaves.shape[0] - 1), 0:8]))
            w.cnt.slabs[idx] += 1
            inb = W._slab([box[:, a] for a in range(3)],
                          [box[:, 3 + a] for a in range(3)],
                          tuple(v[idx] for v in w.lo3),
                          tuple(v[idx] for v in w.ild3), w.best[idx])
            # into a group's tiles
            d0 = idx[inb & (lv == 0)]
            r0 = row[inb & (lv == 0)]
            j0[d0] = tab.groups[r0, 6].long()
            nj[d0] = tab.groups[r0, 7].long()
            tord[d0] = tab.groups[r0, 16 + w.oct[d0]].long()
            q[d0] = 0
            # into a tile's leaves
            d1 = idx[inb & (lv == 1)]
            r1 = row[inb & (lv == 1)]
            j[d1] = r1
            nl_, k0, lo_ = w.tile_leaves(r1, d1)
            nl[d1], key0[d1], lord[d1] = nl_, k0, lo_
            r[d1] = 0
            # a leaf to hold; then the next step of a miss or a leaf
            hl = idx[inb & (lv == 2)]
            fa[hl] = tab.leaves[row[inb & (lv == 2)], 6].long()
            fb[hl] = fa[hl] + tab.leaves[row[inb & (lv == 2)], 7].long()
            lvl[d0], lvl[d1] = 1, 2
            adv = idx[~inb | (lv == 2)]
            la = lvl[adv]
            r[adv[la == 2]] += 1
            q[adv[la == 1]] += 1
            s[adv[la == 0]] += 1
            # climb out of the levels whose steps are spent
            up = go & (lvl == 2) & (r >= nl)
            lvl[up], q[up] = 1, q[up] + 1
            up = go & (lvl == 1) & (q >= nj)
            lvl[up], s[up] = 0, s[up] + 1
            lvl[go & (lvl == 0) & (s >= w.ng)] = DONE
        test = inloop & held & faces_now
        if bool(test.any()):
            w.faces(test, fa, fb, key0)
            fa[test], fb[test] = 0, 0


def _emulate(tab, h, o3, d3, closest, cap, walk, rule=RULE):
    """Per ray the mesh's closest hit (t, face row; t = BIG and face -1 on
    a miss) or occlusion below cap, over every instance in order, with
    `walk` ("nested" or "one loop") and its Counts."""
    from rtf_tpu_torch.render import wave as W
    n = o3[0].shape[0]
    cnt = Counts(n)
    best = torch.full((n,), W.BIG) if closest else cap.clone()
    face = torch.full((n,), -1, dtype=torch.int64)
    occ = torch.zeros(n, dtype=torch.bool)
    for k, row in enumerate(h.insts):
        lo3, ld3 = W._to_local(row, o3, d3)
        ild3 = W._inv_dir(ld3)
        rb = tab.roots[k]
        walking = W._slab([rb[a] for a in range(3)],
                          [rb[3 + a] for a in range(3)], lo3, ild3, best) \
            & ~occ
        w = Walk(tab, k, lo3, ld3, ild3, walking, closest, best.clone(),
                 cnt)
        nested(w) if walk == "nested" else one_loop(w, rule)
        if closest:
            won = w.bface >= 0
            best, face[won] = w.best, w.bface[won]
        else:
            occ |= w.stopped
    return (best, face) if closest else occ, cnt


def _warp_rays(scene):
    """test_torch_mxu_tree.py's rays, padded with copies of the first to
    whole warps."""
    o, d = _rays(scene)
    pad = -o.shape[1] % WARP
    o, d = torch.cat([o, o[:, :pad]], 1), torch.cat([d, d[:, :pad]], 1)
    return tuple(o), tuple(d)


@pytest.mark.parametrize("case", CASES)
def test_warp_walk_exact(case):
    """The one-loop walk under the kernel's wait rule and waiting for every
    lane: the plain winner (t, key) of every ray, the plain any-hit answer of every
    shadow ray, and each lane's slab and face tests those of the nested
    walk; prints the lane use of both walks."""
    from rtf_tpu_torch.render import wave as W
    scene, tab, _ = _tables(case)
    h = W._Host(tab)
    o3, d3 = _warp_rays(scene)
    n = o3[0].shape[0]
    # the plain winner: per instance the least (t, key), the earliest
    # instance on a tie of t
    want_t = torch.full((n,), W.BIG)
    want_f = torch.full((n,), -1, dtype=torch.int64)
    for k, inst in enumerate(h.insts):
        lo3, ld3 = W._to_local(inst, o3, d3)
        t, f = _winners(tab, k, lo3, ld3, int(inst[22]), int(inst[23]))
        win = (f >= 0) & (t < want_t)
        want_t, want_f = torch.where(win, t, want_t), torch.where(win, f,
                                                                  want_f)
    st = [torch.full((n,), W.BIG)] + [torch.zeros(n) for _ in range(7)]
    W._mesh_closest_mxu(h, o3, d3, st, False)
    assert torch.equal(st[0], want_t)
    assert int((want_f >= 0).sum()) > 100
    # shadow caps around the winner's t: about half the rays occluded
    rng = np.random.RandomState(7)
    cap = torch.where(want_f >= 0, want_t * torch.as_tensor(
        rng.uniform(0.5, 1.5, n), dtype=torch.float32),
        torch.as_tensor(rng.uniform(1.0, 40.0, n), dtype=torch.float32))
    want_occ = W._mesh_anyhit_mxu(h, o3, d3, cap)
    assert 0.2 < float(want_occ.float().mean()) < 0.8

    (t0, f0), c0 = _emulate(tab, h, o3, d3, True, None, "nested")
    occ0, s0 = _emulate(tab, h, o3, d3, False, cap, "nested")
    assert torch.equal(t0, want_t) and torch.equal(f0, want_f)
    assert torch.equal(occ0, want_occ)
    use = {}
    for rule in (RULE, 8):
        (t1, f1), c1 = _emulate(tab, h, o3, d3, True, None, "one loop",
                                   rule)
        occ1, s1 = _emulate(tab, h, o3, d3, False, cap, "one loop", rule)
        assert torch.equal(t1, want_t) and torch.equal(f1, want_f), rule
        assert torch.equal(occ1, want_occ), rule
        # a lane never traverses while it holds a leaf: its own tests,
        # and the caps they read, are the nested walk's
        for a, b in ((c1, c0), (s1, s0)):
            assert torch.equal(a.slabs, b.slabs), rule
            assert torch.equal(a.faces, b.faces), rule
        use[rule] = c1, s1
    print(f"\n[warp walk] {case}: {n} rays; lane use, walk / face loops "
          f"(closest hit; shadow rays): nested {c0.use('walk'):.1f}% / "
          f"{c0.use('pair'):.1f}% ({s0.use('walk'):.1f}% / "
          f"{s0.use('pair'):.1f}%); " + "; ".join(
              f"one loop, {rule}/8 {c.use('walk'):.1f}% / {c.use('pair'):.1f}%"
              f" ({s.use('walk'):.1f}% / {s.use('pair'):.1f}%)"
              for rule, (c, s) in use.items()))
    # the faces of a warp's leaves are tested together
    assert use[RULE][0].use("pair") > c0.use("pair")
