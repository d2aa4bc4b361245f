"""A plain-torch model of how W1/W2 (``csrc/intersect_wide.cu``) split their
work, on the CPU.

The kernels run only on the card; what they compute there rests on their
work split: a block compacts the live rays of its span of lanes, a group of
B lanes (B = the tree's branch) walks one ray at a time, lane k slab-tests
child k of a node or triangles k, k + B, ... of a leaf, a ballot gives the
hit set, the hits are ordered by rank (count of nearer hits, ties by slot;
slot order alone in the any-hit entry), the nearest goes straight to the
next step and the others onto the group's row of a shared-memory stack,
farthest first, and a leaf's (t, slot) minimum comes from an xor butterfly
of shuffles, the lowest slot winning a tie. The model is built from the
constants the source declares (read from it, as
``tests/test_torch_gather_split.py`` reads ``gather_rows.cu``) and follows
the kernel's steps with every group of a block in lockstep, the block's
groups sharing one flat stack array. It walks the cases of
``tests/test_torch_intersect_wide.py`` to the plain walk's t bit for bit,
with the same winners but for ties between leaves and the same rows fetched
per ray, and it catches three seeded faults: a dropped hit child, ties
broken to the highest slot, and a stack too short, which overruns into the
next group's. The card holds the kernels themselves to the plain walk
(``tests/test_torch_cuda.py::test_w1_w2_match_plain_walk``,
``chip_smoke.py`` phases 3c and 7b). No JAX function is used here.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nrc_tpu_torch.ops import intersect_wide as IW
from nrc_tpu_torch.ops import intersect_wide_cuda as WC
from nrc_tpu_torch.ops.bvh_wide import build_wide_bvh
from nrc_tpu_torch.ops.intersect import RT_MAX
from test_torch_bvh import soup
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_intersect_wide import CASES, _case

SOURCE = (Path(__file__).resolve().parents[1] / "nrc_tpu_torch" / "csrc" / "intersect_wide.cu").read_text()


def _c_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


THREADS, SPAN, STACK, MAX_LEAF = (_c_constant(name)
                                  for name in ("kThreads", "kSpan", "kStack", "kMaxLeaf"))
GROUPS = tuple(sorted({int(b) for b in re.findall(r"wbvh_kernel<(\d+), kAnyHit, Leaf><<<", SOURCE)}))
SHARED_BYTES_A_BLOCK = 48 * 1024   # static shared memory a block may declare
SHARED_BYTES_AN_SM = 232448        # an H100 SM's shared memory for blocks
THREADS_AN_SM = 2048


def shared_bytes(b):
    """``wbvh_kernel<B>``'s shared arrays: the span's live rays, a stack row
    of kStack entries a group, the span's live count, the queue."""
    return 4 * (SPAN + (THREADS // b) * STACK + 2)


def test_the_kernel_constants_are_the_wrappers():
    assert WC.MAX_STACK == STACK and WC.MAX_LEAF == MAX_LEAF
    assert GROUPS == tuple(sorted(WC.BRANCHES)) == (8, 16)


@pytest.mark.parametrize("b", GROUPS)
def test_the_shared_memory_layout_fits_a_block(b):
    """A group is B lanes of one warp; a span is the lanes of one ballot of
    the block's first warp; the shared arrays fit a block's static shared
    memory, and at the shipped branch of 16 the blocks that fill an SM's
    threads fit its shared memory."""
    assert 32 % b == 0 and b & (b - 1) == 0 and THREADS % 32 == 0
    assert SPAN == 32 <= THREADS
    assert shared_bytes(b) <= SHARED_BYTES_A_BLOCK
    if b == 16:
        assert (THREADS_AN_SM // THREADS) * shared_bytes(b) <= SHARED_BYTES_AN_SM


class Overrun(AssertionError):
    pass


def model_walk(org, d, bvh, tmin, tmax, any_hit, fault=None, stack_entries=STACK):
    """The kernel's walk, block by block, every group of a block in lockstep.

    A copy of the kernel's step logic, not the kernel: a change to how
    ``walk_step`` ranks, pushes, pops or breaks a tie needs the same change
    here (``test_the_kernel_keeps_the_models_step_rules`` fails on an edit of
    those lines of the source). Returns (t, prim, rows fetched per ray, deepest stack per ray). ``fault``
    seeds one: "drop_hit" pushes no farthest hit child, "tie_high" breaks a
    leaf's ties to the highest slot. ``stack_entries`` is a group's stack row
    (its stride in the block's array and its size)."""
    b, ls, w_nodes = bvh.branch, bvh.leaf_size, bvh.num_nodes
    n = org.shape[0]
    groups = THREADS // b
    lanes = torch.arange(b)
    inv = IW.ray_inv_dir(d)
    t_out = torch.full((n,), RT_MAX)
    p_out = torch.full((n,), -1, dtype=torch.int64)
    fetches = torch.zeros(n, dtype=torch.int64)
    deepest = torch.zeros(n, dtype=torch.int64)
    # compaction: each span's live rays in lane order; the q-th live ray of
    # a span goes to group q % groups in round q // groups (every block's
    # round r in lockstep; the queue hands rays out in the same order when
    # the groups keep pace)
    live = ~(tmax <= tmin)
    block = torch.arange(n) // SPAN
    q = torch.cumsum(live.long(), 0) - 1
    q -= torch.cat([torch.zeros(1, dtype=torch.int64), q[SPAN - 1::SPAN] + 1])[block]
    row_of_block = groups * stack_entries + stack_entries  # a block's stack array, with room past its end
    stacks = torch.full(((int(block.max()) + 1) * row_of_block,), -7, dtype=torch.int32)
    for rnd in range(int(q[live].max()) // groups + 1 if live.any() else 0):
        ray = (live & (q // groups == rnd)).nonzero()[:, 0]
        g = block[ray] * (row_of_block // stack_entries) + q[ray] % groups  # stack row in the flat array
        o, dd, iv, tn, tf = org[ray], d[ray], inv[ray], tmin[ray], tmax[ray]
        best_t = torch.full((ray.numel(),), RT_MAX)
        best = torch.full((ray.numel(),), -1, dtype=torch.int64)
        entry = torch.zeros(ray.numel(), dtype=torch.int64)
        sp = torch.zeros(ray.numel(), dtype=torch.int64)
        going = torch.ones(ray.numel(), dtype=torch.bool)
        while going.any():
            fetches[ray[going]] += 1
            cap = torch.minimum(tf, best_t)
            pop = going.clone()
            node = going & (entry >= 0)
            if node.any():
                row = bvh.rows[entry[node]]
                meta = row[:, 6 * b: 7 * b].view(torch.int32)
                t0 = [(row[:, a * b: (a + 1) * b] - o[node, a: a + 1]) * iv[node, a: a + 1] for a in range(3)]
                t1 = [(row[:, (3 + a) * b: (4 + a) * b] - o[node, a: a + 1]) * iv[node, a: a + 1] for a in range(3)]
                near = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]), torch.minimum(t0[1], t1[1])),
                                     torch.minimum(t0[2], t1[2]))
                far = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]), torch.maximum(t0[1], t1[1])),
                                    torch.maximum(t0[2], t1[2]))
                ok = (torch.maximum(near, tn[node, None]) <= torch.minimum(far, cap[node, None])) & (meta != IW.NONE)
                h = ok.sum(dim=1)                                          # the ballot's count
                below = lanes[None, :] < lanes[:, None]                    # [k, j]: j < k
                if any_hit:
                    ahead = ok[:, None, :] & below[None]                   # slot order
                else:
                    kj, kk = near[:, None, :], near[:, :, None]
                    ahead = ok[:, None, :] & ((kj < kk) | ((kj == kk) & below[None]))
                rank = ahead.sum(dim=2)
                if fault == "drop_hit":  # the farthest of two or more hits is lost
                    h = torch.where(h >= 2, h - 1, h)
                    ok &= rank < h[:, None]
                nearest = ok & (rank == 0)
                push = ok & (rank > 0)
                gi, si = g[node], sp[node]
                pos = si[:, None] + h[:, None] - 1 - rank                  # farthest first
                rr, kk_ = push.nonzero(as_tuple=True)
                if (pos[rr, kk_] >= stack_entries).any():
                    raise Overrun("a group's stack overruns into the next group's")
                stacks[gi[rr] * stack_entries + pos[rr, kk_]] = meta[rr, kk_]
                has = h > 0
                nxt = meta[has].gather(1, nearest[has].int().argmax(dim=1, keepdim=True))[:, 0].long()
                sel = node.nonzero()[:, 0]
                entry[sel[has]] = nxt
                sp[sel] = si + torch.clamp(h - 1, min=0)
                deepest[ray[sel]] = torch.maximum(deepest[ray[sel]], sp[sel])
                pop[sel[has]] = False
            leaf = going & (entry < 0)
            if leaf.any():
                row = bvh.rows[w_nodes + ~entry[leaf]]
                c = [row[:, k * ls: (k + 1) * ls] for k in range(IW.TRI_ROW_W)]
                pid = row[:, IW.TRI_ROW_W * ls: (IW.TRI_ROW_W + 1) * ls].view(torch.int32).long()
                t = IW._leaf_tri_t(c, pid, o[leaf], dd[leaf], tn[leaf], cap[leaf])
                # lane k: its triangles k, k + B, ... in order, strict <
                lt = torch.full((t.shape[0], b), RT_MAX)
                lp = torch.full((t.shape[0], b), -1, dtype=torch.int64)
                lslot = torch.full((t.shape[0], b), MAX_LEAF, dtype=torch.int64)
                for tri in range(ls):
                    k = tri % b
                    take = (t[:, tri] <= lt[:, k]) if fault == "tie_high" else (t[:, tri] < lt[:, k])
                    take &= t[:, tri] < RT_MAX
                    lt[:, k] = torch.where(take, t[:, tri], lt[:, k])
                    lp[:, k] = torch.where(take, pid[:, tri], lp[:, k])
                    lslot[:, k] = torch.where(take, tri, lslot[:, k])
                hit = (lt < RT_MAX).any(dim=1)
                sel = leaf.nonzero()[:, 0]
                if any_hit:
                    first = (lt < RT_MAX).int().argmax(dim=1, keepdim=True)
                    best_t[sel[hit]] = lt.gather(1, first)[:, 0][hit]
                    best[sel[hit]] = lp.gather(1, first)[:, 0][hit]
                    going[sel[hit]] = False
                    pop[sel[hit]] = False
                else:
                    off = b // 2
                    while off:  # the xor butterfly of shuffles
                        ot, os_, op = lt[:, lanes ^ off], lslot[:, lanes ^ off], lp[:, lanes ^ off]
                        tie = (os_ > lslot) if fault == "tie_high" else (os_ < lslot)
                        win = (ot < lt) | ((ot == lt) & tie)
                        lt, lslot, lp = torch.where(win, ot, lt), torch.where(win, os_, lslot), torch.where(win, op, lp)
                        off //= 2
                    better = hit & (lt[:, 0] < cap[leaf])
                    best_t[sel[better]] = lt[better, 0]
                    best[sel[better]] = lp[better, 0]
            # pop: a group with an empty stack is done
            out = pop & (sp == 0)
            going &= ~out
            pop &= ~out
            sp[pop] -= 1
            entry[pop] = stacks[g[pop] * stack_entries + sp[pop]].long()
        t_out[ray], p_out[ray] = best_t, best
    return t_out, p_out, fetches, deepest


def leaf_of_prim(bvh):
    """primitive id -> the leaf row that holds it."""
    ls, w = bvh.leaf_size, bvh.num_nodes
    ids = bvh.rows[w:, IW.TRI_ROW_W * ls: (IW.TRI_ROW_W + 1) * ls].view(torch.int32).long()
    out = torch.full((int(ids.max()) + 2,), -1, dtype=torch.int64)
    rows = torch.arange(ids.shape[0])[:, None].expand_as(ids)
    out[ids[ids >= 0]] = rows[ids >= 0]
    return out


def check_against_plain(rays, bvh, any_hit, result):
    """The kernel's promise, on the model's result: t bit for bit and the
    same rows fetched per ray; the same winner but where two triangles of
    different leaves give the same t; W2's occlusion equal."""
    org, d, tmin, tmax = rays
    fetches = torch.zeros(org.shape[0], dtype=torch.int64)
    tp, pp, _ = IW.wide_traverse_plain(org, d, bvh, tmin, tmax, any_hit, ray_fetches=fetches)
    t, prim, got_fetches, _ = result
    if any_hit:
        assert torch.equal(prim >= 0, pp >= 0), "occlusion differs from the plain walk"
        return
    assert torch.equal(t, tp), "t differs from the plain walk"
    other = prim != pp
    leaf = leaf_of_prim(bvh)
    assert bool((leaf[prim[other]] != leaf[pp[other]]).all()), "a leaf's tie went another way than the plain walk's"
    assert torch.equal(got_fetches, fetches), "the model fetched other rows than the plain walk"


# The lines of walk_step that hold the rules model_walk copies, as the source
# spells them: a node's rank (nearer first, ties by slot; slot order in the
# any-hit entry), the push farthest first and the pop, a lane's strict < over
# its triangles, and the leaf's butterfly (lowest t, lowest slot on ties).
STEP_RULES = {
    "rank by slot": "int rank = __popc(hits & ((1u << k) - 1u));",
    "rank nearer first, ties by slot": "rank += (kj < tnear || (kj == tnear && j < k)) ? 1 : 0;",
    "nearest goes on": "const unsigned first = __ballot_sync(gmask, ok && rank == 0) >> lane0;",
    "push farthest first": "if (ok && rank > 0) stack[w.sp + h - 1 - rank] = meta;",
    "stack grows by the hits less one": "w.sp += h - 1;",
    "pop": "w.entry = stack[--w.sp];",
    "a lane's triangles, strict <": "if (t < lt) {",
    "butterfly, lowest slot on ties": "if (ot < lt || (ot == lt && os < ls)) {",
    "a leaf's best only below the cap": "if (lt < cap) {",
}


@pytest.mark.parametrize("rule", sorted(STEP_RULES))
def test_the_kernel_keeps_the_models_step_rules(rule):
    assert STEP_RULES[rule] in SOURCE, f"walk_step changed its rule '{rule}': change model_walk to match"


@pytest.fixture(scope="module", params=CASES)
def case(request):
    (p0, p1, p2), branch, leaf, org, d, tmin, tmax = _case(request.param)
    bvh = IW.upload_wide_bvh(build_wide_bvh(p0, p1, p2, leaf_size=leaf, branch=branch), "cpu")
    return bvh, tuple(torch.from_numpy(x) for x in (org, d, tmin, tmax))


@pytest.mark.parametrize("any_hit", [False, True])
def test_the_group_walk_matches_the_plain_walk(case, any_hit):
    bvh, rays = case
    result = model_walk(*rays[:2], bvh, *rays[2:], any_hit)
    check_against_plain(rays, bvh, any_hit, result)
    deepest = int(result[3].max())
    assert deepest <= (bvh.branch - 1) * bvh.depth + 1 <= STACK
    dead = rays[3] <= rays[2]
    assert bool((result[1][dead] == -1).all()) and bool((result[0][dead] == RT_MAX).all())


def duplicated_soup():
    """Every triangle twice: the copies share a leaf and give the same t,
    so a leaf's tie rule decides the winner."""
    p = soup(1500, seed=31)
    p = tuple(np.repeat(x, 2, axis=0) for x in p)
    org = (np.random.default_rng(32).random((1200, 3)) * 10).astype(np.float32)
    d = np.random.default_rng(33).normal(size=(1200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    bvh = IW.upload_wide_bvh(build_wide_bvh(*p, leaf_size=16, branch=16), "cpu")
    return bvh, (torch.from_numpy(org), torch.from_numpy(d), torch.zeros(1200), torch.full((1200,), RT_MAX))


@pytest.mark.parametrize("fault", ["drop_hit", "tie_high", "short_stack"])
def test_seeded_faults_are_caught(fault):
    bvh, rays = duplicated_soup()
    good = model_walk(*rays[:2], bvh, *rays[2:], False)
    check_against_plain(rays, bvh, False, good)
    assert (good[1] >= 0).float().mean() > 0.3
    with pytest.raises(AssertionError):
        if fault == "short_stack":  # a stack row of fewer entries than the tree needs
            need = int(good[3].max())
            model_walk(*rays[:2], bvh, *rays[2:], False, stack_entries=need - 1)
        else:
            bad = model_walk(*rays[:2], bvh, *rays[2:], False, fault=fault)
            check_against_plain(rays, bvh, False, bad)
