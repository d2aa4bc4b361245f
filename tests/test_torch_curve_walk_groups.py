"""A plain-torch model of how C1/C2 (``csrc/intersect_curves.cu``) walk, on
the CPU.

The kernels run only on the card; what they compute there rests on their
schedule: a block compacts the live rays of its span of lanes (16 for C1, 8
for C2) and, from the span's live count, gives each ray a group of 8 E
lanes (E = 1 or 4; the wrapper's ``curve_widths``, which the source's
``Span`` must match); a step of a ray takes up to E entries, the nearest
hit child of its last step and then pops from the top of its stack row;
sub-group s of 8 lanes tests entry s, lane k child or segment k. C2 tests
them all against the cap taken before the step and pushes every node's hit
children. C1 keeps the plain walk's order: entry s's boxes are tested
against the cap lowered by the least t of the entries before it, the first
node with a hit child ends the step's entries (the others go back onto the
stack), and the (t, entry, slot) minimum of the leaves taken updates the
best. The hit children are ranked over the group (nearer first, ties by
the group's slot order; slot order in the any-hit entry), the nearest is
carried and the others pushed farthest first; a wide step is taken only
while it leaves the narrow walk's row free. At E = 1 this is the kernel's
narrow step: one entry, then the nearest hit child or a pop. The model is
built from the constants the source declares (read from it, as
``tests/test_torch_walk_groups.py`` reads ``intersect_wide.cu``) and follows
the kernel's steps with every group of a block in lockstep, the block's
rays sharing one flat stack array. It walks the cases of
``tests/test_torch_curves.py``, 700 random segments and a ``cornell_hair``
patch of 300 strands to the plain cone walk: C1's t and winner equal to
the plain walk's, its rows the plain walk's fetches one for one and its
stack within the narrow walk's bound at every width; C2's occlusion exact
and its stack within the wrapper's bound. It shows the design's point in
counts: on the patch's rays whose plain walk fetches 20 rows or more, the
walk at E = 4 takes 0.59 of the dependent steps in all for C1 (24 for the
longest chain of 42 fetches) and 0.31 for C2. It catches four seeded
faults: a dropped hit child, the best updated sub-group by sub-group within
a step, a C1 step that tests every entry against one cap and pushes every
node's hit children (the order the any-hit entry may take), and a stack row
one entry short. The card holds the kernels themselves to the plain walk
(``tests/test_torch_cuda.py::test_c1_c2_match_plain_cone_walk``,
``chip_smoke.py`` 6h). No JAX function is used here.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nrc_tpu_torch.ops import intersect_wide as IW
from nrc_tpu_torch.ops import intersect_wide_cuda as WC
from nrc_tpu_torch.ops.curve_intersect import build_wide_curve_bvh
from nrc_tpu_torch.ops.intersect import RT_MAX
from nrc_tpu_torch.scene.scene_builder import cornell_hair
from test_torch_curves import CASES, make_segments, random_segments
from test_torch_intersect import one_torch_thread  # noqa: F401 (an autouse fixture)

SOURCE = (Path(__file__).resolve().parents[1] / "nrc_tpu_torch" / "csrc" / "intersect_curves.cu").read_text()


def _c_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def _c_span(name):
    """``Span``'s constant ``name`` -> {any hit: its value}."""
    any_, closest = re.search(rf"static constexpr int {name} = kAnyHit \? (\d+) : (\d+);", SOURCE).groups()
    return {False: int(closest), True: int(any_)}


THREADS, B, ROW_WORDS, STACK_WORDS = (
    _c_constant(name) for name in ("kThreads", "kB", "kRowWords", "kStackWords"))
SUBS = THREADS // B                   # kSubs
STACK1 = STACK_WORDS // SUBS          # kStack1
SPANS = WC.CURVE_SPANS                # by any hit: the lanes a block compacts
SHARED_BYTES_A_BLOCK = 48 * 1024      # static shared memory a block may declare
NONE = IW.NONE


def span_width(live: int, any_hit: bool) -> int:
    """E, the entries a step (8 E lanes a ray), from a span's live count."""
    return int(WC.curve_widths(torch.tensor(live), any_hit))


def stack_row(e: int) -> int:
    """A ray's row of the block's stack array at width E."""
    return STACK_WORDS // (THREADS // (B * e))


def test_the_kernel_constants_are_the_wrappers():
    assert WC.CURVE_STACK == STACK1 and WC.CURVE_BRANCH == B and WC.CURVE_ROW_WORDS == ROW_WORDS == 10 * B
    assert {WC.CURVE_CLOSEST_KERNEL.source, WC.CURVE_ANYHIT_KERNEL.source} == {"intersect_curves.cu"}
    assert (WC.CURVE_CLOSEST_KERNEL.symbol, WC.CURVE_ANYHIT_KERNEL.symbol) == (
        "nrc_wbvh_curves_closest", "nrc_wbvh_curves_any")
    # the wrapper's span policy is the source's Span
    assert _c_span("kLanes") == WC.CURVE_SPANS and _c_span("kWide") == WC.CURVE_WIDE
    assert [span_width(n, False) for n in (1, 12, 13, 16)] == [4, 4, 1, 1]
    assert [span_width(n, True) for n in range(1, SPANS[True] + 1)] == [4] * SPANS[True]  # every C2 ray 32 lanes


@pytest.mark.parametrize("any_hit", [False, True])
def test_the_span_widths_a_launch_takes(any_hit):
    """``curve_span_widths`` counts a launch's spans by the width the kernel
    gives them, as ``span_width`` picks it (a ragged last span included)."""
    span = SPANS[any_hit]
    rs = np.random.default_rng(3)
    n = span * 50 + 7
    share = np.repeat(rs.random(51), span)[:n]
    tmax = torch.tensor(np.where(rs.random(n) < share, 1.0, 0.0), dtype=torch.float32)
    tmin = torch.zeros(n)
    live = (tmax > tmin).long()
    counts = [int(live[i:i + span].sum()) for i in range(0, n, span)]
    want = {e: sum(1 for c in counts if c and span_width(c, any_hit) == e) for e in (1, 4)}
    assert WC.curve_span_widths(tmin, tmax, any_hit) == want and want[4] and (want[1] > 0) != any_hit


def test_the_shared_memory_layout_fits_a_block():
    """A span is one ballot of warp 0; the stack array, the span's live
    rays and two counters fit a block's static shared memory; at every
    width the groups' stack rows tile the array and leave a wide step the
    narrow row free."""
    assert all(4 <= span <= 32 and span % 4 == 0 for span in SPANS.values())
    assert THREADS % 32 == 0 and B * 4 == 32 and ROW_WORDS % 4 == 0
    assert 4 * (STACK_WORDS + max(SPANS.values()) + 2) <= SHARED_BYTES_A_BLOCK
    for e in (1, 4):
        assert (THREADS // (B * e)) * stack_row(e) == STACK_WORDS
        assert stack_row(e) - STACK1 >= (0 if e == 1 else (B - 1) * e)


class Overrun(AssertionError):
    pass


def _trunc_div(a, b):
    """C's integer division (toward zero)."""
    return torch.sign(a) * (torch.abs(a) // b)


def model_walk(org, d, bvh, tmin, tmax, any_hit, width=None, fault=None, stack_entries=None):
    """The kernel's walk, block by block, the groups of a block in lockstep.

    A copy of the kernel's step logic, not the kernel: a change to how
    ``wide_step`` or ``narrow_step`` picks its entries, ranks, pushes or pops needs
    the same change here (``test_the_kernel_keeps_the_models_step_rules``
    fails on an edit of those lines of the source). ``width`` forces E for
    every span (else the span's live count picks it). ``fault`` seeds one:
    "drop_hit" pushes no farthest hit child, "cap_in_step" lets each
    sub-group's leaf replace the best in turn against the cap before the
    step (so a later sub-group's farther hit overwrites a nearer one);
    "one_cap" walks C1 as C2 walks, every entry against the cap before the
    step and every node's hit children pushed.
    ``stack_entries`` shortens each ray's stack row to that many entries
    while the step rule still reckons with the kernel's rows.

    Returns a dict of [N] tensors: t, prim, E, steps (the ray's chain of
    dependent steps), rows (entries taken), deepest (stack)."""
    n = org.shape[0]
    ls, w_nodes = bvh.leaf_size, bvh.num_nodes
    assert bvh.branch == ls == B and bvh.rows.shape[1] >= ROW_WORDS
    inv = IW.ray_inv_dir(d)
    res = {key: torch.zeros(n, dtype=torch.int64) for key in ("E", "steps", "rows", "deepest")}
    res["t"] = torch.full((n,), RT_MAX)
    res["prim"] = torch.full((n,), -1, dtype=torch.int64)
    live = ~(tmax <= tmin)
    SPAN = SPANS[any_hit]
    block = torch.arange(n) // SPAN
    nblocks = int(block.max()) + 1 if n else 0
    q = torch.cumsum(live.long(), 0) - 1
    q -= torch.cat([torch.zeros(1, dtype=torch.int64), q[SPAN - 1::SPAN] + 1])[block]
    span_live = torch.zeros(nblocks, dtype=torch.int64).index_add_(0, block, live.long())
    e_of = torch.full_like(span_live, width) if width else WC.curve_widths(span_live, any_hit)
    ray_e = e_of[block]
    res["E"] = torch.where(live, ray_e, 0)
    groups = THREADS // (B * ray_e)
    row_len = STACK_WORDS // groups
    phys = row_len if stack_entries is None else torch.clamp(row_len, max=stack_entries)
    stacks = torch.full((nblocks, STACK_WORDS), -7, dtype=torch.int64)
    sgrid = torch.arange(4)
    lanes = torch.arange(4 * B)
    below = lanes[None, :] < lanes[:, None]                          # [i, j]: j < i
    rounds = q // groups
    for rnd in range(int(rounds[live].max()) + 1 if live.any() else 0):
        ray = (live & (rounds == rnd)).nonzero()[:, 0]
        k = ray.numel()
        blk, e = block[ray], ray_e[ray]
        g = q[ray] % groups[ray]
        base = g * row_len[ray]
        room = row_len[ray] - STACK1
        o, dd, iv, tn, tf = org[ray], d[ray], inv[ray], tmin[ray], tmax[ray]
        best_t = torch.full((k,), RT_MAX)
        best = torch.full((k,), -1, dtype=torch.int64)
        entry = torch.zeros(k, dtype=torch.int64)   # the root's row
        sp = torch.zeros(k, dtype=torch.int64)
        going = torch.ones(k, dtype=torch.bool)
        while going.any():
            a = going.nonzero()[:, 0]
            cap = torch.minimum(tf[a], best_t[a])           # the cap before the step
            c = (entry[a] != NONE).long()
            m = torch.minimum(e[a], c + sp[a])
            lim = _trunc_div(room[a] - sp[a] - c + 1, B - 1)
            m = torch.where(m > 1, torch.clamp(torch.minimum(m, lim), min=1), m)
            fin = m == 0
            going[a[fin]] = False
            keep = ~fin
            a, cap, c, m = a[keep], cap[keep], c[keep], m[keep]
            if a.numel() == 0:
                break
            # ---- 1. the entries: the carried child, then pops from the top ----
            pos = sp[a, None] - 1 - (sgrid[None, :] - c[:, None])
            popped = stacks[blk[a, None], base[a, None] + torch.clamp(pos, min=0)]
            ent = torch.where(sgrid[None, :] < c[:, None], entry[a, None],
                              torch.where(sgrid[None, :] < m[:, None], popped, NONE))
            sp[a] -= m - c
            used = ent != NONE
            res["steps"][ray[a]] += 1
            res["rows"][ray[a]] += used.sum(dim=1)
            # ---- 2. the rows ---------------------------------------------------------
            row_idx = torch.where(ent >= 0, ent, w_nodes + ~ent)
            rows = bvh.rows[torch.where(used, row_idx, 0)]                # [k, 4, P]
            x = [rows[:, :, j * B: (j + 1) * B].reshape(-1, 4 * B) for j in range(10)]
            kind_node = (ent >= 0).repeat_interleave(B, dim=1)            # [k, 32]
            kind_leaf = (used & (ent < 0)).repeat_interleave(B, dim=1)
            # ---- 3. nodes: the slab test of occupied children ----------------------
            meta = x[6].view(torch.int32).long()
            t0 = [(x[j] - o[a, j: j + 1]) * iv[a, j: j + 1] for j in range(3)]
            t1 = [(x[3 + j] - o[a, j: j + 1]) * iv[a, j: j + 1] for j in range(3)]
            near = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]), torch.minimum(t0[1], t1[1])),
                                 torch.minimum(t0[2], t1[2]))
            far = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]), torch.maximum(t0[1], t1[1])),
                                torch.maximum(t0[2], t1[2]))
            lane_cap = cap[:, None].expand(-1, 4 * B)
            # ---- 3. leaves: the cone test of occupied segments ---------------------
            planes = [xx.reshape(-1, B) for xx in x[:9]]
            pid = x[9].view(torch.int32).long()
            lt = IW._leaf_cone_t(planes, pid.reshape(-1, B), o[a].repeat_interleave(4, 0),
                                 dd[a].repeat_interleave(4, 0), tn[a].repeat_interleave(4, 0),
                                 cap.repeat_interleave(4, 0)).reshape(-1, 4 * B)
            lt = torch.where(kind_leaf, lt, RT_MAX)
            if not any_hit and fault != "one_cap":
                # in order: entry s against the cap its leaves before it leave,
                # and no entry after the first node with a hit child
                before = torch.cummin(lt.view(-1, 4, B).min(dim=2).values, dim=1).values
                sub_cap = torch.minimum(cap[:, None], torch.cat([torch.full_like(cap[:, None], RT_MAX),
                                                                  before[:, :-1]], dim=1))
                lane_cap = sub_cap.repeat_interleave(B, dim=1)
            ok = kind_node & (meta != NONE) & (torch.maximum(near, tn[a, None]) <= torch.minimum(far, lane_cap))
            if not any_hit and fault != "one_cap":
                node_hit = ok.view(-1, 4, B).any(dim=2)
                stop = torch.where(node_hit.any(dim=1), node_hit.long().argmax(dim=1), m - 1)
                taken = (sgrid[None, :] <= stop[:, None]).repeat_interleave(B, dim=1)
                lt = torch.where(taken, lt, RT_MAX)
                ok = ok & taken
                sp[a] += m - 1 - stop           # the entries after the stop go back
                res["rows"][ray[a]] -= m - 1 - stop
            # ---- 4. the leaves' (t, slot) minimum over the group --------------------
            hit = lt < RT_MAX
            any_leaf = hit.any(dim=1)
            if any_hit:
                first = hit.long().argmax(dim=1, keepdim=True)
                done = a[any_leaf]
                best_t[done] = lt.gather(1, first)[:, 0][any_leaf]
                best[done] = pid.gather(1, first)[:, 0][any_leaf]
                going[done] = False
            elif fault == "cap_in_step":
                for s in range(4):
                    ts, ks = lt[:, s * B: (s + 1) * B].min(dim=1)
                    take = ts < cap
                    best_t[a[take]] = ts[take]
                    best[a[take]] = pid[:, s * B: (s + 1) * B].gather(1, ks[:, None])[:, 0][take]
            else:
                tmin_, kmin = lt.min(dim=1)                                  # first lane on ties
                take = any_leaf & (tmin_ < cap)
                best_t[a[take]] = tmin_[take]
                best[a[take]] = pid.gather(1, kmin[:, None])[:, 0][take]
            # ---- 5. the nodes' hit children: the nearest carried, the others pushed -
            stay = ~any_leaf if any_hit else torch.ones_like(any_leaf)
            a, ok, near, meta = a[stay], ok[stay], near[stay], meta[stay]
            h = ok.sum(dim=1)
            if any_hit:
                ahead = ok[:, None, :] & below[None]
            else:
                kj, ki = near[:, None, :], near[:, :, None]
                ahead = ok[:, None, :] & ((kj < ki) | ((kj == ki) & below[None]))
            rank = ahead.sum(dim=2)
            if fault == "drop_hit":  # the farthest of two or more hits is lost
                h = torch.where(h >= 2, h - 1, h)
                ok = ok & (rank < h[:, None])
            has = h > 0
            nearest = ok & (rank == 0)
            entry[a] = torch.where(has, meta.gather(1, nearest.long().argmax(dim=1, keepdim=True))[:, 0], NONE)
            push = ok & (rank > 0)
            at = sp[a, None] + h[:, None] - 1 - rank
            rr, jj = push.nonzero(as_tuple=True)
            if (at[rr, jj] >= phys[ray[a[rr]]]).any():
                raise Overrun("a ray's stack overruns its row")
            stacks[blk[a[rr]], base[a[rr]] + at[rr, jj]] = meta[rr, jj]
            sp[a] += torch.clamp(h - 1, min=0)
            res["deepest"][ray[a]] = torch.maximum(res["deepest"][ray[a]], sp[a])
            going[a[(entry[a] == NONE) & (sp[a] == 0)]] = False
        res["t"][ray], res["prim"][ray] = best_t, best
    return res


def segment_columns(bvh):
    """segment id -> its 9 columns (pa | ba | ra, rb, m0), from the leaf rows."""
    ls, w = bvh.leaf_size, bvh.num_nodes
    leaf = bvh.rows[w:]
    ids = leaf[:, 9 * ls: 10 * ls].view(torch.int32).long()
    cols = torch.stack([leaf[:, j * ls: (j + 1) * ls] for j in range(9)], dim=-1)   # [L, ls, 9]
    out = torch.zeros((int(ids.max()) + 1, 9))
    out[ids[ids >= 0]] = cols[ids >= 0]
    return out


def check_against_plain(rays, bvh, any_hit, res):
    """The kernel's promise, on the model's result: dead lanes miss; C2's
    occlusion exact and its stack within the wrapper's bound; C1's t and
    winner the plain walk's, its rows the plain walk's fetches one for one
    (the same rows in the same order) and its stack within the narrow
    walk's bound. Returns the plain walk's rows fetched per ray."""
    org, d, tmin, tmax = rays
    fetches = torch.zeros(org.shape[0], dtype=torch.int64)
    tp, pp, _ = IW.wide_traverse_plain(org, d, bvh, tmin, tmax, any_hit, ray_fetches=fetches, leaf="cone")
    t, prim = res["t"], res["prim"]
    dead = tmax <= tmin
    assert bool((prim[dead] == -1).all()) and bool((t[dead] == RT_MAX).all()), "a dead lane reports a hit"
    narrow = (bvh.branch - 1) * bvh.depth + 1
    assert narrow <= STACK1
    if any_hit:
        assert torch.equal(prim >= 0, pp >= 0), "occlusion differs from the plain walk"
        bound = torch.where(res["E"] > 1, STACK_WORDS // (THREADS // (B * res["E"].clamp(min=1))) - STACK1, 0)
        assert bool((res["deepest"] <= bound + narrow).all()), "a stack deeper than the wrapper's bound"
    else:
        assert torch.equal(t, tp), "t differs from the plain walk"
        assert torch.equal(prim, pp), "a winner differs from the plain walk's"
        assert torch.equal(res["rows"], fetches), "rows other than the plain walk's"
        assert bool((res["deepest"] <= narrow).all()), "a stack deeper than the narrow walk's"
    return fetches


def _cone_bvh(args):
    return IW.upload_wide_bvh(build_wide_curve_bvh(make_segments(*args)), "cpu", kind="cone")


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("any_hit", [False, True])
def test_the_round_cone_cases_match_the_plain_walk(case, any_hit):
    seg, org, d, tmax, _, _ = CASES[case]
    org, d = torch.tensor(org, dtype=torch.float32), torch.tensor(d, dtype=torch.float32)
    n = org.shape[0]
    rays = (org, d, torch.zeros(n), torch.full((n,), tmax, dtype=torch.float32))
    bvh = _cone_bvh(seg)
    for width in (None, 1, 4):
        check_against_plain(rays, bvh, any_hit, model_walk(*rays[:2], bvh, *rays[2:], any_hit, width=width))


@pytest.fixture(scope="module")
def seven_hundred():
    args, org, d = random_segments(700, seed=7)
    n = org.shape[0]
    tmax = np.full(n, 1e9, np.float32)
    tmax[::7] = 0.0
    rays = (torch.tensor(org), torch.tensor(d), torch.zeros(n), torch.tensor(tmax))
    return _cone_bvh(args), rays


@pytest.mark.parametrize("width", [None, 1, 4])
@pytest.mark.parametrize("any_hit", [False, True])
def test_seven_hundred_segments_match_the_plain_walk(seven_hundred, width, any_hit):
    bvh, rays = seven_hundred
    check_against_plain(rays, bvh, any_hit, model_walk(*rays[:2], bvh, *rays[2:], any_hit, width=width))


DENSITIES = (1.0, 0.7, 0.4, 0.06)  # the live share of 16 lanes in turn: C1's E = 1, 1 or 4, 4, 4


@pytest.fixture(scope="module")
def hair_patch():
    """``cornell_hair``'s fur cut to 300 strands (4,800 cones, a tree of 5
    levels) and 4,096 rays from inside its box in random directions; the
    spans' live shares cycle through ``DENSITIES`` so that every width runs."""
    scene, _ = cornell_hair((32, 32), strands=300)
    bvh = IW.upload_wide_bvh(build_wide_curve_bvh(scene.curves), "cpu", kind="cone")
    rs = np.random.default_rng(15)
    n = 4096
    lo, hi = scene.curves.pa.min(0), scene.curves.pa.max(0)
    org = torch.tensor(lo + rs.random((n, 3)) * (hi - lo), dtype=torch.float32)
    d = torch.tensor(rs.normal(size=(n, 3)), dtype=torch.float32)
    d = d / d.norm(dim=-1, keepdim=True)
    share = np.asarray(DENSITIES)[(np.arange(n) // 16) % len(DENSITIES)]
    tmax = np.where(rs.random(n) < share, RT_MAX, 0.0).astype(np.float32)
    return bvh, (org, d, torch.full((n,), 1e-4), torch.tensor(tmax))


@pytest.mark.parametrize("any_hit", [False, True])
def test_the_hair_patch_matches_the_plain_walk(hair_patch, any_hit):
    bvh, rays = hair_patch
    res = model_walk(*rays[:2], bvh, *rays[2:], any_hit)
    widths = {1, 4} if not any_hit else {4}  # every C2 ray gets 32 lanes
    assert {int(x) for x in res["E"].unique()} - {0} == widths, "a width the spans should pick did not run"
    check_against_plain(rays, bvh, any_hit, res)
    if not any_hit:
        assert 0.05 < (res["prim"] >= 0).float().mean() < 0.95


def test_wide_steps_shorten_the_long_chains(hair_patch):
    """The design's point, in counts: on the rays whose plain walk fetches
    20 rows or more, every span at E = 4 takes fewer dependent steps in
    all and on the longest chain: C1, in the plain walk's order and on the
    plain walk's rows, 0.59 of them and 24 steps for 42 fetches on this
    patch; C2 0.31."""
    bvh, (org, d, tmin, _) = hair_patch
    tmax = torch.full_like(tmin, RT_MAX)
    rays = (org, d, tmin, tmax)
    for any_hit, share in ((False, 0.65), (True, 0.4)):
        res = model_walk(org, d, bvh, tmin, tmax, any_hit, width=4)
        fetches = check_against_plain(rays, bvh, any_hit, res)
        long = fetches >= 20
        assert int(long.sum()) >= 100
        steps, plain = res["steps"][long], fetches[long]
        assert steps.sum() < share * plain.sum()
        assert steps.max() < 0.6 * plain.max()


@pytest.mark.parametrize("fault", ["drop_hit", "cap_in_step", "one_cap", "short_stack"])
def test_seeded_faults_are_caught(hair_patch, fault):
    bvh, (org, d, tmin, _) = hair_patch
    tmax = torch.full_like(tmin, RT_MAX)
    rays = (org, d, tmin, tmax)
    good = model_walk(org, d, bvh, tmin, tmax, False, width=4)
    check_against_plain(rays, bvh, False, good)
    with pytest.raises(AssertionError):
        if fault == "short_stack":  # a row one entry shorter than the deepest stack the walk reaches
            model_walk(org, d, bvh, tmin, tmax, False, width=4, stack_entries=int(good["deepest"].max()) - 1)
        else:
            check_against_plain(rays, bvh, False, model_walk(org, d, bvh, tmin, tmax, False, width=4, fault=fault))


# The lines of the kernel that hold the rules model_walk copies, as the
# source spells them.
STEP_RULES = {
    "E = 4 at most kWide live rays": "if (total <= Span<kAnyHit>::kWide) {\n    walk_span<4, kAnyHit>",
    "E = 1 otherwise": "} else {\n    walk_span<1, kAnyHit>",
    "a span by entry point": "constexpr int kSpan = Span<kAnyHit>::kLanes;",
    "a ray's stack row": "constexpr int kRow = kStackWords / (kThreads / W);",
    "a wide step's room": "kRow - kStack1, gl, gmask, lane0",
    "the narrow step's cap": "const float cap = fminf(w.r.tf, w.best_t);  // the cap before the step\n",
    "the wide step's cap": "const float cap = fminf(w.r.tf, w.best_t);  // the cap before the step, for all",
    "E entries a step": "int m = min(E, c + w.sp);",
    "a wide step leaves kStack1 free": "if (m > 1) m = max(1, min(m, (room - w.sp - c + 1) / (kB - 1)));",
    "the carried child, then pops": "const int my = s < c ? w.entry : (s < m ? stack[w.sp - 1 - (s - c)] : kNone);",
    "the wide pops": "w.sp -= m - c;",
    "the narrow pop": "w.entry = stack[--w.sp];",
    "occupied children only (wide)": "if (meta != kNone) ok = slab(w, sub_cap,",
    "occupied children only (narrow)": "const bool ok = meta != kNone && slab(",
    "occupied segments only (wide)": "if (lp >= 0) lt = cone_t(w.r, cap,",
    "occupied segments only (narrow)": "const float lt = lp >= 0 ? cone_t(w.r, cap,",
    "the first leaf hit ends the any-hit walk": "const int src = __ffs(leaf_hits) - 1;",
    "a sub-group's least t": "least = fminf(least, __shfl_xor_sync(gmask, least, off, W));",
    "entry s's cap: the least t before it": "if (j < s) sub_cap = fminf(sub_cap, before);",
    "the first node with a hit child stops": "const int stop = (__ffs(hits) - 1) / kB;",
    "nothing after the stop is taken": "if (s > stop) {\n      lt = kRtMax;\n      ok = false;",
    "the entries after the stop go back": "w.sp += m - 1 - stop;",
    "butterfly, lowest slot on ties": "if (ot < lt || (ot == lt && os < ls)) {",
    "a leaf's best only below the cap": "if (lt < cap) {",
    "rank by slot": "int rank = __popc(hits & ((1u << gl) - 1u));",
    "rank nearer first, ties by slot": "rank += (kj < tnear || (kj == tnear && j < gl)) ? 1 : 0;",
    "nearest carried": "const unsigned first = __ballot_sync(gmask, ok && rank == 0) >> lane0;",
    "push farthest first": "if (ok && rank > 0) stack[w.sp + h - 1 - rank] = meta;",
    "stack grows by the hits less one": "w.sp += h - 1;",
}


@pytest.mark.parametrize("rule", sorted(STEP_RULES))
def test_the_kernel_keeps_the_models_step_rules(rule):
    assert STEP_RULES[rule] in SOURCE, f"the curve walk changed its rule '{rule}': change model_walk to match"


def test_the_cap_is_taken_before_the_tests_and_the_best_moves_after():
    """The wide step reads the cap at its start and tests the cones against
    it; C1's boxes are tested against that cap lowered by the cones before
    them, and the best is written only after every entry's test, by the
    group's minimum."""
    step = SOURCE[SOURCE.index("__device__ __forceinline__ bool wide_step"):SOURCE.index("// The span's live rays")]
    cap = step.index("const float cap = fminf(w.r.tf, w.best_t);")
    cones = step.index("lt = cone_t(w.r, cap,")
    lowered = step.index("float sub_cap = cap;")
    boxes = step.index("ok = slab(w, sub_cap,")
    least = step.index("leaf_min<W>(w, cap, lt, lp, gl, gmask);")
    writes = [mt.start() for mt in re.finditer(r"w\.best_t = ", step)]
    assert cap < cones < lowered < boxes < least
    assert len(writes) == 1 and cones < writes[0] < lowered  # the any-hit entry's first hit, and nothing else
    assert SOURCE.count("w.best_t = lt;") == 1  # inside leaf_min, after the butterfly
