"""The design of ``csrc/select_topk.cu``, emulated in numpy on the CPU.

The CUDA kernel runs only on the card; what it computes is held here to the
contract by emulations of its two halves, built from the same launch plan
(:func:`~repro_torch.kernels.select_topk.kernel.launch_plan`) the wrapper
hands the kernel:

* the selection: the persistent tile-to-CTA assignment, the carried top-K_pad
  of each CTA with the ``before(row, kth)`` admit rule, the rank-sort and
  binary-search merge, the lists' publication, the last CTA of each group of
  16 and then the last group merging them (in any arrival order), and the
  large-K_pad route (sorted tile lists, then the pairwise merge tree).  It
  must equal ``stable_topk`` exactly;
* the scoring: the fp32 FMA order of the register-tiled SGEMM (each unit's
  sum one fma chain in k-ascending order, each thread's ReLU-and-w3 sum over
  its own units, the 8 threads' xor-butterfly, then + b3 + bias), within
  1e-5 * max(1, |v|) of fp64 scores, and the same bits for a row wherever in
  a tile it is computed, on each of the three scoring paths' widths.

Also: the plan's sizes from the source's constants (the scoring path by
width, the global path's activations in the scratch), and the pinned
record layout.  numpy has no fused multiply-add: ``fma32`` forms a*b exactly in
float64 (24 + 24 bits) and rounds the sum twice, which can differ from one
rounding in the last bit; the tolerance absorbs that.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.select_topk import kernel as K
from repro_torch.kernels.select_topk.ref import NEG_INF, stable_topk

VIRGIN = (np.float32(NEG_INF), 2**31 - 1)


def _before(a, b):
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def _count_before(lst, x):
    lo, hi = 0, len(lst)
    while lo < hi:
        mid = (lo + hi) // 2
        if _before(lst[mid], x):
            lo = mid + 1
        else:
            hi = mid
    return lo


def _rank_sort(cands):
    """The kernel's rank sort: equal entries rank by position."""
    out = [None] * len(cands)
    for c, x in enumerate(cands):
        r = sum(_before(y, x) or (y == x and j < c) for j, y in enumerate(cands))
        out[r] = x
    assert all(e is not None for e in out)
    return out


def _merge(lst, cands, k_pad):
    """admit_and_merge after the admit test: rank-sort the candidates, then
    place every entry at its rank in the merged order, dropping ranks >= K_pad."""
    srt = _rank_sort(cands)
    new = [None] * k_pad
    for p, e in enumerate(lst):
        q = p + _count_before(srt, e)
        if q < k_pad:
            assert new[q] is None
            new[q] = e
    for c, x in enumerate(srt):
        q = c + _count_before(lst, x)
        if q < k_pad:
            assert new[q] is None
            new[q] = x
    assert all(e is not None for e in new)
    return new


def _filter_merge(lst, entries, k_pad):
    admitted = [e for e in entries if _before(e, lst[k_pad - 1])]
    return _merge(lst, admitted, k_pad) if admitted else lst


def _merge_lists(lst, lists, k_pad):
    """merge_lists: the other lists, CAND // K_pad of them at a time."""
    per = K.CAND // k_pad
    for first in range(0, len(lists), per):
        chunk = [e for other in lists[first:first + per] for e in other]
        lst = _filter_merge(lst, chunk, k_pad)
    return lst


def _merge_pairs(lists, k_pad):
    """The tree route's levels: pairs of lists merged, the best kept, an odd
    list out padded with virgin slots."""
    while len(lists) > 1:
        nxt = []
        for b in range(0, len(lists), 2):
            a = lists[b]
            out_len = min(2 * len(a), k_pad)
            if b + 1 == len(lists):
                nxt.append((a + [VIRGIN] * out_len)[:out_len])
                continue
            c = lists[b + 1]
            out = [None] * out_len
            for t, x in enumerate(a):             # A wins exact ties
                r = t + _count_before(c, x)
                if r < out_len:
                    out[r] = x
            for t, x in enumerate(c):
                r = t + sum(not _before(x, y) for y in a)
                if r < out_len:
                    out[r] = x
            assert all(e is not None for e in out)
            nxt.append(out)
        lists = nxt
    return lists[0]


def emulate_selection(v, k, sms, per_sm, arrival_seed=0):
    """The kernel's selection over final scores v (masked rows already
    NEG_INF): its first k (value, index) pairs."""
    v = np.asarray(v, np.float32)
    n = len(v)
    k_pad = K.k_padded(k)
    p = K.launch_plan(n, 6, 64, k_pad, sms, per_sm)
    rows = lambda t: [(v[r], r) if r < n else VIRGIN            # noqa: E731
                      for r in range(t * K.BM, (t + 1) * K.BM)]
    if p.route == "tree":
        len0 = min(k_pad, K.BM)
        tile_lists = [_rank_sort([e for e in rows(t)])[:len0] for t in range(p.tiles)]
        return _merge_pairs(tile_lists, k_pad)[:k]
    published = []
    for cta in range(p.grid):                    # each CTA's tiles, in its order
        lst = [VIRGIN] * k_pad
        for t in range(cta, p.tiles, p.grid):
            lst = _filter_merge(lst, [e for e in rows(t) if e != VIRGIN], k_pad)
        published.append(lst)
    rng = np.random.default_rng(arrival_seed)
    group_lists = []
    for g in range(p.groups):
        members = list(range(g * K.GROUP, min((g + 1) * K.GROUP, p.grid)))
        last = members[rng.integers(len(members))]          # any CTA may arrive last
        others = [published[c] for c in members if c != last]
        group_lists.append(_merge_lists(published[last], others, k_pad))
    last = rng.integers(p.groups)
    others = [group_lists[g] for g in range(p.groups) if g != last]
    return _merge_lists(group_lists[last], others, k_pad)[:k]


def _reference(v, k):
    vals, idx = stable_topk(torch.as_tensor(np.asarray(v, np.float32)), k)
    return list(zip(vals.numpy().tolist(), idx.numpy().tolist()))


def _scores(kind, n, rng):
    if kind == "random":
        v = rng.normal(size=n).astype(np.float32)
    elif kind == "duplicate-rows":              # few distinct scores, many ties
        v = rng.normal(size=7).astype(np.float32)[rng.integers(0, 7, n)]
    elif kind == "quantised":
        v = rng.integers(0, 4, n).astype(np.float32)
    elif kind == "all-masked":
        return np.full(n, NEG_INF, np.float32)
    masked = rng.random(n) < 0.3
    return np.where(masked, np.float32(NEG_INF), v)


@pytest.mark.parametrize("kind", ["random", "duplicate-rows", "quantised", "all-masked"])
@pytest.mark.parametrize("n,k,sms,per_sm", [
    (1, 1, 132, 3),              # one row
    (25, 25, 132, 3),            # the probe cohort: k = N, one CTA
    (1000, 20, 132, 3),          # the fleet cut: 8 CTAs of 128 rows
    (2500, 64, 2, 9),            # 18 CTAs: two groups, CTAs of 1 and of 2 tiles
    (6000, 40, 4, 5),            # 20 CTAs, 2 or 3 tiles a CTA, two groups
    (900, 256, 2, 2),            # the largest carried K_pad
    (900, 257, 2, 2),            # the smallest tree K_pad
    (700, 700, 4, 3),            # tree, k = N
    (300, 300, 132, 3),          # carry, k = N past a CTA's rows
])
def test_selection_emulation_equals_stable_topk(kind, n, k, sms, per_sm):
    rng = np.random.default_rng(n + k)
    v = _scores(kind, n, rng)
    want = _reference(v, k)
    for seed in (0, 1):
        got = emulate_selection(v, k, sms, per_sm, arrival_seed=seed)
        assert [(float(a), int(b)) for a, b in got] == want


def test_selection_k_beyond_valid_rows_takes_masked_rows_by_index():
    """k > n_valid: every valid row first, then masked rows lowest index
    first, never a virgin slot."""
    v = np.full(500, NEG_INF, np.float32)
    v[[3, 250, 499]] = [1.0, 2.0, 1.0]
    got = emulate_selection(v, 10, 2, 2)
    assert [i for _, i in got] == [250, 3, 499, 0, 1, 2, 4, 5, 6, 7]


def test_admit_rule_lets_in_an_equal_score_with_a_lower_index():
    """before(row, kth), not score > kth: a tie with the K_pad-th entry and
    a lower index must replace it."""
    lst = [(np.float32(3.0), 10)] + [(np.float32(1.0), i) for i in range(21, 28)]
    got = _filter_merge(lst, [(np.float32(1.0), 5), (np.float32(1.0), 40)], 8)
    assert got[1] == (np.float32(1.0), 5) and (np.float32(1.0), 40) not in got
    assert got[-1] == (np.float32(1.0), 26)


# ---------------------------------------------------------------------------
# the scoring's fp32 order
# ---------------------------------------------------------------------------


def fma32(a, b, c):
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def emulate_tile_scores(q, x):
    """Scores of the rows of one tile (``x``: (rows, F)) in the kernel's
    order: thread (ty, tx) sums rows ty*4 + i over its units tx*4 + c and
    32 + tx*4 + c of every 64-unit chunk."""
    f, h = q["w1"].shape
    hp = K.hidden_padded(h)
    pad = lambda a, shape: np.pad(a, [(0, s - d) for s, d in zip(shape, a.shape)])  # noqa: E731
    w1, w2 = pad(q["w1"], (f, hp)), pad(q["w2"], (hp, hp))
    b1, b2, w3 = (pad(q[nm].reshape(-1), (hp,)) for nm in ("b1", "b2", "w3"))
    acc = np.zeros((len(x), hp), np.float32)
    for k in range(f):                            # one chain per unit, k ascending
        acc = fma32(x[:, k:k + 1], w1[k], acc)
    h1 = np.maximum(acc + b1, np.float32(0))
    acc = np.zeros((len(x), hp), np.float32)
    for k in range(hp):
        acc = fma32(h1[:, k:k + 1], w2[k], acc)
    act = np.maximum(acc + b2, np.float32(0))
    part = np.zeros((len(x), 8), np.float32)       # per tx
    for u in range(hp // K.UC):
        for c in range(8):
            for tx in range(8):
                unit = u * K.UC + (0 if c < 4 else 32) + tx * 4 + (c & 3)
                part[:, tx] = fma32(act[:, unit], w3[unit], part[:, tx])
    for o in (1, 2, 4):                            # the xor-butterfly
        part = part + part[:, np.arange(8) ^ o]
    assert np.all(part == part[:, :1])             # every thread of a row agrees
    return part[:, 0]


def _qnet(rng, f, h):
    """Weights at the Q-net's init scale, N(0, 1 / fan_in): activations stay
    O(1) at any width.  (At a fixed 0.3 a 96 -> 256 net's partial sums reach
    ~1e2, and a score near 0 then carries ~1e-5 of fp32 rounding in any
    summation order.)"""
    shapes = {"w1": (f, h), "b1": (h,), "w2": (h, h), "b2": (h,), "w3": (h, 1), "b3": (1,)}
    return {k: (rng.normal(size=s) / np.sqrt(s[0] if len(s) == 2 else h)).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("f,h", [(6, 64), (14, 64), (96, 256), (1000, 64), (3, 20),
                                 (20, 384), (7, 515)])
def test_score_order_within_tolerance_of_fp64(f, h):
    rng = np.random.default_rng(f * h)
    q = _qnet(rng, f, h)
    x = rng.normal(size=(64, f)).astype(np.float32)
    bias = rng.normal(size=64).astype(np.float32)
    got = (emulate_tile_scores(q, x) + q["b3"][0]) + bias
    d = {k: v.astype(np.float64) for k, v in q.items()}
    h1 = np.maximum(x.astype(np.float64) @ d["w1"] + d["b1"], 0)
    h2 = np.maximum(h1 @ d["w2"] + d["b2"], 0)
    want = (h2 @ d["w3"])[:, 0] + d["b3"][0] + bias
    assert np.all(np.abs(got - want) <= 1e-5 * np.maximum(1.0, np.abs(want)))


@pytest.mark.parametrize("f,h", [(6, 64), (96, 256), (20, 384)])
def test_score_bits_do_not_depend_on_tile_position(f, h):
    """The same row scored at every position of a 128-row tile, among other
    rows, gives the same bits (one width per scoring path)."""
    rng = np.random.default_rng(3)
    q = _qnet(rng, f, h)
    row = rng.normal(size=f).astype(np.float32)
    seen = set()
    for pos in range(0, K.BM, 9):
        x = rng.normal(size=(K.BM, f)).astype(np.float32)
        x[pos] = row
        seen.add(emulate_tile_scores(q, x)[pos].tobytes())
    assert len(seen) == 1


# ---------------------------------------------------------------------------
# the launch plan and the record layout
# ---------------------------------------------------------------------------


def test_shared_memory_from_the_source_layout():
    # h1 [hp][128] (none on the global path); resident (H_pad 64, F <= 32):
    # 2 staged feature tiles [F][132], w1 [F][hp], w2 [hp][hp]; streamed and
    # global: 2 x ([32][132] + [32][64]); then b1, b2, w3, two carried lists,
    # candidates and sorted candidates (256 pairs each) and 16 words
    assert K.smem_bytes(6, 64, 24) == 4 * (64 * 128 + 2 * 6 * 132 + 6 * 64 + 64 * 64
                                           + 192 + 96 + 1040)
    assert K.smem_bytes(40, 64, 24) == 4 * (64 * 128 + 2 * (32 * 132 + 2048) + 192 + 96 + 1040)
    assert K.smem_bytes(40, 64, 24) == 88256
    assert K.smem_bytes(6, 64, 64) == 62976
    assert K.smem_bytes(96, 256, 64) == 189504          # one CTA a SM
    assert K.smem_bytes(6, 64, 2000) == 61952           # tree: no carried list
    assert K.smem_bytes(20, 384, 256) == 4 * (2 * (32 * 132 + 2048) + 3 * 384 + 1024 + 1040)
    assert 2 * (K.smem_bytes(14, 64, 64) + 1024) <= 228 * 1024  # two CTAs a SM
    assert K.smem_bytes(20, 320, 256) <= K.MAX_SMEM     # the widest streamed, largest list
    assert 3 * (K.smem_bytes(6, 64, 256) + 1024) <= 228 * 1024  # resident: three a SM


@pytest.mark.parametrize("f,h,path", [
    (6, 64, "resident"), (32, 20, "resident"), (33, 64, "streamed"), (6, 128, "streamed"),
    (96, 256, "streamed"), (20, 320, "streamed"), (20, 321, "global"), (7, 515, "global"),
    (1, 4096, "global"),
])
def test_scoring_path_by_width(f, h, path):
    assert K.path_of(f, h) == path


@pytest.mark.parametrize("args,want", [
    # (n, f, h, k_pad, sms, per_sm) -> (route, path, tiles, grid, groups, scratch, launches)
    ((1000, 6, 64, 24, 132, 3), ("carry", "resident", 8, 8, 1, 8 * 9 * 24, 1)),
    ((25, 6, 64, 32, 132, 3), ("carry", "resident", 1, 1, 1, 8 * 2 * 32, 1)),
    ((10**6, 6, 64, 64, 132, 3), ("carry", "resident", 7813, 396, 25, 8 * 421 * 64, 1)),
    ((10**6, 14, 64, 64, 132, 2), ("carry", "resident", 7813, 264, 17, 8 * 281 * 64, 1)),
    ((10**6, 40, 64, 64, 132, 2), ("carry", "streamed", 7813, 264, 17, 8 * 281 * 64, 1)),
    ((10**5, 96, 256, 64, 132, 1), ("carry", "streamed", 782, 132, 9, 8 * 141 * 64, 1)),
    ((10**5, 6, 64, 256, 132, 3), ("carry", "resident", 782, 396, 25, 8 * 421 * 256, 1)),
    ((10**5, 6, 64, 2000, 132, 3), ("tree", "resident", 782, 396, 25, 16 * 100352, 11)),
    ((10**5, 6, 64, 264, 132, 3), ("tree", "resident", 782, 396, 25, 16 * 100096, 11)),
    ((3000, 6, 64, 64, 132, 3), ("carry", "resident", 24, 24, 2, 8 * 26 * 64, 1)),
    # the global path: the selection's scratch, then 264 slices of [384][128]
    ((10**5, 20, 384, 64, 132, 2),
     ("carry", "global", 782, 264, 17, 8 * 281 * 64 + 4 * 264 * 384 * 128, 1)),
    ((10**5, 7, 515, 2000, 132, 2),
     ("tree", "global", 782, 264, 17, 16 * 100352 + 4 * 264 * 576 * 128, 11)),
])
def test_launch_plan(args, want):
    p = K.launch_plan(*args)
    assert (p.route, p.path, p.tiles, p.grid, p.groups, p.scratch, p.launches) == want
    assert p.smem == K.smem_bytes(*args[1:4])


def test_launch_plan_resident_from_a_function_and_refusals():
    seen = []
    p = K.launch_plan(10**6, 6, 64, 64, 132, lambda path, s: seen.append((path, s)) or 2)
    assert seen == [("resident", K.smem_bytes(6, 64, 64))] and p.grid == 264
    p = K.launch_plan(10**5, 20, 400, 64, 132, lambda path, s: seen.append((path, s)) or 2)
    assert seen[-1] == ("global", K.smem_bytes(20, 400, 64)) and p.grid == 264
    assert K.tree_entries(10**5, 2000) == 100352
    for bad in ((10, 6, 64, 20), (10, 0, 64, 8), (10, 6, 64, 12), (10, 6, 0, 8),
                (0, 6, 64, 8)):
        with pytest.raises(ValueError):
            K.launch_plan(*bad, 132, 3)
    assert K.launch_plan(10, 6, 4096, 8, 132, 1).path == "global"   # any H
    assert K.route_of(256) == "carry" and K.route_of(264) == "tree"


def test_records_round_trip():
    rng = np.random.default_rng(0)
    states = rng.normal(size=(37, 6))
    mask = rng.random(37) > 0.3
    bias = rng.normal(size=37)
    buf = np.full(K.record_floats(37, 6) + 5, np.nan, np.float32)
    rec = K.pack_records(states, mask, bias, buf)
    assert rec.size == 37 * 8 and np.isnan(buf[rec.size:]).all()
    x, m, b = K.unpack_records(buf, 37, 6)
    np.testing.assert_array_equal(x, states.astype(np.float32))
    np.testing.assert_array_equal(m, mask.astype(np.float32))
    np.testing.assert_array_equal(b, bias.astype(np.float32))
    K.pack_records(states[:5], None, None, buf)
    x, m, b = K.unpack_records(buf, 5, 6)
    np.testing.assert_array_equal(x, states[:5].astype(np.float32))
    assert np.all(m == 1.0) and np.all(b == 0.0)
