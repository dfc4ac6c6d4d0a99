"""The port's fleet_state segment lookup against the JAX reference.

The same numpy segments and queries go through the reference's three paths
(the host ``searchsorted`` over the f64 key, the XLA masked count
``segment_index_ref`` and the Pallas kernel in interpret mode) and through
the port's plain version, which is what the port runs on CPU tensors and
what ``chip_smoke.py`` holds the CUDA kernel to on the card.  Segment
indices, state codes and next-flip times must be exactly equal: the lookup
is an exact count, not an approximation.  One exception, in the reference:
its host path folds (device, time) into one f64 key ``device * period + t``,
which cannot resolve a query within 1e-6 s of the period's end on a week-long
trace of 30 devices (the key's ulp is ~4e-9 s there), so that path is held
to the port only on the other queries (``_key_exact``).

The edge cases are where a split-time search could go wrong: a query exactly
at a segment start, fractions that round up to 1.0 in f32, week-scale
seconds, the first and last segment of a device, a device with one segment,
and query counts that are not a multiple of any block (padding).
"""
import numpy as np
import pytest
import torch

import repro.fl.traces as jtr
from repro.kernels.fleet_state import ops as jops
from repro.kernels.fleet_state.kernel import segment_index_pallas
from repro.kernels.fleet_state.ref import segment_index_ref as jax_ref

import repro_torch.fl.traces as ttr
from repro_torch.kernels.fleet_state import (
    pack_queries,
    segment_index,
    segment_index_cuda,
    segment_index_lookup,
    segment_index_ref,
    upload_segments,
)
from repro_torch.kernels.fleet_state.ops import _split_times, fleet_state_at

WEEK = 7 * 86400.0


def _random_trace(seed, n_dev, max_segs, period, whole_seconds=True):
    rng = np.random.default_rng(seed)
    events = {}
    for d in range(n_dev):
        k = int(rng.integers(1, max_segs + 1))
        t = np.sort(rng.choice(int(period), size=k, replace=False)).astype(float)
        if not whole_seconds:
            t = t + np.round(rng.random(k), 3) * (t > 0)
        events[f"d{d:03d}"] = [(float(x), int(rng.integers(0, 4))) for x in t]
    return events


def _both(events, period):
    return (jtr.compile_events(events, period),
            ttr.compile_events(events, period))


def _edge_queries(tr, rng, n_extra=300):
    """(src, t) queries: every segment start, +-1 s and +-eps around it,
    fractions that round to 1.0 in f32, the period's last second, and
    random times; devices from -1 (padding) to D (past the last)."""
    src, t = [], []
    for d in range(tr.n_devices):
        starts, _ = tr.segments_of(d)
        for s in starts:
            for dt in (0.0, -1.0, 1.0, -1e-6, 1e-6, 0.99999999, -0.00000001):
                src.append(d)
                t.append(s + dt)
        src += [d, d, d]
        t += [tr.period_s - 1e-9, tr.period_s - 1.0, 5.99999999]
    src += list(rng.integers(0, tr.n_devices, size=n_extra))
    t += list(rng.uniform(0.0, 3 * tr.period_s, size=n_extra))
    src += [-1, -1, tr.n_devices]
    t += [0.0, 100.0, 0.0]
    return np.asarray(src, np.int64), np.asarray(t, np.float64)


def _key_exact(tr, src, t):
    """Queries the reference's f64-key path resolves: real devices, and not
    within 1e-6 s below the period's end."""
    return ((src >= 0) & (src < tr.n_devices)
            & (np.asarray(t) % tr.period_s < tr.period_s - 1e-6))


def _port_index(tr_port, src, t):
    return segment_index(tr_port.resident("cpu"), tr_port.period_s, src, t)


def _reference_indices(jt, src, t):
    """The reference's three paths on the same queries (numpy, XLA,
    Pallas interpret), each through its own public entry."""
    key, sdev = jt._seg_key, jt._seg_dev
    out = {"numpy": jops.segment_index(key, sdev, jt.t_start, jt.period_s,
                                       src, t, impl="numpy")}
    tau = np.asarray(t) % jt.period_s
    sti, stf = jops._split_times(jt.t_start)
    qi, qf = jops._split_times(tau)
    args = (sdev.astype(np.int32), sti, stf, src.astype(np.int32), qi, qf)
    out["xla"] = np.asarray(jax_ref(*args), np.int64)
    out["pallas"] = np.asarray(segment_index_pallas(*args, interpret=True), np.int64)
    return out


CASES = [
    ("two-devices", dict(seed=0, n_dev=2, max_segs=6, period=86400.0)),
    ("one-segment-devices", dict(seed=1, n_dev=5, max_segs=1, period=86400.0)),
    ("week-scale", dict(seed=2, n_dev=12, max_segs=40, period=WEEK)),
    ("many-devices", dict(seed=3, n_dev=64, max_segs=9, period=3 * 86400.0)),
]


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_segment_index_equals_every_reference_path(name, kw):
    events = _random_trace(**kw)
    jt, tt = _both(events, kw["period"])
    src, t = _edge_queries(tt, np.random.default_rng(kw["seed"] + 100))
    got = _port_index(tt, src, t)
    assert got.dtype == np.int64 and got.shape == src.shape
    exact = _key_exact(tt, src, t)
    for path, want in _reference_indices(jt, src, t).items():
        if path == "numpy":
            np.testing.assert_array_equal(got[exact], want[exact], err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
    # padded queries (src = -1) find no segment, as the kernel's padding does
    assert (got[src < 0] == -1).all()


@pytest.mark.parametrize("fixture", ["livelab", "synthetic-week"])
def test_fixtures_states_and_next_flip_equal(fixture):
    if fixture == "livelab":
        jt = jtr.read_trace_csv(jtr.sample_trace_path())
        tt = ttr.read_trace_csv(ttr.sample_trace_path())
    else:
        spec = dict(n_devices=32, days=7, seed=11)
        jt = jtr.synthesize_trace(jtr.SyntheticTraceSpec(**spec))
        tt = ttr.synthesize_trace(ttr.SyntheticTraceSpec(**spec))
    assert tt.n_segments == jt.n_segments
    for n, seed in ((1, 0), (7, 1), (1000, 2)):
        jf = jt.resample(n, seed=seed)
        tf = tt.resample(n, seed=seed, device="cpu")
        np.testing.assert_array_equal(tf.src, jf.src)
        np.testing.assert_array_equal(tf.phase_s, jf.phase_s)
        lut = np.array([False, True, True, True])
        for t_s in (0.0, 3600.0 * 5, jt.period_s - 1.0, 2.5 * jt.period_s):
            np.testing.assert_array_equal(tf.states_at(t_s), jf.states_at(t_s))
            jc, jflip = jf.states_and_next_flip(t_s, lut)
            tc, tflip = tf.states_and_next_flip(t_s, lut)
            np.testing.assert_array_equal(tc, jc)
            np.testing.assert_array_equal(tflip, jflip)
    # the raw table too, with and without a flip table
    src, t = _edge_queries(tt, np.random.default_rng(5), n_extra=500)
    valid = (src >= 0) & (src < tt.n_devices)
    src, t = src[valid], t[valid]
    flip = tt.online_flip_tau(np.array([False, True, True, True]))
    np.testing.assert_array_equal(flip, jt.online_flip_tau(
        np.array([False, True, True, True])))
    exact = _key_exact(tt, src, t)
    for table in (flip, None):
        tc, tn = fleet_state_at(tt.resident("cpu"), tt.state, table,
                                tt.period_s, src, t)
        for impl in ("xla", "numpy"):
            jc, jn = jops.fleet_state_at(jt._seg_key, jt._seg_dev, jt.t_start,
                                         jt.state, table, jt.period_s, src, t,
                                         impl=impl)
            keep = exact if impl == "numpy" else slice(None)
            np.testing.assert_array_equal(tc[keep], jc[keep], err_msg=impl)
            np.testing.assert_array_equal(tn[keep], jn[keep], err_msg=impl)


def test_fractional_segment_starts_match_the_split_paths():
    """Fractional starts: the split compare is what both compiled reference
    paths and the port compute, exactly."""
    events = _random_trace(seed=9, n_dev=6, max_segs=12, period=86400.0,
                           whole_seconds=False)
    jt, tt = _both(events, 86400.0)
    src, t = _edge_queries(tt, np.random.default_rng(9))
    got = _port_index(tt, src, t)
    ref = _reference_indices(jt, src, t)
    np.testing.assert_array_equal(got, ref["xla"])
    np.testing.assert_array_equal(got, ref["pallas"])


def test_split_times_equal_reference():
    t = np.array([0.0, 5.99999999, 604799.5, 604799.99999999, 1e-9, 86400.0])
    for a, b in zip(_split_times(t), jops._split_times(t)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    qi, qf = _split_times(np.array([5.99999999]))
    assert qi[0] == 5 and qf[0] == np.float32(1.0)   # rounds up to 1.0 in f32


def test_round_up_fraction_stays_in_its_second():
    """t = 5.99999999 splits to (5, 1.0f): it must still sit before a
    segment starting at 6 s and after one starting at 5 s."""
    events = {"a": [(0.0, 2), (5.0, 1), (6.0, 3), (7.0, 2)]}
    tt = ttr.compile_events(events, 100.0)
    got = _port_index(tt, np.zeros(4, np.int64),
                      np.array([4.99999999, 5.0, 5.99999999, 6.0]))
    np.testing.assert_array_equal(got, [0, 1, 1, 2])


def test_plain_version_chunks_without_changing_the_count(monkeypatch):
    from repro_torch.kernels.fleet_state import ref as tref

    events = _random_trace(seed=4, n_dev=8, max_segs=20, period=86400.0)
    tt = ttr.compile_events(events, 86400.0)
    segs = tt.resident("cpu")
    src, t = _edge_queries(tt, np.random.default_rng(4))
    tau = t % tt.period_s
    qi, qf = _split_times(tau)
    args = (segs.dev, segs.ti, segs.tf, torch.as_tensor(src.astype(np.int32)),
            torch.as_tensor(qi), torch.as_tensor(qf))
    whole = segment_index_ref(*args)
    monkeypatch.setattr(tref, "MAX_ELEMS", 7 * tt.n_segments)   # 7 queries/chunk
    assert torch.equal(tref.segment_index_ref(*args), whole)
    assert whole.dtype == torch.int32


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    events = _random_trace(seed=6, n_dev=3, max_segs=5, period=1000.0)
    tt = ttr.compile_events(events, 1000.0)
    segs = tt.resident("cpu")
    src = np.array([0, 1, 2, -1], np.int32)
    qi = np.array([0, 10, 999, 0], np.int32)
    qf = np.zeros(4, np.float32)
    before = segment_index_cuda.launches
    got = segment_index_cuda(segs, torch.as_tensor(pack_queries(src, qi, qf)))
    want = segment_index_ref(segs.dev, segs.ti, segs.tf, torch.as_tensor(src),
                             torch.as_tensor(qi), torch.as_tensor(qf))
    assert torch.equal(got, want)
    np.testing.assert_array_equal(segment_index_lookup(segs, src, qi, qf), want.numpy())
    assert segment_index_cuda.launches == before


def test_upload_checks_sortedness_once():
    with pytest.raises(ValueError, match="not sorted"):
        upload_segments(np.array([0, 0, 0]), np.array([0.0, 10.0, 5.0]),
                        torch.device("cpu"))
    with pytest.raises(ValueError, match="not sorted"):
        upload_segments(np.array([1, 0]), np.array([0.0, 0.0]), torch.device("cpu"))
    segs = upload_segments(np.array([0, 0, 1]), np.array([0.0, 10.0, 0.0]),
                           torch.device("cpu"))
    assert segs.dev.dtype == torch.int32 and segs.tf.dtype == torch.float32
    assert segs.rec.shape == (3, 4) and segs.rec.is_contiguous()
    assert segs.tf.data_ptr() == segs.rec.data_ptr() + 8      # column views
    tt = ttr.compile_events({"a": [(0.0, 1)], "b": [(0.0, 2), (3.0, 1)]}, 10.0)
    assert tt.resident("cpu") is tt.resident("cpu")        # cached per device


# ---------------------------------------------------------------------------
# the kernel's design: CSR offsets and a search within the query's device
# ---------------------------------------------------------------------------


def _fixture(name):
    if name == "livelab":
        return jtr.read_trace_csv(jtr.sample_trace_path()), ttr.read_trace_csv(
            ttr.sample_trace_path())
    spec = dict(n_devices=32, days=7, seed=11)
    return (jtr.synthesize_trace(jtr.SyntheticTraceSpec(**spec)),
            ttr.synthesize_trace(ttr.SyntheticTraceSpec(**spec)))


@pytest.mark.parametrize("name", ["livelab", "synthetic-week"] + [c[0] for c in CASES])
def test_uploaded_offsets_equal_the_trace_offsets(name):
    if name in ("livelab", "synthetic-week"):
        jt, tt = _fixture(name)
    else:
        kw = dict(CASES)[name]
        jt, tt = _both(_random_trace(**kw), kw["period"])
    segs = tt.resident("cpu")
    assert segs.offsets.dtype == torch.int32
    np.testing.assert_array_equal(segs.offsets.numpy(), tt.offsets)
    np.testing.assert_array_equal(segs.offsets.numpy(), jt.offsets)
    # the bucket table: columns 0 and K are the offsets, rows non-decreasing,
    # and K << shift lies past every start
    bkt = segs.buckets.numpy()
    np.testing.assert_array_equal(bkt[:, 0], tt.offsets[:-1])
    np.testing.assert_array_equal(bkt[:, -1], tt.offsets[1:])
    assert (np.diff(bkt, axis=1) >= 0).all()
    assert (bkt.shape[1] - 1) << segs.bucket_shift > tt.t_start.max()
    with pytest.raises(ValueError, match="offsets"):
        bad = tt.offsets.copy()
        bad[1] += 1
        upload_segments(tt._seg_dev, tt.t_start, torch.device("cpu"), offsets=bad)


def _emulate_kernel(segs, q):
    """numpy emulation of fleet_state.cu's index arithmetic, query by query
    in lockstep: -1 for src < 0, S - 1 for src >= D, else the upper bound of
    (qi, qf) within the query's bucket of its device's segments, minus
    one."""
    rec, bkt, shift = segs.rec.numpy(), segs.buckets.numpy(), segs.bucket_shift
    s, d_count, k_count = len(rec), bkt.shape[0], bkt.shape[1] - 1
    d, qi, qf = q[:, 0], q[:, 1], q[:, 2].view(np.float32)
    own = (d >= 0) & (d < d_count)
    dc = np.where(own, d, 0)
    b = np.minimum(np.where(qi < 0, 0, qi >> shift), k_count - 1)
    lo, hi = bkt[dc, b].astype(np.int64), bkt[dc, b + 1].astype(np.int64)
    lo, hi = np.where(own, lo, 0), np.where(own, hi, 0)
    mti, mtf = rec[:, 1], rec[:, 2].view(np.float32)
    while (lo < hi).any():
        go = lo < hi
        mid = np.where(go, lo + ((hi - lo) >> 1), 0)
        le = (mti[mid] < qi) | ((mti[mid] == qi) & (mtf[mid] <= qf))
        lo = np.where(go & le, mid + 1, lo)
        hi = np.where(go & ~le, mid, hi)
    return np.where(d < 0, -1, np.where(d >= d_count, s - 1, lo - 1))


def _raw_table():
    """Segment arrays no compiled trace has: devices whose first segment
    starts after 0 (queries before it), a device with no segment, devices
    with one segment, and fractional starts."""
    dev = np.array([0, 0, 0, 1, 3, 3, 4, 5, 5, 5], np.int64)
    t = np.array([5.0, 10.0, 10.5, 2.0, 0.0, 7.25, 86399.0, 1.0, 1.5, 3.0])
    return dev, t, 86400.0


def _raw_queries(rng, n_dev, period):
    src = np.concatenate([np.repeat(np.arange(-1, n_dev + 2), 12),
                          rng.integers(-1, n_dev + 2, size=500)])
    base = np.array([0.0, 1.0, 1.5, 1.99999999, 2.0, 4.99999999, 5.0, 10.25,
                     10.5, 10.4999, period - 1e-9, period - 1.0])
    t = np.concatenate([np.tile(base, n_dev + 3), rng.uniform(0.0, 2 * period, 500)])
    return src, t


@pytest.mark.parametrize("name", ["raw-gaps"] + [c[0] for c in CASES])
def test_two_level_search_equals_every_reference_path(name):
    rng = np.random.default_rng(17)
    if name == "raw-gaps":
        sdev, t_start, period = _raw_table()
        src, t = _raw_queries(rng, int(sdev.max()) + 1, period)
        key = sdev * period + t_start
        segs = upload_segments(sdev, t_start, torch.device("cpu"))
    else:
        kw = dict(CASES)[name]
        jt, tt = _both(_random_trace(**kw), kw["period"])
        sdev, t_start, period, key = jt._seg_dev, jt.t_start, jt.period_s, jt._seg_key
        src, t = _edge_queries(tt, rng)
        src = np.concatenate([src, [-3, tt.n_devices + 7]])
        t = np.concatenate([t, [50.0, 50.0]])
        segs = tt.resident("cpu")
    tau = t % period
    qi, qf = _split_times(tau)
    q = pack_queries(src.astype(np.int32), qi, qf)
    got = _emulate_kernel(segs, q)
    plain = segment_index_ref(segs.dev, segs.ti, segs.tf, *(
        torch.as_tensor(a) for a in (src.astype(np.int32), qi, qf))).numpy()
    np.testing.assert_array_equal(got, plain)
    sti, stf = _split_times(t_start)
    xla = np.asarray(jax_ref(sdev.astype(np.int32), sti, stf, src.astype(np.int32),
                             qi, qf), np.int64)
    np.testing.assert_array_equal(got, xla)
    ref_np = jops.segment_index(key, sdev, t_start, period, src, t, impl="numpy")
    exact = (src >= 0) & (src <= sdev.max()) & (tau < period - 1e-6)
    np.testing.assert_array_equal(got[exact], ref_np[exact])
    # the edge rules themselves
    assert (got[src < 0] == -1).all()
    assert (got[src > sdev.max()] == len(sdev) - 1).all()
    if name == "raw-gaps":
        # before device 1's first segment (2 s): device 0's last segment
        before = (src == 1) & (tau < 2.0)
        assert before.any() and (got[before] == 2).all()
        # device 2 has no segment: device 1's last, at any time
        assert (got[src == 2] == 3).all()


def test_packed_query_records_round_trip_the_split():
    t = np.array([0.0, 5.99999999, 604799.5, 604799.99999999, 1e-9, 86400.0,
                  7.25, 3599.999999999])
    src = np.array([0, 1, -1, 31, 2, 7, 1023, 5], np.int32)
    qi, qf = _split_times(t)
    rec = pack_queries(src, qi, qf)
    assert rec.dtype == np.int32 and rec.shape == (len(t), 4) and rec.flags.c_contiguous
    np.testing.assert_array_equal(rec[:, 0], src)
    np.testing.assert_array_equal(rec[:, 1], qi)
    np.testing.assert_array_equal(rec[:, 2].view(np.float32), qf)
    assert (rec[:, 3] == 0).all()
    assert rec[1, 1] == 5 and rec[1, 2].view(np.float32) == np.float32(1.0)
    # into a larger buffer, and through torch as the kernel reads it
    buf = np.full((16, 4), -7, np.int32)
    assert pack_queries(src, qi, qf, out=buf) is not None
    np.testing.assert_array_equal(buf[:len(t)], rec)
    assert (buf[len(t):] == -7).all()
    back = torch.as_tensor(rec)
    assert torch.equal(back[:, 2].view(torch.float32), torch.as_tensor(qf))


def test_upload_refuses_start_times_the_buckets_cannot_hold():
    for t in ([-1.0, 5.0], [0.0, 2.0**30]):
        with pytest.raises(ValueError, match="start times"):
            upload_segments(np.array([0, 0]), np.array(t), torch.device("cpu"))
