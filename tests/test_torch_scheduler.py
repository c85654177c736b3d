"""The port's SLA scheduler (``repro_torch.serve.scheduler``) held against
the JAX package's on the same sequences: EDF order across classes,
arrival gating, requeues at the front, victim choice,
``InterleavePolicy``, ``poisson_arrivals``, ``VirtualClock`` and the
``LatencyHistogram`` (one copy, in ``serve/metrics.py``), mirroring
``tests/test_frontend.py``'s scheduler tests."""

import numpy as np
import pytest

from repro.serve import Request as JRequest
from repro.serve import scheduler as jsched
from repro_torch.serve import Request, metrics, scheduler


def _pair(uid, arrival, cls):
    return (Request(uid=uid, prompt=[1], arrival_time=arrival,
                    latency_class=cls),
            JRequest(uid=uid, prompt=[1], arrival_time=arrival,
                     latency_class=cls))


def _both(classes=None):
    if classes is None:
        return scheduler.SLAScheduler(), jsched.SLAScheduler()
    return (scheduler.SLAScheduler([scheduler.SLAClass(*c) for c in classes]),
            jsched.SLAScheduler([jsched.SLAClass(*c) for c in classes]))


def _observe(s, now):
    return (s.has_ready(now), s.ready_count(now), s.pending(),
            s.next_arrival(), s.depths(), bool(s.view(now)))


@pytest.mark.parametrize("classes", [
    None,
    (("interactive", 0, 0.25), ("batch", 1, 2.5), ("bulk", 2, 30.0)),
])
@pytest.mark.parametrize("seed", range(4))
def test_decisions_match_jax_on_random_sequences(seed, classes):
    """Submits, requeues, admissions through the ready view and victim
    picks, in a random order on a moving clock: every decision and gauge
    equals the JAX scheduler's."""
    rng = np.random.default_rng(seed)
    t, j = _both(classes)
    names = list(t.classes)
    uid, now = 0, 0.0
    popped_t, popped_j, slots_t, slots_j = [], [], [], []
    for _ in range(200):
        op = rng.integers(0, 5)
        if op <= 1:
            pt, pj = _pair(uid, float(now + rng.exponential(0.5)),
                           names[rng.integers(len(names))])
            t.submit(pt)
            j.submit(pj)
            uid += 1
        elif op == 2:
            vt, vj = t.view(now), j.view(now)
            if vt:
                assert vj and vt[0].uid == vj[0].uid
                popped_t.append(vt.popleft())
                popped_j.append(vj.popleft())
                slots_t.append(popped_t[-1])
                slots_j.append(popped_j[-1])
            else:
                assert not vj
                with pytest.raises(IndexError):
                    vt.popleft()
        elif op == 3 and slots_t:
            cands = sorted(rng.choice(len(slots_t),
                                      size=rng.integers(1, len(slots_t) + 1),
                                      replace=False).tolist())
            vt = t.pick_victim(cands, slots_t)
            assert vt == j.pick_victim(cands, slots_j)
            t.requeue(slots_t.pop(vt))
            j.requeue(slots_j.pop(vt))
        else:
            now += float(rng.exponential(0.3))
        assert _observe(t, now) == _observe(j, now)
        for r in (t, j):
            if r.pending():
                head = next(q[0] for q in r.queues.values() if q)
                assert r.deadline(head) == pytest.approx(
                    (head.arrival_time or 0.0)
                    + r.classes[head.latency_class].ttft_target)
    assert [r.uid for r in popped_t] == [r.uid for r in popped_j]
    assert len(popped_t) > 20


def test_edf_across_classes():
    """interactive (250 ms) outranks batch (2.5 s) at equal arrival, but
    an old enough batch request wins EDF: no starvation."""
    s = scheduler.SLAScheduler()
    for uid, arrival, cls in ((0, 1.0, "batch"), (1, 1.0, "interactive"),
                              (2, 1.2, "interactive")):
        s.submit(_pair(uid, arrival, cls)[0])
    view = s.view(now=10.0)
    assert [view.popleft().uid for _ in range(3)] == [1, 2, 0]
    s.submit(_pair(3, 1.0, "batch")[0])
    s.submit(_pair(4, 3.5, "interactive")[0])
    assert s.view(10.0).popleft().uid == 3


def test_arrival_gating_and_requeue():
    s = scheduler.SLAScheduler()
    s.submit(_pair(0, 5.0, "interactive")[0])
    assert not s.has_ready(4.9) and s.pending()
    assert s.ready_count(4.9) == 0 and s.next_arrival() == 5.0
    assert s.has_ready(5.0) and len(s.view(5.0)) == 1
    assert not s.view(4.9)
    with pytest.raises(IndexError):
        s.view(4.9).popleft()
    with pytest.raises(IndexError):
        s.view(10.0)[1]
    s.submit(_pair(1, 6.0, "interactive")[0])
    s.requeue(_pair(2, 5.5, "interactive")[0])
    assert s.view(10.0).popleft().uid == 2
    assert s.depths() == {"interactive": 2, "batch": 0}


def test_victim_selection_and_validation():
    """Victims: the lowest-priority class, then the latest arrival, then
    the highest slot, among the candidates."""
    s = scheduler.SLAScheduler()
    slots = [_pair(0, 1.0, "interactive")[0], _pair(1, 9.0, "interactive")[0],
             _pair(2, 0.5, "batch")[0], _pair(3, 0.1, "batch")[0]]
    assert s.pick_victim([0, 1, 2, 3], slots) == 2
    assert s.pick_victim([0, 1], slots) == 1
    assert s.pick_victim([3], slots) == 3
    with pytest.raises(ValueError):
        scheduler.SLAScheduler([])
    with pytest.raises(ValueError):
        scheduler.SLAScheduler([scheduler.SLAClass("a", 0, 1.0),
                                scheduler.SLAClass("a", 1, 2.0)])
    with pytest.raises(ValueError, match="unknown latency class"):
        s.submit(_pair(9, 0.0, "bulk")[0])


@pytest.mark.parametrize("rate,n,start", [(100.0, 50, 2.0), (8.0, 16, 0.0),
                                          (0.5, 3, 10.0)])
def test_poisson_arrivals_match_jax(rate, n, start):
    a = scheduler.poisson_arrivals(np.random.default_rng(7), rate, n, start)
    b = jsched.poisson_arrivals(np.random.default_rng(7), rate, n, start)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (n,) and a[0] >= start and np.all(np.diff(a) > 0)
    with pytest.raises(ValueError):
        scheduler.poisson_arrivals(np.random.default_rng(0), 0.0, 5)


def test_interleave_policy_and_clock_match_jax():
    tp, jp = scheduler.InterleavePolicy(), jsched.InterleavePolicy()
    for decoding in (False, True):
        for prio in (None, 0, 1, 2):
            assert tp.chunk_steps(decoding, prio) == jp.chunk_steps(decoding,
                                                                    prio)
    custom = dict(idle_burst=7, busy_burst=2, urgent_burst=3)
    assert (scheduler.InterleavePolicy(**custom).chunk_steps(True, 0)
            == jsched.InterleavePolicy(**custom).chunk_steps(True, 0) == 3)
    tc, jc = scheduler.VirtualClock(1.0), jsched.VirtualClock(1.0)
    for dt in (0.5, 0.25, 3.0):
        assert tc.advance(dt) == jc.advance(dt) and tc() == jc()
    assert ([c.name for c in scheduler.DEFAULT_CLASSES]
            == [c.name for c in jsched.DEFAULT_CLASSES]
            == ["interactive", "batch"])
    assert ([(c.priority, c.ttft_target) for c in scheduler.DEFAULT_CLASSES]
            == [(c.priority, c.ttft_target) for c in jsched.DEFAULT_CLASSES])


def test_latency_histogram_is_one_copy_and_matches_jax():
    """``scheduler.LatencyHistogram`` is ``metrics.LatencyHistogram``, and
    it answers the JAX histogram's percentiles, mean and summary on the
    same records (edges included)."""
    assert scheduler.LatencyHistogram is metrics.LatencyHistogram
    t, j = scheduler.LatencyHistogram(), jsched.LatencyHistogram()
    rng = np.random.default_rng(3)
    values = list(10.0 ** rng.uniform(-7, 2, 300)) + [
        t.lo * 2.0 ** k for k in range(0, 30, 3)]
    for v in values:
        t.record(float(v))
        j.record(float(v))
    assert t.counts == j.counts and t.count == j.count
    assert t.mean == pytest.approx(j.mean) and t.max == j.max
    for p in (0.0, 0.1, 33.0, 50.0, 90.0, 99.0, 100.0):
        assert t.percentile(p) == j.percentile(p)
    assert t.to_dict() == pytest.approx(j.to_dict())
    empty = scheduler.LatencyHistogram()
    assert empty.percentile(50) == 0.0 and empty.mean == 0.0


def test_latency_histogram_merge_equals_one_histogram():
    """Merging per-class histograms (``ServingEngine.ttft_all``) equals
    recording every value into one histogram; other buckets refuse."""
    rng = np.random.default_rng(5)
    parts = [10.0 ** rng.uniform(-6, 1, n) for n in (40, 0, 17)]
    merged, whole = metrics.LatencyHistogram(), metrics.LatencyHistogram()
    for values in parts:
        h = metrics.LatencyHistogram()
        for v in values:
            h.record(float(v))
            whole.record(float(v))
        merged.merge(h)
    assert merged.counts == whole.counts and merged.count == whole.count
    assert merged.total == pytest.approx(whole.total)
    assert merged.max == whole.max
    for p in (1.0, 50.0, 99.0):
        assert merged.percentile(p) == whole.percentile(p)
    with pytest.raises(ValueError):
        merged.merge(metrics.LatencyHistogram(n_buckets=20))
