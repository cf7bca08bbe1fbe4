"""The port's arrival-trace generators (``serving/traces.py``, a copy of
the reference's numpy-only module) replay the reference's traces bit for
bit, and the serving driver's ``poisson_trace`` is that generator."""
import numpy as np
import pytest

from repro.serving import traces as ref_traces
from repro_torch.launch import serve as port_serve
from repro_torch.serving import traces

CASES = [
    ("poisson", {}),
    ("diurnal", {}),
    ("diurnal", {"period_s": 7.5, "amplitude": 0.3}),
    ("flash_crowd", {}),
    ("flash_crowd", {"burst_frac": 0.5, "burst_factor": 4.0,
                     "burst_at_frac": 0.2}),
    ("mixed_slo", {}),
    ("mixed_slo", {"classes": ("a", "b", "c"), "weights": (0.2, 0.3, 0.5)}),
]


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1, 17])
@pytest.mark.parametrize("kind,kw", CASES,
                         ids=[f"{k}-{i}" for i, (k, _) in enumerate(CASES)])
def test_trace_equals_reference(kind, kw, seed):
    """Same seed, kind and keywords: the same arrivals, prompt lengths
    (and SLO labels), through both ``make_trace`` and the generator."""
    args = (6.0, 40, 24)
    got = traces.make_trace(kind, np.random.RandomState(seed), *args, **kw)
    want = ref_traces.make_trace(kind, np.random.RandomState(seed), *args,
                                 **kw)
    _equal(got, want)
    _equal(traces.TRACE_KINDS[kind](np.random.RandomState(seed), *args,
                                    **kw), want)
    assert np.all(np.diff(got[0]) >= 0)


def test_kinds_and_unknown_kind():
    assert sorted(traces.TRACE_KINDS) == sorted(ref_traces.TRACE_KINDS)
    with pytest.raises(ValueError, match="unknown trace kind"):
        traces.make_trace("bursty", np.random.RandomState(0), 1.0, 4, 8)


def test_serve_poisson_trace_is_the_generator():
    """The driver's ``poisson_trace`` is ``traces.poisson_trace``: all gaps
    are drawn before all lengths, so old seeds replay old traces."""
    assert port_serve.poisson_trace is traces.poisson_trace
    rs = np.random.RandomState(5)
    arrivals, lengths = port_serve.poisson_trace(rs, 8.0, 12, 64)
    rs2 = np.random.RandomState(5)
    assert np.array_equal(arrivals, np.cumsum(rs2.exponential(1 / 8.0, 12)))
    assert np.array_equal(lengths, rs2.randint(16, 65, 12))
