"""The control of each kind of cell at a size a test run holds: the plain
reference in float8 put in the program's place, judged by the harness as
the program is, comes out not correct where the program passes.  At
this size the decode control separates by the exit entropies on every
seed, by the served tokens' gap on some.  On the card the same control
runs at the cells' own sizes (``bench/control.py``; readings in
PERF.md)."""
import pytest

from bench.conftest import run_small


@pytest.mark.parametrize("seed", [5, 6, 7])
@pytest.mark.parametrize("name,number", [("small.decode",
                                          "exit_entropy_gap"),
                                         ("small.score", "logit_err")])
def test_control_fails_where_the_program_passes(small_root, name, number,
                                                seed):
    out = run_small(small_root, name, seed, control=True)
    assert out["correct"], out["checks"]
    assert out["control_correct"] is False, out["control"]
    limit = out["checks"][number]["limit"]
    assert out["control"][number] > limit, (out["control"], limit)
    assert out["control"][number] >= 3 * out["checks"][number]["value"]
