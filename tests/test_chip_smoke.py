"""chip_smoke.py at tiny sizes on the CPU: every phase runs its comparisons
against the references, and main() refuses to run without a GPU. The full
smoke runs on the card through the `gpu`-marked test."""

from __future__ import annotations

import numpy as np
import pytest

import chip_smoke as cs


def _rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize(
    "phase",
    [
        cs.phase_core,
        cs.phase_big_table,
        cs.phase_high_dim,
        cs.phase_extensions,
        cs.phase_compat,
        cs.phase_gradients,
        cs.phase_classes,
    ],
    ids=lambda f: f.__name__,
)
def test_phase_passes_at_tiny_size(phase):
    assert phase(cs.TINY, _rng()) >= 0.0


def test_phase_aot_round_trip_on_the_host_platform():
    assert cs.phase_aot(cs.TINY, _rng(), platforms=("cpu",)) >= 0.0


def test_timings_compare_factorized_with_gather(capsys):
    assert cs.phase_timings(cs.TINY, _rng()) == 0.0
    out = capsys.readouterr().out
    assert out.count("factorized/gather=") == 4
    assert "native_median_s=" in out and "peak_bytes_in_use=" in out


def test_phase_multichip_on_four_virtual_devices(capsys):
    cs.phase_multichip(cs.TINY, _rng(), n_dev=4)
    out = capsys.readouterr().out
    # 12 sharded_evaluator families, 2 prepared extensions, 1 stack
    assert out.count("collectives=none") == 15
    assert "FAIL" not in out


def test_report_raises_past_tolerance():
    with pytest.raises(cs.PhaseFailure, match="max_err"):
        cs._report("x", "y", np.array([1.0]), np.array([1.1]), 1.0, 1e-3)
    with pytest.raises(cs.PhaseFailure, match="non-finite"):
        cs._report("x", "y", np.array([np.nan]), np.array([0.0]), 1.0, 1.0)
    cs._report("x", "y", np.array([2.0]), np.array([2.0]), 1.0, 0.0, exact=True)


def test_queries_put_a_tenth_out_of_bounds():
    grids = [cs._regular_axis(20) for _ in range(3)]
    obs = cs._queries(grids, 100_000, _rng())
    outside = np.zeros(100_000, bool)
    for g, o in zip(grids, obs):
        outside |= (o < g[0]) | (o > g[-1])
    assert abs(outside.mean() - cs.OOB_SHARE) < 0.01
    import interpn_tpu as it

    assert it._check_regular([g.astype(np.float32) for g in grids])


def test_failed_phase_fails_the_run(capsys):
    def boom(sizes, rng):
        raise cs.PhaseFailure("synthetic")

    failed = cs._run_phases([("ok", lambda s, r: 0.0), ("boom", boom)], cs.TINY)
    assert failed == ["boom"]
    assert "phase boom: FAILED" in capsys.readouterr().out


def test_main_exits_nonzero_without_gpu(capsys):
    assert cs.main([]) != 0
    captured = capsys.readouterr()
    assert "needs a GPU" in captured.err
    assert '"ok"' not in captured.out


@pytest.mark.gpu
def test_full_smoke_on_gpu(gpu_device):
    assert cs.main([]) == 0
