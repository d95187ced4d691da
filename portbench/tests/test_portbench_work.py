"""Shape-only work counts, by hand, at the cartpole and quadrotor shapes;
the rates and the tail taken over every period."""

import math
import types

import pytest

from portbench import run, work


def test_trip_counts_cartpole_by_hand():
    # n = 4, m = 1, T = 50.  bytes per stage (floats): model outputs
    # (16 + 4) + (16 + 8 + 1) + (4 + 1) = 50, condensation 21, factor
    # 21 + 24 + 53 = 98, solve 36 + 12 + 1 + 9 = 58, line search 20
    assert work.trip_bytes(50, 4, 1) == 4 * 50 * (50 + 21 + 98 + 58 + 20)
    # flops per stage: factor 64/3 + 128 + 128 + 32 + 8 + 1/3 + 8 + 128
    # + 32, solve 192 + 32, residual 128 + 32
    factor = 64 / 3 + 128 + 128 + 32 + 8 + 1 / 3 + 8 + 128 + 32
    assert work.trip_flops(50, 4, 1) == pytest.approx(
        50 * (factor + 224 + 160))


def test_trip_counts_quadrotor_by_hand():
    # n = 6, m = 2, T = 20: 120 + 52 + 230 + 118 + 32 floats a stage
    assert work.trip_bytes(20, 6, 2) == 4 * 20 * 552
    factor = 216 / 3 + 432 + 432 + 144 + 48 + 8 / 3 + 48 + 432 + 144
    assert work.trip_flops(20, 6, 2) == pytest.approx(
        20 * (factor + 12 * 36 + 96 + 8 * 36 + 96))


def test_riccati_counts_by_hand():
    # solve_bwd at (4, 1): 24 + 32 + 8 + 2 + 32 + 8 + 8
    assert work.riccati_flops("solve_bwd", 4, 1) == 114
    # solve_fwd at (6, 2): 24 + 72 + 24 + 24 + 72 + 72
    assert work.riccati_flops("solve_fwd", 6, 2) == 288


def test_kernel_work_by_name():
    cw = work.CellWork(T=50, n=4, m=1, batch=10, chunk=6, exact=False,
                       finite_u=2, finite_x=0, ops=(100, 10, 3))
    # the probe: 6 candidates x (50 x (113 + 10 + 12 + 4) + 10 + 20 +
    # 3 x 2 x 51) operations; reads 2 x 51 x 4 + 2 x 50 + 4 + 6 floats,
    # writes 18
    flops, nbytes = cw.kernel("void ls_probe::probe_kernel<Model>(int)")
    assert flops == 10 * 6 * (50 * 139 + 10 + 20 + 306)
    assert nbytes == 10 * 4 * (408 + 100 + 4 + 6 + 18)
    assert cw.kernel("void riccati::solve_bwd_kernel<4, 1>(int)")[0] \
        == 10 * 50 * 114
    assert cw.kernel("void fused_iter::eval_kernel<M>(int)") is not None
    assert cw.kernel("void at::native::vectorized_elementwise") is None
    assert work.is_port_kernel("void fused_iter::factor_thread_kernel<M>")
    assert not work.is_port_kernel("void at::native::reduce_kernel")


def test_scalar_ops_of_a_plain_function():
    import torch

    def f(x):
        return torch.sin(x) * 2.0 + x

    # sin, mul, add over 4 elements
    assert work.scalar_ops(f, torch.zeros(4)) == 12


def _ctx(periods, window_s):
    return types.SimpleNamespace(batch=1000, period_s=periods,
                                 window_s=window_s)


def test_rate_over_all_periods_and_the_whole_window():
    periods = [0.1] * 9 + [1.0]
    # 10 periods of 1000 solves over 1.9 s, the slow one included
    assert run.reader("solves_per_s")(_ctx(periods, 1.9)) == \
        pytest.approx(10_000 / 1.9)


def test_p95_over_every_period_nearest_rank():
    periods = [0.01 * (i + 1) for i in range(200)]
    # nearest rank: the 190th of 200
    assert run.reader("step_ms_p95")(_ctx(periods, 20.1)) == \
        pytest.approx(1900.0)
    # a chunked median of 20-period chunks would read 1,005 ms here
    assert run.reader("step_ms_p95")(_ctx(periods[::-1], 20.1)) == \
        pytest.approx(1900.0)


def test_trace_readers():
    trace = dict(window_s=2.0, busy_s=0.5, trips=10,
                 kernels={"void fused_iter::eval_kernel<M>(int)": [10, 0.1],
                          "void at::native::add": [990, 0.4]})
    cw = work.CellWork(T=50, n=4, m=1, batch=10, chunk=6, exact=False,
                       finite_u=2, finite_x=0, ops=(100, 10, 3))
    ctx = types.SimpleNamespace(trace=trace, work=cw)
    assert run.reader("launches_per_trip")(ctx) == 100
    assert run.reader("device_idle_pct")(ctx) == 75.0
    assert run.reader("kernel_share_pct")(ctx) == pytest.approx(20.0)
    least = 10 * work.bound_s(*cw.kernel("fused_iter::eval_kernel"))
    assert run.reader("kernel_roofline")(ctx) == pytest.approx(
        100 * least / 0.1)
    assert run.reader("device_idle_pct")(
        types.SimpleNamespace(trace=None)) is None
    assert math.isfinite(run.reader("kernel_roofline")(ctx))
