"""The A/B harness of the row-CE backward kernels (`experiments/row_ce_ab.py`)
on the CPU: its arguments, its shapes (`chip_smoke.py`'s phase 10), the work
and bound it prints beside each time, and its reading of ptxas's registers
and spills. Needs no card."""

import pytest

import chip_smoke
from clip_dplm_tpu_torch.experiments import row_ce_ab

PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN10clip_dplm12_GLOBAL__N_118row_ce_grad_kernelILi8ELb1EEEv14CUtensorMap_stS2_PKfPKiS4_PfS7_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN10clip_dplm12_GLOBAL__N_118row_ce_grad_kernelILi8ELb1EEEv14CUtensorMap_stS2_PKfPKiS4_PfS7_ii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 212 registers, used 1 barriers, 256 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN10clip_dplm12_GLOBAL__N_118row_ce_grad_kernelILi3ELb0EEEv14CUtensorMap_stS2_PKfPKiS4_PfS7_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN10clip_dplm12_GLOBAL__N_118row_ce_grad_kernelILi3ELb0EEEv14CUtensorMap_stS2_PKfPKiS4_PfS7_ii
    8 bytes stack frame, 112 bytes spill stores, 96 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 256 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN10clip_dplm12_GLOBAL__N_117row_ce_lse_kernelEPK13__nv_bfloat16S3_PKfPKiPfiii' for 'sm_90a'
ptxas info    : Used 64 registers, used 1 barriers, 400 bytes cmem[0]
"""


def test_shapes_are_the_smoke_phase_10_shapes():
    assert row_ce_ab.SHAPES == chip_smoke.CACHE_SHAPES
    assert row_ce_ab.D == 512


def test_arguments():
    args = row_ce_ab.parse_args(["--other", "build/parent"])
    assert (str(args.other), args.rounds, args.steps, args.profile) == ("build/parent", 2, "", "")
    args = row_ce_ab.parse_args(["--other", "x", "--rounds", "3", "--steps", "two_tower_cached",
                                 "--profile", "two_tower_cached"])
    assert (args.rounds, args.steps.split(","), args.profile) == (3, ["two_tower_cached"],
                                                                  "two_tower_cached")
    with pytest.raises(SystemExit):
        row_ce_ab.parse_args([])


@pytest.mark.parametrize("kernel,shape,ms", [
    ("row_ce_dx", 0, 4.0 * 8192 * 13192 * 512 / 989e9),
    ("row_ce_dy", 0, 4.0 * 8192 * 8192 * 512 / 989e9),
    ("row_ce_dx", 1, 4.0 * 8192 * 8192 * 512 / 989e9),
    ("row_ce_dy", 1, 4.0 * 8192 * 8192 * 512 / 989e9)])
def test_bound_at_the_cached_step_is_the_tensor_cores(kernel, shape, ms):
    """At a->[b; cache] dX does 4 m n_valid d operations (0.2238 ms at 989
    TFLOP/s) and dY for b's rows 4 m 8192 d (0.1390 ms); b->a both 0.1390."""
    _, m, _, nv, rows = row_ce_ab.SHAPES[shape]
    bound_ms, by = row_ce_ab.bound(*row_ce_ab.work(kernel, m, nv, rows))
    assert by == "operations"
    assert bound_ms == pytest.approx(ms, rel=1e-12)
    assert round(bound_ms, 4) == (0.2238 if (kernel, shape) == ("row_ce_dx", 0) else 0.139)


@pytest.mark.parametrize("kernel", ["row_ce_dx", "row_ce_dy"])
def test_bound_is_the_smoke_bound(kernel):
    """The harness's bound is the smoke's for the same work (the same peaks),
    at every phase-10 shape."""
    for _, m, _, nv, rows in row_ce_ab.SHAPES:
        work = row_ce_ab.work(kernel, m, nv, rows)
        assert row_ce_ab.bound(*work) == chip_smoke.bound(*work)


def test_work_counts_each_byte_once():
    """dx: x and y's valid rows in bf16, the lse in, P y (f32) and rowdot
    out; dy: x and y's first rows in bf16, the lse in, P^T x (f32) out."""
    assert row_ce_ab.work("row_ce_dx", 10, 7, 5, d=64) == (
        (10 + 7) * 64 * 2 + 10 * 4 + 10 * 64 * 4 + 10 * 4, 4.0 * 10 * 7 * 64)
    assert row_ce_ab.work("row_ce_dy", 10, 7, 5, d=64) == (
        (10 + 5) * 64 * 2 + 10 * 4 + 5 * 64 * 4, 4.0 * 10 * 5 * 64)


def test_ptxas_summary_reads_each_grad_instance():
    got = list(row_ce_ab.ptxas_summary(PTXAS_LOG))
    assert got == [
        {"instance": "<8, 1>", "registers": 212, "stack_frame": 0, "spill_stores": 0,
         "spill_loads": 0},
        {"instance": "<3, 0>", "registers": 255, "stack_frame": 8, "spill_stores": 112,
         "spill_loads": 96}]
    assert [e["instance"] for e in row_ce_ab.ptxas_summary(PTXAS_LOG, "row_ce_lse_kernel")] == []
