"""The A/B harness of the symmetric InfoNCE's recompute pass
(`experiments/sym_ab.py`) on the CPU: its arguments, its shapes
(`chip_smoke.py`'s phase 6, then B = 32768), the work and bound it prints
beside each time, the source it builds from the other tree, and its reading
of ptxas's registers and spills. Needs no card."""

import pytest

import chip_smoke
from clip_dplm_tpu_torch.experiments import sym_ab

PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN10clip_dplm12_GLOBAL__N_118row_ce_grad_kernelILi8ELi2EEEv14CUtensorMap_stS2_PKfPKiS4_S4_PfS7_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN10clip_dplm12_GLOBAL__N_118row_ce_grad_kernelILi8ELi2EEEv14CUtensorMap_stS2_PKfPKiS4_S4_PfS7_ii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 230 registers, used 1 barriers, 256 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN10clip_dplm12_GLOBAL__N_115sym_grad_kernelILi8EEEvPK13__nv_bfloat16S4_PKfS6_S6_PfS7_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN10clip_dplm12_GLOBAL__N_115sym_grad_kernelILi8EEEvPK13__nv_bfloat16S4_PKfS6_S6_PfS7_iii
    288 bytes stack frame, 284 bytes spill stores, 284 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN10clip_dplm12_GLOBAL__N_122sym_grad_merged_kernelILi8EEEvPKsiPK13__nv_bfloat16S6_PKfS8_S8_PfS9_S9_iii' for 'sm_90a'
ptxas info    : Used 96 registers, used 1 barriers, 400 bytes cmem[0]
"""


def test_shapes_are_the_smoke_phase_6_shapes_then_past_the_raw_limit():
    assert sym_ab.SHAPES[:3] == chip_smoke.SYM_GRAD_SHAPES
    assert sym_ab.SHAPES[3] == ("B=32768", 32768)
    assert sym_ab.D == 512


def test_arguments():
    args = sym_ab.parse_args(["--other", "build/parent"])
    assert (str(args.other), args.rounds, args.steps, args.profile) == ("build/parent", 2, "", "")
    args = sym_ab.parse_args(["--other", "x", "--rounds", "3", "--steps", "never8192,auto32768",
                              "--profile", "auto32768"])
    assert (args.rounds, args.steps.split(","), args.profile) == (
        3, ["never8192", "auto32768"], "auto32768")
    for bad in (["--other", "x", "--steps", "two_tower"], ["--other", "x", "--profile", "x"], []):
        with pytest.raises(SystemExit):
            sym_ab.parse_args(bad)


def test_steps_take_the_recompute_pass():
    """never8192 forces the recompute pass at the two-tower bench's batch;
    auto32768 is past the 640 MiB of int16 raw at which "auto" stops saving
    it, so it takes the recompute pass with no override."""
    from clip_dplm_tpu_torch.ops import fused_infonce as fi

    for name, (batch, overrides) in sym_ab.STEPS.items():
        mode = next((o.split("=")[1] for o in overrides
                     if o.startswith("contrastive.fused_materialize_raw=")), "auto")
        assert not fi._resolve_materialize(mode, batch, batch), name
    assert fi._resolve_materialize("auto", 8192, 8192)


@pytest.mark.parametrize("m,ms", [(8192, 4.0 * 8192 ** 2 * 512 / 989e9),
                                  (32768, 4.0 * 32768 ** 2 * 512 / 989e9)])
def test_bound_is_the_tensor_cores(m, ms):
    """4·B²·d operations: 0.1390 ms at B = 8192, 2.2235 at 32768 (989
    TFLOP/s), the same bound the smoke prints for the same work."""
    work = sym_ab.work(m, m)
    bound_ms, by = sym_ab.bound(*work)
    assert by == "operations"
    assert bound_ms == pytest.approx(ms, rel=1e-12)
    assert round(bound_ms, 4) == (0.139 if m == 8192 else 2.2235)
    assert (bound_ms, by) == chip_smoke.bound(*work)


def test_work_counts_each_byte_once():
    """x and y in bf16, lse_row, lse_col and the scale in f32 in; acc (f32)
    and rowdot out; 4·m·n·d products."""
    assert sym_ab.work(10, 7, d=64) == (
        (10 + 7) * 64 * 2 + (10 + 7) * 4 + 4 + 10 * 64 * 4 + 10 * 4, 4.0 * 10 * 7 * 64)


def test_other_source(tmp_path):
    """A tree whose row_ce.cu holds the entry builds it; one from before
    builds its fused_infonce.cu."""
    csrc = tmp_path / "clip_dplm_tpu_torch" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "row_ce.cu").write_text('extern "C" int row_ce_dx(const void* x);\n')
    assert sym_ab.other_source(tmp_path) == csrc / "fused_infonce.cu"
    (csrc / "row_ce.cu").write_text('extern "C" int sym_infonce_grad(const void* x,\n')
    assert sym_ab.other_source(tmp_path) == csrc / "row_ce.cu"


def test_ptxas_summary_reads_both_designs():
    got = list(sym_ab.ptxas_summary(PTXAS_LOG, "row_ce_grad_kernel"))
    assert got == [{"instance": "<8, 2>", "registers": 230, "stack_frame": 0, "spill_stores": 0,
                    "spill_loads": 0}]
    got = list(sym_ab.ptxas_summary(PTXAS_LOG, "sym_grad_kernel"))
    assert got == [{"instance": "<8>", "registers": 128, "stack_frame": 288,
                    "spill_stores": 284, "spill_loads": 284}]
