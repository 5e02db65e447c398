"""The A/B harness of the backward from the saved int16 raw
(`experiments/raw_ab.py`) on the CPU: its arguments, its shapes
(`chip_smoke.py`'s phase 11), the work and bound it prints beside each time
(each byte counted once), the blocks and L2 bytes of this tree's kernel, its
reading of ptxas's report for both trees' kernels, and how its profile picks
each tree's InfoNCE kernels. Needs no card."""

import json

import pytest

import chip_smoke
from clip_dplm_tpu_torch.experiments import raw_ab

PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN9clip_dplm44_GLOBAL__N__db6a41a0_11_raw_grad_cu_ad021a9520from_raw_grad_kernelILi8ELb1EEEv14CUtensorMap_stS2_NS0_11RawGradArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN9clip_dplm44_GLOBAL__N__db6a41a0_11_raw_grad_cu_ad021a9520from_raw_grad_kernelILi8ELb1EEEv14CUtensorMap_stS2_NS0_11RawGradArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 6 barriers, 256 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN9clip_dplm12_GLOBAL__N_119sym_grad_raw_kernelILi8EEEvPKsiPK13__nv_bfloat16PKfS8_S8_PfS9_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN9clip_dplm12_GLOBAL__N_119sym_grad_raw_kernelILi8EEEvPKsiPK13__nv_bfloat16PKfS8_S8_PfS9_iii
    128 bytes stack frame, 120 bytes spill stores, 120 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 424 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN9clip_dplm12_GLOBAL__N_120sym_grad_rawT_kernelILi2EEEvPKsiPK13__nv_bfloat16PKfS8_S8_Pfiii' for 'sm_90a'
ptxas info    : Used 104 registers, used 1 barriers, 420 bytes cmem[0]
"""


def test_shapes_are_the_smoke_phase_11_shapes():
    assert raw_ab.SHAPES == chip_smoke.SAVED_RAW_SHAPES
    assert [B for _, B in raw_ab.SHAPES] == [8192, 4096, 1000, 256, 200]
    assert raw_ab.D == 512


def test_arguments():
    args = raw_ab.parse_args(["--other", "build/parent"])
    assert (str(args.other), args.rounds, args.variant, args.steps, args.profile) == (
        "build/parent", 2, False, "", "")
    args = raw_ab.parse_args(["--other", "x", "--rounds", "3", "--variant", "--steps",
                              "two_tower,tf_clip,rna_rbp", "--profile", "two_tower,tf_clip"])
    assert (args.rounds, args.variant) == (3, True)
    assert args.steps.split(",") == ["two_tower", "tf_clip", "rna_rbp"]
    assert args.profile.split(",") == ["two_tower", "tf_clip"]
    with pytest.raises(SystemExit):
        raw_ab.parse_args([])


def test_work_counts_each_byte_once():
    """The int16 raw (m x n), both lse and the scale in; the walked operand in
    bf16 (y for pass A, x for pass B); the f32 product out, pass A's rowdot
    too; 2·m·n·d operations."""
    raw_in = 10 * 7 * 2 + (10 + 7) * 4 + 4
    assert raw_ab.work("sym_infonce_grad_raw", 10, 7, d=64) == (
        raw_in + 7 * 64 * 2 + 10 * 64 * 4 + 10 * 4, 2.0 * 10 * 7 * 64)
    assert raw_ab.work("sym_infonce_grad_rawT", 10, 7, d=64) == (
        raw_in + 10 * 64 * 2 + 7 * 64 * 4, 2.0 * 10 * 7 * 64)


@pytest.mark.parametrize("entry", raw_ab.ENTRIES)
@pytest.mark.parametrize("B,ms", [(8192, 0.0695), (4096, 0.0174)])
def test_bound_at_the_large_shapes_is_the_tensor_cores(entry, B, ms):
    """2·B²·d over 989 TFLOP/s at B = 8192 and 4096 (the int16 raw's 134 MB at
    8192 is 0.040 ms at 3.35 TB/s, under it), the smoke's bound for the same
    work."""
    work = raw_ab.work(entry, B, B)
    bound_ms, by = raw_ab.bound(*work)
    assert by == "operations" and round(bound_ms, 4) == ms
    assert (bound_ms, by) == chip_smoke.bound(*work)


def test_l2_bytes_read_the_walked_operand_once_a_block():
    """64 own entries a block; each block reads the whole walked operand and
    the raw is read once: pass A owns the raw's rows, pass B its columns."""
    assert raw_ab.l2_bytes("sym_infonce_grad_raw", 8192, 8192) == (
        128, 128 * 8192 * 512 * 2 + 8192 * 8192 * 2)
    assert raw_ab.l2_bytes("sym_infonce_grad_raw", 1000, 130, d=64) == (
        16, 16 * 130 * 64 * 2 + 1000 * 130 * 2)
    assert raw_ab.l2_bytes("sym_infonce_grad_rawT", 1000, 130, d=64) == (
        3, 3 * 1000 * 64 * 2 + 1000 * 130 * 2)


def test_ptxas_summary_reads_both_trees_kernels():
    new = list(raw_ab.ptxas_summary(PTXAS_LOG, raw_ab.NEW_KEY))
    assert new == [{"instance": "<8, 1>", "registers": 168, "stack_frame": 0, "spill_stores": 0,
                    "spill_loads": 0}]
    old = [list(raw_ab.ptxas_summary(PTXAS_LOG, key)) for key in raw_ab.OLD_KEYS]
    assert old == [[{"instance": "<8>", "registers": 128, "stack_frame": 128,
                     "spill_stores": 120, "spill_loads": 120}],
                   [{"instance": "<2>", "registers": 104, "stack_frame": None,
                     "spill_stores": None, "spill_loads": None}]]


def test_profile_sums_each_trees_from_raw_kernels(monkeypatch, capsys):
    """Both trees' profiles list the InfoNCE kernels past the top 25; each
    line sums the from-raw passes as either tree names them, and the InfoNCE
    kernels as a whole."""
    from clip_dplm_tpu_torch.experiments import gemm_ab

    seen = []
    rows = {"other": [("void clip_dplm::sym_grad_raw_kernel<8>(...)", 0.91, 1.0),
                      ("void clip_dplm::sym_grad_rawT_kernel<8>(...)", 1.05, 1.0),
                      ("void clip_dplm::lse_walk_kernel<8, true, true, false>(...)", 0.13, 1.0),
                      ("cutlass_gemm", 9.0, 8.0)],
            "this": [("void clip_dplm::from_raw_grad_kernel<8, false>(...)", 0.12, 1.0),
                     ("void clip_dplm::from_raw_grad_kernel<8, true>(...)", 0.11, 1.0),
                     ("void clip_dplm::lse_walk_kernel<8, true, true, false>(...)", 0.13, 1.0)]}

    def run(tree, module, args):
        name = "this" if tree == raw_ab.REPO else "other"
        seen.append((name, module, list(args)))
        lines = [{"kernel": k, "device_ms_per_step": ms, "launches_per_step": n}
                 for k, ms, n in rows[name]] + [{"model": "two_tower"}]
        return "\n".join(json.dumps(x) for x in lines)

    monkeypatch.setattr(gemm_ab, "_run", run)
    raw_ab.profile_infonce(raw_ab.REPO / "build" / "parent", "two_tower")
    keys = ",".join(raw_ab.PROFILE_KEYS)
    assert seen == [("other", "profile_step", ["--model", "two_tower", "--kernels", keys]),
                    ("this", "profile_step", ["--model", "two_tower", "--kernels", keys])]
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(x["tree"], round(x["from_raw_device_ms_per_step"], 4), x["from_raw_launches_per_step"],
             round(x["infonce_device_ms_per_step"], 4)) for x in out] == [
        ("other", 1.96, 2.0, 2.09), ("this", 0.23, 2.0, 0.36)]
