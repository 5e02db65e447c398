"""The A/B harness of the InfoNCE lse forwards (`experiments/lse_ab.py`) on the
CPU: its arguments, its shapes (`chip_smoke.py`'s phases 10, 11 and 6), the
work and bound it prints beside each time, its reading of ptxas's report for
the walk's four template arguments, and how its profile picks each tree's lse
kernels. Needs no card."""

import json

import pytest

import chip_smoke
from clip_dplm_tpu_torch.experiments import lse_ab

PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN9clip_dplm44_GLOBAL__N__c4e8ad53_11_lse_walk_cu_d53f65ea15lse_walk_kernelILi8ELb1ELb1ELb0EEEv14CUtensorMap_stS2_NS0_8WalkArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN9clip_dplm44_GLOBAL__N__c4e8ad53_11_lse_walk_cu_d53f65ea15lse_walk_kernelILi8ELb1ELb1ELb0EEEv14CUtensorMap_stS2_NS0_8WalkArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 5 barriers, 256 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN9clip_dplm44_GLOBAL__N__c4e8ad53_11_lse_walk_cu_d53f65ea15lse_walk_kernelILi1ELb0ELb0ELb1EEEv14CUtensorMap_stS2_NS0_8WalkArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN9clip_dplm44_GLOBAL__N__c4e8ad53_11_lse_walk_cu_d53f65ea15lse_walk_kernelILi1ELb0ELb0ELb1EEEv14CUtensorMap_stS2_NS0_8WalkArgsE
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers, 256 bytes cmem[0]
"""


def test_shapes_are_the_smoke_shapes():
    """Phase 10's three row-CE shapes; phase 11's saving forward at B = 8192,
    4096, 1000, 256, 200 and phase 6's non-saving one at 8192 and 1000."""
    assert lse_ab.ROW_CE_SHAPES == chip_smoke.CACHE_SHAPES
    assert [B for _, B, save in lse_ab.SYM_SHAPES if save] == [8192, 4096, 1000, 256, 200]
    assert [B for _, B, save in lse_ab.SYM_SHAPES if not save] == [8192, 1000]
    assert lse_ab.D == 512


def test_arguments():
    args = lse_ab.parse_args(["--other", "build/parent"])
    assert (str(args.other), args.rounds, args.steps, args.profile) == ("build/parent", 2, "", "")
    args = lse_ab.parse_args(["--other", "x", "--rounds", "3", "--steps",
                              "two_tower_cached,two_tower,tf_clip", "--profile",
                              "two_tower_cached,tf_clip"])
    assert args.rounds == 3
    assert args.steps.split(",") == ["two_tower_cached", "two_tower", "tf_clip"]
    assert args.profile.split(",") == ["two_tower_cached", "tf_clip"]
    with pytest.raises(SystemExit):
        lse_ab.parse_args([])


def test_work_counts_each_byte_once():
    """x and the walked (valid) rows of y in bf16, the scale (and n_valid) in;
    the row lse out, the column lse and the int16 raw where they are made;
    the raw product's 2·m·n·d operations."""
    assert lse_ab.work("row_ce", 10, 7, d=64) == ((10 + 7) * 64 * 2 + 4 + 10 * 4 + 4,
                                                  2.0 * 10 * 7 * 64)
    assert lse_ab.work("lse", 10, 7, d=64) == ((10 + 7) * 64 * 2 + 4 + 10 * 4 + 7 * 4,
                                               2.0 * 10 * 7 * 64)
    assert lse_ab.work("save", 10, 7, d=64) == ((10 + 7) * 64 * 2 + 4 + 10 * 4 + 7 * 4
                                                + 10 * 7 * 2, 2.0 * 10 * 7 * 64)


@pytest.mark.parametrize("kind,m,n,ms", [("row_ce", 8192, 8192 + 5000, 0.1119),
                                         ("row_ce", 8192, 8192, 0.0695),
                                         ("save", 8192, 8192, 0.0695),
                                         ("save", 4096, 4096, 0.0174),
                                         ("lse", 8192, 8192, 0.0695)])
def test_bound_at_the_large_shapes_is_the_tensor_cores(kind, m, n, ms):
    """2·m·n·d operations over 989 TFLOP/s at every large shape (the int16
    raw's 134 MB at B = 8192 is 0.040 ms at 3.35 TB/s, under it), the same
    bound as the smoke's for the same work."""
    work = lse_ab.work(kind, m, n)
    bound_ms, by = lse_ab.bound(*work)
    assert by == "operations" and round(bound_ms, 4) == ms
    assert (bound_ms, by) == chip_smoke.bound(*work)


def test_ptxas_summary_reads_the_walk_instances():
    got = list(lse_ab.ptxas_summary(PTXAS_LOG, "lse_walk_kernel"))
    assert got == [
        {"instance": "<8, 1, 1, 0>", "registers": 168, "stack_frame": 0, "spill_stores": 0,
         "spill_loads": 0},
        {"instance": "<1, 0, 0, 1>", "registers": 168, "stack_frame": 8, "spill_stores": 8,
         "spill_loads": 8}]


def test_profile_lists_each_trees_lse_kernels(monkeypatch, capsys):
    """This tree's profile asks for the walk and the combine past the top 25;
    each tree's line sums the kernels named as either tree names them."""
    from clip_dplm_tpu_torch.experiments import gemm_ab

    seen = []
    rows = {"other": [("void clip_dplm::sym_lse_kernel<true>(...)", 1.25, 3.0),
                      ("cutlass_gemm", 9.0, 8.0)],
            "this": [("void clip_dplm::lse_walk_kernel<8, true, true, false>(...)", 0.106, 3.0),
                     ("clip_dplm::lse_combine_kernel(float const*, ...)", 0.018, 3.0)]}

    def run(tree, module, args):
        name = "this" if tree == lse_ab.REPO else "other"
        seen.append((name, module, list(args)))
        lines = [{"kernel": k, "device_ms_per_step": ms, "launches_per_step": n}
                 for k, ms, n in rows[name]] + [{"model": "tf_clip"}]
        return "\n".join(json.dumps(x) for x in lines)

    monkeypatch.setattr(gemm_ab, "_run", run)
    lse_ab.profile_lse(lse_ab.REPO / "build" / "parent", "tf_clip")
    assert seen == [("other", "profile_step", ["--model", "tf_clip"]),
                    ("this", "profile_step", ["--model", "tf_clip", "--kernels",
                                              "lse_walk_kernel,lse_combine_kernel"])]
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(x["tree"], round(x["lse_device_ms_per_step"], 4), x["lse_launches_per_step"])
            for x in out] == [("other", 1.25, 3.0), ("this", 0.124, 6.0)]
