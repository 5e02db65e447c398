"""The A/B harness of the fused-Dense row passes
(`experiments/fused_dense_ab.py`) on the CPU: its arguments, its geometries
(`chip_smoke.py`'s FD_GEOMETRIES), the bytes it counts for each pass's bound
(each byte once, for every geometry, with f32 or bf16 dy, the skip tail and
an L2 output), its reading of ptxas's report for both trees' row kernels,
and how its profile picks each tree's row kernels. Needs no card."""

import json

import pytest
import torch

import chip_smoke
from clip_dplm_tpu_torch.experiments import fused_dense_ab as ab

PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN9clip_dplm12_GLOBAL__N_115fwd_rows_kernelILi8EEEvNS0_9RowParamsEP13__nv_bfloat16PviiPfS6_' for 'sm_90a'
ptxas info    : Function properties for _ZN9clip_dplm12_GLOBAL__N_115fwd_rows_kernelILi8EEEvNS0_9RowParamsEP13__nv_bfloat16PviiPfS6_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 432 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN9clip_dplm12_GLOBAL__N_116bwd_stats_kernelENS0_9RowParamsEPKviPK13__nv_bfloat16PKfS8_iPNS0_8RowStatsE' for 'sm_90a'
ptxas info    : Function properties for _ZN9clip_dplm12_GLOBAL__N_116bwd_stats_kernelENS0_9RowParamsEPKviPK13__nv_bfloat16PKfS8_iPNS0_8RowStatsE
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, 464 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN9clip_dplm12_GLOBAL__N_117dense_gemm_kernelILb1ELb0EEEv14CUtensorMap_stS2_PK13__nv_bfloat16PS3_iiii' for 'sm_90a'
ptxas info    : Used 112 registers, used 1 barriers, 432 bytes cmem[0]
"""


def test_geometries_are_the_smoke_geometries():
    assert list(ab.GEOMETRIES) == chip_smoke.FD_GEOMETRIES
    assert [(g[1], g[2], g[3]) for g in ab.GEOMETRIES] == [
        (8192, 1024, 1024), (8192, 1024, 2048), (8192, 2048, 2048), (8192, 2048, 512),
        (1000, 1024, 2048), (1024, 512, 2048), (1024, 2048, 2048), (1024, 2048, 512)]


def test_arguments():
    args = ab.parse_args(["--other", "build/parent"])
    assert (str(args.other), args.rounds, args.variant, args.define, args.steps,
            args.profile) == ("build/parent", 2, False, [], "", "")
    assert ab.parse_args(["--other", ".", "--define", "FD_BWD_SPLIT=2", "--define",
                          "X=1"]).define == ["FD_BWD_SPLIT=2", "X=1"]
    args = ab.parse_args(["--other", "x", "--rounds", "3", "--variant", "--steps",
                          "two_tower,rna_rbp", "--profile", "two_tower,rna_rbp"])
    assert (args.rounds, args.variant) == (3, True)
    assert args.steps.split(",") == ["two_tower", "rna_rbp"]
    assert args.profile.split(",") == ["two_tower", "rna_rbp"]
    with pytest.raises(SystemExit):
        ab.parse_args([])


def test_spec_of_each_geometry():
    """f32 output (and dy) for act_ln and the skip tail, bf16 for the heads;
    the smoke's dropout seed; no L2 output."""
    outs = [ab.spec_of(g).out_dtype for g in ab.GEOMETRIES]
    assert outs == [torch.float32, torch.bfloat16, torch.bfloat16, torch.float32,
                    torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.float32]
    assert all(ab.spec_of(g).seed == 777 and not ab.spec_of(g).l2 for g in ab.GEOMETRIES)
    assert [ab.rewrites_s(ab.spec_of(g)) for g in ab.GEOMETRIES] == [True] + [False] * 7


@pytest.mark.parametrize("geometry", ab.GEOMETRIES, ids=[g[0] for g in ab.GEOMETRIES])
def test_forward_bytes_count_each_byte_once(geometry):
    """u read and y written once; s written only where act_ln rewrites it;
    the skip rows and layer scale read once with the tail; mean, rstd,
    gamma and beta once."""
    _, B, _, N, order, _, _, skip = geometry
    spec = ab.spec_of(geometry)
    y = 4 if spec.out_dtype == torch.float32 else 2
    want = B * N * 2 + B * N * y + 2 * B * 4 + 2 * N * 4
    if order == "act_ln":  # relu: s = bf16(relu(u)) over u
        want += B * N * 2
    if skip:
        want += B * N * 2 + 4
    assert ab.work_fwd(B, N, spec, skip) == want


def test_forward_bytes_of_a_saved_pre_activation():
    """gelu and silu under act_ln keep u as the saved rows: no s written."""
    for act, rewrites in (("gelu", False), ("silu", False), ("tanh", True), ("none", False)):
        spec = ab.fd._Spec("act_ln", act, 0.0, 1, torch.bfloat16, torch.float32, False)
        assert ab.rewrites_s(spec) is rewrites
        assert ab.work_fwd(10, 16, spec, False) == 10 * 16 * (2 + 4 + 2 * rewrites) + 80 + 128


@pytest.mark.parametrize("geometry", ab.GEOMETRIES, ids=[g[0] for g in ab.GEOMETRIES])
def test_backward_bytes_count_each_byte_once(geometry):
    """saved and dy (f32 for the f32 outputs) read once, du written once;
    mean, rstd, gamma and beta read, dgamma, dbeta and db written once; the
    layer scale and dls with the skip tail."""
    _, B, _, N, _, _, _, skip = geometry
    dy = ab.spec_of(geometry).out_dtype.itemsize
    want = B * N * (2 + dy + 2) + 2 * B * 4 + 2 * N * 4 + 3 * N * 4 + (8 if skip else 0)
    assert ab.work_bwd(B, N, dy, skip, False) == want


@pytest.mark.parametrize("dy", [2, 4])
def test_backward_bytes_with_an_l2_output(dy):
    """The L2 output reads the skip rows and writes dskip (bf16), once each."""
    B, N = 7, 24
    base = B * N * (2 + dy + 2) + 2 * B * 4 + 2 * N * 4 + 3 * N * 4 + 8
    assert ab.work_bwd(B, N, dy, True, True) == base + B * N * 2 * 2


def test_bound_is_the_bytes_over_the_memory_rate():
    spec = ab.spec_of(ab.GEOMETRIES[1])  # head fc0: u and y bf16
    ms, by = ab.bound(ab.work_fwd(8192, 2048, spec, False))
    assert by == "bytes" and round(ms, 4) == 0.0201
    assert (ms, by) == chip_smoke.bound(ab.work_fwd(8192, 2048, spec, False), 0.0)


def test_ptxas_rows_reads_both_trees_row_kernels():
    rows = list(ab.ptxas_rows(PTXAS_LOG))
    assert rows == [
        {"kernel": "fwd_rows_kernel", "instance": "<8>", "registers": 96, "stack_frame": 0,
         "spill_stores": 0, "spill_loads": 0},
        {"kernel": "bwd_stats_kernel", "instance": "", "registers": 64, "stack_frame": 8,
         "spill_stores": 4, "spill_loads": 4}]


def test_profile_sums_each_trees_row_kernels(monkeypatch, capsys):
    from clip_dplm_tpu_torch.experiments import gemm_ab

    seen = []
    rows = {"other": [("void clip_dplm::fwd_rows_kernel(...)", 0.40, 8.0),
                      ("void clip_dplm::bwd_stats_kernel(...)", 0.50, 8.0),
                      ("void clip_dplm::bwd_cols_kernel(...)", 1.10, 8.0),
                      ("cutlass_gemm", 9.0, 8.0)],
            "this": [("void clip_dplm::fwd_rows_kernel<8>(...)", 0.20, 8.0),
                     ("void clip_dplm::bwd_rows_kernel<1>(...)", 0.30, 8.0)]}

    def run(tree, module, args):
        name = "this" if tree == ab.REPO else "other"
        seen.append((name, module, list(args)))
        lines = [{"kernel": k, "device_ms_per_step": ms, "launches_per_step": n}
                 for k, ms, n in rows[name]] + [{"model": "two_tower"}]
        return "\n".join(json.dumps(x) for x in lines)

    monkeypatch.setattr(gemm_ab, "_run", run)
    ab.profile_rows(ab.REPO / "build" / "parent", "two_tower")
    keys = ",".join(ab.ROW_KEYS)
    assert seen == [("other", "profile_step", ["--model", "two_tower", "--kernels", keys]),
                    ("this", "profile_step", ["--model", "two_tower", "--kernels", keys])]
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(x["tree"], round(x["rows_device_ms_per_step"], 4), x["rows_launches_per_step"])
            for x in out] == [("other", 2.0, 24.0), ("this", 0.5, 16.0)]
