"""The recompute mode of the short-S attention's A/B harness
(`experiments/short_ab.py --bwd --recompute`) on the CPU: its shapes run the
designs its rows name (the one-block kernel at S <= 128, among them the
flagship's and DPLM's training shapes, and the WMMA head kernel at S = 200),
and the bench step it runs in each checkout takes the recompute mode at a
shape where the JAX size rule saves. Needs no card."""

import sys

import pytest

from clip_dplm_tpu_torch.experiments import bench
from clip_dplm_tpu_torch.experiments import short_ab
from clip_dplm_tpu_torch.ops import short_attention as sa


@pytest.mark.parametrize("name,B,S,D,H,entry", short_ab.BWD_RECOMPUTE_SHAPES)
def test_recompute_shapes_run_the_design_they_name(name, B, S, D, H, entry):
    want = "head" if "head kernel" in name else "one block"
    assert sa.bwd_recompute_design(S, D // H) == want
    assert S <= 128 or want != "one block"


def test_recompute_shapes_cover_the_main_paths():
    shapes = {(B, S, D, H, entry) for _, B, S, D, H, entry in short_ab.BWD_RECOMPUTE_SHAPES}
    assert {(1024, 128, 512, 8, "sep"), (1024, 128, 512, 8, "packed"),
            (256, 128, 640, 10, "packed rope")} <= shapes


def test_recompute_bench_pins_the_rule(monkeypatch):
    """The snippet each checkout runs: bench.main sees saves_probs False at
    the flagship's B=1024, where the rule itself saves, and the snippet
    prints the step time as its last line."""
    seen = []
    monkeypatch.setattr(sa, "saves_probs", sa.saves_probs)  # restored after the test
    assert sa.saves_probs(1024, 128, 8)

    def fake_main(argv):
        seen.append((list(argv), sa.saves_probs(1024, 128, 8)))
        return {"step_ms": 1.5}

    monkeypatch.setattr(bench, "main", fake_main)
    monkeypatch.setattr(sys, "argv", ["-c", "--model", "rna_rbp"])
    printed = []
    monkeypatch.setattr("builtins.print", lambda *a, **k: printed.append(" ".join(map(str, a))))
    exec(compile(short_ab._RECOMPUTE_BENCH, "<recompute bench>", "exec"), {})
    assert seen == [(["--model", "rna_rbp"], False)]
    assert printed[-1] == '{"step_ms": 1.5}'


@pytest.mark.parametrize("name,B,S,D,H", short_ab.CLS_SHAPES)
def test_cls_shapes_run_the_design_they_name(name, B, S, D, H):
    """`short_ab --cls`: every shape up to S=256 runs the group design, the
    one past the cut the row design, as its name says."""
    want = "row" if "past" in name else "group"
    assert sa.cls_bwd_design(S, D, H) == want
    assert (S > sa.CLS_GROUP_MAX) == (want == "row")


def test_cls_shapes_cover_the_flagship_and_the_cut():
    shapes = {(B, S, D, H) for _, B, S, D, H in short_ab.CLS_SHAPES}
    assert {(1024, 128, 512, 8), (1000, 65, 512, 8), (1024, 64, 512, 8)} <= shapes
    assert any(S == sa.CLS_GROUP_MAX + 1 for _, S, _, _ in shapes)
