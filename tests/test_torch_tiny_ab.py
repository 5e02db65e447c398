"""The A/B harness of the tiny-S attention pair (`experiments/tiny_ab.py`) on
the CPU: its arguments (`--variant` included), its shapes (`chip_smoke.py`'s
phase 9a), the work and bound it prints beside each time (each byte counted
once; the products at the rate of their input type), its reading of ptxas's
report for both trees' kernels (template instances and the parent's plain
kernels), and how its profile picks each tree's tiny kernels. Needs no
card."""

import json

import pytest

import chip_smoke
from clip_dplm_tpu_torch.experiments import tiny_ab

PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN9clip_dplm12_GLOBAL__N_120tiny_attn_fwd_kernelILi1EEEvNS0_8TinyArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN9clip_dplm12_GLOBAL__N_120tiny_attn_fwd_kernelILi1EEEvNS0_8TinyArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers, 456 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN9clip_dplm12_GLOBAL__N_120tiny_attn_bwd_kernelILi3EEEvNS0_8TinyArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN9clip_dplm12_GLOBAL__N_120tiny_attn_bwd_kernelILi3EEEvNS0_8TinyArgsE
    16 bytes stack frame, 12 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 456 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN9clip_dplm12_GLOBAL__N_120tiny_attn_fwd_kernelEPK13__nv_bfloat16PKhPS1_iiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN9clip_dplm12_GLOBAL__N_120tiny_attn_fwd_kernelEPK13__nv_bfloat16PKhPS1_iiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 46 registers, 400 bytes cmem[0]
"""


def test_shapes_are_the_smoke_phase_9a_shapes():
    assert tiny_ab.SHAPES == chip_smoke.TINY_SHAPES
    assert [s[:2] for s in tiny_ab.SHAPES] == [(4096, 10), (1000, 33), (8192, 8)]
    assert {(s[2], s[3]) for s in tiny_ab.SHAPES} == {(512, 8)}
    assert [s[4] for s in tiny_ab.SHAPES] == [False, True, False]


def test_arguments():
    args = tiny_ab.parse_args(["--other", "build/parent"])
    assert (str(args.other), args.rounds, args.variant, args.steps, args.profile) == (
        "build/parent", 2, None, "", "")
    args = tiny_ab.parse_args(["--other", ".", "--rounds", "3", "--variant", "copy", "--steps",
                               "tf_clip", "--profile", "tf_clip"])
    assert (args.rounds, args.variant, args.steps, args.profile) == (3, "copy", "tf_clip",
                                                                     "tf_clip")
    assert tiny_ab.parse_args(["--other", ".", "--variant", "nosplit"]).variant == "nosplit"
    assert tiny_ab.VARIANTS == {"copy": 1, "nosplit": 2}
    for bad in ([], ["--other", ".", "--variant", "other"]):
        with pytest.raises(SystemExit):
            tiny_ab.parse_args(bad)


@pytest.mark.parametrize("masked", [False, True])
def test_work_counts_each_byte_once(masked):
    """Forward: qkv (3D) and the mask in, o (D) out; two (S, S, Dh) products
    a head on bf16 inputs. Backward: qkv, o, dO and the mask in, dqkv out;
    four products on bf16 inputs and dV on the f32 probabilities."""
    B, S, D = 7, 5, 64
    mask = B * S if masked else 0
    pair = 2 * B * S * S * D
    assert tiny_ab.work("tiny_attention_fwd", B, S, D, masked) == (
        B * S * (3 * D + D) * 2 + mask, {"bf16": 2 * pair})
    assert tiny_ab.work("tiny_attention_bwd", B, S, D, masked) == (
        B * S * (3 * D + D + D) * 2 + mask + B * S * 3 * D * 2, {"bf16": 4 * pair, "f32": pair})


@pytest.mark.parametrize("entry,B,S,masked,ms", [
    ("tiny_attention_fwd", 4096, 10, False, 0.0501), ("tiny_attention_bwd", 4096, 10, False, 0.1002),
    ("tiny_attention_fwd", 1000, 33, True, 0.0404), ("tiny_attention_bwd", 1000, 33, True, 0.0807),
    ("tiny_attention_fwd", 8192, 8, False, 0.0801), ("tiny_attention_bwd", 8192, 8, False, 0.1603)])
def test_bound_at_the_smoke_shapes_is_bytes(entry, B, S, masked, ms):
    """Every smoke shape is bound by its bytes once the products count at the
    rate of their input type (the S=33 backward was 0.0832 ms of f32
    operations when all five products counted at the f32 rate); the smoke's
    bound for the same work is the same."""
    work = tiny_ab.work(entry, B, S, 512, masked)
    bound_ms, by = tiny_ab.bound(*work)
    assert by == "bytes" and round(bound_ms, 4) == ms
    assert (bound_ms, by) == chip_smoke.bound(*work)


def test_bound_sums_the_operations_of_each_type():
    assert tiny_ab.bound(0, {"bf16": 989e9, "f32": 67e9}) == (2.0, "operations")
    assert chip_smoke.bound(0, {"bf16": 989e9, "f32": 67e9}) == (2.0, "operations")
    assert chip_smoke.bound(0, 67e9, "f32") == (1.0, "operations")


def test_ptxas_summary_reads_templates_and_plain_kernels():
    fwd = list(tiny_ab.ptxas_summary(PTXAS_LOG, "tiny_attn_fwd_kernel"))
    assert fwd == [{"instance": "<1>", "registers": 90, "stack_frame": 0, "spill_stores": 0,
                    "spill_loads": 0},
                   {"instance": "<>", "registers": 46, "stack_frame": 0, "spill_stores": 0,
                    "spill_loads": 0}]
    bwd = list(tiny_ab.ptxas_summary(PTXAS_LOG, "tiny_attn_bwd_kernel"))
    assert bwd == [{"instance": "<3>", "registers": 168, "stack_frame": 16, "spill_stores": 12,
                    "spill_loads": 12}]
    assert tiny_ab.instance_of(bwd, 33) == bwd[0]
    assert tiny_ab.instance_of(bwd, 10) is None
    assert tiny_ab.instance_of(fwd, 10) == fwd[0]
    assert tiny_ab.instance_of(fwd[1:], 64)["instance"] == "<>"


def test_profile_sums_each_trees_tiny_kernels(monkeypatch, capsys):
    from clip_dplm_tpu_torch.experiments import gemm_ab

    seen = []
    rows = {"other": [("void clip_dplm::(anonymous namespace)::tiny_attn_fwd_kernel(...)", 0.5, 3.0),
                      ("void clip_dplm::(anonymous namespace)::tiny_attn_bwd_kernel(...)", 1.0, 3.0),
                      ("cutlass_gemm", 9.0, 8.0)],
            "this": [("void clip_dplm::(anonymous namespace)::tiny_attn_fwd_kernel<1>(...)", 0.2, 3.0),
                     ("void clip_dplm::(anonymous namespace)::tiny_attn_bwd_kernel<1>(...)", 0.4, 3.0)]}

    def run(tree, module, args):
        name = "this" if tree == tiny_ab.REPO else "other"
        seen.append((name, module, list(args)))
        lines = [{"kernel": k, "device_ms_per_step": ms, "launches_per_step": n}
                 for k, ms, n in rows[name]] + [{"model": "tf_clip", "device_busy_ms_per_step": 50}]
        return "\n".join(json.dumps(x) for x in lines)

    monkeypatch.setattr(gemm_ab, "_run", run)
    tiny_ab.profile_tiny(tiny_ab.REPO / "build" / "parent", "tf_clip")
    keys = ",".join(tiny_ab.KERNELS)
    assert seen == [("other", "profile_step", ["--model", "tf_clip", "--kernels", keys]),
                    ("this", "profile_step", ["--model", "tf_clip", "--kernels", keys])]
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [(x["tree"], round(x["tiny_device_ms_per_step"], 4), x["tiny_launches_per_step"],
             x["summary"]["device_busy_ms_per_step"]) for x in out] == [
        ("other", 1.5, 6.0, 50), ("this", 0.6, 6.0, 50)]
