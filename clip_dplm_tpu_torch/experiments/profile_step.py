"""Where the time of one train step goes on the card:
`python -m clip_dplm_tpu_torch.experiments.profile_step [--model
two_tower|two_tower_cached|rna_rbp|esm_clip|tf_clip|triple_flow|dplm]
[-o a.b=c ...] [--kernels KEY,...]`.

Builds the configuration, batch and warmed-up step of
`experiments/bench.py` (`build_step`, at the model's default batch), then:
- times STEPS steps one by one on the host clock, each ended by a
  synchronize, with the host's enqueue time (the step's return, before the
  synchronize) beside it;
- profiles as many steps with torch.profiler (CPU and CUDA activities) and
  prints the device busy share (the kernels' summed device time over the
  profiled wall time) and the TOP operators and kernels that take the most
  device time, per step, and with `--kernels` every other kernel whose name
  holds one of the keys;
- prints, for every range the port traces with
  `torch.profiler.record_function`, its host time per step and the device
  time and launches of the kernels enqueued inside it (today triple_flow's
  exact-OT pairings: `ot.hungarian_pairing` from the copy of the cost,
  which waits for the card, to the assignment's return, and the solve
  alone, `ot.linear_sum_assignment`; and `gnn.edge_update`, the PiGNN's
  edge-state update, whose output no loss reads); the ranges' device-side
  annotations are left out of the kernels and the busy time.
Prints JSON lines; the last is the summary. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

STEPS = 5  # steps timed one by one, then as many profiled
TOP = 25  # operators and kernels listed


def _device_us(evt) -> float:
    """Self device time of a profiler event, in microseconds, under either
    of torch's attribute names."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _launched(evt) -> list:
    """The kernels launched by a host event and the host ops under it (the
    profiler's `kernels` of each, durations in microseconds)."""
    out = list(evt.kernels)
    for child in evt.cpu_children:
        out += _launched(child)
    return out


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    from clip_dplm_tpu_torch.experiments.bench import MODELS

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", choices=sorted(MODELS), default="two_tower")
    p.add_argument("--override", "-o", action="append", default=[])
    p.add_argument("--kernels", default="",
                   help="also list the kernels whose names hold one of these comma-separated keys")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the profile runs the CUDA kernels: it needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from clip_dplm_tpu_torch.experiments.bench import MODELS, build_step

    device = torch.device("cuda", torch.cuda.current_device())
    B = MODELS[args.model][1]
    _, state, batch, step = build_step(args.model, B, args.override, device)

    walls, enqueues = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        enqueues.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize(device)
        walls.append((time.perf_counter() - t0) * 1e3)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state, _ = step(state, batch)
        torch.cuda.synchronize(device)
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # the port's host ranges (every `record_function`); their device-side
    # annotations are no kernels
    ranges: Dict[str, list] = {}
    for e in prof.events():
        if e.is_user_annotation and e.device_type == torch.autograd.DeviceType.CPU:
            launched = _launched(e)
            entry = ranges.setdefault(e.name, [0.0, 0, 0.0, 0])
            entry[0] += e.time_range.elapsed_us()
            entry[1] += 1
            entry[2] += sum(k.duration for k in launched)
            entry[3] += len(launched)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation and e.name not in ranges]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    per_step = lambda us: round(us / 1e3 / STEPS, 4)  # noqa: E731
    ops = sorted((e for e in events if e.key.startswith("aten::") and _device_us(e) > 0),
                 key=_device_us, reverse=True)[:TOP]
    for e in ops:
        print(json.dumps({"op": e.key, "device_ms_per_step": per_step(_device_us(e)),
                          "calls_per_step": e.count / STEPS}))
    by_kernel: Dict[str, list] = {}
    for e in kernels:
        entry = by_kernel.setdefault(e.name[:120], [0.0, 0])
        entry[0] += e.time_range.elapsed_us()
        entry[1] += 1
    keys = [k for k in args.kernels.split(",") if k]
    for i, (name, (us, n)) in enumerate(sorted(by_kernel.items(), key=lambda kv: -kv[1][0])):
        if i >= TOP and not any(k in name for k in keys):
            continue
        print(json.dumps({"kernel": name, "device_ms_per_step": per_step(us),
                          "launches_per_step": n / STEPS}))
    for key, (us, n, dev_us, launches) in ranges.items():
        print(json.dumps({"range": key, "host_ms_per_step": per_step(us),
                          "calls_per_step": n / STEPS, "device_ms_per_step": per_step(dev_us),
                          "launches_per_step": launches / STEPS}))
    out = {
        "model": args.model, "batch": B, "steps": STEPS,
        "step_ms_median": float(np.median(walls)), "step_ms": walls,
        "enqueue_ms_median": float(np.median(enqueues)),
        "profiled_wall_ms_per_step": round(prof_wall_ms / STEPS, 4),
        "device_busy_ms_per_step": round(busy_ms / STEPS, 4),
        "device_busy_share": round(busy_ms / prof_wall_ms, 4),
        "kernel_launches_per_step": len(kernels) / STEPS,
        "host_ranges_ms_per_step": {k: per_step(v[0]) for k, v in ranges.items()},
        "device": torch.cuda.get_device_name(device),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
