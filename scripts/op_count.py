#!/usr/bin/env python3
"""Count a benchmark cell's launches a frame by frame-graph stage, on the
CPU at a test size, without a card.

Builds the cell as port_bench/run.py does (open_cell) at --width x
--height with port_bench/tests/_small.py's cut, renders --frames frames
of its traffic with RenderTimings on, and counts under a
TorchDispatchMode every ATen op that launches a kernel on a card (views,
allocations and host scalars count none) and every hand-kernel wrapper
as one launch, whatever its CPU twin runs inside. Each count goes to the
innermost RenderTimings span open. Prints the counts a frame by stage
and, with --by-op, the ops of one stage.

    python3 scripts/op_count.py --workload helmet-ibl.orbit [--seed 5]
        [--width 256] [--height 128] [--frames 2] [--repo DIR]
        [--by-op render_frame/shade]

--repo counts another checkout's program (say, a parent commit unpacked
with git archive); the harness comes from that checkout too.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the functions that launch a hand kernel on the card (a CPU tensor
# takes their twins)
WRAPPERS = ("rasterize16_slim", "rasterize16_msaa", "rasterize_binned",
            "_rasterize_binned_compact", "_rasterize_dense",
            "resolve_planes_fused", "onehot_split_rows",
            "gather_split_channels", "gather_split_channels_f32",
            "split_rows", "channel_rows", "tap_plan_fused",
            "filter_taps_fused", "reproject_history_planes",
            "shade_surface_fused", "vertex_stage")
# ops that launch no kernel on the card
FREE = {"empty", "empty_like", "empty_strided", "new_empty",
        "new_empty_strided", "_local_scalar_dense", "lift_fresh",
        "scalar_tensor", "is_nonzero", "equal", "sym_size", "sym_stride",
        "sym_numel", "set_", "resize_", "record_stream"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--by-op", default=None)
    args = ap.parse_args()
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, os.path.join(repo, "port_bench", "tests"))
    sys.path.insert(0, repo)

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from _small import small
    from awsm_renderer_tpu_torch.utils import profiling
    from port_bench import run

    torch.set_num_threads(2)
    stack = ["(none)"]
    inside = [0]
    counts = collections.Counter()
    ops = collections.Counter()

    enter, exit_ = profiling._Span.__enter__, profiling._Span.__exit__

    def span_enter(self):
        stack.append(self.name)
        return enter(self)

    def span_exit(self, *a):
        stack.pop()
        return exit_(self, *a)

    profiling._Span.__enter__, profiling._Span.__exit__ = (span_enter,
                                                           span_exit)

    def counted(fn):
        def wrapped(*a, **kw):
            if not inside[0]:
                counts[stack[-1]] += 1
                ops[(stack[-1], fn.__name__)] += 1
            inside[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                inside[0] -= 1
        return wrapped

    def patch_wrappers():
        mods = [m for n, m in list(sys.modules.items())
                if n.startswith("awsm_renderer_tpu_torch") and m]
        originals = {}
        for m in mods:
            for name in WRAPPERS:
                fn = getattr(m, name, None)
                if callable(fn) and getattr(fn, "__name__", "") == name:
                    originals.setdefault(fn, counted(fn))
        for m in mods:
            for attr, val in list(vars(m).items()):
                if callable(val) and val in originals:
                    setattr(m, attr, originals[val])

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            view = any(r.alias_info is not None and not r.alias_info.is_write
                       for r in func._schema.returns)
            if not inside[0] and not view and name not in FREE:
                counts[stack[-1]] += 1
                ops[(stack[-1], name)] += 1
            return out

    _w, _cfg, _mix, _scene, r, drv = run.open_cell(
        args.workload, args.seed, torch.device("cpu"),
        edit_cfg=lambda c, m: small(c, m, args.width, args.height))
    patch_wrappers()
    r.logging_timings = True
    r.timings = profiling.RenderTimings(enabled=True, device="cpu")
    drv.step(0)                                 # one frame unmeasured
    counts.clear()
    ops.clear()
    with Count():
        for i in range(args.frames):
            drv.step(1 + i)
    n = args.frames
    total = sum(counts.values()) / n
    print(f"== {args.workload} at {args.width}x{args.height}, {repo}: "
          f"{total:.1f} launches a frame")
    for k, v in counts.most_common():
        print(f"  {k}: {v / n:.1f}")
    if args.by_op:
        print(f"-- {args.by_op} by op")
        for (stage, name), v in ops.most_common():
            if stage == args.by_op:
                print(f"  {name}: {v / n:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
