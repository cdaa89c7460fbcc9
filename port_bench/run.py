#!/usr/bin/env python3
"""Benchmark of awsm_renderer_tpu_torch, the renderer's PyTorch + CUDA
port, on NVIDIA cards.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
                              --trace <0|1>

run from the root of a checkout. A cell is "<config>.<mix>" as
BENCHMARK.json names it: the scene of configs/<config>.json (built by
configs/<config>.py from the seed), driven by the traffic of
traffic/<mix>.json, whose "driver" names the module of drivers/ that
turns it into frames. A closed loop: a frame is the driver's step (its
input, such as a camera move, and the render_device() call), then a
synchronize (the image is ready to present); the next starts when it
has finished.

--trace 0 prints the end-to-end metrics (frame_ms, frame_ms_p95,
peak_mem_mib, setup_s); --trace 1 the per-layer metrics, each read by
metrics/<name>.py from the traced run's records (the program's
RenderTimings spans and launch counters, host syncs, a torch.profiler
trace of a few frames). Either way, once the window has closed the plain
reference (reference/) renders frames drawn from the seed and `correct`
says whether the program's images held to it (check.py).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and breakdown with --trace 1), then the
compared numbers beside their limits. No card, or fewer than the cell
asks for: exit 3 and no result.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import inspect
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "awsm_renderer_tpu")
PROFILED_FRAMES = 8
SYNC_FRAMES = 2


def process_start() -> float:
    """Wall-clock time this process started (Linux /proc), else now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()


def _caches_in_checkout() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def _few_threads() -> None:
    """One process, few threads: the host's dispatch is one Python thread,
    and idle worker pools only add jitter to it. (Pinning the process to
    one core was slower and no steadier on an H100 machine's 8-core host:
    93-108 against 82-99 ms a colonnade frame in alternating runs.)"""
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = "1"


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ident(name: str) -> str:
    return "port_bench_" + "".join(c if c.isalnum() else "_" for c in name)


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(workload: str, bench: dict | None = None):
    """(workload entry, configuration dict, mix dict, config module)."""
    bench = bench or manifest()
    w = next((x for x in bench["workloads"] if x["name"] == workload), None)
    if w is None:
        raise SystemExit(f"unknown workload {workload!r}")
    with open(os.path.join(HERE, "configs", w["config"] + ".json")) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "traffic", w["traffic"] + ".json")) as f:
        mix = json.load(f)
    mod = load_module(os.path.join(HERE, "configs", w["config"] + ".py"),
                      _ident("config_" + w["config"]))
    return w, cfg, mix, mod


def driver(mix: dict, scene, seed: int, renderer=None, render=None):
    """The mix's driver (drivers/<mix["driver"]>.py), bound to the
    renderer and its entry when they are given."""
    name = mix["driver"]
    mod = load_module(os.path.join(HERE, "drivers", name + ".py"),
                      _ident("driver_" + name))
    return mod.make(mix, scene, seed, renderer, render)


def readers(names):
    return {n: load_module(os.path.join(HERE, "metrics", n + ".py"),
                           _ident("metric_" + n)) for n in names}


def forbidden_loaded():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def sizes_of(scene) -> dict:
    st = scene.settings
    return dict(pixels=int(st["width"]) * int(st["height"]),
                samples=4 if st.get("msaa") else 1,
                tri_opaque=scene.triangles(transparent=False),
                tri_transparent=scene.triangles(transparent=True),
                slots=scene.opaque_slots(),
                normal_map=any("normal" in scene.materials[m.material].textures
                               for m in scene.meshes if not m.transparent),
                transparent=scene.triangles(transparent=True) > 0)


class Frame:
    """What a wrap of faults.py reads besides the renderer and the scene:
    the configuration's reference class, and what the driver says the
    window's frame now being stepped shows (None outside the window)."""

    def __init__(self, reference):
        self.reference = reference
        self.drv = None
        self.i = None

    def shown(self):
        return None if self.i is None else self.drv.shown(self.i)


def reference_of(mod):
    """The configuration's own reference class (its module's `Reference`),
    else the shared one."""
    if hasattr(mod, "Reference"):
        return mod.Reference
    from port_bench.reference.render import Reference

    return Reference


def open_cell(workload: str, seed: int, dev, bench: dict | None = None,
              edit_cfg=None, wrap=None):
    """Set-up of a run: the scene from the seed, handed to the program,
    the mix's driver, its warm-up rendered. Returns (entry, cfg, mix,
    scene, renderer, driver); the driver renders through the renderer's
    entry, or through wrap(renderer, scene), which is handed the run's
    Frame too where it takes a keyword `frame`."""
    return _open(workload, seed, dev, bench, edit_cfg, wrap)[:6]


def _open(workload, seed, dev, bench, edit_cfg, wrap):
    from port_bench import program

    w, cfg, mix, mod = cell(workload, bench)
    if edit_cfg is not None:
        edit_cfg(cfg, mix)
    scene = mod.build_scene(cfg, seed)
    workdir = os.path.join(ROOT, "build", "port_bench")
    os.makedirs(workdir, exist_ok=True)
    if hasattr(mod, "load_program"):
        r = mod.load_program(scene, dev, workdir)
    else:
        r = program.load(scene, dev)
    frame = Frame(reference_of(mod))
    if wrap is None:
        render = r.render_device
    elif "frame" in inspect.signature(wrap).parameters:
        render = wrap(r, scene, frame=frame)
    else:
        render = wrap(r, scene)
    drv = frame.drv = driver(mix, scene, seed, r, render)
    drv.warmup()
    return w, cfg, mix, scene, r, drv, frame


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", bench: dict | None = None,
             edit_cfg=None, wrap=None, log=None) -> dict:
    """One run of a cell; returns the result object. edit_cfg(cfg, mix)
    may change the configuration and the mix (tests run them small on
    the CPU); wrap(r, scene[, frame=]) may replace the renderer's entry
    (faults.py: the planted faults and the control)."""
    import torch

    from port_bench import check, window
    from port_bench import trace as tr

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = bench or manifest()
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    w, cfg, mix, scene, r, drv, frame = _open(workload, seed, dev, bench,
                                              edit_cfg, wrap)
    workdir = os.path.join(ROOT, "build", "port_bench")

    sync()
    ck = cfg["check"]
    H, W = int(scene.settings["height"]), int(scene.settings["width"])
    shown = check.Reservoir(seed, int(ck["frames"]), (H, W, 4), cuda)
    if trace:
        from awsm_renderer_tpu_torch.ops import kernels

        r.logging_timings = True
        launches0 = dict(kernels.launch_counts)
    sync()
    # what set-up made lives on: keep the collector from walking it
    gc.collect()
    gc.freeze()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - T_START

    # ---- the window: closed loop, every frame to its synchronize --------
    finishes, durations, host_s = [], [], []
    i = 0
    t_open = time.perf_counter()
    t_close = t_open + seconds
    while True:
        ts = time.perf_counter()
        if ts >= t_close:
            break
        take = shown.wants(i)
        frame.i = i
        out = drv.step(i)
        th = time.perf_counter()
        if take:
            shown.copy(out, non_blocking=cuda)
        sync()
        te = time.perf_counter()
        if te > t_close:
            i += 1
            break
        if take:
            shown.keep(i)
        finishes.append(te)
        durations.append(te - ts)
        host_s.append(th - ts)
        i += 1
    attempted = i
    frame.i = None
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    metrics, extra_device, breakdown = {}, {}, None
    if not trace:
        e2e = {"frame_ms": window.frame_ms(t_open, finishes),
               "frame_ms_p95": window.percentile_ms(durations, 95.0),
               "peak_mem_mib": peak / 2 ** 20, "setup_s": setup_s}
        for m in bench["end_to_end"]:
            if m["name"] in e2e and w["name"] in m.get("workloads",
                                                       [w["name"]]):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    else:
        spans_host = r.timings.summary()
        spans_device = r.timings.device_summary()
        launches = {k: v - launches0.get(k, 0)
                    for k, v in kernels.launch_counts.items()}
        syncs, prof = [], None
        if cuda:
            syncs = [tr.count_syncs(lambda j=j: drv.step(i + j))
                     for j in range(SYNC_FRAMES)]
            i += SYNC_FRAMES

            def traced(j):
                from torch.profiler import record_function

                with record_function("bench/step"):
                    drv.step(i + j)
                with record_function("bench/sync"):
                    sync()

            # the spans stay on: their ranges label the idle gaps
            prof = tr.profile_frames(traced, PROFILED_FRAMES,
                                     os.path.join(workdir, "trace.json"))
            extra_device = {"busy_s": prof["busy_s"],
                            "window_s": prof["window_s"]}
            breakdown = {"device_ops": [list(x) for x in prof["device_ops"][:10]],
                         "idle_gaps": [list(x) for x in
                                       prof["idle_by_range"][:10]]}
        # the program's counters over every frame timed so far: the
        # window's, the sync frames' and the profiled ones
        n_timed = len(r.timings.frames)
        counts = ({k: v / n_timed for k, v in r.timings.counts.items()}
                  if n_timed else None)
        r.logging_timings = False
        rec = dict(frames=len(finishes), host_render_s=host_s,
                   spans_host=spans_host, spans_device=spans_device,
                   launches=launches, syncs=syncs, profile=prof,
                   sizes=sizes_of(scene), counts=counts)
        wanted = [m for m in bench["per_layer"]
                  if w["name"] in m.get("workloads", [w["name"]])]
        for name, rd in readers([m["name"] for m in wanted]).items():
            v = rd.read(rec)
            if v is not None:
                unit = next(m["unit"] for m in wanted if m["name"] == name)
                metrics[name] = {"value": float(v), "unit": unit}

    # ---- correctness, once the window has closed and the program is freed
    held = shown.frames()
    picks = [p for p, _ in held]
    frames = [drv.shown(p) for p in picks]
    reference = frame.reference
    del r, drv, out, frame
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    per_frame = []
    refs = check.render_reference(frames, dev, reference=reference)
    for (_, img), ref in zip(held, refs):
        per_frame.append(check.compare(img.to(dev), ref,
                                       float(ck["pixel_tol"])))
    limits = ck["limits"]
    ok, worst, failed = check.judge(per_frame, limits)
    compared = {n: {"value": worst[n], "limit": limits.get(n)}
                for n in check.NAMES}
    for n in check.NAMES:
        log(f"check {n}: {worst[n]!r} (limit {limits.get(n)!r}; frames "
            f"{picks}: {[f[n] for f in per_frame]})")
    result = {"correct": ok, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": (torch.cuda.get_device_name(dev) if cuda
                                  else "cpu"),
                         "count": int(w["chips"]),
                         "memory_peak_bytes": int(peak), **extra_device}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = compared
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches_in_checkout()
    _few_threads()
    sys.path.insert(0, ROOT)
    bench = manifest()
    w, _cfg, _mix, _mod = cell(args.workload, bench)

    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(w["chips"]):
        print(f"no result: the cell needs {w['chips']} CUDA card(s), "
              f"this host has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), bench=bench)
    bad = forbidden_loaded()
    if bad:
        print(f"no result: the process loaded {bad}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
