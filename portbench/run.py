"""One run of one cell of the benchmark of merfin_tpu_torch:

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (``workloads/<cell>.json``) names a configuration
(``configs/<config>.json``: the deployment's sequences, k, peak, read
errors, repeats, threads) and a traffic mix (``traffic/<mix>.json``: the
mode's driver, its parameters and the limits of its checks).  The run:

1. makes the world from the seed on the card (``world.py``);
2. sets up as the CLI would for one job, with the tables built once
   (``drivers/<driver>.py``), and runs one warm pass: this is ``setup_s``,
   from the process's start to the window's start;
3. runs pass after pass of the mode's loop for ``--seconds``: the window
   runs from the first pass's start to the end of the last pass begun
   in time, and the rate is all the work of its passes over all its time;
4. with ``--trace 1``, does the same under ``torch.profiler`` with host
   spans on the layers' entry methods, and reports the per-layer metrics
   that the readers in ``metrics/`` find something to read for;
5. checks every pass's output against the plain reference
   (``reference/``), after the peak memory is read and the program's
   state is freed, and prints each compared number beside its limit.

The last line of standard output is the result's JSON.  Without a CUDA
card, or where the process has loaded JAX or the JAX package once the
window has closed, the run exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names no run may load (compared whole: the port's
# name, merfin_tpu_torch, begins with merfin_tpu)
FORBIDDEN = ("jax", "jaxlib", "flax", "merfin_tpu")
_T_IMPORT = time.perf_counter()


def process_age() -> float:
    """Seconds since this process started (the kernel's start time), or
    since this module was imported where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        age = up - start / os.sysconf("SC_CLK_TCK")
        if age >= 0:
            return age
    except (OSError, ValueError, IndexError):
        pass
    return time.perf_counter() - _T_IMPORT


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def fails(numbers: dict, limits: dict) -> bool:
    """Whether one of the compared ``numbers`` is over its limit."""
    return any(numbers[n] > limits[n] for n in limits)


def load_json(base: Path, kind: str, name: str) -> dict:
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"portbench: no {kind} file {path}")
    return json.loads(path.read_text())


def load_module(path: Path):
    name = "portbench._" + "_".join(path.relative_to(path.parents[1])
                                    .with_suffix("").parts).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own nvcc builds go to build/merfin_tpu_torch/)."""
    cache = root / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


class Context:
    """What a driver sets up with: the device, a scratch directory, the
    set-up stages' host seconds, and in a traced run the host spans and
    the joins' work."""

    def __init__(self, device, tmp: str, trace: bool):
        from portbench.spans import Spans
        from portbench.trace import JoinWork

        self.device = device
        self.tmp = tmp
        self.trace = trace
        self.stages: dict[str, float] = {}
        self.spans = Spans()
        self.joins = JoinWork() if trace else None

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Host seconds of a set-up step, ended by a device sync."""
        t = time.perf_counter()
        yield
        self.sync()
        self.stages[name] = self.stages.get(name, 0.0) + \
            time.perf_counter() - t


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", base: Path = HERE) -> dict:
    """One run of ``workload``: the result's dict (without the chip's
    look, which ``main`` makes); ``base`` is the benchmark's folder."""
    import torch

    from portbench.world import make_world

    cell = load_json(base, "workloads", workload)
    config = load_json(base, "configs", cell["config"])
    traffic = load_json(base, "traffic", cell["traffic"])
    driver = load_module(base / "drivers" / f"{traffic['driver']}.py")
    torch.set_num_threads(int(config["threads"]["torch"]))
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        ctx = Context(dev, tmp, trace)
        with ctx.stage("world_s"):
            world = make_world(config, traffic, seed, dev)
        if trace:
            ctx.joins.install()
            driver.wrap(ctx.spans)
        bench = driver.setup(ctx, world, config, traffic)
        with ctx.stage("warm_s"):
            bench.one_pass()
        bench.outputs.clear()           # the window's passes are judged
        ctx.spans.clear()
        if trace:
            ctx.joins.start_window()

        tracer = None
        if trace:
            from portbench.trace import Trace

            tracer = Trace(dev)
            tracer.__enter__()
        setup_s = process_age()
        t0 = time.perf_counter()
        passes = work = 0
        cpu_s = []          # the process's CPU seconds a pass
        while True:
            a = time.perf_counter()
            if passes and a - t0 >= seconds:
                break
            c0 = os.times()
            work += bench.one_pass()
            passes += 1
            ctx.spans.intervals.append(("pass", a, time.perf_counter()))
            c1 = os.times()
            cpu_s.append(round(c1.user + c1.system - c0.user - c0.system, 3))
        t1 = ctx.spans.intervals[-1][2]
        window_s = t1 - t0
        got = None
        if tracer is not None:
            tracer.__exit__(None, None, None)
            got = tracer.read(t0, t1, ctx.spans, base)
            ctx.joins.uninstall()
            driver.unwrap(ctx.spans)
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0

        name, unit = driver.RATE
        metrics = {}
        if not trace:
            metrics[name] = {"value": work / window_s, "unit": unit}
            metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        else:
            # what the metric readers read (portbench/readers.py)
            reading = SimpleNamespace(
                mode=traffic["driver"], cell=workload, stages=ctx.stages,
                window_s=window_s, t0=t0, t1=t1, spans=ctx.spans, trace=got,
                join_bytes=dict(ctx.joins.bytes),
                device_name=torch.cuda.get_device_name(dev)
                if dev.type == "cuda" else "cpu")
            for f in sorted((base / "metrics").glob("*.py")):
                mod = load_module(f)
                v = mod.read(reading)
                if v is not None:
                    metrics[f.stem] = {"value": v, "unit": mod.UNIT}
        counters = bench.counters()
        outputs = bench.outputs
        bench.close()
        del bench
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        t_check = time.perf_counter()
        limits = traffic["limits"]
        per_pass = driver.judge(world, outputs, traffic, dev)
        ctx.stages["check_s"] = time.perf_counter() - t_check
        compared = {n: max(c[n] for c in per_pass) for n in limits}
        failed = sum(fails(c, limits) for c in per_pass)
        correct = failed == 0
        res = {"correct": bool(correct), "attempted": passes,
               "failed": failed, "metrics": metrics,
               "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                          "kind": torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu",
                          "count": 1, "memory_peak_bytes": int(peak)}}
        if got is not None:
            res["device"]["busy_s"] = got["busy_s"]
            res["device"]["window_s"] = got["window_s"]
            top = sorted(got["by_name"].items(), key=lambda x: -x[1])[:10]
            gaps = sorted(got["idle"].items(), key=lambda x: -x[1])[:10]
            res["breakdown"] = {"device_ops": [list(x) for x in top],
                                "idle_gaps": [list(x) for x in gaps]}
        res["info"] = {"passes": passes, "window_s": window_s,
                       "pass_s": [round(b - a, 4) for k, a, b in
                                  ctx.spans.intervals if k == "pass"],
                       "pass_cpu_s": cpu_s,
                       "work": work,
                       "stages": ctx.stages, "counters": counters,
                       "threads": config["threads"]}
        if trace:
            # join calls: the warm pass's, and the window's (its passes
            # times the warm pass's where the passes repeat the calls)
            res["info"]["join_calls"] = {
                j: [len(ctx.joins.recorded[j]), ctx.joins.calls[j]]
                for j in ctx.joins.JOINS}
        res["compared"] = {n: {"value": compared[n], "limit": limits[n]}
                           for n in limits}
        return res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = load_json(HERE, "workloads", args.workload)
    config = load_json(HERE, "configs", cell["config"])
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = str(config["threads"]["torch"])
    set_cache_dirs(ROOT)
    import torch

    need = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: needs {need} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    info = res.pop("info")
    print("portbench: " + json.dumps(info), file=sys.stderr)
    for n, c in res["compared"].items():
        print(f"portbench: compared {n} = {c['value']!r} (limit "
              f"{c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
