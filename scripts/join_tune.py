#!/usr/bin/env python3
"""Time the hand-written sorted joins at several builds of their
constants, on one CUDA card:

    python3 scripts/join_tune.py [--reps 20] [--kernels union window]
        [--variants 256,2,8192 ...] [--window-variants 256,4,1024 ...]

union: the windowed sorted join (csrc/union_join.cu); each variant
(THREADS, QPT, SMEM entries) is compiled with nvcc -D overrides into
build/merfin_tpu_torch/tune/, checked bit-exact against the plain PyTorch
version, then timed (CUDA events, median of --reps, twice, after the
plain version) on three synthetic streams with the shapes of the port's
main paths:

  * hist: 2^20 sorted queries (89% table keys, 10% random, 1% u64::MAX)
    against 198,210,751 sorted random keys (two value columns), the
    density of a -hist dispatch on chip_smoke.py's full world;
  * compl: a block of 2^22 consecutive keys of a 198,210,751-key sorted
    set against 63,929,720 sorted random keys (one value column), a
    completeness block;
  * span: 2^23 queries holding 904 distinct table keys, ~13% u64::MAX,
    a fused variant scorer span.

window: the window join (csrc/window_join.cu); each variant (THREADS,
QPT, CHUNK keys a stage, MINB CTAs an SM) likewise, with the median of
back-to-back launches (20 between two CUDA events, as a loop of blocks
enqueues them) beside the single-call time, at its two timed shapes:

  * compl: the completeness block above;
  * ratio: 2^20 sorted queries (89% table keys, 10% random, 1% u64::MAX)
    against 2^21 sorted random keys, the table/query ratio of 2 at which
    the ratio rule still picks v1.

Prints one line per variant and shape, with the card's nvidia-smi name
and power limit, the device time of each kernel and the time the card
was busy (torch.profiler; kernels that overlap, as the window join's two
do, count once in the latter); --json PATH also writes the results
there.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


# per kernel: its source and the -D names of its variant's constants
SOURCES = {"union": ("union_join", ("MERFIN_JOIN_THREADS", "MERFIN_JOIN_QPT",
                                    "MERFIN_JOIN_SMEM")),
           "window": ("window_join", ("MERFIN_WINDOW_THREADS",
                                      "MERFIN_WINDOW_QPT",
                                      "MERFIN_WINDOW_CHUNK",
                                      "MERFIN_WINDOW_MINB"))}


def build_variant(kernel: str, variant: tuple) -> str:
    from merfin_tpu_torch.ops import _build

    src, names = SOURCES[kernel]
    out = _build.BUILD_DIR / "tune" / (
        f"lib{src}-{'-'.join(str(v) for v in variant)}.so")
    out.parent.mkdir(parents=True, exist_ok=True)
    flags = [f"-D{k}={v}" for k, v in zip(names, variant)]
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(out),
         str(_build.CSRC / f"{src}.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr)
    regs = [ln.strip() for ln in proc.stderr.splitlines()
            if "registers" in ln]
    return str(out), regs


def bind(cls, path: str):
    """A ``cls`` kernel wrapper bound to the variant library at ``path``
    (its init run, its constants read from that library)."""
    lib = ctypes.CDLL(path)
    assert getattr(lib, cls.init)() == 0
    cfg = (ctypes.c_longlong * len(cls.config_keys))()
    getattr(lib, cls.configs).argtypes = [ctypes.c_void_p]
    getattr(lib, cls.configs)(ctypes.addressof(cfg))
    k = cls()
    fn = getattr(lib, cls.symbol)
    fn.argtypes = cls.argtypes
    fn.restype = ctypes.c_int
    k._fn = fn
    k._config = dict(zip(cls.config_keys, cfg))
    return k


def bind_window(path: str):
    from merfin_tpu_torch.ops.window_join import WindowJoinKernel

    return bind(WindowJoinKernel, path)


def back_to_back_ms(fn, reps: int, k: int = 20) -> float:
    """Median over ``reps`` of the CUDA-event time of ``k`` calls enqueued
    back to back, divided by ``k``."""
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(k):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / k)
    return float(np.median(times))


def median_ms(fn, reps: int) -> float:
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def split(fn, reps: int = 10) -> str:
    """Mean device us a call of each CUDA kernel that ``fn`` launches
    (torch.profiler over ``reps`` calls), and of the time the card was
    busy (chip_smoke.device_ms: kernels that overlap count once)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import device_ms

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us:
            rows.append(f"{e.key[:40]} {us / reps:.1f} us")
    if not rows:
        return "no device time in the trace"
    return "; ".join(rows) + f"; busy {device_ms(fn, reps) * 1e3:.1f} us"


def sorted_unique_keys(n: int, gen, device):
    import torch

    k = torch.randint(0, 1 << 42, (n + n // 64,), generator=gen,
                      device=device)
    k = torch.unique(k)                       # sorted
    return k[torch.randperm(k.numel(), generator=gen, device=device)[:n]
             .sort().values]


def mixed_queries(keys, m: int, gen):
    """``m`` sorted queries: 89% table keys, 10% random mers, 1%
    u64::MAX."""
    import torch

    from merfin_tpu_torch.ops.kmer_ops import U64_MAX, bias

    dev = keys.device
    q = torch.cat([keys[torch.randint(0, keys.numel(),
                                      (m - m // 10 - m // 100,),
                                      generator=gen, device=dev)],
                   torch.randint(0, 1 << 42, (m // 10,), generator=gen,
                                 device=dev),
                   torch.full((m // 100,), U64_MAX, device=dev)])
    return bias(torch.sort(bias(q)).values)


def shapes(device, kernels):
    import torch

    from merfin_tpu_torch.ops.kmer_ops import U64_MAX, bias

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    out = {}
    keys = sorted_unique_keys(198_210_751, gen, device)
    n = keys.numel()
    vals = [torch.randint(1, 1 << 31, (n,), generator=gen, device=device,
                          dtype=torch.int32) for _ in range(2)]
    if "union" in kernels:
        out["hist"] = (keys, vals, mixed_queries(keys, 1 << 20, gen))
        pick = keys[torch.randint(0, n, (904,), generator=gen,
                                  device=device)]
        m = 1 << 23
        q = torch.cat([pick[torch.randint(0, 904, (m - m // 8,),
                                          generator=gen, device=device)],
                       torch.full((m // 8,), U64_MAX, device=device)])
        out["span"] = (keys, vals, bias(torch.sort(bias(q)).values))
    reads = keys
    mid = n // 2 - (1 << 21)
    q = reads[mid: mid + (1 << 22)].clone()
    del keys, vals, reads
    asm = sorted_unique_keys(63_929_720, gen, device)
    out["compl"] = (asm, [torch.randint(1, 1 << 31, (asm.numel(),),
                                        generator=gen, device=device,
                                        dtype=torch.int32)], q)
    if "window" in kernels:
        rk = sorted_unique_keys(1 << 21, gen, device)
        out["ratio"] = (rk, [torch.randint(1, 1 << 31, (rk.numel(),),
                                           generator=gen, device=device,
                                           dtype=torch.int32)],
                        mixed_queries(rk, 1 << 20, gen))
    return out


def tune_window(data, built, reps: int, smi: str) -> list:
    """The window-join variants at the compl and ratio shapes."""
    import torch

    from merfin_tpu_torch.ops.kmer_ops import bias
    from merfin_tpu_torch.ops.window_join import (lookup_plain, prefix_sums,
                                                  prefix_u32)

    results = []
    for name in ("compl", "ratio"):
        keys, (vals,), q = data[name]
        kb, cs, pre = bias(keys), prefix_sums(vals), prefix_u32(vals)

        def plain():
            return lookup_plain(keys, vals, q, kb, cs)

        want = plain()
        p_ms = median_ms(plain, reps)
        print(f"window {name}: {q.numel()} queries, {keys.numel()} keys; "
              f"plain {p_ms:.4f} ms", flush=True)
        for v, (path, _) in built:
            kern = bind_window(path)

            def new():
                return kern(keys, pre, q)

            got = new()
            torch.cuda.synchronize()
            ok = torch.equal(got, want)
            n_ms = median_ms(new, reps)
            n2 = median_ms(new, reps)
            b2b = back_to_back_ms(new, reps)
            print(f"  {v}: exact={ok} window {min(n_ms, n2):.4f} ms, back "
                  f"to back {b2b:.4f} ms; device time {split(new)}",
                  flush=True)
            results.append(dict(kernel="window", shape=name, variant=v,
                                exact=ok, ms=min(n_ms, n2),
                                back_to_back_ms=b2b, plain_ms=p_ms,
                                card=smi))
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", help="write the results to this file")
    ap.add_argument("--kernels", nargs="*", default=["union", "window"],
                    choices=sorted(SOURCES))
    ap.add_argument("--variants", nargs="*",
                    default=["256,1,2048", "256,2,2048", "256,4,2048",
                             "256,1,8192"])
    ap.add_argument("--window-variants", nargs="*",
                    default=["256,4,1024,8", "256,4,1024,1",
                             "256,4,512,8", "128,4,1024,16",
                             "256,2,1024,8"])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("join_tune: no CUDA device", file=sys.stderr)
        return 1
    from merfin_tpu_torch.ops.union_join import (UnionJoinKernel,
                                                 fence_index, lookup2_plain)
    from merfin_tpu_torch.ops.sorted_join import (SortedJoinKernel,
                                                  lookup_plain)
    from merfin_tpu_torch.ops.kmer_ops import bias

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    todo = [(kern, tuple(int(x) for x in v.split(",")))
            for kern, vs in (("union", args.variants),
                             ("window", args.window_variants))
            if kern in args.kernels for v in vs]
    with ThreadPoolExecutor(len(todo)) as pool:
        built = list(pool.map(lambda kv: build_variant(*kv), todo))
    for (kern, v), (_, regs) in zip(todo, built):
        print(f"{kern} variant {v}: {' | '.join(regs)}", flush=True)
    union_built = [(v, b) for (k, v), b in zip(todo, built) if k == "union"]
    window_built = [(v, b) for (k, v), b in zip(todo, built)
                    if k == "window"]
    variants = [v for v, _ in union_built]

    dev = torch.device("cuda")
    data = shapes(dev, args.kernels)
    results = []
    for name, (keys, vals, q) in data.items():
        if "union" not in args.kernels or name == "ratio":
            continue
        fences = fence_index(keys)
        kb = bias(keys)
        if len(vals) == 2:
            def plain():
                return lookup2_plain(keys, vals[0], vals[1], q, kb)
        else:
            def plain():
                return (lookup_plain(keys, vals[0], q, kb),)
        want = plain()
        p_ms = median_ms(plain, args.reps)
        print(f"{name}: {q.numel()} queries, {keys.numel()} keys; plain "
              f"{p_ms:.4f} ms", flush=True)
        for v, (path, _) in union_built:
            union = bind(UnionJoinKernel, path)
            single = bind(SortedJoinKernel, path)
            if len(vals) == 2:
                def new():
                    return union(keys, vals[0], vals[1], fences, q)
            else:
                def new():
                    return (single(keys, vals[0], fences, q),)
            got = new()
            torch.cuda.synchronize()
            ok = all(torch.equal(a, b) for a, b in zip(got, want))
            if v == variants[0]:
                print(f"  {v}: device time by kernel, {split(new)}",
                      flush=True)
            n_ms = median_ms(new, args.reps)
            n2 = median_ms(new, args.reps)
            print(f"  {v}: exact={ok} windowed {min(n_ms, n2):.4f} ms",
                  flush=True)
            results.append(dict(kernel="union", shape=name, variant=v,
                                exact=ok, ms=min(n_ms, n2), plain_ms=p_ms,
                                card=smi))
    if "window" in args.kernels:
        results += tune_window(data, window_built, args.reps, smi)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0 if all(r["exact"] for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
