#!/usr/bin/env python3
"""Time the windowed sorted join (csrc/union_join.cu) at several builds of
its constants, on one CUDA card:

    python3 scripts/join_tune.py [--reps 20] [--variants 256,2,8192 ...]

Each variant (THREADS, QPT, SMEM entries) is compiled with nvcc -D
overrides into build/merfin_tpu_torch/tune/ and checked bit-exact against
the plain PyTorch version, then timed (CUDA events, median of --reps, in
turns with the plain version and the earlier binary search) on three
synthetic streams with the shapes of the port's main paths:

  * hist: 2^20 sorted queries (89% table keys, 10% random, 1% u64::MAX)
    against 198,210,751 sorted random keys (two value columns), the
    density of a -hist dispatch on chip_smoke.py's full world;
  * compl: a block of 2^22 consecutive keys of a 198,210,751-key sorted
    set against 63,929,720 sorted random keys (one value column), a
    completeness block;
  * span: 2^23 queries holding 904 distinct table keys, ~13% u64::MAX,
    a fused variant scorer span.

Prints one line per variant and shape, with the card's nvidia-smi name
and power limit, and the device time of each kernel of the first variant
(torch.profiler); --json PATH also writes the results there.
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


def build_variant(threads: int, qpt: int, smem: int) -> str:
    from merfin_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "tune" / f"libjoin-{threads}-{qpt}-{smem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    flags = [f"-DMERFIN_JOIN_THREADS={threads}", f"-DMERFIN_JOIN_QPT={qpt}",
             f"-DMERFIN_JOIN_SMEM={smem}"]
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(out),
         str(_build.CSRC / "union_join.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr)
    regs = [ln.strip() for ln in proc.stderr.splitlines()
            if "registers" in ln]
    return str(out), regs


def bind(path: str):
    """(union, sorted) wrappers bound to the library at ``path``."""
    from merfin_tpu_torch.ops.sorted_join import SortedJoinKernel
    from merfin_tpu_torch.ops.union_join import UnionJoinKernel

    lib = ctypes.CDLL(path)
    assert lib.merfin_join_init() == 0
    cfg = (ctypes.c_longlong * 4)()
    lib.merfin_join_config.argtypes = [ctypes.c_void_p]
    lib.merfin_join_config(ctypes.addressof(cfg))
    kerns = []
    for cls in (UnionJoinKernel, SortedJoinKernel):
        k = cls()
        fn = getattr(lib, cls.symbol)
        fn.argtypes = cls.argtypes
        fn.restype = ctypes.c_int
        k._fn = fn
        k._config = dict(zip(
            ("tile", "fence", "smem", "fences_per_query"), cfg))
        kerns.append(k)
    return kerns


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
    (torch.profiler over ``reps`` calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    return "; ".join(rows) or "no device time in the trace"


def sorted_unique_keys(n: int, gen, device):
    import torch

    k = torch.randint(0, 1 << 42, (n + n // 64,), generator=gen,
                      device=device)
    k = torch.unique(k)                       # sorted
    return k[torch.randperm(k.numel(), generator=gen, device=device)[:n]
             .sort().values]


def shapes(device):
    import torch

    from merfin_tpu_torch.ops.kmer_ops import U64_MAX, bias

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    out = {}
    keys = sorted_unique_keys(198_210_751, gen, device)
    n = keys.numel()
    vals = [torch.randint(1, 1 << 31, (n,), generator=gen, device=device,
                          dtype=torch.int32) for _ in range(2)]
    m = 1 << 20
    q = torch.cat([keys[torch.randint(0, n, (m - m // 10 - m // 100,),
                                      generator=gen, device=device)],
                   torch.randint(0, 1 << 42, (m // 10,), generator=gen,
                                 device=device),
                   torch.full((m // 100,), U64_MAX, device=device)])
    out["hist"] = (keys, vals, bias(torch.sort(bias(q)).values))
    pick = keys[torch.randint(0, n, (904,), generator=gen, device=device)]
    m = 1 << 23
    q = torch.cat([pick[torch.randint(0, 904, (m - m // 8,), generator=gen,
                                      device=device)],
                   torch.full((m // 8,), U64_MAX, device=device)])
    out["span"] = (keys, vals, bias(torch.sort(bias(q)).values))
    reads = keys
    mid = n // 2 - (1 << 21)
    q = reads[mid: mid + (1 << 22)].clone()
    asm = sorted_unique_keys(63_929_720, gen, device)
    out["compl"] = (asm, [torch.randint(1, 1 << 31, (asm.numel(),),
                                        generator=gen, device=device,
                                        dtype=torch.int32)], q)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", help="write the results to this file")
    ap.add_argument("--variants", nargs="*",
                    default=["256,1,2048", "256,2,2048", "256,4,2048",
                             "256,1,8192"])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("join_tune: no CUDA device", file=sys.stderr)
        return 1
    from merfin_tpu_torch.ops.union_join import (bsearch_join_kernel,
                                                 fence_index, lookup2_plain)
    from merfin_tpu_torch.ops.sorted_join import lookup_plain
    from merfin_tpu_torch.ops.kmer_ops import bias

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    variants = [tuple(int(x) for x in v.split(",")) for v in args.variants]
    with ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(lambda v: build_variant(*v), variants))
    for v, (_, regs) in zip(variants, built):
        print(f"variant {v}: {' | '.join(regs)}", flush=True)

    dev = torch.device("cuda")
    data = shapes(dev)
    results = []
    for name, (keys, vals, q) in data.items():
        fences = fence_index(keys)
        kb = bias(keys)
        if len(vals) == 2:
            def plain():
                return lookup2_plain(keys, vals[0], vals[1], q, kb)

            def old():
                return bsearch_join_kernel(keys, vals[0], vals[1], q)
        else:
            def plain():
                return (lookup_plain(keys, vals[0], q, kb),)

            def old():
                return bsearch_join_kernel(keys, vals[0], None, q)
        want = plain()
        assert all(torch.equal(a, b) for a, b in zip(old(), want))
        p_ms = median_ms(plain, args.reps)
        o_ms = median_ms(old, args.reps)
        print(f"{name}: {q.numel()} queries, {keys.numel()} keys; plain "
              f"{p_ms:.4f} ms, bsearch {o_ms:.4f} ms", flush=True)
        for v, (path, _) in zip(variants, built):
            union, single = bind(path)
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
            o2 = median_ms(old, args.reps)
            n2 = median_ms(new, args.reps)
            print(f"  {v}: exact={ok} windowed {min(n_ms, n2):.4f} ms "
                  f"(bsearch again {o2:.4f})", flush=True)
            results.append(dict(shape=name, variant=v, exact=ok,
                                ms=min(n_ms, n2), bsearch_ms=min(o_ms, o2),
                                plain_ms=p_ms, card=smi))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0 if all(r["exact"] for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
