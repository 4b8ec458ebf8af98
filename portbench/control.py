"""The control of each cell's check, on several seeds:

    python3 -m portbench.control --workload <cell> --seeds 1 2 3

The control is the plain reference put in the program's place, one step
below a guarantee the configuration states: for -completeness, lookups
by 32-bit key fingerprints where the lookups are exact; for -polish,
each cluster's paths cut short where every cluster of up to -comb 15
variants is evaluated over all its paths.  Its numbers are judged by
the limits of the cell's mix, as a run's are, and each line prints them
and ``correct``: a sound check has every control come out not correct.
No program code runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench.run import HERE, fails, load_json, load_module


def control_readings(workload: str, seed: int, device, base=HERE) -> dict:
    """{control: {"compared": {number: {"value", "limit"}}, "correct"}}."""
    from portbench.world import make_world

    cell = load_json(base, "workloads", workload)
    config = load_json(base, "configs", cell["config"])
    traffic = load_json(base, "traffic", cell["traffic"])
    driver = load_module(base / "drivers" / f"{traffic['driver']}.py")
    world = make_world(config, traffic, seed, device)
    limits = traffic["limits"]
    return {name: {"compared": {n: {"value": got[n], "limit": limits[n]}
                                for n in limits},
                   "correct": not fails(got, limits)}
            for name, got in driver.control(world, traffic, device).items()}


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    for seed in args.seeds:
        t = time.perf_counter()
        got = control_readings(args.workload, seed, dev)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "controls": got,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
