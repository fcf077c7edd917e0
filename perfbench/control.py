"""The control of a cell's comparison: the plain reference put in the
program's place and computed in bfloat16, the nearest precision below the
float32 that the configurations state, compared with the float32
reference by the cell's own comparison. It has to come out as not correct.

    python3 perfbench/control.py --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line a seed: the compared numbers beside their limits.
The benchmark's own runs do not run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.harness import registry, runner  # noqa: E402


def control(cell: str, seed: int, device="cuda", base=None) -> list:
    import torch
    ctx = runner.Ctx(cell, seed, torch.device(device), base)
    driver = registry.traffic(ctx.workload["traffic"],
                              base or registry.HERE)
    return driver.control(ctx)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    runner.set_cache_dirs(registry.ROOT)
    import torch
    if not torch.cuda.is_available():
        print("perfbench: the control runs on a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control(args.workload, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "failed": [c["name"] for c in out if not c["ok"]],
                          "compared": {c["name"]: c["value"] for c in out}}),
              flush=True)
        for fault, res in faults(args.workload, seed).items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "fault": fault,
                              "failed": [c["name"] for c in res
                                         if not c["ok"]],
                              "compared": {c["name"]: c["value"]
                                           for c in res}}), flush=True)
    return 0


def faults(cell: str, seed: int, device="cuda", base=None) -> dict:
    """The readings of the faults a cell's driver can plant in the
    reference, by fault ({} where it plants none)."""
    import torch
    ctx = runner.Ctx(cell, seed, torch.device(device), base)
    driver = registry.traffic(ctx.workload["traffic"],
                              base or registry.HERE)
    return driver.faults(ctx) if hasattr(driver, "faults") else {}


if __name__ == "__main__":
    sys.exit(main())
