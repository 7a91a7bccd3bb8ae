"""The two readings that each limit of the correctness check is set from.

    python3 evalbench/readings.py --workload <cell> --seeds 1,2,...

For each seed: the cell's inputs, one warm pass and one pass of the
program (the timed path, at the cell's own sizes), and the gap of each
value to the float64 reference: the lower readings. For the first
``CONTROL_SEEDS`` seeds, the same pass with the control (the reference
computed in bfloat16) in the program's place: the upper readings. Prints
one JSON line a seed and side, then the largest program gap and the
smallest control gap of each number. Needs a CUDA device; the benchmark's
own runs do not run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTROL_SEEDS = 3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from evalbench.core import harness
    from evalbench.core.spec import Spec

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.Cell(Spec(ROOT), args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    lower, upper = {}, {}
    program = harness.Program(cell, device)
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        inputs = cell.inputs(seed, device)
        batches = cell.batches(inputs)
        harness.run_pass(program, batches, device)
        values = harness.run_pass(program, batches, device)
        refs = harness.references(cell, inputs, torch.float64)
        sides = [("program", values)]
        if i < CONTROL_SEEDS:
            control = harness.ControlProgram(cell, device)
            sides.append(("control", harness.run_pass(control, batches, device)))
        for side, vals in sides:
            g = harness.gaps(cell, vals, refs)
            store = lower if side == "program" else upper
            for k, v in g.items():
                store[k] = max(store.get(k, 0.0), v) if side == "program" else min(store.get(k, float("inf")), v)
            print(json.dumps({"cell": cell.name, "seed": seed, "side": side, "gaps": g,
                              "values": {k: v.flatten()[:4].tolist() for k, v in vals.items()},
                              "seconds": time.perf_counter() - t}), flush=True)
        del inputs, batches
    print(json.dumps({"cell": cell.name, "seeds": len(seeds), "lower": lower, "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
