#!/usr/bin/env python3
"""What the port's obs costs a benchmark cell's pass, on one CUDA device.

Run from the root of the repository:

    python3 scripts/obs_cost_torch.py --cell imagenet1k_val_eval.b256 [--cell ...] [--passes 40] [--seed 7] [--rows N]

For each cell it builds the program as ``evalbench/run.py`` does (inputs
made on the card from the seed, one ``MetricCollection`` per signature,
a warm pass), then runs passes with ``torcheval_tpu_torch.obs`` off and
on in turn, ``--passes`` of each, without the profiler. A pass is the
benchmark's: ``reset()``, every ``update()``, ``compute()`` with its values
on the host. Prints one JSON line a cell: the median pass of each, their
ratio (on over off), the median of each phase (``reset``, the
``updates``, ``compute`` until the values are on the host), and the
median ``MetricCollection.update()`` (harness clock) of each. The obs ring is cleared after every pass, as a
reader of it would.

Exits 2, and prints no result, when there is no CUDA device: a pass on the
CPU is not the benchmark's.
"""

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cell", action="append", required=True)
    p.add_argument("--passes", type=int, default=40)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--rows", type=int, default=None, help="rows a pass (default: the cell's)")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from evalbench.core import harness
    from evalbench.core.spec import Spec
    from torcheval_tpu_torch import obs
    from torcheval_tpu_torch.obs import trace as ring

    if not torch.cuda.is_available():
        print("obs_cost_torch: no CUDA device; no result.", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    obs.set_timeline_capacity(1 << 20)
    for name in args.cell:
        cell = harness.Cell(Spec(ROOT), name, rows=args.rows)
        inputs = cell.inputs(args.seed, device)
        batches = cell.batches(inputs)
        program = harness.Program(cell, device)
        phases = {on: {"pass": [], "reset": [], "updates": [], "compute": []} for on in (False, True)}
        updates = {False: [], True: []}
        for on in (False, True):  # warm both paths
            (obs.enable if on else obs.disable)()
            harness.run_pass(program, batches, device)
        for i in range(2 * args.passes):
            on = bool(i % 2)
            (obs.enable if on else obs.disable)()
            # the harness's pass (run_pass), with a clock between its phases
            t0 = time.perf_counter()
            program.reset()
            t1 = time.perf_counter()
            for b in batches:
                program.update(b, updates[on])
            t2 = time.perf_counter()
            harness.to_host(program.compute())
            torch.cuda.synchronize(device)
            t3 = time.perf_counter()
            for key, sec in (("pass", t3 - t0), ("reset", t1 - t0), ("updates", t2 - t1),
                             ("compute", t3 - t2)):
                phases[on][key].append(sec)
            obs.disable()
            obs.default_registry.reset()
            ring.clear()
        med = {on: {k: statistics.median(v) * 1e3 for k, v in phases[on].items()} for on in phases}
        print(json.dumps({
            "cell": name,
            "device": torch.cuda.get_device_name(0),
            "passes_each": args.passes,
            "pass_ms_obs_off": med[False]["pass"],
            "pass_ms_obs_on": med[True]["pass"],
            "on_over_off": med[True]["pass"] / med[False]["pass"],
            "phase_ms_obs_off": med[False],
            "phase_ms_obs_on": med[True],
            "update_us_obs_off": statistics.median(updates[False]) * 1e6,
            "update_us_obs_on": statistics.median(updates[True]) * 1e6,
        }), flush=True)
        del program, batches, inputs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
