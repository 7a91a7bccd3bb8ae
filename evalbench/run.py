"""Run one cell of the benchmark once, on this machine's CUDA device.

    python3 evalbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout of the repository. Prints the card's name
and power limit on stderr, then each number that the correctness check
compared beside its limit, and, as the last line of stdout, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and ``checks``.

Exits non-zero, and prints no result, when there is no CUDA device or
fewer than the cell asks for, when ``torcheval_tpu_torch`` cannot be
imported, or when a module of JAX or of the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"
    return out.stdout.strip() or f"unknown (nvidia-smi exit {out.returncode})"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, ROOT)
    import torch

    from evalbench.core import guard, harness
    from evalbench.core.spec import Spec

    spec = Spec(ROOT)
    cell = harness.Cell(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"evalbench: the cell needs {cell.chips} CUDA device(s), found {n}; "
              "no result.", file=sys.stderr)
        return 2
    try:
        import torcheval_tpu_torch.metrics  # noqa: F401
    except ImportError as e:
        print(f"evalbench: cannot import torcheval_tpu_torch ({e}); no result.",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    run = harness.measure(cell, args.seed, args.seconds, bool(args.trace), device, t0=T0)
    # read after the window, so that set-up does not wait for nvidia-smi
    print(f"evalbench: {args.workload} seed {args.seed} on {name}; "
          f"name, power.limit: {_power_limit()}", file=sys.stderr)
    from torcheval_tpu_torch import _build

    built = _build.build_report()[0]
    parts = ", ".join(f"{k} {v:.3f} s" for k, v in run.setup_parts.items())
    print(f"evalbench: setup_s {run.setup_s:.3f}: {parts}; kernels "
          + (f"built in {built:.3f} s" if built is not None else "loaded from the checkout's build"),
          file=sys.stderr)
    line = harness.result_line(run, spec, bool(args.trace))
    found = guard.forbidden_modules()
    if found:
        print(f"evalbench: modules of JAX or the JAX package were loaded: {found}; "
              "no result.", file=sys.stderr)
        return 3
    harness.print_checks(run)
    harness.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
