"""Run one cell of the benchmark once and print its result line.

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cell's number of
CUDA devices.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and ``checks`` last: each number
compared beside its limit); the numbers compared are also the last lines
of standard error.  Without a card, with too few, with an unknown cell,
or when a forbidden module is loaded, it prints no result and exits
with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def use_checkout_caches(root=ROOT):
    """Kernel and extension caches at fixed paths inside the checkout (the
    port's own nvcc library already lives in build/epgpy_torch/)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


def main(argv=None):
    args = parse(argv)
    use_checkout_caches()
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "perfbench":
        sys.path[0] = str(ROOT)
    else:
        sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import harness

    bench = harness.load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"perfbench: unknown workload {args.workload!r}; cells: "
              f"{', '.join(cells)}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    parts = harness.load_cell(bench, args.workload)
    try:
        out = harness.run_cell(parts, seed=args.seed, seconds=args.seconds,
                               trace=bool(args.trace), device="cuda:0",
                               t_start=T_START)
    except harness.ForbiddenImport as exc:
        print(f"perfbench: {exc}", file=sys.stderr)
        return 1
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
