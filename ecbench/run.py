"""One run of one cell of the benchmark:

    python3 -m ecbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as the last lines of standard error,
each number compared with the reference beside its limit, and as the last
line of standard output the result as one JSON object. Exits non-zero, and
prints no result, without a CUDA device, without as many devices as the
cell asks for, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m ecbench.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ecbench: no CUDA device", file=sys.stderr)
        return 2
    from ecbench import harness, spec

    cell = spec.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"ecbench: {args.workload} needs {cell.chips} devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"ecbench: loaded {found}, which the benchmark may not load",
              file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"ecbench check {name}: {check['value']} "
              f"(limit {check['rule']} {check['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
