"""The control of the comparison that decides ``correct``: the reference
code put in the program's place over GF(2^8) modulo 0x11B (the AES
field), where the configurations state 0x11D. It breaks the stated field,
so every answer it gives differs from the reference's, and the check has
to come out false. The benchmark's own runs never run it.

    python3 -m ecbench.control --workload <name> --seeds 1,2,3 --seconds 3

runs the cell's traffic at its own size once a seed in one process, the
checked answers the first ``check_answers`` of the window, and prints one
JSON line a seed: ``correct`` and each number compared.
"""

import argparse
import gc
import json
import sys

import torch

from ecbench import harness, reference, spec

CONTROL_POLY = 0x11B


def control_codec(config: dict, device: str) -> reference.Code:
    """The configuration's code over the control's field."""
    return reference.load(config, field_poly=CONTROL_POLY)


def run(cell, seed: int, seconds: float, device: str = "cuda") -> dict:
    """One run of ``cell`` with the control in the program's place. The
    control is slower than the program: its checked answers are the first
    ones, as many as a run checks."""
    cell.traffic["check_within"] = cell.traffic["check_answers"]
    return harness.run_cell(cell, seed, seconds, False, device=device,
                            system=control_codec)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m ecbench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("ecbench: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        result = run(cell, seed, args.seconds)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
