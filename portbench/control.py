"""The readings that a cell's limits are set from, in one process on the
card:

    python3 -m portbench.control --workload <name> --seeds 12 --control-seeds 3 --seconds 2

runs the cell with the program on ``--seeds`` seeds and with the control
(the reference in bfloat16, the precision below the program's float32, in
the program's place) on ``--control-seeds`` others, each a short window at
the cell's own load with the check a run makes. It prints one JSON line a
run and, last, each compared number's lower reading (the largest the
program gave) and upper reading (the smallest the control gave). The
benchmark's runs never run this.
"""

import argparse
import json
import sys
import time

from portbench.harness import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_019)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    lower, upper = {}, {}
    runs = [(None, args.first_seed + 7919 * i) for i in range(args.seeds)]
    runs += [("control", args.first_seed + 104729 * (i + 1)) for i in range(args.control_seeds)]
    for program, seed in runs:
        t0 = time.perf_counter()
        r = run_cell(args.workload, seed, args.seconds, False, "cuda", program=program)
        numbers = {k: c["value"] for k, c in r["checks"].items()}
        side = upper if program else lower
        for k, v in numbers.items():
            side[k] = (min if program else max)(side.get(k, v), v)
        print(json.dumps({"side": program or "program", "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"], "seconds": time.perf_counter() - t0, "numbers": numbers}),
              flush=True)
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
