"""Repeat runs of one cell, each its own process as the benchmark's check
makes them, and the spread of each metric:

    python3 -m portbench.spread --workload <name> --seconds 10 --seeds 11 12 13 14 15 16 --sets 2

runs ``python3 -m portbench.run`` once a seed in each set (the sets use the
same seeds) and prints each run's result line, then for each metric and set
the median and the spread: the distance between the first and the third
quartile (``statistics.quantiles(values, n=4)``) as a share of the median.
``setup_s`` of each set's first run, which may build, is left out of its
spread. The benchmark's runs never run this.
"""

import argparse
import json
import statistics
import subprocess
import sys


def spread(values) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.spread", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sets = []
    for s in range(args.sets):
        runs = []
        for seed in args.seeds:
            cmd = [sys.executable, "-m", "portbench.run", "--workload", args.workload, "--seed", str(seed),
                   "--seconds", str(args.seconds), "--trace", str(args.trace)]
            out = subprocess.run(cmd, capture_output=True, text=True, timeout=1200)
            line = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else "{}"
            print(json.dumps({"set": s, "seed": seed, "rc": out.returncode, "result": json.loads(line),
                              "stderr_tail": out.stderr[-600:]}), flush=True)
            if out.returncode == 0:
                runs.append(json.loads(line))
        sets.append(runs)
    summary = {}
    for s, runs in enumerate(sets):
        for name in runs[0]["metrics"] if runs else []:
            values = [r["metrics"][name]["value"] for r in runs if name in r["metrics"]]
            if name == "setup_s":
                values = values[1:]
            if len(values) >= 2:
                summary.setdefault(name, []).append({"set": s, "median": statistics.median(values),
                                                     "spread": spread(values), "n": len(values)})
        summary.setdefault("correct", []).append(sum(r["correct"] for r in runs))
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
