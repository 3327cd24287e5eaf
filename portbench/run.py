"""Run one cell of the benchmark once, on the card of the machine it starts
on:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It prints the compared numbers beside their
limits as the last lines of standard error, and the result as one JSON
object, the last line of standard output. It refuses to run (exit code 2,
no result) without a card, in a directory that lacks the program, or where
the reference imports the program; and it withholds the result (exit code
3) if ``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded once the
window has closed.
"""

import time

T_START = time.perf_counter()  # the process's start, for setup_s

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Compiled bytecode of every module the run imports (torch's own included)
# is kept in a fixed directory inside the checkout, so that only a
# checkout's first run compiles it. Where an installation ships no bytecode
# and bytecode writing is off, every run would otherwise compile torch's
# Python anew: seconds of set-up that swing with the host's load.
sys.pycache_prefix = os.path.join(ROOT, "build", "portbench", "pycache")
sys.dont_write_bytecode = False

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(ROOT)


def _fixed_caches(root: Path) -> None:
    """Kernel caches in fixed directories inside the checkout, so that only
    a checkout's first run builds: the program's own kernel library builds
    into ``build/signalizer_tpu_torch/``; torch's runtime-compiled kernels,
    CUDA's JIT cache of compiled PTX, Triton and torch extensions go under
    ``build/portbench/``. Each is made here: torch turns its kernel cache
    off, with a warning, where the directory is missing."""
    for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"), ("CUDA_CACHE_PATH", "cuda_cache"),
                     ("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        path = root / "build" / "portbench" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fixed_caches(ROOT)

    import torch

    from portbench import guard
    from portbench.harness import Bench, run_cell

    bench = Bench(ROOT)
    try:
        cell = bench.cell(args.workload)
    except KeyError as e:
        print(e, file=sys.stderr)
        return 2
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    try:
        import signalizer_tpu_torch
    except ImportError as e:
        print(f"portbench: the program is missing from {ROOT}: {e}", file=sys.stderr)
        return 2
    if ROOT not in Path(signalizer_tpu_torch.__file__).resolve().parents:
        print(f"portbench: signalizer_tpu_torch loads from {signalizer_tpu_torch.__file__}, outside {ROOT}",
              file=sys.stderr)
        return 2
    bad = guard.reference_imports(ROOT / "portbench" / "reference")
    if bad:
        print(f"portbench: the reference imports {bad}", file=sys.stderr)
        return 2

    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", bench=bench,
                      t_start=T_START)
    banned = guard.loaded_banned()
    if banned:
        print(f"portbench: loaded after the window: {banned}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
