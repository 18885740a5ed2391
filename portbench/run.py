"""Run one benchmark cell once and print its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits nonzero, printing no result, without a CUDA card (or with fewer than
the cell asks for), when the run has loaded JAX or the JAX package, or when
the program is missing. The compared numbers and their limits are the last
lines on standard error and the ``checks`` key of the result line.
"""

from __future__ import annotations

import time

T_START = time.time()  # the run's set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# run as a script, Python puts this folder first on the path; the package
# is imported from the checkout's root instead
sys.path[0] = str(ROOT)


def _cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds (the program's own nvcc builds land
    in ``freud_tpu_torch/_build/``, inside it too)."""
    base = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(base / "nv_compute")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()

    from portbench import core

    cell = core.resolve_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    chips = next(w.get("chips", 1) for w in core.load_json(ROOT / "BENCHMARK.json")
                 ["workloads"] if w["name"] == cell.name)
    if torch.cuda.device_count() < chips:
        print(f"portbench: {cell.name} needs {chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    try:
        result = core.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                               device="cuda", root=ROOT, t_start=T_START)
        # once more, with everything the run did behind it
        core.check_imports()
    except core.ForbiddenImport as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
