"""A benchmark root for tests: this folder's benchmark copied with the
CPU fixtures (toy configurations, traffic, limits and ``BENCHMARK.json``)."""

import shutil
from pathlib import Path

PB = Path(__file__).resolve().parents[1]
REPO = PB.parent
FIXTURES = PB / "tests" / "fixtures"


def make_root(dst: Path) -> Path:
    shutil.copytree(PB, dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for sub in ("configs", "traffic", "limits"):
        for f in (FIXTURES / sub).glob("*.json"):
            shutil.copy(f, dst / "portbench" / sub / f.name)
    shutil.copy(FIXTURES / "benchmark.json", dst / "BENCHMARK.json")
    return dst
