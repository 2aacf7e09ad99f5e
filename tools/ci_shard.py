"""Deterministic test-suite sharding for parallel CI boxes.

The full suite is ~26 min on a single-CPU box and the tests are
CPU-bound (JAX on a CPU mesh), so local pytest-xdist cannot help on a
1-core runner. This splits the suite into N deterministic, roughly
load-balanced shards to run on N boxes:

    python tools/ci_shard.py --shard 0 --num-shards 4 [pytest args...]

Balancing uses committed per-file wall-time weights (measured on the
1-CPU box, round 5) with a greedy longest-processing-time assignment,
so the slowest shard is close to total/N. Files missing from the table
get a default weight. `--list` prints the assignment without running.

4-way split of the ~26 min suite => slowest shard ~8 min (< the 10 min
round-5 target); the quick local iteration path remains
`pytest -m "not slow"` (~13 min).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

# seconds on the 1-CPU reference box (full suite, round 5); measured
# with `pytest --durations` aggregation — re-measure when adding heavy
# files. Missing files default to 30 s.
WEIGHTS = {
    "test_classes.py": 160,
    "test_filterbanks.py": 200,
    "test_transforms.py": 150,
    "test_realtime.py": 130,
    "test_transfer_functions.py": 120,
    "test_ops_filtering.py": 110,
    "test_beamforming.py": 100,
    "test_room_acoustics.py": 90,
    "test_pipeline.py": 90,
    "test_parallel.py": 80,
    "test_property_kernels.py": 120,
    "test_ops_spectral.py": 70,
    "test_e2e_pipelines.py": 70,
    "test_standard.py": 60,
    "test_mesh_public_api.py": 60,
    "test_defer.py": 50,
    "test_lazy_returns.py": 50,
    "test_fx.py": 50,
    "test_das_core.py": 40,
    "test_iir_freq.py": 40,
    "test_distributed.py": 40,
    "test_iir_bank.py": 30,
    "test_aliasing_contracts.py": 30,
    "test_differentiable.py": 30,
    "test_prefix.py": 20,
    "test_helpers.py": 20,
    "test_io.py": 20,
    "test_distances_generators.py": 20,
    "test_plots_smoke.py": 20,
    "test_precision_guard.py": 15,
    "test_reference_suite.py": 15,
    "test_api_parity.py": 10,
    "test_tools.py": 10,
    "test_dead_code.py": 10,
    "test_audio_io.py": 5,
}

DEFAULT_WEIGHT = 30


def assign(files: list[str], n: int) -> list[list[str]]:
    """Greedy LPT: heaviest file onto the currently lightest shard."""
    shards: list[list[str]] = [[] for _ in range(n)]
    loads = [0.0] * n
    for f in sorted(
        files,
        key=lambda f: -WEIGHTS.get(os.path.basename(f), DEFAULT_WEIGHT),
    ):
        i = loads.index(min(loads))
        shards[i].append(f)
        loads[i] += WEIGHTS.get(os.path.basename(f), DEFAULT_WEIGHT)
    return shards


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shard", type=int, required=True)
    ap.add_argument("--num-shards", type=int, required=True)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("pytest_args", nargs="*")
    args = ap.parse_args()
    assert 0 <= args.shard < args.num_shards

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tests = sorted(
        os.path.join("tests", f)
        for f in os.listdir(os.path.join(repo, "tests"))
        if f.startswith("test_") and f.endswith(".py")
    )
    shards = assign(tests, args.num_shards)
    mine = sorted(shards[args.shard])
    est = sum(WEIGHTS.get(os.path.basename(f), DEFAULT_WEIGHT) for f in mine)
    print(
        f"[ci-shard] shard {args.shard}/{args.num_shards}: "
        f"{len(mine)} files, ~{est // 60} min est", flush=True
    )
    if args.list:
        for f in mine:
            print(" ", f)
        return 0
    cmd = [sys.executable, "-m", "pytest", "-q", *mine, *args.pytest_args]
    return subprocess.call(cmd, cwd=repo)


if __name__ == "__main__":
    sys.exit(main())
