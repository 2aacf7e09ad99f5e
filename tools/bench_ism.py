"""Reference-vs-repo wall-clock for the image-source RIR generator.

The reference's ISM (`/root/reference/dsptoolbox/room_acoustics/
_room_acoustics.py:161-268`) is a Python triple loop over image orders;
ours enumerates the whole image lattice as one chunked device
scatter-add. Both sides run the PUBLIC `generate_synthetic_rir`.

    python tools/bench_ism.py repo   # on a GPU
    python tools/bench_ism.py ref    # reference on host CPU
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

DIM = [6.0, 5.0, 3.0]
SRC = [1.2, 2.1, 1.3]
RCV = [4.3, 1.2, 1.6]
RT = 0.8
SR = 44100


def bench_repo():
    import dsptoolbox_jax as dsp

    room = dsp.room_acoustics.ShoeboxRoom(DIM, t60_s=RT)

    def one(mo):
        t0 = time.perf_counter()
        r = dsp.room_acoustics.generate_synthetic_rir(
            room, SRC, RCV, SR, max_order=mo
        )
        v = float(np.asarray(r.time_data)[0, 0])  # full host materialize
        return time.perf_counter() - t0, v

    one(17)  # compile warm-up
    results = {}
    for mo in (10, 17, 25):
        dts = [one(mo)[0] for _ in range(3)]
        results[f"max_order_{mo}"] = round(min(dts), 4)
    print(json.dumps({"side": "repo", **results}), flush=True)


def bench_ref():
    from bench_suite import _install_reference

    ref = _install_reference()
    room = ref.room_acoustics.ShoeboxRoom(DIM, t60_s=RT)
    results = {}
    for mo in (10, 17):  # 25 would take minutes; extrapolate from 17
        t0 = time.perf_counter()
        ref.room_acoustics.generate_synthetic_rir(
            room, SRC, RCV, SR, max_order=mo
        )
        results[f"max_order_{mo}"] = round(time.perf_counter() - t0, 4)
    print(json.dumps({"side": "reference_cpu", **results}), flush=True)


if __name__ == "__main__":
    (bench_ref if sys.argv[1] == "ref" else bench_repo)()
