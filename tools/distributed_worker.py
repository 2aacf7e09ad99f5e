"""Worker for the two-process `jax.distributed` CPU cluster test.

Usage: python tools/distributed_worker.py <process_id> <num_processes> <port>

Each process owns one virtual CPU device; together they form a 2-device
global mesh spanning process boundaries (the same bring-up path a
multi-host GPU cluster uses, with TCP on localhost standing in for the
inter-host network). The worker runs
one cross-process `psum` through `shard_map` and prints `PSUM_OK <value>`
on success — executable evidence for the multi-host story in
`docs/scaling.md`.
"""

import os
import sys


def main() -> None:
    pid = int(sys.argv[1])
    nprocs = int(sys.argv[2])
    port = sys.argv[3]

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
        os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=1"

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nprocs,
        process_id=pid,
    )
    assert jax.process_count() == nprocs, jax.process_count()
    assert jax.device_count() == nprocs, jax.device_count()
    assert jax.local_device_count() == 1

    import numpy as np

    from jax.experimental import multihost_utils
    from jax import shard_map
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()), ("p",))
    sharding = NamedSharding(mesh, P("p"))
    local = np.array([[float(pid + 1)]], dtype=np.float32)
    garr = jax.make_array_from_process_local_data(
        sharding, local, (nprocs, 1)
    )

    psum = jax.jit(
        shard_map(
            lambda x: jax.lax.psum(x, "p"),
            mesh=mesh,
            in_specs=P("p"),
            out_specs=P(),
        )
    )
    out = psum(garr)
    gathered = multihost_utils.process_allgather(out, tiled=True)
    expected = float(sum(range(1, nprocs + 1)))
    val = float(np.ravel(gathered)[0])
    assert val == expected, (val, expected)
    print(f"PSUM_OK {val}", flush=True)


if __name__ == "__main__":
    main()
