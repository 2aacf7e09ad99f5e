"""Two-process `jax.distributed` cluster over TCP on this host.

Turns the multi-host story from prose into an executed test: two
OS processes, one coordinator, a global 2-device mesh, and one
cross-process `psum` whose result both processes verify. This is the
same initialization + collective path a multi-host GPU cluster uses —
only the transport differs. Skips where the runtime lacks distributed support.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.timeout(300)
def test_two_process_psum():
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
            env=env,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        if rc != 0 and (
            "Unimplemented" in err or "UNIMPLEMENTED" in err
        ):
            pytest.skip(f"distributed runtime unsupported here: {err[-200:]}")
        assert rc == 0, f"worker failed: {err[-800:]}"
        assert "PSUM_OK 3.0" in out, out
