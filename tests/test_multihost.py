"""TRUE multi-process SPMD test.

The single-process virtual-device mesh tests (test_shard.py) can't catch
multi-host bugs like device_put onto non-addressable devices or a broken
`jax.distributed.initialize` ordering. This test spawns 2 SEPARATE OS
processes, wires them with `jax.distributed.initialize` + gloo CPU
collectives (2 virtual devices each -> a 4-device global mesh), runs the
sharded PPO train step through the real multi-host recipe
(`replicate` + `host_local_to_global`), and asserts every process — and a
single-process run on an identically sized 4-device mesh — produces the same
trained params and metrics.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _clean_env():
    env = dict(os.environ)
    # the workers choose their own platform/device flags
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    env.pop("JAX_COORDINATOR", None)
    return env


def _run_workers(num_processes: int, local_devices: int):
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(i), str(num_processes), str(port),
             str(local_devices)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=_clean_env(),
        )
        for i in range(num_processes)
    ]
    results = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, f"worker failed:\n{out}"
        lines = [l for l in out.splitlines() if l.startswith("RESULT ")]
        assert lines, f"no RESULT line in worker output:\n{out}"
        results.append(json.loads(lines[-1][len("RESULT "):]))
    return results


@pytest.mark.slow
def test_two_process_spmd_matches_single_process():
    two = _run_workers(num_processes=2, local_devices=2)
    assert [r["num_processes"] for r in two] == [2, 2]
    assert all(r["num_devices"] == 4 for r in two)

    # both processes of the SPMD program must agree bitwise
    for k in ("params_checksum", "state_checksum", "mean_reward", "loss"):
        assert two[0][k] == two[1][k], f"{k} diverged across processes"

    # and the result must match a single-process run on the same 4-device mesh
    one = _run_workers(num_processes=1, local_devices=4)[0]
    assert one["num_devices"] == 4
    for k in ("params_checksum", "state_checksum", "mean_reward", "loss"):
        np.testing.assert_allclose(
            two[0][k], one[k], rtol=1e-5, atol=1e-6,
            err_msg=f"{k}: 2-process vs single-process mismatch",
        )
    # and the sharded run must match the same global batch on one device
    for k in ("params_checksum", "state_checksum", "loss"):
        np.testing.assert_allclose(
            one[f"single_device_{k}"], one[k], rtol=1e-5, atol=1e-6,
            err_msg=f"{k}: sharded vs single-device mismatch",
        )
