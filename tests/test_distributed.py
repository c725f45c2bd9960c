"""Multi-process (2-controller) mesh bring-up test.

Exercises parallel/mesh.py::init_distributed the way a real multi-host
deployment would use it: two OS processes, each owning 4 virtual CPU
devices, form one global 8-device mesh and run a sharded channel_scan whose
result is allgathered and checked on both controllers.  The reference has
no distributed layer at all (SURVEY §2.6), so this test has no reference
counterpart — it validates the scaling design BASELINE.md asks for
("samples/s/chip measured at ... N>=2 hosts").
"""

import os
import pathlib
import socket
import subprocess
import sys

WORKER = pathlib.Path(__file__).parent / "distributed_worker.py"


def test_two_process_mesh_channel_scan():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    env_base = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = []
    for pid in range(2):
        env = dict(env_base)
        env["TEST_COORD"] = f"127.0.0.1:{port}"
        env["TEST_NPROC"] = "2"
        env["TEST_PID"] = str(pid)
        env["PYTHONPATH"] = str(WORKER.parent.parent)
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER)],
            env=env, cwd=str(WORKER.parent.parent),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)

    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-4000:]}"
        assert "DISTRIBUTED_OK" in out, f"process {pid} output:\n{out[-4000:]}"
