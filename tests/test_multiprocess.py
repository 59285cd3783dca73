"""REAL multi-process execution: two jax.distributed processes on
localhost (CPU backend, 4 virtual devices each) run a latitude-sharded
flux-correction + scenario year over the global 8-device mesh — the halo
ppermutes cross the process boundary — and each process checks its own
addressable shards against an unsharded reference (tests/mp_worker.py).

The reference is strictly single-process (SURVEY §2.4); this is the
multi-host story's process-boundary proof without multi-device hardware.
"""
import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_year(tmp_path):
    nproc = 2
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "mp_worker.py")
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    # workers set their own JAX_PLATFORMS/XLA_FLAGS; scrub the parent's
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen([sys.executable, worker, str(i), str(nproc),
                          str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env, cwd=root)
        for i in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
        assert "MP_OK" in out, f"process {i} missing MP_OK:\n{out}"
