"""``semantic_suma_tpu_torch.parallel.multihost_smoke`` as two processes on
the CPU (gloo, a ``file://`` rendezvous under ``tmp_path``, one thread
each), like ``tests/test_multihost.py`` does for the JAX package: both print
their ``MULTIHOST OK`` line over a group of both processes, with chunks
spilled to host RAM and paged back in on each, and the same map count and
loss on both. The processes are joined with a deadline and killed on
expiry."""
import torch_env  # noqa: F401  (first: one torch thread)

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DEADLINE_S = 80


def test_two_process_cpu_smoke(tmp_path):
    init = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m",
         "semantic_suma_tpu_torch.parallel.multihost_smoke",
         "--coordinator", init, "--num-processes", "2", "--process-id",
         str(pid), "--cpu", "--threads", "1", "--timeout", str(DEADLINE_S)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DEADLINE_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    lines = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        m = re.search(rf"MULTIHOST OK proc={pid} devices=2 surfels=(\d+) "
                      r"max_spilled=(\d+) paged_back=(\d+) loss=(\S+)", out)
        assert m, f"process {pid} printed no OK line:\n{out}"
        lines.append(m.groups())
        assert int(m.group(2)) > 0 and int(m.group(3)) > 0, out
    # the map count and the loss are reduced over both processes
    assert lines[0][0] == lines[1][0] and lines[0][3] == lines[1][3]
