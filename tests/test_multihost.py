"""Multi-process (multi-host) runtime test: the sharded-state DD step
over a process-spanning mesh (jax.distributed.initialize) produces
norms identical to the single-process run with the same total device
count.  SURVEY.md §2.3 row 5 (the reference has no multi-node story).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spawn(nproc, pid, port, steps):
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("PYTEST_CURRENT_TEST", None)
    return subprocess.Popen(
        [sys.executable, "-m", "nupgcm.tools.multihost_dryrun",
         "--nproc", str(nproc), "--pid", str(pid), "--port", str(port),
         "--steps", str(steps)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )


def test_two_process_dd_step_matches_single_process():
    port = 9873
    procs = [_spawn(2, pid, port, steps=2) for pid in (0, 1)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"rc={p.returncode}\n{err[-2000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))

    a, b = outs
    assert a["n_processes"] == 2 and a["n_devices"] == 8
    for k in ("u2", "p2", "b2", "u_max", "b_max"):
        assert a[k] == b[k], (k, a[k], b[k])  # bitwise-replicated scalars

    # single-process reference with the same 8-shard partition
    from nupgcm.tools.multihost_dryrun import run

    ref = run(n_steps=2)
    assert ref["n_devices"] == 8
    for k in ("u2", "p2", "b2"):
        assert np.isclose(ref[k], a[k], rtol=1e-12), (k, ref[k], a[k])
