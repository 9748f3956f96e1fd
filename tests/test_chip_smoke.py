"""chip_smoke.py: the on-card smoke check.  Its CPU-side contract is
tested here; the run itself needs a GPU (``gpu`` marker)."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, env_extra=None, timeout=300):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_device_check_fails_on_cpu():
    p = _run(REPO, {"JAX_PLATFORMS": "cpu"})
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "JAX found no GPU" in p.stderr


def test_fails_without_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run(str(tmp_path), {"JAX_PLATFORMS": "cpu"})
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout


def test_result_line_has_exactly_the_contract_keys():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    dev = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([dev])
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


@pytest.fixture
def gpu_card():
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True).returncode:
        pytest.skip("no NVIDIA GPU on this machine")


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_card):
    # a child process: this one is held to the CPU by conftest.py
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=1500)
    assert p.returncode == 0, p.stderr[-4000:]
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
