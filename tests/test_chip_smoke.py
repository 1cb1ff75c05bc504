"""The parts of chip_smoke.py that need no card: it refuses a CPU, the
format of its last line, the phases --four-cards selects, and where the
compile cache lives."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest

import chip_smoke
from tpu_pathtracer.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_refuses_a_cpu_device():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.require_gpu(jax.devices())


@pytest.mark.parametrize("alone", [False, True],
                         ids=["in_repo", "alone_in_a_directory"])
def test_fails_without_a_gpu_and_prints_no_result(tmp_path, alone):
    """No card here (and, alone, none of the repo): non-zero exit and no
    result line."""
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    else:
        cwd = REPO
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_result_line_format():
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([dev])
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_four_cards_runs_only_the_multi_device_path():
    assert chip_smoke.phases(True) == ("four_cards",)
    one = chip_smoke.phases(False)
    assert "four_cards" not in one
    assert set(one) | {"four_cards"} == set(chip_smoke.PHASES)


@pytest.mark.parametrize("env_set", [True, False],
                         ids=["from_env", "repo_default"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.cache_dir() == str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert cache.cache_dir() == os.path.join(REPO, ".jax_cache")
