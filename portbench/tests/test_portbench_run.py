"""The command refuses to run where it cannot measure the program on a
card, and prints no result."""

import os
import shutil
import subprocess
import sys

from portbench import harness

ARGS = ["--workload", "spectrum_sep16.batch256", "--seed", "4294967311", "--seconds", "1", "--trace", "0"]


def run(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "portbench.run", *ARGS], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env=env)


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run(harness.ROOT, env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_refuses_an_unknown_workload():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "nowhere", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == ""
