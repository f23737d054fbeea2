"""The command as the benchmark's runner calls it.  Without the cards a
cell asks for it exits with a code other than 0 and prints no result; on
a card (marked ``cuda``, skipped without one) a short run of a cell is
correct."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]


def _run(*args, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=REPO,
                          capture_output=True, text=True, env=env, timeout=600)


def test_no_result_without_the_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run("--workload", "clip480.single_17s", "--seed", "1", "--seconds", "1", "--trace", "0",
             env=env)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.fixture()
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    p = _run("--workload", "clip480.single_17s", "--seed", str(2**31 + 5), "--seconds", "2",
             "--trace", "0")
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
