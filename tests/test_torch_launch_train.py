"""The port's train CLI on the CPU (``repro_torch.launch.train``): the
reference's flags and log lines, checkpoints every ``--checkpoint-every``
steps, a preempted run resumed with ``--resume`` ending bit for bit where
an uninterrupted run ends, and the example script end to end."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch.train import parser, train
from repro_torch.runtime.checkpoint import Checkpointer
from repro_torch.runtime.fault_tolerance import PreemptionGuard

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARGS = "--smoke --steps 6 --batch 2 --seq 16 --device cpu --log-every 2"
LINE = re.compile(r"step +\d+ loss=\d+\.\d{4} exits=\['\d+\.\d{3}'"
                  r"(, '\d+\.\d{3}')*\] gnorm=\d+\.\d{3} \d+\.\d{2}s/step")


def _run(argv, guard=None, on_step=None):
    return train(parser().parse_args(argv.split()),
                 guard=guard or PreemptionGuard(), on_step=on_step)


def test_cli_logs_and_checkpoints(tmp_path, capsys):
    out = _run(f"{ARGS} --checkpoint-dir {tmp_path} --checkpoint-every 2")
    text = capsys.readouterr().out
    lines = text.splitlines()
    assert lines[0].startswith("arch=smollm-135m-smoke params=0.1M "
                               "exits=(1, 2, 3, 4) devices=1")
    steps = [ln for ln in lines if ln.startswith("step")]
    assert [int(ln.split()[1]) for ln in steps] == [0, 2, 4, 5]
    assert all(LINE.fullmatch(ln) for ln in steps), steps
    assert lines[-1] == "done"
    assert out["start_step"] == 0 and out["end_step"] == 6
    assert len(out["losses"]) == 4
    # saves after steps 0, 2, 4 and the last; the default keep is 3
    assert Checkpointer(str(tmp_path)).committed_steps() == [3, 5, 6]


def test_preempted_run_resumes_bitwise(tmp_path, capsys):
    whole = _run(ARGS)
    guard = PreemptionGuard()

    def preempt_after_3(step, metrics):
        if step == 3:
            guard.request_stop()

    cut = _run(f"{ARGS} --checkpoint-dir {tmp_path} --checkpoint-every 10",
               guard=guard, on_step=preempt_after_3)
    assert cut["end_step"] == 4
    assert Checkpointer(str(tmp_path)).committed_steps() == [1, 4]
    capsys.readouterr()
    resumed = _run(f"{ARGS} --checkpoint-dir {tmp_path} "
                   f"--checkpoint-every 10 --resume")
    text = capsys.readouterr().out
    assert "resumed from step 4" in text
    assert "preemption requested" not in text
    assert resumed["start_step"] == 4 and resumed["end_step"] == 6
    for name, value in whole["values"].items():
        assert torch.equal(resumed["values"][name], value), name
    for key in ("m", "v"):
        for name, value in whole["opt_state"][key].items():
            assert torch.equal(resumed["opt_state"][key][name], value), name


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is reachable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run("--smoke --steps 1")


def test_example_script_runs_the_cli(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" /
                             "train_early_exit_lm.py"),
         "--steps", "3", "--device", "cpu", "--checkpoint-dir",
         str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "-m repro_torch.launch.train --arch smollm-135m" in proc.stdout
    assert "--smoke" in proc.stdout and proc.stdout.rstrip().endswith("done")
    assert Checkpointer(str(tmp_path)).committed_steps() == [1, 3]
