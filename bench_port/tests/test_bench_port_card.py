"""On the card: one short run of a cell through the command, from the root
of the repository. Skips without a CUDA device."""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.cuda
def test_command_prints_a_correct_line_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "beam_sa.pcg",
                          "--seed", str(2**31 + 99), "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert {"solves_per_s", "solve_ms_p95", "peak_mem_gib", "setup_s"} == set(line["metrics"])
    assert out.stderr.splitlines()[-1].startswith("check a0_rel_err")
