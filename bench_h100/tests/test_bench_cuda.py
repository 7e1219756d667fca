"""On the card: one short run of each cell through the command the
driver runs, its last line read back.  Skips without a CUDA device.

    PYTHONPATH=src python -m pytest -m cuda bench_h100/tests -q
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["blas3.paper_100mb",
                                      "mixtral.prefill_heavy"])
def test_a_short_run_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 101), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["count"] == 1
    assert "setup_s" in res["metrics"]
