"""``examples/quickstart_torch.py`` on the CPU against the reference's
``examples/quickstart.py``, and every ``*_torch.py`` example's refusal of
``--device cuda`` on a machine without a card.

The DSE is framework-neutral, so the quickstart's DSE lines (steps 1-3,
the plan line and the hardware co-search line) are the reference's.  The
weights are the port's own (a ``torch.Generator``), so the forward and
planned-execution lines are checked for their form only.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from test_torch_examples import EXAMPLES, ROOT, TIMEOUT_S, _run


def _dse_lines(lines: list[str]) -> list[str]:
    keep = ("dense params:", "top-K path MACs:", "dense GEMM MACs:", "fpga_vu9p:",
            "tpu_v5e:", "plan:", "hw co-search")
    return [ln for ln in lines if ln.startswith(keep)]


def test_quickstart_prints_the_references_dse_lines():
    port = _run([os.path.join(EXAMPLES, "quickstart_torch.py"), "--device", "cpu"])
    ref = _run([os.path.join(EXAMPLES, "quickstart.py")], port=False)
    assert len(_dse_lines(ref)) == 7
    assert _dse_lines(port) == _dse_lines(ref)
    assert any(ln.startswith("forward: (256, 1024) -> (256, 4096) finite: True")
               for ln in port)
    planned = [ln for ln in port if ln.startswith("planned execution")]
    assert planned and "[('demo', 'streaming_tt')]" in planned[0]
    # the plain versions run on the CPU: no kernel launch is counted
    launches = port[-1].removeprefix("kernel launches on cpu: ")
    assert launches != port[-1]
    assert not any(json.loads(launches.replace("'", '"')).values())


@pytest.mark.parametrize("example", ["quickstart_torch.py", "train_tt_lm_torch.py"])
def test_device_cuda_without_a_card_is_an_error(example):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, os.path.join(EXAMPLES, example)],
                         env=env, capture_output=True, text=True,
                         timeout=TIMEOUT_S, cwd=ROOT)
    assert res.returncode == 2
    assert "no CUDA device" in res.stderr
