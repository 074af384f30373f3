"""The port's examples (``examples/*_torch.py``) on the CPU, each in a
subprocess with a time limit, with neither ``jax`` nor ``repro`` imported.

The DSE is framework-neutral, so ``dse_explore_torch.py`` (host-only, no
``--device``) prints what ``examples/dse_explore.py`` prints, its
wall-clock timings aside.  The
train example runs the smoke tt-lm for 40 steps, its checkpoints under
``tmp_path``, and must end below its first loss.  The quickstart and
``--device cuda`` without a card: ``test_torch_quickstart.py``.
"""

from __future__ import annotations

import os
import subprocess
import sys


ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
EXAMPLES = os.path.join(ROOT, "examples")
TIMEOUT_S = 120

#: runs an example as ``__main__``, then prints the JAX modules it imported
RUNNER = """
import json, runpy, sys
sys.argv = sys.argv[1:]
code = 0
try:
    runpy.run_path(sys.argv[0], run_name="__main__")
except SystemExit as e:
    code = e.code or 0
bad = sorted(k for k in sys.modules
             if k in ("jax", "repro") or k.startswith(("jax.", "repro.")))
print("IMPORTED " + json.dumps(bad))
sys.exit(code)
"""


def _run(argv: list[str], port: bool = True) -> list[str]:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = ([sys.executable, "-c", RUNNER] if port else [sys.executable]) + argv
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=TIMEOUT_S, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    if port:
        assert lines[-1] == "IMPORTED []"
        lines = lines[:-1]
    return lines


def test_dse_explore_prints_the_references_report():
    port = _run([os.path.join(EXAMPLES, "dse_explore_torch.py")])
    ref = _run([os.path.join(EXAMPLES, "dse_explore.py")], port=False)

    def untimed(lines):
        return [ln for ln in lines if not ln.strip().startswith("path search")]

    assert len(untimed(port)) == len(port) - 1
    assert untimed(port) == untimed(ref)


def test_train_tt_lm_reduces_the_loss(tmp_path):
    lines = _run([os.path.join(EXAMPLES, "train_tt_lm_torch.py"), "--device", "cpu",
                  "--smoke", "--steps", "40", "--batch", "4", "--seq", "32",
                  "--ckpt-dir", str(tmp_path / "ck")])
    assert lines[0].startswith("arch tt-lm-smoke:") and lines[0].endswith("on cpu")
    assert lines[-1].startswith("done at step 40: loss ")
