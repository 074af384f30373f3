"""The train driver across ranks, on the CPU: ``launch.train.run`` on 2
``gloo`` ranks (``tests/_torch_shard_ranks.py``, 60 s limit a spawn) and
under ``torchrun``.

* tt-lm-smoke under its K1 train plan, its batch of 2 split over the
  ranks: the 2-rank loss curve against the port's single process at rel
  1e-4 (the ranks sum their gradients in another order, and the CPU plain
  K1 is not row-independent; ``tests/test_torch_shard_train.py`` holds the
  gradients to the reference), one gradient sum and the loss's sum a
  step and no collective of a projection, rank 0's report with the layout
  and mesh lines;
* dense tt-lm-smoke, whose embedding ``param_shardings`` splits: the
  ranks' checkpoint (rank 0 writes the moments gathered whole) restores in
  the reference's ``CheckpointManager``.  On a batch of 3, which stays
  replicated, it equals the single process's bit for bit (the split AdamW
  update is elementwise); on the split batch of 2 it matches it at rel
  1e-4.  A 2-rank ``--resume`` of the split run continues the
  uninterrupted run's losses exactly.
"""

from __future__ import annotations

import contextlib
import io
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.configs import get_config as ref_get_config
from repro.models import api as ref_api
from repro.optim import adamw_init as ref_adamw_init

from _torch_shard_ranks import PLANS, SRC, spawn
from repro_torch.launch import train

TT = ["--smoke", "--device", "cpu", "--plan", str(PLANS / "tt-lm-smoke.train.json"),
      "--batch", "2", "--seq", "16", "--log-every", "1"]


def _dense(batch: int) -> list[str]:
    return ["--smoke", "--dense", "--device", "cpu", "--batch", str(batch),
            "--seq", "16", "--log-every", "1"]


DENSE = _dense(2)
#: a batch of 3 does not divide over the 2 ranks: it stays replicated
REPLICATED = _dense(3)


def _runs(d: pathlib.Path) -> list:
    return [("curve", TT + ["--steps", "2", "--ckpt-dir", str(d / "curve")]),
            ("straight", DENSE + ["--steps", "3", "--ckpt-dir", str(d / "a")]),
            ("first", DENSE + ["--steps", "2", "--ckpt-every", "1",
                               "--ckpt-dir", str(d / "b")]),
            ("resumed", DENSE + ["--steps", "3", "--resume",
                                 "--ckpt-dir", str(d / "b")]),
            ("replicated", REPLICATED + ["--steps", "3", "--ckpt-dir", str(d / "c")])]


@pytest.fixture(scope="module")
def two(tmp_path_factory) -> tuple[list[dict], pathlib.Path]:
    d = tmp_path_factory.mktemp("two")
    return spawn("train_cli", 2, {"reduce": False, "runs": _runs(d)}, d / "ranks"), d


def _single(argv) -> train.TrainRun:
    with contextlib.redirect_stdout(io.StringIO()):
        run = train.run(argv)
    assert run.code == 0
    return run


def test_two_ranks_follow_the_single_process_loss_curve(two, tmp_path):
    ranks, _ = two
    want = _single(TT + ["--steps", "2", "--ckpt-dir", str(tmp_path)])
    for i, rank in enumerate(ranks):
        got = rank["train_cli"]["curve"]
        assert got["code"] == 0, got["stdout"]
        assert got["losses"] == pytest.approx(want.losses, rel=1e-4)
        assert got["grad_norms"] == pytest.approx(want.grad_norms, rel=1e-4)
        # each rank its sequence: the loss's sum forward, the gradients'
        # sum after the backward, nothing from a projection
        assert all(c == {"fwd": {"all_gather": 0, "all_reduce": 1, "grad_all_reduce": 0},
                         "bwd": {"all_gather": 0, "all_reduce": 0, "grad_all_reduce": 1}}
                   for c in got["collectives"])
        if i == 0:
            assert "layout: batch split over data=2: 1 of 2 sequences a rank" in got["stdout"]
            assert got["stdout"].count("sharded planned execution: mesh data=2") == 1
            assert "(2 ranks, backend gloo, on the CPU)" in got["stdout"]
            assert "bwd backends ['streaming_tt', 'tt_gemm']" in got["stdout"]
        else:
            assert got["stdout"] == ""  # rank 0 prints the report
    assert ranks[0]["train_cli"]["curve"]["losses"] == ranks[1]["train_cli"]["curve"]["losses"]


def test_two_rank_resume_continues_the_same_losses(two):
    for rank in two[0]:
        runs = rank["train_cli"]
        assert all(runs[k]["code"] == 0 for k in ("straight", "first", "resumed"))
        assert runs["first"]["losses"] == runs["straight"]["losses"][:2]
        assert runs["resumed"]["done"] == 3
        assert runs["resumed"]["losses"] == runs["straight"]["losses"][2:]
    assert "resumed from step 2" in two[0][0]["train_cli"]["resumed"]["stdout"]


def test_two_rank_checkpoint_restores_in_the_reference(two, tmp_path):
    """Rank 0 wrote the dense smoke state after 3 steps, the embedding's
    moments gathered from both ranks' blocks: the reference restores it.
    The replicated run's equals the single process's checkpoint bit for
    bit; the split run's matches it at rel 1e-4 (the ranks' gradient sum
    adds the two blocks in another order)."""
    _, d = two
    rm = ref_api(ref_get_config("tt-lm-100m", tt=False, smoke=True))
    params = rm.init_params(jax.random.PRNGKey(0))
    template = {"params": params, "opt": ref_adamw_init(params)}
    for sub, argv, exact in (("c", REPLICATED, True), ("a", DENSE, False)):
        _single(argv + ["--steps", "3", "--ckpt-dir", str(tmp_path / sub)])
        step, got = RefCheckpointManager(str(d / sub)).restore(template)
        _, want = RefCheckpointManager(str(tmp_path / sub)).restore(template)
        assert step == 3
        leaves = jax.tree.leaves(got)
        assert any(np.asarray(x).shape == (512, 128) for x in leaves)
        for g, w in zip(leaves, jax.tree.leaves(want)):
            if exact:
                assert np.array_equal(np.asarray(g), np.asarray(w))
            else:
                np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                           rtol=1e-4, atol=1e-6)


def test_torchrun_trains_on_two_ranks(tmp_path):
    """``launch.train`` under torchrun joins the ranks itself (env://)."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(SRC), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *TT,
         "--steps", "2", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=60, env=env,
        cwd=pathlib.Path(__file__).parent)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("sharded planned execution: mesh data=2") == 1
    assert "layout: batch split over data=2" in proc.stdout
    assert "(2 ranks, backend gloo, on the CPU)" in proc.stdout
    assert "finished at step 2" in proc.stdout
