"""The cases that train one smoke model of the MoE, hybrid (Mamba2), RWKV6
or VLM family through the port against the reference, on the CPU.

Each family's test module (``test_torch_train_{moe,hybrid,rwkv,vlm}.py``)
imports these cases and binds ``family`` to its arch with
:func:`family_fixture`; one module per family lets the four run on four
workers.

Each family's smoke train plan is emitted by the port's DSE (``--smoke
--mode train --top-k 2 --tokens 32``) with every layer forced to one
kernel backend (``--plan-backend streaming_tt`` / ``tt_gemm``), so that the
port's backward runs through the plain versions of K1 (forward and dx) and
of K2-K5 (the smoke plans' OS and IS dataflows, fused segments).  The
reference runs its plain path (no plan) under ``jax.value_and_grad``: its
Pallas kernels in interpret mode took 10-35 s a case under ``jax.grad``,
and a plan changes only the order of fp32 sums, well inside the tolerance.
Weights come from the reference's ``init_params``
(``repro_torch.convert.params_from_jax``); batches are made from a seed
with numpy.

Tolerance 1e-4 (rtol and atol) for losses and every gradient leaf, the
reference's gradcheck tolerance (``tests/test_backward.py:40``): both sides
sum in fp32, in another order.  The port's ``remat`` modes are held
bit-equal to ``"none"``; int8 gradient codes are held equal.
"""

from __future__ import annotations

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.configs import get_config as ref_get_config
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import api as ref_api
from repro.models.lm import count_params as ref_count_params
from repro.nn import install_plan as ref_install_plan
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import clip_by_global_norm as ref_clip_by_global_norm
from repro.optim import compress_init as ref_compress_init
from repro.optim import int8_quantize as ref_int8_quantize
from repro_torch import dse_cli
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import train as port_train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import api
from repro_torch.models.lm import count_params
from repro_torch.nn import install_plan
from repro_torch.optim import adamw_init, clip_by_global_norm, compress_init, int8_quantize
from repro_torch.plan import execution_log, load_plan, reset_execution_log
from repro_torch.tree import leaves, map_tree

torch.set_num_threads(2)

#: the cases each family's module imports (``from _torch_family_train
#: import *``) and runs with its own ``family``
__all__ = ["test_train_loss_and_gradients_match_reference",
           "test_remat_modes_are_bit_equal_to_none",
           "test_two_adamw_steps_match_reference",
           "test_a_compressed_step_sends_the_references_int8_codes",
           "test_count_params_matches_reference",
           "test_train_cli_trains_each_family_under_a_kernel_plan",
           "test_checkpoints_restore_across_packages"]

BACKENDS = ("streaming_tt", "tt_gemm")
TOL = dict(rtol=1e-4, atol=1e-4)
BATCH, SEQ = 2, 16


class Family:
    """One smoke model in both packages (the same weights), its smoke train
    plan forced to each kernel backend, and the reference's loss and
    gradients, computed once per batch and loss setting."""

    def __init__(self, arch: str, plan_dir: str):
        self.arch = arch
        self.cfg = get_config(arch, smoke=True)
        self.rcfg = ref_get_config(arch, smoke=True)
        self.rparams = jax.jit(ref_api(self.rcfg, plan=None).init_params)(
            jax.random.PRNGKey(0))
        self.plan_files = {}
        for backend in BACKENDS:
            path = os.path.join(plan_dir, f"{arch}.{backend}.train.json")
            with contextlib.redirect_stdout(io.StringIO()):
                assert dse_cli.main(
                    ["--arch", arch, "--smoke", "--mode", "train", "--top-k", "2",
                     "--tokens", "32", "--plan-backend", backend, "--emit-plan",
                     path, "--out", os.devnull]) == 0
            self.plan_files[backend] = path
        self._refs: dict = {}

    def params(self) -> dict:
        """Fresh port parameters that require grad."""
        p = params_from_jax(jax.tree.map(np.asarray, self.rparams))
        for leaf in leaves(p):
            leaf.requires_grad_(True)
        return p

    def batch(self, b: int = BATCH, s: int = SEQ, seed: int = 0) -> dict:
        rng = np.random.default_rng(seed)
        out = {k: rng.integers(0, self.cfg.vocab, (b, s)).astype(np.int32)
               for k in ("tokens", "labels")}
        if self.cfg.family == "vlm":
            out["frontend"] = rng.normal(
                size=(b, self.cfg.n_frontend_tokens, self.cfg.d_model)).astype(np.float32)
        return out

    def plan(self, backend):
        return None if backend is None else load_plan(self.plan_files[backend])

    def reference(self, loss_chunk: int, b: int = BATCH, s: int = SEQ,
                  seed: int = 0) -> tuple[float, dict]:
        """The reference's loss and gradients (its tree, numpy leaves) of
        ``batch(b, s, seed)`` at ``loss_chunk``, on its plain path."""
        key = (loss_chunk, b, s, seed)
        if key not in self._refs:
            ref_install_plan(None)
            rm = ref_api(self.rcfg.with_(loss_chunk=loss_chunk), plan=None)
            rloss, rgrads = jax.jit(jax.value_and_grad(rm.train_loss))(
                self.rparams, jax.tree.map(jnp.asarray, self.batch(b, s, seed)))
            self._refs[key] = float(rloss), jax.tree.map(np.asarray, rgrads)
        return self._refs[key]


def family_fixture(arch: str):
    """A module-scoped ``family`` fixture bound to ``arch``; it also clears
    both packages' installed plans when the module ends."""

    @pytest.fixture(scope="module")
    def family(tmp_path_factory) -> Family:
        yield Family(arch, str(tmp_path_factory.mktemp("plans")))
        ref_install_plan(None)
        install_plan(None)

    return family


def torch_batch(batch: dict) -> dict:
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k in ("tokens", "labels"):
        out[k] = out[k].long()
    return out


def flat(tree, prefix=""):
    """``{path: leaf}`` of a tree (dict keys, sequence indices)."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in flat(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree)
                for k, v in flat(t, f"{prefix}[{i}]").items()}
    return {prefix: tree}


def port_loss_and_grads(fam: Family, cfg, batch, plan):
    install_plan(None)
    m = api(cfg, plan=plan, device="cpu")
    params = fam.params()
    loss = m.train_loss(params, torch_batch(batch))
    loss.backward()
    return loss.detach(), {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                           for k, p in flat(params).items()}


def check_against_reference(family: Family, backend, loss_chunk: int, seq: int = SEQ):
    """The port's loss and every gradient leaf under ``backend`` against
    the reference's at 1e-4; the port's execution log shows the backend's
    forward records and tt_gemm weight gradients (none without a plan)."""
    rloss, rgrads = family.reference(loss_chunk, s=seq)
    want = flat(params_from_jax(rgrads))
    reset_execution_log()
    loss, got = port_loss_and_grads(family, family.cfg.with_(loss_chunk=loss_chunk),
                                    family.batch(s=seq), family.plan(backend))
    assert loss.item() == pytest.approx(rloss, rel=1e-4)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), **TOL,
                                   err_msg=key)
    log = execution_log()
    if backend is None:
        assert not log
    else:
        assert {r["backend"] for r in log if r["phase"] == "bwd"} >= {"tt_gemm"}
        assert {r["backend"] for r in log if r["phase"] == "fwd"} == {backend}


# ---------------------------------------------------------------------------
# the cases each family's module runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loss_chunk", [0, 8])
@pytest.mark.parametrize("backend", (None,) + BACKENDS)
def test_train_loss_and_gradients_match_reference(family, backend, loss_chunk):
    """Loss and every gradient leaf at 1e-4, under no plan (the plain
    executor) and under the smoke train plan forced to K1 / to K2-K5;
    ``loss_chunk`` 0 (one cross-entropy over the full logits) and 8 (two
    interleaved chunks at 16 tokens)."""
    check_against_reference(family, backend, loss_chunk)


@pytest.mark.parametrize("backend", [None, "streaming_tt"])
def test_remat_modes_are_bit_equal_to_none(family, backend):
    """``remat="full"`` and ``"dots"`` change no bit of the loss or of any
    gradient.  Under a kernel plan the recompute runs each planned forward
    again: ``"full"`` logs every forward record at least twice (a hybrid's
    Mamba layers three times: their group is recomputed, then each layer
    inside it, as under the reference's nested ``jax.checkpoint``)."""
    plan = family.plan(backend)
    batch = family.batch()
    runs, fwd = {}, {}
    for mode in ("none", "full", "dots"):
        reset_execution_log()
        runs[mode] = port_loss_and_grads(family, family.cfg.with_(remat=mode),
                                         batch, plan)
        fwd[mode] = sum(r["phase"] == "fwd" for r in execution_log())
    loss, grads = runs["none"]
    for mode in ("full", "dots"):
        assert torch.equal(runs[mode][0], loss), mode
        for key, g in grads.items():
            assert torch.equal(runs[mode][1][key], g), (mode, key)
    if backend is not None:
        nested = family.cfg.family == "hybrid"
        assert (fwd["full"] > 2 * fwd["none"] > 0) if nested else \
            (fwd["full"] == 2 * fwd["none"] > 0)


@pytest.mark.parametrize("grad_compress", [False, True])
def test_two_adamw_steps_match_reference(family, grad_compress):
    """Two steps of ``make_train_step`` (clip, [int8 round-trip], AdamW):
    the loss curve and the gradient norms at 1e-4."""
    rm_step = jax.jit(ref_make_train_step(family.rcfg, grad_compress=grad_compress))
    ref_install_plan(None)
    rparams = family.rparams
    ropt = ref_adamw_init(rparams)
    if grad_compress:
        ropt = (ropt, ref_compress_init(rparams))
    install_plan(None)
    step = make_train_step(family.cfg, grad_compress=grad_compress)
    params = family.params()
    opt = adamw_init(params)
    if grad_compress:
        opt = (opt, compress_init(params))
    for i in range(2):
        batch = family.batch(seed=10 + i)
        rparams, ropt, rmetrics = rm_step(rparams, ropt,
                                          jax.tree.map(jnp.asarray, batch))
        params, opt, metrics = step(params, opt, torch_batch(batch))
        for k in ("loss", "grad_norm"):
            assert metrics[k].item() == pytest.approx(float(rmetrics[k]), rel=1e-4), (i, k)


def stacked(tree):
    """The port's tree in the reference's layout: layer stacks stacked."""
    if isinstance(tree, dict):
        return {k: stacked(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return map_tree(lambda *xs: torch.stack(xs), *tree)
    return tree


def test_a_compressed_step_sends_the_references_int8_codes(family):
    """Step 0 of ``--grad-compress``: the clipped gradients of both packages
    (no plan, ``loss_chunk`` 0) quantized per reference tensor.  The codes
    are equal, but where the two fp32 gradients (equal at 1e-4, summed in
    another order) straddle a rounding boundary: every differing code is
    one step off, its inputs agree at the gradient tolerance and the
    half-way point between the two codes lies between them (each over its
    own scale).  Such straddles are rare: an element's chance is about the
    gap between its two inputs in code steps, ~1e-4 here (rwkv6: 17 of
    73 840 codes differ, in its ``tm`` leaves: the decay and mix LoRAs,
    ``wk``, ``wv``, ``cm_k``; zamba2 1, in ``ssm.wout``; the MoE and the VLM
    none), so at most one code in 1 000 may differ."""
    _, rgrads = family.reference(0)
    rgrads, _ = ref_clip_by_global_norm(jax.tree.map(jnp.asarray, rgrads), 1.0)
    install_plan(None)
    params = family.params()
    api(family.cfg.with_(loss_chunk=0), device="cpu").train_loss(
        params, torch_batch(family.batch())).backward()
    grads, _ = clip_by_global_norm(map_tree(lambda p: p.grad, params), 1.0)
    want = flat(jax.tree.map(np.asarray, rgrads))
    got = flat(stacked(grads))
    assert sorted(got) == sorted(want)
    flips = 0
    for key, g in got.items():
        q, scale = int8_quantize(g)
        rq, rscale = ref_int8_quantize(jnp.asarray(want[key]))
        assert scale.item() == pytest.approx(float(rscale), rel=1e-4), key
        diff = q.numpy() != np.asarray(rq)
        a, b = g.numpy()[diff], want[key][diff]
        assert np.all(np.abs(a - b) <= 1e-4 + 1e-4 * np.abs(b)), (key, a, b)
        qa, qb = q.numpy()[diff].astype(int), np.asarray(rq)[diff].astype(int)
        half = (qa + qb) / 2
        x, y = a / scale.item(), b / float(rscale)
        assert np.all(np.abs(qa - qb) == 1), (key, qa, qb)
        assert np.all((x - half) * (y - half) <= 0), (key, x, y)
        flips += int(diff.sum())
    assert flips <= 1e-3 * sum(g.numel() for g in got.values())


def test_count_params_matches_reference(family):
    assert count_params(family.params()) == ref_count_params(family.rparams) > 0


def test_train_cli_trains_each_family_under_a_kernel_plan(family, tmp_path, capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu`` under the
    streaming plan: exit 0, finite losses, K1 forward and backward records,
    the parameter count printed."""
    out = port_train.run(
        ["--arch", family.arch, "--smoke", "--device", "cpu", "--plan",
         family.plan_files["streaming_tt"], "--steps", "2", "--batch", "2",
         "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert out.code == 0 and len(out.losses) == 2
    assert all(np.isfinite(out.losses + out.grad_norms))
    assert out.fwd_backends == ["streaming_tt"]
    assert "streaming_tt" in out.bwd_backends
    assert out.n_params == ref_count_params(family.rparams)
    assert f"{out.n_params} parameters" in capsys.readouterr().out


def test_checkpoints_restore_across_packages(family, tmp_path):
    """A ``--grad-compress`` train run's checkpoint (params, (AdamWState,
    CompressState)) written by the port restores in the reference, and one
    written by the reference restores in the port: the same keys, shapes,
    dtypes and values.  The trees hold the stacked experts, the hybrid's
    ``shared_attn`` and RWKV's ``tm`` dict."""
    ck = tmp_path / "port"
    assert port_train.run(
        ["--arch", family.arch, "--smoke", "--device", "cpu", "--grad-compress",
         "--steps", "1", "--batch", "2", "--seq", "16",
         "--ckpt-dir", str(ck)]).code == 0
    rtemplate = {"params": family.rparams,
                 "opt": (ref_adamw_init(family.rparams),
                         ref_compress_init(family.rparams))}
    params = family.params()
    template = {"params": params, "opt": (adamw_init(params), compress_init(params))}
    step, restored = CheckpointManager(str(ck)).restore(template)
    rstep, rrestored = RefCheckpointManager(str(ck)).restore(rtemplate)
    assert step == rstep == 1
    assert int(restored["opt"][0].step) == 1
    _assert_same_state(restored, rrestored)

    rck = tmp_path / "ref"
    RefCheckpointManager(str(rck)).save(3, rtemplate)
    step, restored = CheckpointManager(str(rck)).restore(template)
    assert step == 3
    _assert_same_state(restored, rtemplate)


def _assert_same_state(state, rstate):
    """A port train state equals a reference one, leaf by leaf, once the
    reference's stacked layers are split as the port keeps them."""
    def split(tree):
        return params_from_jax(jax.tree.map(np.asarray, tree))

    adam, comp = rstate["opt"]
    want = flat({"params": split(rstate["params"]),
                 "opt": ([np.asarray(adam.step), split(adam.m), split(adam.v)],
                         [split(comp.residual)])})
    got = flat({"params": state["params"],
                "opt": ([state["opt"][0].step, state["opt"][0].m, state["opt"][0].v],
                        [state["opt"][1].residual])})
    assert sorted(got) == sorted(want)
    for key, a in got.items():
        b = np.asarray(want[key])
        assert a.dtype == torch.from_numpy(np.array(b)).dtype, key
        np.testing.assert_array_equal(a.detach().numpy(), b, err_msg=key)

