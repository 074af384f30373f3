"""Training smoke qwen2-moe-a2.7b (the MoE family) through the port against
the reference, on the CPU: the cases of ``_torch_family_train``, and the
gradients of an expert that no kept token reaches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_family_train import *  # noqa: F401,F403 -- the shared cases
from _torch_family_train import family_fixture, flat, torch_batch
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.optim import adamw_init as ref_adamw_init
from repro_torch.convert import params_from_jax
from repro_torch.launch.steps import make_train_step
from repro_torch.models import api
from repro_torch.nn import install_plan
from repro_torch.optim import adamw_init
from repro_torch.tree import leaves
from test_torch_plan import one_blas_thread  # noqa: F401

family = family_fixture("qwen2-moe-a2.7b")


@pytest.fixture(scope="module")
def one_step_of_two_tokens(family):
    """Two tokens, top-2 of 6 experts, through the reference: its gradients
    and its parameters and AdamW state after one step."""
    batch = family.batch(b=1, s=2, seed=3)
    _, rgrads = family.reference(family.cfg.loss_chunk, b=1, s=2, seed=3)
    rparams, ropt, _ = jax.jit(ref_make_train_step(family.rcfg))(
        family.rparams, ref_adamw_init(family.rparams), jax.tree.map(jnp.asarray, batch))
    return batch, rgrads, rparams, ropt


@pytest.mark.parametrize("backend", [None, "streaming_tt"])
def test_an_expert_with_no_kept_token_gets_zero_gradients(family, backend,
                                                           one_step_of_two_tokens):
    """Each layer leaves at least two experts without a token.  On a kernel
    plan the batched call runs them too, at zero input, as the reference's
    ``vmap`` does; their gradient slices are exact zeros, so after one
    AdamW step their moments are zero and their weights have only decayed,
    as in the reference."""
    batch, rgrads, rparams, ropt = one_step_of_two_tokens
    install_plan(family.plan(backend))
    params = family.params()
    opt = adamw_init(params)
    loss = api(family.cfg, device="cpu").train_loss(params, torch_batch(batch))
    loss.backward()
    for layer, blk in enumerate(params["blocks"]):
        for name in ("eu", "eg", "ed"):
            for core, p in blk["moe"][name].items():
                want = rgrads["blocks"]["moe"][name][core][layer]
                zero = [e for e in range(want.shape[0]) if not want[e].any()]
                assert len(zero) >= 2, (layer, name, core)
                for e in zero:
                    assert not p.grad[e].any(), (layer, name, core, e)
    for p in leaves(params):
        p.grad = None
    params, opt, _ = make_train_step(family.cfg)(params, opt, torch_batch(batch))
    install_plan(None)
    got = flat(params)
    want = flat(params_from_jax(jax.tree.map(np.asarray, rparams)))
    for key in want:
        np.testing.assert_allclose(got[key].detach().numpy(), want[key].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    want_m = flat(params_from_jax(jax.tree.map(np.asarray, ropt.m)))
    for key, m in flat(opt.m).items():
        if "/moe/e" in key:
            np.testing.assert_array_equal(m.numpy() == 0, want_m[key].numpy() == 0,
                                          err_msg=key)
