"""chatglm3-smoke (the dense family with GLM's 2d partial rotary,
``qkv_bias`` and the chunked loss) through the port against the
reference on one process, on the CPU: the training cases of
``_torch_family_train`` (loss and every gradient leaf at 1e-4 under no
plan and the smoke train plan forced to K1 / to K2-K5, ``loss_chunk`` 0
and 8, remat, AdamW, int8 codes, the train CLI, checkpoints), and the
prefill logits and decode step at the reference's fp32 tolerance (1e-4 x
max |logit|)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.models import api as ref_api

from _torch_family_train import *  # noqa: F401,F403 -- the shared cases
from _torch_family_train import check_against_reference, family_fixture
from test_torch_plan import one_blas_thread  # noqa: F401
from repro_torch.models import api
from repro_torch.nn import install_plan, rope

family = family_fixture("chatglm3-6b")


def test_the_smoke_config_takes_the_glm_sites(family):
    """What this module exercises: GLM's 2d rotary on half of each head,
    biased q/k/v projections, 2 kv heads and the chunked loss."""
    cfg = family.cfg
    assert cfg.rope == "glm2d" and rope.rope_for("glm2d")[0] == 0.5
    assert cfg.qkv_bias and cfg.n_kv_heads == 2 and cfg.loss_chunk == 256
    assert "b" in family.params()["blocks"][0]["attn"]["wq"]


def test_four_loss_chunks_match_reference(family):
    """``loss_chunk`` 8 at 32 tokens: four interleaved chunks, on K1."""
    check_against_reference(family, "streaming_tt", 8, 32)


@pytest.mark.parametrize("backend", [None, "streaming_tt"])
def test_prefill_and_decode_logits_match_reference(family, backend):
    """Prefill logits of every position and one decode step's, against the
    reference's plain path at 1e-4 x max |logit|."""
    batch = family.batch(s=12)
    rm = ref_api(family.rcfg, plan=None)

    @jax.jit
    def ref(params, tokens):
        logits, caches = rm.prefill_full(params, {"tokens": tokens}, 16)
        nxt = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        step, _ = rm.decode_step(params, nxt, caches, jnp.asarray(12, jnp.int32))
        return logits, nxt, step

    want, nxt, want_step = (np.asarray(t) for t in ref(family.rparams,
                                                        jnp.asarray(batch["tokens"])))
    install_plan(None)
    m = api(family.cfg, plan=family.plan(backend), device="cpu")
    params = family.params()
    with torch.no_grad():
        got, caches = m.prefill_full(params, {"tokens": torch.from_numpy(
            batch["tokens"]).long()}, 16)
        step, _ = m.decode_step(params, torch.from_numpy(np.array(nxt)).long(), caches,
                                torch.tensor(12))
    install_plan(None)
    for g, w in ((got, want), (step, want_step)):
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()
