"""``nn.norms.layernorm`` / ``layernorm_init`` and ``serve.save_trace``
against the reference, on the CPU.

Layer norm at 1e-6 (both sides normalise in fp32); the trace file byte for
byte, for the same requests.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import layernorm as ref_layernorm
from repro.nn import layernorm_init as ref_layernorm_init
from repro.serve import save_trace as ref_save_trace
from repro.serve import synthetic_trace as ref_synthetic_trace
from repro_torch.nn import layernorm, layernorm_init
from repro_torch.serve import load_trace, save_trace, synthetic_trace


def _np(shape, seed, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            + shift).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_init_matches_reference(dtype):
    got = layernorm_init(24, getattr(torch, dtype), device="cpu")
    want = ref_layernorm_init(24, getattr(jnp, dtype))
    assert sorted(got) == sorted(want) == ["bias", "scale"]
    for k in want:
        assert got[k].dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32))


@pytest.mark.parametrize("shape,eps", [((2, 5, 24), 1e-5), ((7, 64), 1e-3)])
def test_layernorm_matches_reference(shape, eps):
    """Random scale and bias, inputs off zero mean and unit variance."""
    x = _np(shape, 0, scale=3.0, shift=1.5)
    params = {"scale": _np(shape[-1:], 1), "bias": _np(shape[-1:], 2)}
    got = layernorm({k: torch.from_numpy(v) for k, v in params.items()},
                    torch.from_numpy(x), eps=eps)
    want = ref_layernorm({k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(x), eps=eps)
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_layernorm_keeps_a_bf16_input_dtype():
    x = torch.from_numpy(_np((3, 16), 3)).to(torch.bfloat16)
    y = layernorm(layernorm_init(16, device="cpu"), x)
    want = ref_layernorm(ref_layernorm_init(16), jnp.asarray(x.float().numpy(),
                                                             jnp.bfloat16))
    assert y.dtype == torch.bfloat16
    np.testing.assert_array_equal(y.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("arrival_rate", [0.0, 2.5])
def test_save_trace_writes_the_references_bytes(tmp_path, arrival_rate):
    """The same synthetic requests written by both packages: the files are
    equal byte for byte, and ``load_trace`` reads the port's back."""
    kw = dict(n_requests=5, vocab=97, prompt_len=(3, 9), gen=(1, 6), seed=4,
              arrival_rate=arrival_rate)
    reqs = synthetic_trace(**kw)
    got, want = tmp_path / "port.json", tmp_path / "ref.json"
    save_trace(str(got), reqs)
    ref_save_trace(str(want), ref_synthetic_trace(**kw))
    assert got.read_bytes() == want.read_bytes()
    back = load_trace(str(got), vocab=97)
    assert [(r.prompt, r.max_new_tokens, r.arrival) for r in back] == \
        [(r.prompt, r.max_new_tokens, r.arrival) for r in reqs]
