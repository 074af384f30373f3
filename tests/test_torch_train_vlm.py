"""Training smoke internvl2-2b (the VLM family: a frontend prefix before
the tokens) through the port against the reference, on the CPU: the cases
of ``_torch_family_train``, and a ragged loss chunk."""

from _torch_family_train import *  # noqa: F401,F403 -- the shared cases
from _torch_family_train import check_against_reference, family_fixture
from test_torch_plan import one_blas_thread  # noqa: F401

family = family_fixture("internvl2-2b")


def test_a_ragged_loss_chunk_takes_the_whole_sequence(family):
    """``loss_chunk`` 8 at 12 tokens (12 % 8 != 0): one chunk of the whole
    sequence, as in the reference (the VLM, with its frontend, on K1)."""
    check_against_reference(family, "streaming_tt", 8, 12)
