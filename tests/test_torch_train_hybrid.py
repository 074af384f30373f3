"""Training smoke zamba2-1.2b (the hybrid family: Mamba2 layers and one
shared attention block) through the port against the reference, on the
CPU: the cases of ``_torch_family_train``."""

from _torch_family_train import *  # noqa: F401,F403 -- the shared cases
from _torch_family_train import family_fixture
from test_torch_plan import one_blas_thread  # noqa: F401

family = family_fixture("zamba2-1.2b")
