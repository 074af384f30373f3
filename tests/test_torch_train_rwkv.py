"""Training smoke rwkv6-7b (the RWKV6 family) through the port against the
reference, on the CPU: the cases of ``_torch_family_train``."""

from _torch_family_train import *  # noqa: F401,F403 -- the shared cases
from _torch_family_train import family_fixture
from test_torch_plan import one_blas_thread  # noqa: F401

family = family_fixture("rwkv6-7b")
