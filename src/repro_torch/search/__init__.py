"""Guided exploration of the joint (arch, path, dataflow) design space.

Framework-neutral copy of ``src/repro/search/__init__.py`` (the port
never imports the JAX package).

The exhaustive search in ``repro_torch.core.dse`` is the optimality oracle;
this package is the scaling story: a budgeted evolutionary driver
(:func:`guided_search`) that scores candidate encodings
(:class:`Genome`) by reads of the same vectorized cost tables and
refines promising architectures *exactly* — so with budget to visit
everything it returns the oracle's answer bit-for-bit, and with less it
degrades gracefully (never worse than the fixed target, monotone in the
budget).  ``python -m repro_torch.dse --search guided`` is the CLI entry;
``tests/test_search_oracle.py`` holds the differential-oracle contract.
"""

from .encoding import ARCH_NEIGHBORS, Genome, JointSpace
from .guided import (
    DEFAULT_BUDGET_FRACTION,
    POPULATION,
    BudgetExhausted,
    guided_search,
)

__all__ = [
    "ARCH_NEIGHBORS",
    "BudgetExhausted",
    "DEFAULT_BUDGET_FRACTION",
    "Genome",
    "JointSpace",
    "POPULATION",
    "guided_search",
]
