"""``repro_torch.dse`` — the DSE command-line entry point package.

Framework-neutral copy of ``src/repro/dse/__init__.py`` (the port never imports
the JAX package).

``python -m repro_torch.dse`` runs :func:`repro_torch.dse_cli.main`; the core
algorithm lives in ``repro_torch.core.dse`` (Algorithm 1) and the batched
cost-table engine in ``repro_torch.core.cost_table``.
"""

from repro_torch.dse_cli import main, run_dse

__all__ = ["main", "run_dse"]
