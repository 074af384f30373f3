"""Data pipeline."""

from .pipeline import DataSpec, SyntheticTokens, make_pipeline

__all__ = ["DataSpec", "SyntheticTokens", "make_pipeline"]
