"""Data pipeline: deterministic token streams with prefetch overlap."""

from .pipeline import (DataConfig, SyntheticLM, FileTokenSource,
                       Prefetcher, make_pipeline)

__all__ = ["DataConfig", "SyntheticLM", "FileTokenSource", "Prefetcher",
           "make_pipeline"]
