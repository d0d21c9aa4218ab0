"""The synthetic token pipeline (a copy of the reference package's
``data``)."""

from .pipeline import DataConfig, SyntheticLM, make_pipeline

__all__ = ["DataConfig", "SyntheticLM", "make_pipeline"]
