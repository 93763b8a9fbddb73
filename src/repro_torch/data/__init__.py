"""The synthetic LM data pipeline (counterpart of ``repro.data``; the
reference's ``spatial_router`` is ROADMAP A4b)."""

from .pipeline import DataConfig, SyntheticLM, make_batch_fn  # noqa: F401
