"""Data pipelines of the port (``repro/data/``)."""
from repro_torch.data.pipeline import SyntheticLM, TextFileTokens, make_pipeline  # noqa: F401
