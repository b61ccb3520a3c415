"""The token data pipeline of the port (a copy of `repro.data`)."""
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: F401
