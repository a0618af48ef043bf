from .pipeline import PipelineConfig, TokenPipeline  # noqa: F401
