from repro_torch.data.pipeline import PipelineState, TokenPipeline  # noqa: F401
