from selftoktokenizer_tpu_torch.pipeline.pipeline import SelftokPipeline  # noqa: F401
