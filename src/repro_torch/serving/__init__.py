from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: F401
