from repro_torch.configs.base import OneRecConfig, TransformerConfig  # noqa: F401
