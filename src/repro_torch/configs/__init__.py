from repro_torch.configs.base import (OneRecConfig, ShapeSpec,  # noqa: F401
                                      TransformerConfig)
