from repro_torch.models.base import (ModelConfig, QueryEncoder, make_model,
                                     model_names, params_from_numpy)

__all__ = ["ModelConfig", "QueryEncoder", "make_model", "model_names",
           "params_from_numpy"]
