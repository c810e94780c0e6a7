from repro_torch.models.api import Model, make_model
from repro_torch.models.spec import ParamSpec, init_params, param_count, stacked

__all__ = ["Model", "make_model", "ParamSpec", "init_params", "param_count", "stacked"]
