"""Model zoo of the port: the decoder LM (dense and ssm families, with the
training loss ``LM.loss_fn``) and its layers."""

from .config import ModelConfig
from .lm import LM, Cache
from .param import ArrayDecl, init_params, param_count, params_from_numpy

__all__ = ["ModelConfig", "LM", "Cache", "ArrayDecl", "init_params",
           "param_count", "params_from_numpy", "build_model"]


def build_model(cfg: ModelConfig) -> LM:
    """Family-dispatching factory (the port builds ``dense`` and ``ssm``)."""
    return LM(cfg)
