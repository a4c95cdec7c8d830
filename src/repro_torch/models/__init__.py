"""Model zoo of the port: the decoder LM (dense, moe and ssm families, with
the training loss ``LM.loss_fn``) and its layers."""

from .config import ModelConfig
from .lm import LM, Cache
# the function shadows its module's name here: reach the module itself
# through importlib.import_module("repro_torch.models.moe")
from .moe import moe, moe_decls
from .param import ArrayDecl, init_params, param_count, params_from_numpy

__all__ = ["ModelConfig", "LM", "Cache", "ArrayDecl", "init_params",
           "param_count", "params_from_numpy", "build_model", "moe",
           "moe_decls"]


def build_model(cfg: ModelConfig) -> LM:
    """Family-dispatching factory (the port builds ``dense``, ``moe`` and
    ``ssm``)."""
    return LM(cfg)
