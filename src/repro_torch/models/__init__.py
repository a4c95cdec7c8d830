"""Model zoo of the port: the decoder LM (dense, vlm, moe, ssm and hybrid
families, with the training loss ``LM.loss_fn``), the encoder-decoder
(``EncDecLM``) and their layers."""

from .config import ModelConfig
from .encdec import EncDecCache, EncDecLM
from .lm import LM, Cache
# the function shadows its module's name here: reach the module itself
# through importlib.import_module("repro_torch.models.moe")
from .moe import moe, moe_decls
from .param import ArrayDecl, init_params, param_count, params_from_numpy

__all__ = ["ModelConfig", "LM", "Cache", "EncDecLM", "EncDecCache",
           "ArrayDecl", "init_params", "param_count", "params_from_numpy",
           "build_model", "moe", "moe_decls"]


def build_model(cfg: ModelConfig) -> LM | EncDecLM:
    """Family-dispatching factory: ``encdec`` builds ``EncDecLM``; ``dense``,
    ``vlm``, ``moe``, ``ssm`` and ``hybrid`` build ``LM``, which raises
    ``ValueError`` for any other family."""
    if cfg.family == "encdec":
        return EncDecLM(cfg)
    return LM(cfg)
