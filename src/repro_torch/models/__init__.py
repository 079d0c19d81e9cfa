"""The dense LM decoders, ported: layers, the transformer stack and the
zoo utilities (``repro.models``)."""
from . import layers, model_zoo, transformer
from .model_zoo import count_params, init_cache
from .transformer import Transformer, init_lm
