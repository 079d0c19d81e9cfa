from . import ops, ref
from .ops import flash_attention
