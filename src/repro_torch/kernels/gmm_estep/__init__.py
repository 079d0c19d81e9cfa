from . import ops, ref
from .ops import gmm_estep, gmm_estep_chunked
