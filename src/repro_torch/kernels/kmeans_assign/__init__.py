from . import ops, ref
from .ops import kmeans_assign, kmeans_assign_chunked
