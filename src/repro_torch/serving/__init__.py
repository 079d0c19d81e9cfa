"""LM serving with slot-based continuous batching, ported
(``repro.serving.serve_loop``)."""
from .serve_loop import Request, Server
