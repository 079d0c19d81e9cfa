"""Import side-effect module: registers the dense decoders this slice
serves (the reference's other architectures: ``base.LATER``)."""
from . import mistral_nemo_12b, qwen2_7b, qwen3_8b  # noqa: F401
