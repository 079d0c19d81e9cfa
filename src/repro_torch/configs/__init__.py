from .base import ArchConfig, MoEConfig, MambaConfig, get_config, list_archs
