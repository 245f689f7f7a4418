"""Config composition and instantiation (port of vitslam_tpu/config)."""
from .loader import DotDict, compose, instantiate, set_dotted

__all__ = ["DotDict", "compose", "instantiate", "set_dotted"]
