from .registry import ARCHS, SHAPES, get_config  # noqa: F401
