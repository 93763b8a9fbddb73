from .registry import ARCHS, SHAPES, get_config, input_specs  # noqa: F401
