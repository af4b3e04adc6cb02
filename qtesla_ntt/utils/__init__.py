from . import native, timing  # noqa: F401
from .cache import compile_cache_dir, enable_compile_cache  # noqa: F401
