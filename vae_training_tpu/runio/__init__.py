import os

# The checkout (or install) root: the package directory's parent.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_COMPILE_CACHE = os.path.join(_ROOT, ".jax_cache")


def compile_cache_dir() -> str | None:
    """Where compiled programs are cached: None when the environment's
    ``JAX_COMPILATION_CACHE_DIR`` is set (jax then reads it itself), else
    one fixed directory inside the checkout. The path is part of the
    cache's identity, so it must not move between runs."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return DEFAULT_COMPILE_CACHE


def enable_compile_cache() -> None:
    """Enable jax's persistent compilation cache: sweeps and repeated runs
    compile the same programs."""
    import jax

    cache_dir = compile_cache_dir()
    if cache_dir is not None:
        jax.config.update("jax_compilation_cache_dir", cache_dir)


from .checkpoint import (
    checkpoint_exists,
    restore_checkpoint,
    save_checkpoint,
    save_checkpoint_async,
)
from .export import load_model_pkl, save_model_pkl, to_reference_state_dict
from .outdir import get_output_dir, make_output_dir

__all__ = [
    "compile_cache_dir",
    "enable_compile_cache",
    "checkpoint_exists",
    "restore_checkpoint",
    "save_checkpoint",
    "save_checkpoint_async",
    "load_model_pkl",
    "save_model_pkl",
    "to_reference_state_dict",
    "get_output_dir",
    "make_output_dir",
]
