"""The modules a run's process may not hold: JAX and the JAX package."""
import sys

#: top-level module names that may not be loaded in the run's process
BARRED = ("jax", "jaxlib", "flax", "repro")


def barred_modules(modules=None):
    """The barred top-level names among `modules` (default: what
    `sys.modules` holds), each compared whole (`repro_torch` is not
    `repro`)."""
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(BARRED))
