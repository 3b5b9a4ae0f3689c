"""Read the JAX package's pickle checkpoints without jax.

The JAX package writes ``model_{iteration}`` (flowtron_tpu/train/
checkpoints.py:_write_checkpoint: ``{"params", "opt_state", "iteration",
"learning_rate", "config"}``) and ``waveglow_{iteration}``
(scripts/train_waveglow.py: ``{"params", "config"}``) with ``pickle``:
numpy leaves, and an optimizer state made of optax's and the JAX
package's NamedTuples. ``load_jax_pickle`` unpickles such a file with a
restricted unpickler: numpy arrays and dtypes (under numpy 1's and 2's
module names), and stand-ins for the optimizer-state classes, which take
their fields positionally as the NamedTuples do. Nothing of jax, optax or
``flowtron_tpu`` is imported, and any other global raises
``pickle.UnpicklingError`` naming it before anything of it runs.

optax moves its classes between modules across versions
(``optax._src.transform.ScaleByAdamState``, ``optax._src.base.EmptyState``,
``optax.transforms._masking.MaskedState`` / ``MaskedNode`` in 0.2), so
those are matched by class name under any ``optax`` module.
"""

import pickle
from collections import namedtuple

import numpy as np

RAdamState = namedtuple("RAdamState", "count exp_avg exp_avg_sq")
ScaleByAdamState = namedtuple("ScaleByAdamState", "count mu nu")
EmptyState = namedtuple("EmptyState", "")
MaskedState = namedtuple("MaskedState", "inner_state")
MaskedNode = namedtuple("MaskedNode", "")

_OPTAX = {cls.__name__: cls for cls in (ScaleByAdamState, EmptyState,
                                        MaskedState, MaskedNode)}
# numpy's array unpickler, under whichever module this numpy names it
_reconstruct = np.ndarray.__reduce__(np.zeros(0))[0]
_ALLOWED = {
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
    ("numpy._core.multiarray", "_reconstruct"): _reconstruct,
    ("numpy.core.multiarray", "_reconstruct"): _reconstruct,
    ("flowtron_tpu.train.radam", "RAdamState"): RAdamState,
}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _ALLOWED:
            return _ALLOWED[(module, name)]
        if (module == "optax" or module.startswith("optax.")) \
                and name in _OPTAX:
            return _OPTAX[name]
        raise pickle.UnpicklingError(
            f"global {module}.{name} is not allowed in a JAX checkpoint")


def load_jax_pickle(path):
    """The payload dict of a JAX package pickle checkpoint at ``path``."""
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def adam_moments(opt_state):
    """The first RAdam or Adam state in a (chained, masked) optimizer
    state, as ``(count, first moments, second moments)``; the moment trees
    hold ``MaskedNode`` where a leaf was frozen."""
    if isinstance(opt_state, RAdamState):
        return opt_state
    if isinstance(opt_state, ScaleByAdamState):
        return RAdamState(*opt_state)
    if isinstance(opt_state, MaskedState):
        return adam_moments(opt_state.inner_state)
    if isinstance(opt_state, tuple):
        for item in opt_state:
            found = adam_moments(item)
            if found is not None:
                return found
    return None
