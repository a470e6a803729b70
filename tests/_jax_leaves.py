"""Random leaves for JAX parameter trees in the port's decoder tests.

`model.init` leaves the decoders' output convolutions, adaLN-Zero gates,
mask tokens and biases at zero, so a parity test on an initialised tree
would compare outputs that do not depend on those layers. `redraw` replaces
every leaf of a tree by seeded numpy draws: matrices and kernels normal
with std 1/sqrt(fan_in), norm scales 1 + 0.1 N(0, 1), every other vector
0.1 N(0, 1). `init_variables` draws a whole variables tree from the
module's shapes (jax.eval_shape: nothing is initialised or compiled): the
codebook's `embed` as l2-normalised normal rows, its training state zero."""

import jax
import numpy as np


def redraw(tree, seed: int):
    rng = np.random.RandomState(seed)

    def walk(t):
        out = {}
        for name, leaf in sorted(t.items()):
            if hasattr(leaf, "items"):
                out[name] = walk(leaf)
                continue
            shape = tuple(leaf.shape)
            if len(shape) >= 2:
                fan_in = int(np.prod(shape[:-1]))
                out[name] = (rng.randn(*shape) * fan_in ** -0.5).astype(np.float32)
            else:
                base = 1.0 if name in ("scale", "weight") else 0.0
                out[name] = (base + 0.1 * rng.randn(*shape)).astype(np.float32)
        return out

    return walk(tree)


def _codebook(tree, rng):
    out = {}
    for name, leaf in tree.items():
        if hasattr(leaf, "items"):
            out[name] = _codebook(leaf, rng)
        elif name == "embed":
            e = rng.randn(*leaf.shape).astype(np.float32)
            out[name] = e / np.linalg.norm(e, axis=-1, keepdims=True)
        else:
            out[name] = np.zeros(leaf.shape, leaf.dtype)
    return out


def init_variables(module, seed: int, *args, **kwargs):
    """A variables tree for module.apply(..., *args) with every leaf drawn."""
    shapes = jax.eval_shape(lambda: module.init(
        {"params": jax.random.key(0), "rng": jax.random.key(1)}, *args, **kwargs))
    out = {"params": redraw(shapes["params"], seed)}
    if "codebook" in shapes:
        out["codebook"] = _codebook(shapes["codebook"], np.random.RandomState(seed + 1))
    return out
