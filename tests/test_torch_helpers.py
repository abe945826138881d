"""Shared helpers of the port's parity tests (no tests of its own).

Weights are a flax ``init`` of the JAX module, flattened to numpy, with
BatchNorm scales, biases and running statistics jittered from a seeded numpy
generator so that every BN and every residual branch does real work; the
same flat tree goes into the port through ``weights.from_jax_variables``.
"""
from __future__ import annotations

import numpy as np
import torch
from flax.traverse_util import flatten_dict, unflatten_dict


def flat_variables(variables) -> dict[str, np.ndarray]:
    return {k: np.asarray(v, np.float32)
            for k, v in flatten_dict(dict(variables), sep="/").items()}


def jitter_bn(flat: dict[str, np.ndarray], seed: int = 1
              ) -> dict[str, np.ndarray]:
    """BN leaves + seeded noise: scale 0.5 + |N|*0.5-ish, bias 0.1 N,
    mean 0.3 N, var |var + 0.3 N| (kept positive)."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flat.items():
        leaf = k.rsplit("/", 1)[-1]
        bn = (k.startswith("batch_stats/")
              or f"{k.rsplit('/', 1)[0]}/scale" in flat)
        if not bn:
            out[k] = v
            continue
        noise = rng.normal(size=v.shape).astype(np.float32)
        if leaf == "scale":
            v = 1.0 + 0.3 * noise
        elif leaf == "bias":
            v = v + 0.1 * noise
        elif leaf == "mean":
            v = v + 0.3 * noise
        else:
            v = np.abs(v + 0.3 * noise)
        out[k] = v.astype(np.float32)
    return out


def seeded_variables(module, *args, seed: int = 0,
                     init=None) -> dict[str, np.ndarray]:
    """A flat variable tree for a flax ``module`` with the shapes of its
    ``init(*args)`` (or of ``init(rngs, *args)``), filled from a seeded
    numpy generator instead of a flax init (an abstract init takes seconds
    where a concrete one takes a minute): kernels N(0, 1/fan_in), biases 0,
    BN scale 1, mean 0, var 1."""
    import jax

    init = init or module.init
    tree = jax.eval_shape(lambda: init(
        {"params": jax.random.PRNGKey(0)}, *args))
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flatten_dict(dict(tree), sep="/").items():
        leaf = k.rsplit("/", 1)[-1]
        if leaf == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            a = rng.normal(size=v.shape) / np.sqrt(fan_in)
        elif leaf in ("scale", "var"):
            a = np.ones(v.shape)
        else:
            a = np.zeros(v.shape)
        out[k] = a.astype(np.float32)
    return out


def jax_variables(flat: dict[str, np.ndarray]):
    import jax.numpy as jnp

    return unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                          sep="/")


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()
