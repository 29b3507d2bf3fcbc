"""Seeded random JAX variables without compiling a model's ``init``, and
the carrying of one JAX module's variables into its port, for the
iterative models' tests (RAFTStereo, IGEVStereo).

`random_variables` takes the variables' shapes from ``jax.eval_shape`` of
the model's ``init`` (seconds, where a compiled ``init`` of IGEVStereo
takes ~35 s on the CPU) and fills them from a numpy seed: conv and dense
kernels ~ N(0, 2 / fan_in), biases ~ N(0, 0.1²), BatchNorm scales ~ U(0.5,
1.5), its running means ~ N(0, 0.1²) and variances ~ U(0.5, 1.5), so that
every BatchNorm, frozen or not, acts on its input.
"""

import jax
import numpy as np
import torch

from stereo_toolbox_tpu_torch.utils.weights import JaxToTorch


def random_variables(init, *args, seed: int = 0) -> dict:
    """Numpy variables of the shapes ``init(PRNGKey, *args)`` gives."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        keys = [getattr(p, "key", str(p)) for p in path]
        shape, name = leaf.shape, keys[-1]
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
        elif name == "bias":
            v = 0.1 * rng.randn(*shape)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "mean":
            v = 0.1 * rng.randn(*shape)
        else:
            raise KeyError(f"no filling for {'/'.join(keys)}")
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def carry(module: torch.nn.Module, variables: dict, convert
          ) -> torch.nn.Module:
    """The JAX `variables` of one module into the port's `module`, through
    ``convert(t, "m", "m")`` of ``utils.weights``; every tensor of the
    module but BatchNorm's counters carried."""
    t = JaxToTorch({"params": {"m": variables["params"]},
                    "batch_stats": {"m": variables.get("batch_stats", {})}})
    convert(t, "m", "m")
    holder = torch.nn.Module()
    holder.m = module
    holder.load_state_dict(t.state_dict(), strict=False)
    missing = set(holder.state_dict()) - set(t.sd)
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    return module.eval()


def close(got, want, rel: float) -> float:
    """max|got − want|, required within ``rel · max|want|``."""
    got = np.asarray(torch.as_tensor(got).detach().float())
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, rel)
    return err
