"""Helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The oracle of those tests is the JAX package: the same parameters and the
same numpy inputs go through a grlir function and its grlir_torch
counterpart, in fp32 on the CPU.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grlir.models.grl import GRL as JGRL
from grlir.models.grl import GRLConfig as JConfig
from grlir.models.grl import _inflate_mask
from grlir_torch.models.grl import GRL, GRLConfig
from grlir_torch.utils.convert import jax_params_to_state_dict

# GRL-S's trunk at embed 32 and depths (2, 2)
TRUNK = dict(embed_dim=32, depths=(2, 2), num_heads_window=(2, 2),
             num_heads_stripe=(2, 2), window_size=8, stripe_size=(8, None),
             stripe_groups=(None, 4), stripe_shift=True, mlp_ratio=2.0,
             anchor_window_down_factor=4)

# GRL-base's trunk (CAB on every block) at its eval geometry (window 32,
# fixed 64x64 stripes, anchor df 2), cut to embed 36 (3 + 3 heads of d = 6)
# and one stage of four blocks, so every schedule position runs once
BASE_TRUNK = dict(embed_dim=36, depths=(4,), num_heads_window=(3,),
                  num_heads_stripe=(3,), window_size=32, stripe_size=(64, 64),
                  stripe_groups=(None, None), stripe_shift=True, mlp_ratio=2.0,
                  anchor_window_down_factor=2, local_connection=True)


def random_params(module, rng, *inputs):
    """Parameters of `module.init` (its tree from jax.eval_shape, so init
    never runs), drawn from a numpy Generator at the reference's init scales
    (Linear N(0, 0.02^2), Conv U(+-1/sqrt(fan_in))) but with non-trivial
    values everywhere, so every parameter matters: biases N(0, 0.02^2),
    LayerNorm scales 1 + N(0, 0.1^2), logit scales log(10) + N(0, 0.5^2)
    with the first head at 5.0, above the clamp at log(100)."""
    tree = jax.eval_shape(module.init, jax.random.PRNGKey(0), *inputs)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel" and len(shape) == 2:
            a = rng.normal(0, 0.02, shape)
        elif name == "kernel":
            bound = 1 / math.sqrt(np.prod(shape[:-1]))
            a = rng.uniform(-bound, bound, shape)
        elif name == "bias":
            a = rng.normal(0, 0.02, shape)
        elif name == "scale":
            a = 1 + rng.normal(0, 0.1, shape)
        elif name == "logit_scale":
            a = math.log(10) + rng.normal(0, 0.5, shape)
            a.reshape(-1)[0] = 5.0
        else:
            raise KeyError(name)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def jax_geometry(gcfg, x_size, compute_dtype=jnp.float32):
    """The geometry dict grlir's GRL.__call__ hands its blocks."""
    from grlir.ops.geometry import build_geometry_compact

    raw = build_geometry_compact(gcfg, x_size)
    g = {k: jnp.asarray(v) for k, v in raw.items() if not k.startswith("bands_")}
    bw = jnp.asarray(raw["bands_w"])
    g["mask_w"] = _inflate_mask(bw, bw, compute_dtype)
    g["bands_w"] = bw
    for s in ("sh", "sv"):
        b, ba = jnp.asarray(raw[f"bands_{s}"]), jnp.asarray(raw[f"bands_{s}_a"])
        g[f"mask_{s}_a2w"] = _inflate_mask(ba, b, compute_dtype)
        g[f"mask_{s}_w2a"] = _inflate_mask(b, ba, compute_dtype)
        g[f"bands_{s}"], g[f"bands_{s}_a"] = b, ba
    return g


def model_pair(upsampler, upscale, seed, jax_kernels=False, trunk=TRUNK,
               engine="v3"):
    """grlir's GRL with use_pallas_attention=jax_kernels and the port's GRL
    with `engine`, both of `trunk` and the same random parameters; also the
    parameters and the numpy Generator that drew them."""
    rng = np.random.default_rng(seed)
    jcfg = JConfig(**trunk, upsampler=upsampler, upscale=upscale,
                   drop_path_rate=0.0, use_pallas_attention=jax_kernels)
    jmodel = JGRL(jcfg)
    params = random_params(jmodel, rng, jnp.zeros((1, 32, 32, 3), jnp.float32))
    tmodel = GRL(GRLConfig(**trunk, upsampler=upsampler, upscale=upscale,
                           engine=engine)).eval()
    tmodel.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return jmodel, params, tmodel, rng


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread for the test (autouse where a test file
    imports it): a parallel test run puts several workers on a few cores, and
    torch's default of a thread a core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
