"""Whole grlir_torch GRL vs grlir's GRL, fp32 on the CPU, and the
JAX -> torch parameter mapping."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grlir.models.grl import GRL as JGRL
from grlir.models.grl import GRLConfig as JConfig
from grlir.utils.convert import flax_path_to_torch_key
from grlir_torch.models import zoo
from grlir_torch.models.grl import GRL, GRLConfig, init_weights
from grlir_torch.utils.convert import jax_params_to_state_dict
from torch_parity import random_params

# GRL-S's trunk at embed 32 and depths (2, 2)
TRUNK = dict(embed_dim=32, depths=(2, 2), num_heads_window=(2, 2),
             num_heads_stripe=(2, 2), window_size=8, stripe_size=(8, None),
             stripe_groups=(None, 4), stripe_shift=True, mlp_ratio=2.0,
             anchor_window_down_factor=4)


def _pair(upsampler, upscale, seed, jax_kernels=False):
    rng = np.random.default_rng(seed)
    jcfg = JConfig(**TRUNK, upsampler=upsampler, upscale=upscale,
                   drop_path_rate=0.0, use_pallas_attention=jax_kernels)
    jmodel = JGRL(jcfg)
    params = random_params(jmodel, rng, jnp.zeros((1, 32, 32, 3), jnp.float32))
    tmodel = GRL(GRLConfig(**TRUNK, upsampler=upsampler, upscale=upscale)).eval()
    tmodel.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return jmodel, params, tmodel, rng


# every tail on both a square and a non-square input; the JAX side runs its
# XLA path, except for one case that runs the Pallas kernels the port's CUDA
# kernels replace (interpret mode)
@pytest.mark.parametrize("upsampler,upscale,size,jax_kernels", [
    ("pixelshuffle", 4, (32, 32), "v3"),
    ("pixelshuffle", 4, (32, 48), False),
    ("pixelshuffle", 2, (32, 48), False),
    ("pixelshuffledirect", 4, (32, 32), False),
    ("nearest+conv", 4, (32, 48), False),
    ("", 1, (32, 32), False),
    ("", 1, (20, 44), False),
])
def test_grl_matches_jax(upsampler, upscale, size, jax_kernels):
    jmodel, params, tmodel, rng = _pair(upsampler, upscale, 0, jax_kernels)
    x = rng.random((2, *size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == (2, size[0] * upscale, size[1] * upscale, 3)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("name", ["tiny", "small"])
def test_state_dict_keys_map_from_jax(name):
    """The port's state_dict keys are exactly flax_path_to_torch_key over the
    JAX params, and converted JAX weights load with strict=True."""
    from grlir.models import zoo as jzoo

    jmodel = JGRL(jzoo.make_config(name))
    tree = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 32, 32, 3), jnp.float32))
    paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    jax_keys = {flax_path_to_torch_key(tuple(k.key for k in p)) for p, _ in paths}
    tmodel = GRL(zoo.make_config(name))
    assert set(tmodel.state_dict()) == jax_keys
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), tree)
    tmodel.load_state_dict(jax_params_to_state_dict(zeros), strict=True)


def test_unported_variants_raise():
    with pytest.raises(NotImplementedError, match="CAB"):
        GRL(zoo.GRL_BASE)
    with pytest.raises(ValueError, match="kernels"):
        GRL(replace(zoo.GRL_TINY, kernels="v3"))


def test_kernel_mode_resolution():
    """'auto' runs kernels only for CUDA inputs at inference; explicit modes
    are kept."""
    model = GRL(replace(zoo.GRL_TINY, depths=(1,)))
    x = torch.zeros(1, 16, 16, 3)
    assert not model.use_kernels(x)
    assert GRL(replace(zoo.GRL_TINY, depths=(1,), kernels=True)).use_kernels(x)


def test_seeded_init_is_reproducible():
    a = init_weights(GRL(replace(zoo.GRL_TINY, depths=(1,))),
                     torch.Generator().manual_seed(0))
    b = init_weights(GRL(replace(zoo.GRL_TINY, depths=(1,))),
                     torch.Generator().manual_seed(0))
    for (k, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), k
    w = a.layers[0].blocks[0].attn.proj.weight
    assert abs(w.std().item() - 0.02) < 0.005
