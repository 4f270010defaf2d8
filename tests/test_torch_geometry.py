"""The port's own copies of grlir's numpy host code equal the originals:
the attention geometry (`grlir_torch.ops.geometry`) array for array, and the
parameter-name mapping and checkpoint key filter (`grlir_torch.utils.convert`)
key for key."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from grlir.models import zoo as jzoo
from grlir.models.grl import GRL as JGRL
from grlir.ops import geometry as jgeo
from grlir.utils import convert as jconvert
from grlir_torch.ops import geometry as tgeo
from grlir_torch.utils import convert as tconvert

# (window, stripe size, stripe groups, df, padded size): GRL-S at 256^2, and
# GRL-base's eval geometries (window 32, df 2; 64x64 stripes for SR, 64x128
# for denoising)
GEOMETRIES = [
    ((8, 8), (8, None), (None, 4), 4, (256, 256)),
    ((32, 32), (64, 64), (None, None), 2, (64, 64)),
    ((32, 32), (64, 64), (None, None), 2, (128, 192)),
    ((32, 32), (64, 128), (None, None), 2, (256, 256)),
]


@pytest.mark.parametrize("window,stripe,groups,df,size", GEOMETRIES)
def test_build_geometry_compact_equals_grlir(window, stripe, groups, df, size):
    cfg_args = (window, stripe, groups, df)
    got = tgeo.build_geometry_compact(tgeo.GeometryConfig(*cfg_args), size)
    want = jgeo.build_geometry_compact(jgeo.GeometryConfig(*cfg_args), size)
    assert set(got) <= set(want)
    # every key the port reads; the one-hot bias factors are the only ones
    # left out (the port gathers the bias by index)
    assert {k for k in want if not k.startswith("bfac_")} == set(got)
    for k, v in got.items():
        assert v.dtype == want[k].dtype and v.shape == want[k].shape, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert (tgeo.GeometryConfig(*cfg_args).pad_size
            == jgeo.GeometryConfig(*cfg_args).pad_size)


@pytest.mark.parametrize("stripe,groups,shift,res", [
    ((8, None), (None, 4), True, (256, 192)),
    ((None, 8), (4, None), False, (64, 256)),
    ((64, 128), (None, None), True, (256, 256)),
    ((None, None), (1, 2), True, (64, 64)),
])
def test_get_stripe_info_equals_grlir(stripe, groups, shift, res):
    assert (tgeo.get_stripe_info(stripe, groups, shift, res)
            == jgeo.get_stripe_info(stripe, groups, shift, res))


def _param_paths(cfg):
    tree = jax.eval_shape(JGRL(cfg).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 64, 3), jnp.float32))
    return [tuple(k.key for k in p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("name,task", [("base", "sr"), ("base", "bsr"),
                                       ("small", "sr"), ("tiny", "dn")])
def test_flax_path_to_torch_key_equals_grlir(name, task):
    """Over a whole parameter tree (GRL-base's includes CAB: cab0, cab2 and
    the channel attention's fc1/fc2)."""
    paths = _param_paths(jzoo.make_config(name, task=task))
    if name == "base":
        assert any("ca" in p for p in paths) and any("cab0" in p for p in paths)
    for p in paths:
        assert tconvert.flax_path_to_torch_key(p) == jconvert.flax_path_to_torch_key(p)
        wrapped = ("params", *p)
        assert (tconvert.flax_path_to_torch_key(wrapped)
                == jconvert.flax_path_to_torch_key(wrapped))


def test_strip_prefix_equals_grlir():
    sd = {"model.conv_first.weight": 1, "model.layers.0.blocks.0.attn.mean": 2,
          "model.table_w": 3, "model.index_sh_a2w": 4, "model_g.conv_last.bias": 5,
          "model.layers.0.blocks.0.attn.window_attn.attn_mask": 6,
          "best_val_metric": 7, "conv_last.weight": 8, "model.mask_w": 9}
    for prefix in ("model.", "model_g.", ""):
        assert tconvert.strip_prefix(sd, prefix) == jconvert.strip_prefix(sd, prefix)
