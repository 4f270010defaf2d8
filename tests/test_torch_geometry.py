"""The port's own copies of grlir's numpy host code equal the originals:
the attention geometry (`grlir_torch.ops.geometry`) array for array, and the
parameter-name mapping and checkpoint key filter (`grlir_torch.utils.convert`)
key for key."""

import dataclasses

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
    # df 1 (the anchor-free stripe half and stripe_square read it): GRL-S's
    # stripes at 256^2 and 8x8 stripes at 32^2
    ((8, 8), (8, None), (None, 4), 1, (256, 256)),
    ((8, 8), (8, 8), (None, None), 1, (32, 32)),
    ((8, 8), (8, None), (None, 4), 1, (32, 48)),
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


# the ablation switches whose parameters have names of their own
ABLATION_TREES = {
    "separable_qkv-noact-nobias": dict(qkv_proj_type="separable_conv",
                                       separable_conv_act=False, qkv_bias=False),
    "anchor_conv2d-proj_conv2d-3conv": dict(anchor_proj_type="conv2d",
                                            out_proj_type="conv2d", conv_type="3conv"),
    "anchor_separable-1conv1x1": dict(anchor_proj_type="separable_conv",
                                      conv_type="1conv1x1"),
    "anchor_patchmerging_2stage-linear": dict(anchor_proj_type="patchmerging",
                                              anchor_one_stage=False, conv_type="linear"),
    "anchor_separable_2stage": dict(anchor_proj_type="separable_conv",
                                    anchor_one_stage=False),
    "anchor_conv2d_2stage": dict(anchor_proj_type="conv2d",
                                         anchor_one_stage=False),
    "df1": dict(anchor_window_down_factor=1),
    "double_window": dict(double_window=True),
}


@pytest.mark.parametrize("name,task,options", [
    pytest.param("base", "sr", {}, id="base-sr"),
    pytest.param("base", "bsr", {}, id="base-bsr"),
    pytest.param("small", "sr", {}, id="small-sr"),
    pytest.param("tiny", "dn", {}, id="tiny-dn"),
    *(pytest.param("tiny", "sr", o, id=f"tiny-sr-{k}") for k, o in ABLATION_TREES.items()),
])
def test_flax_path_to_torch_key_equals_grlir(name, task, options):
    """Over a whole parameter tree (GRL-base's includes CAB: cab0, cab2 and
    the channel attention's fc1/fc2; the ablation trees separable convs,
    anchor bodies, 3conv and linear last convs); an ablation tree converted
    by the port loads strictly into the port's GRL of the same switches."""
    jcfg = jzoo.make_config(name, task=task)
    if options:
        jcfg = dataclasses.replace(jcfg, depths=(2,), num_heads_window=(2,),
                                   num_heads_stripe=(2,), **options)
    paths = _param_paths(jcfg)
    if name == "base":
        assert any("ca" in p for p in paths) and any("cab0" in p for p in paths)
    for p in paths:
        assert tconvert.flax_path_to_torch_key(p) == jconvert.flax_path_to_torch_key(p)
        wrapped = ("params", *p)
        assert (tconvert.flax_path_to_torch_key(wrapped)
                == jconvert.flax_path_to_torch_key(wrapped))
    if options:
        from grlir_torch.models import zoo
        from grlir_torch.models.grl import GRL

        tree = jax.eval_shape(JGRL(jcfg).init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 64, 64, 3), jnp.float32))
        zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), tree)
        tcfg = dataclasses.replace(zoo.make_config(name, task=task), depths=(2,),
                                   num_heads_window=(2,), num_heads_stripe=(2,),
                                   **options)
        GRL(tcfg).load_state_dict(tconvert.jax_params_to_state_dict(zeros), strict=True)


def test_strip_prefix_equals_grlir():
    sd = {"model.conv_first.weight": 1, "model.layers.0.blocks.0.attn.mean": 2,
          "model.table_w": 3, "model.index_sh_a2w": 4, "model_g.conv_last.bias": 5,
          "model.layers.0.blocks.0.attn.window_attn.attn_mask": 6,
          "best_val_metric": 7, "conv_last.weight": 8, "model.mask_w": 9}
    for prefix in ("model.", "model_g.", ""):
        assert tconvert.strip_prefix(sd, prefix) == jconvert.strip_prefix(sd, prefix)
