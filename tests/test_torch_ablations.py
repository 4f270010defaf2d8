"""GRL's ablation branches in the port against grlir, fp32 on the CPU:
the modules each switch adds (separable conv, patch merging, the anchor
projections, the qkv projections, Euclidean logits) and every switch
through the whole GRL on engine v3, against grlir's use_pallas_attention
"v3" (Pallas in interpret mode where grlir routes to it).  The fused
engine's cases are in tests/test_torch_ablations_fused.py; both files share
the switches of ABLATIONS.  Combinations grlir rejects raise in both
packages."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from grlir.models import blocks as jblocks
from grlir.models.grl import GRL as JGRL
from grlir.models.grl import GRLConfig as JConfig
from grlir_torch.models import blocks as tblocks
from grlir_torch.models.grl import GRL, GRLConfig
from grlir_torch.utils.convert import jax_params_to_state_dict
from torch_parity import TRUNK, model_pair, one_torch_thread, random_params  # noqa: F401

# one stage of four blocks, so the stripe shift (blocks 2 and 3) runs
ABL_TRUNK = dict(TRUNK, depths=(4,), num_heads_window=(2,), num_heads_stripe=(2,))

# switches that keep grlir's raw-weight route (v3: B1/B2; fused: B6/B7 on
# the block input), each case a few switches at once
FUSED_IO = {
    "anchor_maxpool-proj_conv2d": dict(anchor_proj_type="maxpool",
                                       out_proj_type="conv2d"),
    "anchor_conv2d-3conv": dict(anchor_proj_type="conv2d", conv_type="3conv"),
    "anchor_separable-noact-1conv1x1": dict(anchor_proj_type="separable_conv",
                                            separable_conv_act=False,
                                            conv_type="1conv1x1"),
    "anchor_patchmerging_df2": dict(anchor_proj_type="patchmerging",
                                    anchor_window_down_factor=2),
    "anchor_patchmerging_2stage-linear": dict(anchor_proj_type="patchmerging",
                                              anchor_one_stage=False,
                                              conv_type="linear"),
    "anchor_conv2d_2stage-qkv_nobias": dict(anchor_proj_type="conv2d",
                                            anchor_one_stage=False, qkv_bias=False),
    "anchor_separable_2stage-pretrained-feats32": dict(
        anchor_proj_type="separable_conv", anchor_one_stage=False,
        pretrained_window_size=(16, 16), pretrained_stripe_size=(16, 16),
        num_out_feats=32),
}
# switches that project qkv first (grlir's legacy route: plain on v3, B6
# and B7 on the fused engines)
LEGACY = {
    "separable_qkv": dict(qkv_proj_type="separable_conv"),
    "separable_qkv-noact-nobias": dict(qkv_proj_type="separable_conv",
                                       separable_conv_act=False, qkv_bias=False),
    "df1": dict(anchor_window_down_factor=1),
    "df1-stripe_square": dict(anchor_window_down_factor=1, stripe_square=True),
    "double_window": dict(double_window=True),
    "euclidean_dist": dict(euclidean_dist=True),
}
ABLATIONS = {**FUSED_IO, **LEGACY}


def count_calls(monkeypatch, names):
    """Count the port's calls of blocks.<name> for each name."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        def spy(*a, _name=name, _fn=getattr(tblocks, name), **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tblocks, name, spy)
    return calls


def run_pair(options, jax_mode, engine, seed=0):
    """The whole GRL (x2 pixelshuffle tail) of ABL_TRUNK with `options` in
    both packages on one 32^2 input: (port's output, grlir's)."""
    trunk = dict(ABL_TRUNK, **options)
    jmodel, params, tmodel, rng = model_pair("pixelshuffle", 2, seed, jax_mode,
                                             trunk, engine)
    x = rng.random((1, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    return got, want


@pytest.mark.parametrize("name", list(ABLATIONS))
def test_ablation_v3_matches_jax(name, monkeypatch):
    """Engine v3 against grlir's "v3": the raw-weight switches run B1 and B2
    (their plain versions here) in every block, the legacy ones the plain
    path, as grlir degrades "v3" there."""
    calls = count_calls(monkeypatch, ["window_half", "stripe_half"])
    got, want = run_pair(ABLATIONS[name], "v3", "v3")
    assert got.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)
    n = 4 * (name in FUSED_IO)
    assert calls == {"window_half": n, "stripe_half": n}


# ---- the modules, one by one

def _module_pair(jmodule, tmodule, prefix, *inputs, seed=0):
    """grlir module's random parameters loaded strictly into the port's
    module through the conversion, under the parent path `prefix`."""
    rng = np.random.default_rng(seed)
    params = random_params(jmodule, rng, *inputs)
    sd = jax_params_to_state_dict({prefix: params["params"]})
    sd = {k[len(prefix) + 1:]: v for k, v in sd.items()}
    tmodule.load_state_dict(sd, strict=True)
    return params


@pytest.mark.parametrize("proj_type,one_stage,df,act", [
    ("avgpool", True, 4, True), ("maxpool", True, 4, True),
    ("conv2d", True, 4, True), ("separable_conv", True, 4, True),
    ("separable_conv", True, 2, False), ("patchmerging", True, 2, True),
    ("conv2d", False, 4, True), ("separable_conv", False, 4, False),
    ("patchmerging", False, 4, True),
])
def test_anchor_projection_matches_jax(proj_type, one_stage, df, act):
    x = np.random.default_rng(1).standard_normal((2, 16, 24, 32)).astype(np.float32)
    jm = jblocks.AnchorProjection(32, proj_type, one_stage, df, act)
    tm = tblocks.AnchorProjection(32, df, proj_type, one_stage, act)
    params = _module_pair(jm, tm, "anchor", jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    got = tm(torch.from_numpy(x), torch.float32).detach().numpy()
    assert got.shape == (2, 16 // df, 24 // df, 16)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("proj_type,bias,act", [
    ("linear", True, True), ("linear", False, True),
    ("separable_conv", True, True), ("separable_conv", False, False),
])
def test_qkv_projection_matches_jax(proj_type, bias, act):
    x = np.random.default_rng(2).standard_normal((1, 8, 16, 24)).astype(np.float32)
    jm = jblocks.QKVProjection(24, bias, proj_type, act)
    tm = tblocks.QKVProjection(24, bias, proj_type, act)
    params = _module_pair(jm, tm, "qkv", jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    got = tm(torch.from_numpy(x), torch.float32).detach().numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)


class _JEuclid(fnn.Module):
    heads: int

    @fnn.compact
    def __call__(self, q, k, v, table, index, mask):
        t = jblocks.AffineTransform(self.heads, name="attn_transform")
        return jblocks.cosine_attention(q, k, v, t, table, index, mask,
                                        euclidean_dist=True, d_major=True)


@pytest.mark.parametrize("masked", [False, True])
def test_euclidean_attention_matches_jax(masked):
    """cosine_attention's Euclidean logits on d-major operands, a2w-like
    shapes (N1 = 4 queries, N2 = 16 keys), with and without a shift mask;
    fused=True still takes the plain path."""
    from grlir_torch.ops.geometry import (get_relative_coords_table,
                                          get_relative_position_index)

    rng = np.random.default_rng(3)
    h, d, N1, N2 = 2, 8, 4, 16
    q = rng.standard_normal((2, 3, h, d, N1)).astype(np.float32)
    k, v = (rng.standard_normal((2, 3, h, d, N2)).astype(np.float32) for _ in "kv")
    table = get_relative_coords_table((4, 4), (0, 0), 2)
    index = get_relative_position_index((4, 4), 2, False)
    mask = (np.where(rng.random((3, N1, N2)) < 0.3, -100.0, 0.0).astype(np.float32)
            if masked else None)
    jm = _JEuclid(h)
    args = [jnp.asarray(a) for a in (q, k, v, table, index)]
    jmask = None if mask is None else jnp.asarray(mask)
    params = random_params(jm, rng, *args, jmask)
    want = np.asarray(jm.apply(params, *args, jmask))
    t = tblocks.AffineTransform(h)
    sd = jax_params_to_state_dict(params)
    t.load_state_dict({k[len("attn_transform."):]: w for k, w in sd.items()},
                      strict=True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        for fused in (False, True):
            got = tblocks.cosine_attention(
                tq, tk, tv, t, torch.from_numpy(table),
                torch.from_numpy(index.astype(np.int64)), tmask, fused=fused,
                euclidean=True).numpy()
            np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)


# ---- what grlir rejects, the port rejects

def _both_raise(options, size=32, trunk=ABL_TRUNK, out_channels=None):
    cfg = dict(trunk, **options, depths=(1,), num_heads_window=(2,),
               num_heads_stripe=(2,), drop_path_rate=0.0)
    x = np.zeros((1, size, size, 3), np.float32)
    jmodel = JGRL(JConfig(**cfg, out_channels=out_channels, upsampler="",
                          upscale=1, use_pallas_attention=False))
    with pytest.raises(Exception) as jerr:
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.asarray(x))
    with pytest.raises(Exception) as terr:
        with torch.no_grad():
            GRL(GRLConfig(**cfg, out_channels=out_channels))(torch.from_numpy(x))
    return jerr.value, terr.value


def test_rejected_combinations_raise_in_both():
    """stripe_square reads the stripe geometry's table and index: at 64^2
    TRUNK's stripes are 8 x 16, not the 8 x 8 window, and both packages
    fail on the shapes; a two-stage avgpool anchor, an unknown conv_type,
    and a 768-channel head beside an RGB input (the RGB mean cannot
    broadcast: classification trains gray images) raise in both."""
    _both_raise(dict(anchor_window_down_factor=1, stripe_square=True), size=64)
    j, t = _both_raise(dict(anchor_proj_type="avgpool", anchor_one_stage=False))
    assert isinstance(j, ValueError) and isinstance(t, ValueError)
    j, t = _both_raise(dict(conv_type="2conv"))
    assert isinstance(j, ValueError) and isinstance(t, ValueError)
    _both_raise({}, out_channels=768)


def test_ablation_fields_accepted_everywhere():
    """No field grlir honours raises NotImplementedError any more: df 1,
    every remat policy, and each ablation field build a GRL."""
    from grlir_torch.models import zoo

    small = replace(zoo.GRL_TINY, depths=(1,))
    for kw in [dict(anchor_window_down_factor=1), dict(remat=True, remat_policy="dots"),
               dict(remat=True, remat_policy="dots_no_batch"), *ABLATIONS.values()]:
        GRL(replace(small, **kw))
    with pytest.raises(ValueError, match="remat_policy"):
        GRL(replace(small, remat_policy="everything"))
