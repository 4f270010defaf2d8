"""Whole grlir_torch GRL vs grlir's GRL, fp32 on the CPU, and the
JAX -> torch parameter mapping."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grlir.models.grl import GRL as JGRL
from grlir.utils.convert import flax_path_to_torch_key
from grlir_torch.models import zoo
from grlir_torch.models.grl import GRL, init_weights
from grlir_torch.utils.convert import jax_params_to_state_dict
from torch_parity import BASE_TRUNK, TRUNK, model_pair

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
    jmodel, params, tmodel, rng = model_pair(upsampler, upscale, 0, jax_kernels)
    x = rng.random((2, *size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == (2, size[0] * upscale, size[1] * upscale, 3)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("upsampler,upscale", [("pixelshuffle", 2), ("", 1)])
def test_grl_base_trunk_matches_jax_v3(upsampler, upscale):
    """A GRL with CAB at GRL-base's eval geometry against grlir's v3 path in
    interpret mode: at 64x64 every window half takes the large-window route
    (B3) and every stripe half the streamed-bias one (B4)."""
    from grlir_torch.ops import block_attn as tba

    assert tba.window_route((64, 64), (32, 32), 3) == "large"
    assert tba.stripe_route((64, 64), (64, 64), 2, 3) == "large"
    jmodel, params, tmodel, rng = model_pair(upsampler, upscale, 1, "v3",
                                        BASE_TRUNK)
    x = rng.random((1, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 64 * upscale, 64 * upscale, 3)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)


# the fused engines against grlir's use_pallas_attention True / "window" /
# "stripe" (Pallas in interpret mode): at the default threshold TRUNK's
# windows (N = 64) take B6 and its stripes (N1 = 64, N2 = 4) B7a; with
# _FLASH_MIN_TOKENS at 0 in both packages every fused half takes B5.  The
# JAX side runs eagerly, as tests/test_flash_attention.py does, so that the
# patched threshold is read when it traces.
@pytest.mark.parametrize("engine,jax_mode", [("fused", True),
                                             ("window", "window"),
                                             ("stripe", "stripe")])
@pytest.mark.parametrize("flash", [False, True])
def test_grl_engines_match_jax(engine, jax_mode, flash, monkeypatch):
    from grlir.models import blocks as jblocks
    from grlir_torch.models import blocks as tblocks

    if flash:
        for mod in (jblocks, tblocks):
            monkeypatch.setattr(mod, "_FLASH_MIN_TOKENS", 0)
    calls = _count_kernel_calls(monkeypatch)
    jmodel, params, tmodel, rng = model_pair("pixelshuffle", 2, 2, jax_mode,
                                        engine=engine)
    x = rng.random((1, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)
    # 4 blocks: one window half, and a stripe half of two steps, each
    win, stripe = engine in ("fused", "window"), engine in ("fused", "stripe")
    assert calls == {"B5": 4 * flash * (win + 2 * stripe),
                     "B6": 4 * (not flash) * win,
                     "B7": 8 * (not flash) * stripe}


def _count_kernel_calls(monkeypatch):
    """Count the port's calls of B5, B6 and B7 (auto) from its blocks."""
    from grlir_torch.models import blocks as tblocks

    calls = {"B5": 0, "B6": 0, "B7": 0}
    for key, name in (("B5", "flash_rect_attention"),
                      ("B6", "fused_window_attention_qkv"),
                      ("B7", "fused_cosine_attention_auto")):
        def spy(*a, _key=key, _fn=getattr(tblocks, name), **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tblocks, name, spy)
    return calls


def test_grl_base_trunk_fused_matches_jax(monkeypatch):
    """GRL-base's eval geometry with the fused engine against grlir's
    use_pallas_attention=True: every window (N = 1024) and both stripe
    steps (4096 tokens, 1024 anchors) take B5."""
    calls = _count_kernel_calls(monkeypatch)
    jmodel, params, tmodel, rng = model_pair("", 1, 3, True, BASE_TRUNK, "fused")
    x = rng.random((1, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)
    assert calls == {"B5": 4 * 3, "B6": 0, "B7": 0}


@pytest.mark.parametrize("name", ["tiny", "small", "base"])
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
    """GRL-base builds, and so does plain stripe attention (df 1: the
    anchor-free stripe half, no anchor projection); unknown kernel modes
    still raise."""
    from grlir_torch.models.blocks import StripeAttention

    GRL(replace(zoo.GRL_BASE, depths=(1,)))
    m = GRL(replace(zoo.GRL_TINY, depths=(1,), anchor_window_down_factor=1))
    attn = m.layers[0].blocks[0].attn
    assert isinstance(attn.stripe_attn, StripeAttention) and attn.anchor is None
    with torch.no_grad():
        assert m(torch.zeros(1, 32, 32, 3)).shape == (1, 128, 128, 3)
    with pytest.raises(ValueError, match="kernels"):
        GRL(replace(zoo.GRL_TINY, kernels="v3"))


def test_engine_field():
    """engine is its own field beside kernels: "v3" by default, each engine
    builds its halves' modes, an unknown one raises."""
    assert zoo.GRL_TINY.engine == "v3"
    for engine, modes in (("fused", ("fused", "fused")), ("window", ("fused", "plain")),
                          ("stripe", ("plain", "fused")), ("v3", ("v3", "v3"))):
        model = GRL(replace(zoo.GRL_TINY, depths=(1,), engine=engine))
        attn = model.layers[0].blocks[0].attn
        assert (attn.window_attn.mode, attn.stripe_attn.mode) == modes
    with pytest.raises(ValueError, match="engine"):
        GRL(replace(zoo.GRL_TINY, engine=True))


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
