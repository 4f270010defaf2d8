"""One grlir_torch EfficientMixAttnTransformerBlock per position of the
block schedule vs grlir's block (XLA path), fp32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grlir.models.blocks import CAB as JCAB
from grlir.models.blocks import EfficientMixAttnTransformerBlock as JBlock
from grlir.ops.geometry import GeometryConfig
from grlir_torch.models.blocks import CAB as TCAB
from grlir_torch.models.blocks import EfficientMixAttnTransformerBlock as TBlock
from grlir_torch.models.grl import geometry_tensors
from grlir_torch.ops import block_attn as tba
from grlir_torch.utils.convert import jax_params_to_state_dict
from torch_parity import jax_geometry, random_params

DIM, HEADS, WINDOW, DF = 32, 2, 8, 4
STRIPE, GROUPS = (8, None), (None, 4)
SIZE = (32, 48)   # non-square: the V stripes are not the H stripes reversed


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_block_matches_jax(i):
    """Position i: window shift on even blocks, H/V stripes on even/odd,
    stripe shift on i % 4 in {2, 3} (grlir/models/grl.py:243-276)."""
    _check_block(i, local=False)


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_block_with_cab_matches_jax(i):
    """The same positions with GRL-base's CAB branch beside the attention:
    x + norm1(attn(x)) + CAB(x)."""
    _check_block(i, local=True)


def _check_block(i, local, dim=DIM, window=WINDOW, size=SIZE,
                 use_pallas=False, engine="v3", batch=2):
    sched = dict(window_shift=i % 2 == 0, stripe_type="H" if i % 2 == 0 else "W",
                 stripe_shift=i % 4 in (2, 3))
    jblock = JBlock(dim=dim, num_heads_w=HEADS, num_heads_s=HEADS,
                    window_size=(window, window), stripe_size_cfg=STRIPE,
                    stripe_groups_cfg=GROUPS, mlp_ratio=2.0,
                    anchor_window_down_factor=DF, d_major=True, attn_io="cm",
                    local_connection=local, use_pallas=use_pallas, **sched)
    gcfg = GeometryConfig((window, window), STRIPE, GROUPS, DF)
    rng = np.random.default_rng(i)
    x = rng.standard_normal((batch, *size, dim)).astype(np.float32)
    geom = jax_geometry(gcfg, size)
    params = random_params(jblock, rng, jnp.asarray(x), geom)
    want = np.asarray(jax.jit(jblock.apply)(params, jnp.asarray(x), geom))

    tblock = TBlock(dim, HEADS, HEADS, window, stripe_size=STRIPE,
                    stripe_groups=GROUPS, mlp_ratio=2.0, df=DF,
                    local_connection=local, engine=engine, **sched).eval()
    tblock.load_state_dict(jax_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tblock(torch.from_numpy(x), geometry_tensors(gcfg, size, "cpu"),
                     torch.float32, kernels=True)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=1e-4)


# Two heads of d = 64 a half (dim 256) against grlir's block on its Pallas
# kernels (interpret mode), which take that head dim, as the port's kernels
# do on the card.  v3 at window 32: the window half routes to B3, the 8 x 16
# stripes to B2.  fused with 8 x 36 stripes (288 tokens): the window half
# takes B6, the H stripe half B5.  No half leaves its route.
@pytest.mark.parametrize("engine,window,size", [("v3", 32, (32, 64)),
                                                ("fused", 8, (16, 144))])
def test_wide_head_block_matches_jax(engine, window, size):
    tba.reset_launches()
    _check_block(0, local=False, dim=256, window=window, size=size,
                 use_pallas="v3" if engine == "v3" else True, engine=engine,
                 batch=1)
    assert tba.unrouted_halves == 0


# GRL-base's width: C = 180 compresses to 45 and squeezes to 10 channels
@pytest.mark.parametrize("dim,size", [(180, (16, 24)), (36, (20, 12))])
def test_cab_matches_jax(dim, size):
    """CAB: 3x3 conv to C/4, exact GELU (fp32), 3x3 conv back, channel
    attention with reduction 18."""
    rng = np.random.default_rng(dim)
    x = rng.standard_normal((2, *size, dim)).astype(np.float32)
    jcab = JCAB()
    params = random_params(jcab, rng, jnp.asarray(x))
    want = np.asarray(jax.jit(jcab.apply)(params, jnp.asarray(x)))
    tcab = TCAB(dim).eval()
    tcab.load_state_dict(jax_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tcab(torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=1e-4)
