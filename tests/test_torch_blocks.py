"""One grlir_torch EfficientMixAttnTransformerBlock per position of the
block schedule vs grlir's block (XLA path), fp32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grlir.models.blocks import EfficientMixAttnTransformerBlock as JBlock
from grlir.ops.geometry import GeometryConfig
from grlir_torch.models.blocks import EfficientMixAttnTransformerBlock as TBlock
from grlir_torch.models.grl import geometry_tensors
from grlir_torch.utils.convert import jax_params_to_state_dict
from torch_parity import jax_geometry, random_params

DIM, HEADS, WINDOW, DF = 32, 2, 8, 4
STRIPE, GROUPS = (8, None), (None, 4)
SIZE = (32, 48)   # non-square: the V stripes are not the H stripes reversed


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_block_matches_jax(i):
    """Position i: window shift on even blocks, H/V stripes on even/odd,
    stripe shift on i % 4 in {2, 3} (grlir/models/grl.py:243-276)."""
    sched = dict(window_shift=i % 2 == 0, stripe_type="H" if i % 2 == 0 else "W",
                 stripe_shift=i % 4 in (2, 3))
    jblock = JBlock(dim=DIM, num_heads_w=HEADS, num_heads_s=HEADS,
                    window_size=(WINDOW, WINDOW), stripe_size_cfg=STRIPE,
                    stripe_groups_cfg=GROUPS, mlp_ratio=2.0,
                    anchor_window_down_factor=DF, d_major=True, attn_io="cm",
                    **sched)
    gcfg = GeometryConfig((WINDOW, WINDOW), STRIPE, GROUPS, DF)
    rng = np.random.default_rng(i)
    x = rng.standard_normal((2, *SIZE, DIM)).astype(np.float32)
    geom = jax_geometry(gcfg, SIZE)
    params = random_params(jblock, rng, jnp.asarray(x), geom)
    want = np.asarray(jax.jit(jblock.apply)(params, jnp.asarray(x), geom))

    tblock = TBlock(DIM, HEADS, HEADS, WINDOW, stripe_size=STRIPE,
                    stripe_groups=GROUPS, mlp_ratio=2.0, df=DF,
                    **sched).eval()
    tblock.load_state_dict(jax_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tblock(torch.from_numpy(x), geometry_tensors(gcfg, SIZE, "cpu"),
                     torch.float32, kernels=True)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=1e-4)
