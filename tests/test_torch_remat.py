"""Remat policies on the CPU: each block under torch.utils.checkpoint with
a selective-checkpoint policy ("dots" keeps every matrix product's output,
"dots_no_batch" those without a batch dimension, grlir's
jax.checkpoint_policies) gives the loss and gradients of full recompute
(policy None), with drop path on, and the policy changes what the backward
recomputes."""

from dataclasses import replace

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from grlir_torch.models.grl import REMAT_SAVED, GRL, GRLConfig, init_weights
from torch_parity import TRUNK, one_torch_thread  # noqa: F401

CFG = GRLConfig(**dict(TRUNK, depths=(3, 2), num_heads_window=(2, 2),
                       num_heads_stripe=(2, 2)),
                upsampler="pixelshuffle", upscale=2, drop_path_rate=0.3,
                remat=True)
PRODUCTS = {torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm,
            torch.ops.aten.baddbmm}


class _CountProducts(TorchDispatchMode):
    """Count the matrix products dispatched while active, by op."""

    def __init__(self):
        super().__init__()
        self.n = dict.fromkeys(PRODUCTS, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in self.n:
            self.n[func.overloadpacket] += 1
        return func(*args, **(kwargs or {}))


def _step(policy, masks, x, y, options=None):
    """(loss, {name: grad}, products the backward dispatched) of one
    forward and backward of CFG's model with `policy`."""
    cfg = replace(CFG, remat_policy=policy, **(options or {}))
    model = init_weights(GRL(cfg), torch.Generator().manual_seed(0)).train()
    loss = torch.mean(torch.abs(model(x, drop_masks=masks) - y))
    with _CountProducts() as counter:
        loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}, counter.n


@pytest.fixture(scope="module")
def inputs():
    g = torch.Generator().manual_seed(1)
    x, y = torch.rand(2, 32, 32, 3, generator=g), torch.rand(2, 64, 64, 3, generator=g)
    masks = GRL(CFG).draw_drop_masks(2, torch.Generator().manual_seed(2))
    assert not masks.all()
    return x, y, masks


@pytest.mark.parametrize("policy", sorted(REMAT_SAVED))
def test_policy_gradients_equal_full_recompute(policy, inputs):
    x, y, masks = inputs
    l0, g0, n0 = _step(None, masks, x, y)
    l1, g1, n1 = _step(policy, masks, x, y)
    assert torch.equal(l0, l1)
    assert sorted(g0) == sorted(g1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    # the saved products are not recomputed in the backward; the others are
    saved = set(REMAT_SAVED[policy])
    for op in PRODUCTS:
        if op in saved and n0[op]:
            assert n1[op] < n0[op], (op, n1[op], n0[op])
        else:
            assert n1[op] == n0[op], (op, n1[op], n0[op])


@pytest.mark.parametrize("policy", sorted(REMAT_SAVED))
def test_policy_on_the_legacy_route(policy, inputs):
    """A separable-conv qkv (grlir's legacy route) under the policy: the
    gradients of full recompute."""
    x, y, masks = inputs
    options = {"qkv_proj_type": "separable_conv"}
    l0, g0, _ = _step(None, masks, x, y, options)
    l1, g1, _ = _step(policy, masks, x, y, options)
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
