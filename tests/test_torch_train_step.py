"""One training step of the port against grlir's, on the CPU in fp32: the
loss and every parameter gradient of `grlir_torch.engines.train`'s step
against `jax.value_and_grad` inside `grlir.engines.train.make_train_step`
(jit_compile=False), at drop path 0; and the training fields of the port's
GRL: remat against no remat with drop path on, the per-block drop-path
rates, drop path in eval(), img_range and res_scale."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from grlir.engines.train import create_state
from grlir.engines.train import make_train_step as jmake_train_step
from grlir.models.blocks import drop_path as jdrop_path
from grlir.models.grl import GRL as JGRL
from grlir.models.grl import GRLConfig as JConfig
from grlir_torch.engines.train import TrainState, make_train_step
from grlir_torch.models.blocks import drop_path
from grlir_torch.models.grl import GRL, GRLConfig, init_weights
from grlir_torch.optim import build_optimizer
from grlir_torch.utils.convert import jax_params_to_state_dict
from torch_parity import TRUNK, random_params, one_torch_thread  # noqa: F401

LOSS_REL = 1e-5
GRAD_ATOL, GRAD_FLOOR = 3e-5, 1e-8     # x max|g| of each tensor, + floor

CASES = {
    # GRL-S's trunk at embed 32, one stage of two blocks, x2 pixelshuffle
    "sr_x2_l1": (dict(TRUNK, depths=(2,), num_heads_window=(2,), num_heads_stripe=(2,)),
                 "pixelshuffle", 2, {"l1": 1.0}, 24),
    # the denoising tail, charbonnier + weighted TV.  At embed 16 (head dim
    # 4) grlir's and the port's fp32 gradients of block 0's qkv each sit
    # 2-3e-5 x max|g| from a float64 reference, so their difference passes
    # this gate only from head dim 8 on
    "dn_charbonnier_tv": (dict(TRUNK, depths=(2,), num_heads_window=(2,),
                               num_heads_stripe=(2,)), "", 1,
                          {"charbonnier": 1.0, "tv": 0.5}, 32),
}


def _pair(trunk, upsampler, upscale, seed, **extra):
    rng = np.random.default_rng(seed)
    jm = JGRL(JConfig(**trunk, upsampler=upsampler, upscale=upscale,
                      drop_path_rate=0.0, **extra))
    params = random_params(jm, rng, jnp.zeros((1, 32, 32, 3), jnp.float32))
    tm = GRL(GRLConfig(**trunk, upsampler=upsampler, upscale=upscale,
                       drop_path_rate=0.0, **extra))
    tm.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return jm, params, tm, rng


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_loss_and_grads_match_jax(case):
    trunk, upsampler, upscale, loss_cfg, hw = CASES[case]
    jm, params, tm, rng = _pair(trunk, upsampler, upscale, seed=3)
    lq = rng.random((2, hw, hw, 3)).astype(np.float32)
    gt = rng.random((2, hw * upscale, hw * upscale, 3)).astype(np.float32)

    def zeros(t):
        return jax.tree_util.tree_map(jnp.zeros_like, t)

    # an optax transform that changes nothing and keeps the gradients as
    # its state, so that the step can be jitted
    recorder = optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))
    jstep = jax.jit(jmake_train_step(jm, recorder, loss_cfg, jit_compile=False))
    jstate, jmetrics = jstep(create_state(params, recorder),
                             {"img_lq": jnp.asarray(lq), "img_gt": jnp.asarray(gt)},
                             jax.random.PRNGKey(0))

    opt, sched = build_optimizer(tm.parameters(), "sgd", learning_rate=0.0)
    state = TrainState(tm, opt, sched)
    metrics = make_train_step(loss_cfg)(
        state, {"img_lq": torch.from_numpy(lq), "img_gt": torch.from_numpy(gt)})
    assert state.step == 1 and tm.training
    for k in jmetrics:
        want = float(jmetrics[k])
        assert abs(float(metrics[k]) - want) <= LOSS_REL * abs(want), (k, metrics[k], want)

    want = jax_params_to_state_dict({"params": jstate.opt_state})
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert sorted(got) == sorted(want)
    for n, g in got.items():
        w = want[n].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_ATOL * np.abs(w).max() + GRAD_FLOOR, err_msg=n)


def _grads(model, x, y, **kw):
    model.zero_grad(set_to_none=True)
    loss = torch.mean(torch.abs(model(x, **kw) - y))
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_remat_equals_no_remat_with_drop_path():
    """Each block under torch.utils.checkpoint: the same loss and gradients
    as without, with drop path on, for fixed masks and for masks drawn from
    a seeded generator (drawn before the checkpointed blocks, so the
    recompute applies the same ones)."""
    cfg = GRLConfig(**dict(TRUNK, depths=(3, 2), num_heads_window=(2, 2),
                           num_heads_stripe=(2, 2)),
                    upsampler="pixelshuffledirect", upscale=2, drop_path_rate=0.4)
    base = init_weights(GRL(cfg), torch.Generator().manual_seed(0)).train()
    rem = GRL(replace(cfg, remat=True)).train()
    rem.load_state_dict(base.state_dict())
    g = torch.Generator().manual_seed(1)
    x, y = torch.rand(2, 32, 32, 3, generator=g), torch.rand(2, 64, 64, 3, generator=g)
    masks = base.draw_drop_masks(2, torch.Generator().manual_seed(2))
    assert masks.shape == (5, 2, 2) and not masks.all()
    for kw_a, kw_b in (({"drop_masks": masks}, {"drop_masks": masks}),
                       ({"generator": torch.Generator().manual_seed(4)},
                        {"generator": torch.Generator().manual_seed(4)})):
        la, ga = _grads(base, x, y, **kw_a)
        lb, gb = _grads(rem, x, y, **kw_b)
        assert torch.equal(la, lb)
        for n in ga:
            assert torch.equal(ga[n], gb[n]), n
    # the masks matter: all-kept masks give another loss
    l_all, _ = _grads(base, x, y, drop_masks=torch.ones_like(masks))
    l_m, _ = _grads(base, x, y, drop_masks=masks)
    assert not torch.equal(l_all, l_m)


def test_drop_path_rates_and_semantics_match_grlir():
    cfg = GRLConfig(**dict(TRUNK, depths=(2, 3), num_heads_window=(2, 2),
                           num_heads_stripe=(2, 2)), drop_path_rate=0.25)
    want = np.linspace(0, 0.25, 5).tolist()
    assert cfg.drop_path_rates == tuple(want)
    model = GRL(cfg)
    got = [b.drop_path_rate for stage in model.layers for b in stage.blocks]
    assert got == want
    assert GRL(GRLConfig(**TRUNK)).cfg.drop_path_rate == JConfig().drop_path_rate == 0.1
    # the function: grlir's mask from its rng, applied by both
    x = np.random.default_rng(0).standard_normal((6, 4, 4, 8)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    mask = np.asarray(jax.random.bernoulli(key, 0.7, (6, 1, 1, 1))).reshape(-1)
    want = np.asarray(jdrop_path(jnp.asarray(x), 0.3, False, key))
    got = drop_path(torch.from_numpy(x), torch.from_numpy(mask), 0.3).numpy()
    np.testing.assert_array_equal(got, want)


def test_drop_path_is_identity_in_eval():
    cfg = GRLConfig(**TRUNK, upsampler="pixelshuffle", upscale=2, drop_path_rate=0.5)
    m = init_weights(GRL(cfg), torch.Generator().manual_seed(0))
    ref = GRL(replace(cfg, drop_path_rate=0.0))
    ref.load_state_dict(m.state_dict())
    x = torch.rand(3, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = ref.eval()(x)
        assert torch.equal(m.eval()(x), want)
        # in train mode the same weights drop blocks
        assert not torch.equal(m.train()(x, generator=torch.Generator().manual_seed(0)), want)


@pytest.mark.parametrize("img_range,init_method", [(255.0, "n"), (1.0, "r"), (2.5, "r")])
def test_img_range_and_res_scale_match_grlir(img_range, init_method):
    trunk = dict(TRUNK, depths=(2,), num_heads_window=(2,), num_heads_stripe=(2,))
    jm, params, tm, rng = _pair(trunk, "pixelshuffle", 2, seed=8,
                                img_range=img_range, init_method=init_method)
    assert tm.cfg.res_scale == (0.1 if init_method == "r" else 1.0)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)


def test_eval_step_and_unported_options():
    """make_eval_step runs the model in eval mode without grad; remat
    policies and classification training, once refused, now build (their
    parity: tests/test_torch_remat.py, tests/test_torch_classification.py)."""
    from grlir_torch.engines.train import make_eval_step

    cfg = GRLConfig(**TRUNK, upsampler="pixelshuffle", upscale=2, drop_path_rate=0.3)
    m = init_weights(GRL(cfg), torch.Generator().manual_seed(0)).train()
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    y = make_eval_step(m)(x)
    assert not m.training and not y.requires_grad
    with torch.no_grad():
        assert torch.equal(y, m(x))
    for policy in ("dots", "dots_no_batch"):
        assert GRL(replace(cfg, remat=True, remat_policy=policy)).layers[0].remat_kwargs
    assert callable(make_train_step({"l1": 1.0, "cross_entropy": 1.0},
                                    classification=True))
