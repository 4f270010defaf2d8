"""Short training trajectories of the port against grlir's on the CPU: 20
AdamW steps with a warmup multi-step schedule on identical batches (the
losses, the LR sequence and the final parameters), and torch's Adam, AdamW
and SGD under the port's `build_optimizer` against optax itself on a small
parameter tree fed the same gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grlir.engines.train import create_state
from grlir.engines.train import make_train_step as jmake_train_step
from grlir.models.grl import GRL as JGRL
from grlir.models.grl import GRLConfig as JConfig
from grlir.optim import build_optimizer as jbuild_optimizer
from grlir.optim import current_lr as jcurrent_lr
from grlir.optim.schedules import SCHEDULES as JSCHEDULES
from grlir_torch.engines.train import TrainState, make_train_step
from grlir_torch.models.grl import GRL, GRLConfig
from grlir_torch.optim import build_optimizer, current_lr
from grlir_torch.optim.schedules import SCHEDULES
from grlir_torch.utils.convert import jax_params_to_state_dict
from torch_parity import TRUNK, random_params

STEPS = 20
SCHED = ("multi_steplr", dict(milestones=[8, 14], gamma=0.5, warmup_iter=5,
                              warmup_init_lr=1e-6))
BASE_LR = 2e-4          # config/optimizer/adamw.yaml's lr


def loss_tol(i):
    return 3e-4 + 3e-5 * i


def test_adamw_warmup_trajectory_matches_grlir():
    trunk = dict(TRUNK, depths=(2,), num_heads_window=(2,), num_heads_stripe=(2,))
    rng = np.random.default_rng(21)
    jm = JGRL(JConfig(**trunk, upsampler="pixelshuffle", upscale=2, drop_path_rate=0.0))
    params = random_params(jm, rng, jnp.zeros((1, 32, 32, 3), jnp.float32))
    tm = GRL(GRLConfig(**trunk, upsampler="pixelshuffle", upscale=2, drop_path_rate=0.0))
    tm.load_state_dict(jax_params_to_state_dict(params), strict=True)
    lq = rng.random((2, 24, 24, 3)).astype(np.float32)
    gt = np.clip(np.repeat(np.repeat(lq, 2, 1), 2, 2)
                 + 0.05 * rng.standard_normal((2, 48, 48, 3)), 0, 1).astype(np.float32)

    name, kw = SCHED
    jopt = jbuild_optimizer("adamw", schedule=JSCHEDULES[name](BASE_LR, **kw),
                            weight_decay=1e-2)
    jstep = jmake_train_step(jm, jopt, {"l1": 1.0}, donate=False)
    jstate = create_state(params, jopt)
    schedule = SCHEDULES[name](BASE_LR, **kw)
    opt, sched = build_optimizer(tm.parameters(), "adamw", schedule=schedule,
                                 weight_decay=1e-2)
    state = TrainState(tm, opt, sched)
    step = make_train_step({"l1": 1.0})
    batch_j = {"img_lq": jnp.asarray(lq), "img_gt": jnp.asarray(gt)}
    batch_t = {"img_lq": torch.from_numpy(lq), "img_gt": torch.from_numpy(gt)}

    losses_j, losses_t, lr_j, lr_t = [], [], [], []
    for i in range(STEPS):
        lr_t.append(current_lr(opt))             # the LR of update i
        jstate, jm_ = jstep(jstate, batch_j, jax.random.PRNGKey(i))
        lr_j.append(jcurrent_lr(jstate.opt_state))
        losses_t.append(float(step(state, batch_t)["loss"]))
        losses_j.append(float(jm_["loss"]))
    for i, (a, b) in enumerate(zip(losses_t, losses_j)):
        assert abs(a - b) <= loss_tol(i) * abs(b), (i, a, b)
    assert losses_t[-1] < losses_t[0]
    np.testing.assert_allclose(lr_t, lr_j, rtol=1e-6)
    np.testing.assert_allclose(lr_t, [schedule(i) for i in range(STEPS)], rtol=0)
    assert lr_t[0] == 1e-6 and lr_t[5] == BASE_LR and lr_t[14] == BASE_LR / 4

    # Adam moves every parameter by about the LR whatever its gradient, so
    # fp32 noise can walk a small parameter by a fraction of the summed LR:
    # the scale is the larger of the tensor's and the summed LR, as in
    # tests/test_training_dynamics.py.  The port runs at torch's default
    # intra-op thread count here: on one thread (another summation order)
    # one CPB-MLP bias of 512 ends 1.6e-4 from grlir's, against 5.9e-5
    cum_lr = sum(lr_t)
    want = jax_params_to_state_dict(jstate.params)
    for n, p in tm.named_parameters():
        w = want[n].numpy()
        scale = max(np.abs(w).max(), cum_lr)
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=1e-3 * scale, err_msg=n)


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_optimizer_steps_match_optax(name):
    """The same gradients through optax (grlir.optim.build_optimizer) and
    through the port's torch optimizer and LambdaLR: the parameters after
    every step, and update k taking schedule(k)."""
    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in tree.items()}
             for _ in range(12)]
    kw = dict(milestones=[4, 9], gamma=0.3, warmup_iter=3, warmup_init_lr=1e-3)
    jsched = JSCHEDULES["multi_steplr"](5e-2, **kw)
    jopt = jbuild_optimizer(name, schedule=jsched, betas=(0.8, 0.95), weight_decay=0.1)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in tree.items()}
    opt, sched = build_optimizer(tparams.values(), name,
                                 schedule=SCHEDULES["multi_steplr"](5e-2, **kw),
                                 betas=(0.8, 0.95), weight_decay=0.1)
    for k, g in enumerate(grads):
        updates, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        assert current_lr(opt) == pytest.approx(float(jsched(k)), rel=1e-6)
        for key, p in tparams.items():
            p.grad = torch.from_numpy(g[key])
        opt.step()
        sched.step()
        for key, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[key]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{name} step {k} {key}")
