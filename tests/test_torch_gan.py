"""The GAN path's networks and losses of the port against grlir's on the
CPU: gan_loss, SNConv's power iteration, the three discriminators, the x2
bilinear upsampling, VGG19 features with the perceptual loss, and LPIPS,
with the same numpy weights and inputs on both sides."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grlir.losses.gan import gan_loss as jgan_loss
from grlir.metrics import lpips as JL
from grlir.models import discriminator as JD
from grlir.models import vgg as JV
from grlir_torch.losses.gan import gan_loss
from grlir_torch.metrics import lpips as TL
from grlir_torch.models import discriminator as TD
from grlir_torch.models import vgg as TV
from grlir_torch.utils import convert as C
from torch_parity import one_torch_thread  # noqa: F401

GAN_TYPES = ("vanilla", "lsgan", "wgan", "wgan_softplus", "hinge")
LOSS_ATOL = 1e-6
NET_TOL = dict(atol=3e-5, rtol=1e-4)     # discriminators, SNConv
UP_TOL = 1e-6                            # _bilinear_up2 vs jax.image.resize
VGG_RTOL = 1e-5                          # VGG features, perceptual loss, LPIPS


def random_variables(module, rng, *inputs, **kw):
    """A flax module's variables (the tree of module.init) with every leaf
    drawn from numpy: kernels U(+-1/sqrt(fan_in)), biases and BatchNorm
    shifts N(0, 0.05^2), scales 1 + N(0, 0.1^2), running variances
    U(0.5, 1.5), spectral vectors unit normal draws."""
    tree = jax.eval_shape(functools.partial(module.init, **kw),
                          jax.random.PRNGKey(0), *inputs)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            bound = 1 / np.sqrt(np.prod(shape[:-1]))
            a = rng.uniform(-bound, bound, shape)
        elif name in ("bias", "mean"):
            a = rng.normal(0, 0.05, shape)
        elif name == "scale" or name.startswith("lin"):
            a = 1 + rng.normal(0, 0.1, shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, shape)
        elif name == "u":
            a = rng.standard_normal(shape)
            a /= np.linalg.norm(a)
        else:
            raise KeyError(name)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def to_port(module, variables, strict=True):
    module.load_state_dict(C.jax_variables_to_state_dict(variables), strict=strict)
    return module


@pytest.mark.parametrize("gan_type", GAN_TYPES)
@pytest.mark.parametrize("is_disc", [False, True])
@pytest.mark.parametrize("real", [False, True])
def test_gan_loss_matches_grlir(gan_type, is_disc, real):
    logits = np.random.default_rng(0).normal(0, 3, (2, 8, 8, 1)).astype(np.float32)
    want = jgan_loss(jnp.asarray(logits), real, gan_type, is_disc=is_disc,
                     loss_weight=0.1)
    got = gan_loss(torch.from_numpy(logits), real, gan_type, is_disc=is_disc,
                   loss_weight=0.1)
    assert abs(float(got) - float(want)) <= LOSS_ATOL * max(1.0, abs(float(want)))


def test_sn_conv_three_calls_match_grlir():
    """Update, no update, update: the outputs and the stored u after each
    call, on a 4x4 stride-2 and a 3x3 SNConv."""
    rng = np.random.default_rng(1)
    for k, s, bias in (((4, 4), (2, 2), False), ((3, 3), (1, 1), True)):
        x = rng.random((2, 16, 16, 6)).astype(np.float32)
        jm = JD.SNConv(10, k, s, bias)
        vs = random_variables(jm, rng, jnp.asarray(x))
        tm = to_port(TD.SNConv(6, 10, k, s, bias), vs)
        for update in (True, False, True):
            if update:
                jy, new = jm.apply(vs, jnp.asarray(x), True, mutable=["spectral"])
                vs = {**vs, "spectral": new["spectral"]}
            else:
                jy = jm.apply(vs, jnp.asarray(x), False)
            ty = tm(torch.from_numpy(x).permute(0, 3, 1, 2), update)
            np.testing.assert_allclose(ty.permute(0, 2, 3, 1).detach().numpy(),
                                       np.asarray(jy), **NET_TOL)
            np.testing.assert_allclose(tm.u.numpy(), np.asarray(vs["spectral"]["u"]),
                                       **NET_TOL)


def test_sn_conv_gradient_is_u_v():
    """d sigma / dW = u v^T: the weight gradient through the normalized
    kernel matches grlir's, with u and v held constant."""
    rng = np.random.default_rng(2)
    x = rng.random((1, 8, 8, 4)).astype(np.float32)
    jm = JD.SNConv(6, (3, 3), (1, 1), False)
    vs = random_variables(jm, rng, jnp.asarray(x))
    tm = to_port(TD.SNConv(4, 6, (3, 3), (1, 1), False), vs)

    def jloss(params):
        y, _ = jm.apply({**vs, "params": params}, jnp.asarray(x), True,
                        mutable=["spectral"])
        return jnp.sum(y ** 2)

    jg = jax.grad(jloss)(vs["params"])["kernel"]
    y = tm(torch.from_numpy(x).permute(0, 3, 1, 2), True)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(tm.weight.grad.numpy(),
                               np.asarray(jg).transpose(3, 2, 0, 1), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(jg)).max())


@pytest.mark.parametrize("hw", [(6, 6), (5, 9), (1, 3)])
def test_bilinear_up2_equals_jax_resize(hw):
    x = np.random.default_rng(3).random((2, *hw, 4)).astype(np.float32)
    want = JD._bilinear_up2(jnp.asarray(x))
    got = TD._bilinear_up2(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=UP_TOL)


@pytest.mark.parametrize("update", [True, False])
def test_unet_discriminator_matches_grlir(update):
    rng = np.random.default_rng(4)
    x = rng.random((2, 32, 48, 3)).astype(np.float32)
    jd = JD.UNetDiscriminatorSN(num_feat=8)
    vs = random_variables(jd, rng, jnp.asarray(x))
    td = to_port(TD.UNetDiscriminatorSN(num_feat=8), vs)
    if update:
        want, new = jd.apply(vs, jnp.asarray(x), True, mutable=["spectral"])
    else:
        want, new = jd.apply(vs, jnp.asarray(x), False), vs
    got = td(torch.from_numpy(x), update)
    assert got.shape == (2, 32, 48, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **NET_TOL)
    after = C.jax_variables_to_state_dict({"spectral": new["spectral"]})
    for k, v in after.items():
        np.testing.assert_allclose(td.state_dict()[k].numpy(), v.numpy(), **NET_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("train", [True, False])
def test_patchgan_discriminator_matches_grlir(train):
    rng = np.random.default_rng(5)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    jd = JD.PatchGANDiscriminator(ndf=16, n_layers=3)
    vs = random_variables(jd, rng, jnp.asarray(x), train=False)
    td = to_port(TD.PatchGANDiscriminator(ndf=16, n_layers=3), vs).train(train)
    if train:
        want, new = jd.apply(vs, jnp.asarray(x), True, mutable=["batch_stats"])
    else:
        want, new = jd.apply(vs, jnp.asarray(x), False), vs
    got = td(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **NET_TOL)
    stats = C.jax_variables_to_state_dict({"batch_stats": new["batch_stats"]})
    for k, v in stats.items():
        np.testing.assert_allclose(td.state_dict()[k].numpy(), v.numpy(), **NET_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("train", [True, False])
def test_vgg_style_discriminator_matches_grlir(train):
    rng = np.random.default_rng(6)
    x = rng.random((2, 128, 128, 3)).astype(np.float32)
    jd = JD.VGGStyleDiscriminator(num_feat=8, input_size=128)
    vs = random_variables(jd, rng, jnp.asarray(x), train=False)
    td = to_port(TD.VGGStyleDiscriminator(num_feat=8, input_size=128), vs).train(train)
    if train:
        want, _ = jd.apply(vs, jnp.asarray(x), True, mutable=["batch_stats"])
    else:
        want = jd.apply(vs, jnp.asarray(x), False)
    got = td(torch.from_numpy(x))
    assert got.shape == (2, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **NET_TOL)


def test_unet_discriminator_reference_key_conversion():
    """A state dict in the reference's spectral_norm layout (weight_orig,
    weight_u, weight_v) loads strictly into the port's UNet-SN, and grlir's
    converter reads the same dict: both give one output."""
    rng = np.random.default_rng(7)
    x = rng.random((1, 32, 32, 3)).astype(np.float32)
    jd = JD.UNetDiscriminatorSN(num_feat=8)
    vs = random_variables(jd, rng, jnp.asarray(x))
    port_sd = C.jax_variables_to_state_dict(vs)
    ref_sd = {}
    for k, v in port_sd.items():
        if k.endswith(".u"):
            ref_sd[k[:-1] + "weight_u"] = v.numpy()
            ref_sd[k[:-1] + "weight_v"] = np.zeros(1, np.float32)
        elif k.startswith(("conv0.", "conv9.")) or not k.endswith(".weight"):
            ref_sd[k] = v.numpy()
        else:
            ref_sd[k + "_orig"] = v.numpy()
    from grlir.utils.convert import convert_unet_discriminator as jconvert

    jvars = jconvert(ref_sd, jax.eval_shape(jd.init, jax.random.PRNGKey(0),
                                            jnp.asarray(x)))
    td = TD.UNetDiscriminatorSN(num_feat=8)
    td.load_state_dict(C.convert_unet_discriminator(ref_sd), strict=True)
    want = jd.apply(jvars, jnp.asarray(x), False)
    got = td(torch.from_numpy(x), False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **NET_TOL)


LAYERS = {"conv1_2": 0.1, "conv2_2": 0.1, "conv3_4": 1.0, "conv4_4": 1.0,
          "conv5_4": 1.0}


def _torchvision_sd(names, rng):
    """A torchvision-layout `features.<i>` state dict of random weights."""
    sd, cin = {}, 3
    for i, name in enumerate(names):
        if name.startswith("conv"):
            cout = TV.VGG_CHANNELS[name.split("_")[0]]
            bound = 1 / np.sqrt(9 * cin)
            sd[f"features.{i}.weight"] = rng.uniform(
                -bound, bound, (cout, cin, 3, 3)).astype(np.float32)
            sd[f"features.{i}.bias"] = rng.normal(0, 0.05, cout).astype(np.float32)
            cin = cout
    return sd


def test_vgg_features_and_perceptual_loss_match_grlir():
    rng = np.random.default_rng(8)
    sd = _torchvision_sd(TV.VGG19_NAMES, rng)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    jm = JV.VGGFeatureExtractor(tuple(LAYERS))
    jparams = JV.convert_vgg_torch_weights(sd, tuple(LAYERS))
    tm = TV.VGGFeatureExtractor(tuple(LAYERS))
    tm.load_state_dict(C.convert_vgg_torch_weights(sd, tuple(LAYERS)), strict=True)
    jf = jm.apply(jparams, jnp.asarray(x))
    with torch.no_grad():
        tf = tm(torch.from_numpy(x))
    assert sorted(tf) == sorted(jf)
    for k in LAYERS:
        np.testing.assert_allclose(tf[k].numpy(), np.asarray(jf[k]), rtol=VGG_RTOL,
                                   atol=VGG_RTOL * np.abs(np.asarray(jf[k])).max(),
                                   err_msg=k)
    for style in (0.0, 0.5):
        jp, js = JV.perceptual_loss(lambda v: jm.apply(jparams, v), jnp.asarray(x),
                                    jnp.asarray(y), LAYERS, style_weight=style)
        with torch.no_grad():
            tp, ts = TV.perceptual_loss(tm, torch.from_numpy(x), torch.from_numpy(y),
                                        LAYERS, style_weight=style)
        np.testing.assert_allclose(float(tp), float(jp), rtol=VGG_RTOL)
        np.testing.assert_allclose(float(ts), float(js), rtol=VGG_RTOL)


def _lpips_params(rng):
    sd = _torchvision_sd(TL.VGG16_NAMES, rng)
    lins = {f"lins.{i}.model.1.weight":
            rng.uniform(-0.2, 1.0, (1, c, 1, 1)).astype(np.float32)
            for i, c in enumerate(TL.LPIPS_TAP_CH)}
    return lins, sd


def test_lpips_matches_grlir_and_file_round_trip(tmp_path, monkeypatch):
    rng = np.random.default_rng(9)
    lins, sd = _lpips_params(rng)
    jparams = JL.convert_lpips_torch_weights(lins, sd)
    tparams = C.convert_lpips_torch_weights(lins, sd)
    x = rng.random((2, 32, 40, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    want = np.asarray(JL.LPIPSVgg().apply(jparams, jnp.asarray(x), jnp.asarray(y)))

    model = TL.LPIPSVgg()
    model.load_state_dict(C.jax_variables_to_state_dict(tparams), strict=True)
    np.testing.assert_allclose(TL.lpips_batch(model, x, y), want, rtol=VGG_RTOL)

    # one file for both packages: written by the port, read by grlir, and
    # the other way round
    path = tmp_path / "lpips.npz"
    TL.save_lpips_params(tparams, str(path))
    back = JL.load_lpips_params(str(path))
    np.testing.assert_allclose(
        np.asarray(JL.LPIPSVgg().apply(back, jnp.asarray(x), jnp.asarray(y))), want,
        rtol=VGG_RTOL)
    path2 = tmp_path / "lpips_j.npz"
    JL.save_lpips_params(jparams, str(path2))
    monkeypatch.setenv("GRLIR_LPIPS_NPZ", str(path2))
    np.testing.assert_allclose(TL.lpips_metric_fn("cpu")(x, y), want, rtol=VGG_RTOL)
    monkeypatch.setenv("GRLIR_LPIPS_NPZ", str(tmp_path / "missing.npz"))
    with pytest.raises(RuntimeError, match="GRLIR_LPIPS_NPZ"):
        TL.lpips_metric_fn("cpu")


# ---- the GAN step

STEP_TOL = dict(rtol=1e-5, atol=1e-6)    # losses, parameters and u after each step
GAN_TRUNK = dict(embed_dim=32, depths=(2,), num_heads_window=(2,),
                 num_heads_stripe=(2,), window_size=8, stripe_size=(8, 8),
                 stripe_groups=(None, None), stripe_shift=True, mlp_ratio=2.0,
                 anchor_window_down_factor=2, local_connection=True)


def gan_pair(seed, opt="sgd", lr=0.05, lightning_parity=True, with_vgg=True):
    """grlir's GAN step and the port's on the same tiny GRL (head dim 8,
    nearest+conv x4), UNet-SN num_feat 8 and a random VGG19, with optimizer
    `opt` on one multi-step schedule each; returns (jax side, port side,
    rng)."""
    from grlir.engines.gan import GANLossConfig as JCfg
    from grlir.engines.gan import create_gan_state, make_gan_train_step as jmake
    from grlir.models.grl import GRL as JGRL
    from grlir.models.grl import GRLConfig as JConfig
    from grlir.optim import build_optimizer as jbuild
    from grlir.optim.schedules import SCHEDULES as JSCHED
    from grlir_torch.engines.gan import GANLossConfig, GANTrainState, make_gan_train_step
    from grlir_torch.models.grl import GRL, GRLConfig
    from grlir_torch.optim import build_optimizer
    from grlir_torch.optim.schedules import SCHEDULES
    from torch_parity import random_params

    rng = np.random.default_rng(seed)
    jg = JGRL(JConfig(**GAN_TRUNK, upsampler="nearest+conv", upscale=4,
                      drop_path_rate=0.0))
    pg = random_params(jg, rng, jnp.zeros((1, 16, 16, 3), jnp.float32))
    jd = JD.UNetDiscriminatorSN(num_feat=8)
    dvars = random_variables(jd, rng, jnp.zeros((1, 64, 64, 3), jnp.float32))
    tg = GRL(GRLConfig(**GAN_TRUNK, upsampler="nearest+conv", upscale=4,
                       drop_path_rate=0.0))
    tg.load_state_dict(C.jax_params_to_state_dict(pg), strict=True)
    td = to_port(TD.UNetDiscriminatorSN(num_feat=8), dvars)

    sched = dict(milestones=[1], gamma=0.5)
    jopt_g = jbuild(opt, schedule=JSCHED["multi_steplr"](lr, **sched))
    jopt_d = jbuild(opt, schedule=JSCHED["multi_steplr"](lr, **sched))
    state = create_gan_state(pg, dvars, jopt_g, jopt_d)
    opt_g, sched_g = build_optimizer(tg.parameters(), opt,
                                     schedule=SCHEDULES["multi_steplr"](lr, **sched))
    opt_d, sched_d = build_optimizer(td.parameters(), opt,
                                     schedule=SCHEDULES["multi_steplr"](lr, **sched))
    tstate = GANTrainState(tg, td, opt_g, opt_d, sched_g, sched_d)

    jpercep = tpercep = None
    if with_vgg:
        sd = _torchvision_sd(TV.VGG19_NAMES, rng)
        jvgg = JV.VGGFeatureExtractor(tuple(LAYERS))
        jvp = JV.convert_vgg_torch_weights(sd, tuple(LAYERS))
        tvgg = TV.VGGFeatureExtractor(tuple(LAYERS)).requires_grad_(False)
        tvgg.load_state_dict(C.convert_vgg_torch_weights(sd, tuple(LAYERS)), strict=True)

        def jpercep(pred, target):
            return JV.perceptual_loss(lambda v: jvgg.apply(jvp, v), pred, target,
                                      LAYERS)[0]

        def tpercep(pred, target):
            return TV.perceptual_loss(tvgg, pred, target, LAYERS)[0]

    jstep = jmake(jg, jd, jopt_g, jopt_d, JCfg(), perceptual_fn=jpercep,
                  lightning_parity=lightning_parity)
    tstep = make_gan_train_step(GANLossConfig(), perceptual_fn=tpercep,
                                lightning_parity=lightning_parity)
    return (jstep, state), (tstep, tstate), rng


def assert_gan_state_close(tstate, jstate, what):
    want_g = C.jax_params_to_state_dict(jstate.params_g)
    for n, p in tstate.generator.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_g[n].numpy(), **STEP_TOL,
                                   err_msg=f"{what} G {n}")
    want_d = C.jax_variables_to_state_dict({"params": jstate.params_d["params"],
                                            "spectral": jstate.spectral})
    got_d = tstate.discriminator.state_dict()
    assert sorted(got_d) == sorted(want_d)
    for n, v in want_d.items():
        np.testing.assert_allclose(got_d[n].numpy(), v.numpy(), **STEP_TOL,
                                   err_msg=f"{what} D {n}")


@pytest.mark.parametrize("lightning_parity", [True, False])
def test_gan_step_matches_grlir(lightning_parity):
    """Two steps of each protocol, kernels off (the CPU): every loss, then
    G's and D's parameters and the spectral vectors after each step.  SGD at
    a large LR, so that the parameters show the gradients (Adam normalizes
    a gradient at fp32 noise level to a full LR step of either sign; its
    update is held to optax's in tests/test_torch_trajectory.py)."""
    (jstep, jstate), (tstep, tstate), rng = gan_pair(30, lightning_parity=lightning_parity)
    for i in range(2):
        lq = rng.random((2, 16, 16, 3)).astype(np.float32)
        gt = rng.random((2, 64, 64, 3)).astype(np.float32)
        gt_usm = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, 1).astype(np.float32)
        batch = {"img_lq": lq, "img_gt": gt, "img_gt_usm": gt_usm}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(i))
        tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **STEP_TOL,
                                       err_msg=f"step {i} {k}")
        assert_gan_state_close(tstate, jstate, f"step {i}")
    assert tstate.step == int(jstate.step) == 2
