"""Classification training in the port against grlir, fp32 on the CPU: the
image <-> class converters, the classification losses (one-hot and
smoothed targets, argmax and expectation images), one train step's loss
and gradients against grlir's `make_train_step(classification=True)`, and
the CLI with `loss=l1_ce`, which validates on the formed image and saves
checkpoints."""

import os
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from grlir.engines.train import create_state
from grlir.engines.train import make_train_step as jmake_train_step
from grlir.losses import LOSS_FNS as JLOSS_FNS
from grlir.losses import classification as jloss
from grlir.models.grl import GRL as JGRL
from grlir.models.grl import GRLConfig as JConfig
from grlir.utils import classification as jcls
from grlir_torch.engines.train import TrainState, make_train_step
from grlir_torch.losses import LOSS_FNS
from grlir_torch.losses import classification as tloss
from grlir_torch.models.grl import GRL, GRLConfig
from grlir_torch.optim import build_optimizer
from grlir_torch.utils import classification as tcls
from grlir_torch.utils.convert import jax_params_to_state_dict
from test_torch_train_cli import data_root  # noqa: F401
from test_torch_train_step import GRAD_ATOL, GRAD_FLOOR, LOSS_REL
from torch_parity import TRUNK, one_torch_thread, random_params  # noqa: F401

TOL = dict(atol=3e-5, rtol=1e-4)


def _draw(seed, channels=3, hw=(4, 6)):
    rng = np.random.default_rng(seed)
    img = rng.random((2, *hw, channels)).astype(np.float32)
    img[0, 0, 0] = [1.0, 0.0, 254.9999 / 255][:channels]     # the edges
    logits = (3 * rng.standard_normal((2, *hw, 256 * channels))).astype(np.float32)
    return img, logits


def test_converters_match_jax():
    img, logits = _draw(0)
    dist = np.array(jax.nn.softmax(logits.reshape(2, 4, 6, 3, 256), -1))
    t = torch.from_numpy
    np.testing.assert_allclose(tcls.img_to_prob(t(img)).numpy(),
                               np.asarray(jcls.img_to_prob(img)), **TOL)
    np.testing.assert_allclose(tcls.img_to_prob(t(img) * 255, 3.0, 255).numpy(),
                               np.asarray(jcls.img_to_prob(img * 255, 3.0, 255)), **TOL)
    np.testing.assert_array_equal(tcls.img_to_class(t(img)).numpy(),
                                  np.asarray(jcls.img_to_class(img)))
    np.testing.assert_array_equal(tcls.img_from_prob_argmax(t(dist)).numpy(),
                                  np.asarray(jcls.img_from_prob_argmax(dist)))
    np.testing.assert_allclose(tcls.img_from_prob_weighted(t(dist)).numpy(),
                               np.asarray(jcls.img_from_prob_weighted(dist)), **TOL)
    raw = logits.reshape(2, 4, 6, 3, 256)
    np.testing.assert_allclose(
        float(tcls.cross_entropy_pixel_loss(t(raw), t(img))),
        float(jcls.cross_entropy_pixel_loss(raw, img)), rtol=1e-6)


def test_class_dist_and_soft_ce_match_jax():
    img, logits = _draw(1)
    t = torch.from_numpy
    np.testing.assert_allclose(tloss.logits_to_class_dist(t(logits)).numpy(),
                               np.asarray(jloss.logits_to_class_dist(logits)), **TOL)
    raw = logits.reshape(2, 4, 6, 3, 256)
    np.testing.assert_allclose(
        float(tloss.soft_cross_entropy_pixel_loss(t(raw), t(img))),
        float(jloss.soft_cross_entropy_pixel_loss(raw, img)), rtol=1e-6)
    with pytest.raises(ValueError, match="256"):
        tloss.logits_to_class_dist(torch.zeros(1, 2, 2, 300))


@pytest.mark.parametrize("loss_cfg", [{"l1": 1.0, "cross_entropy": 1.0},
                                      {"l2": 1.0, "cross_entropy": 0.5},
                                      {"cross_entropy": 1.0}])
@pytest.mark.parametrize("one_hot", [True, False])
@pytest.mark.parametrize("form", ["weighted_sum", "argmax"])
def test_classification_loss_matches_jax(loss_cfg, one_hot, form):
    """Loss values and, where the image is formed by expectation, the
    logits' gradient."""
    img, logits = _draw(2, channels=1)
    jfn = jloss.build_classification_loss(loss_cfg, JLOSS_FNS, one_hot, form)
    tfn = tloss.build_classification_loss(loss_cfg, LOSS_FNS, one_hot, form)
    (jtotal, jparts), jgrad = jax.value_and_grad(jfn, has_aux=True)(
        jnp.asarray(logits), jnp.asarray(img))
    tl = torch.from_numpy(logits).requires_grad_(True)
    total, parts = tfn(tl, torch.from_numpy(img))
    total.backward()
    total, parts = total.detach(), {k: v.detach() for k, v in parts.items()}
    assert sorted(parts) == sorted(jparts)
    for k in parts:
        assert float(parts[k]) == pytest.approx(float(jparts[k]), rel=1e-5, abs=1e-7)
    assert float(total) == pytest.approx(float(jtotal), rel=1e-5)
    g = np.asarray(jgrad)
    np.testing.assert_allclose(tl.grad.numpy(), g, rtol=0,
                               atol=3e-5 * np.abs(g).max() + 1e-9)
    with pytest.raises(NotImplementedError):
        tloss.build_classification_loss({"lpips": 1.0}, LOSS_FNS)(tl, torch.from_numpy(img))


@pytest.mark.parametrize("one_hot", [True, False])
def test_classification_step_matches_jax(one_hot):
    """One step of a gray GRL with a 256-class head on l1 + cross entropy:
    the loss, its parts and every gradient against grlir's step, at the
    gates of tests/test_torch_train_step.py."""
    trunk = dict(TRUNK, depths=(2,), num_heads_window=(2,), num_heads_stripe=(2,))
    kw = dict(trunk, in_channels=1, out_channels=256, upsampler="", upscale=1,
              drop_path_rate=0.0)
    rng = np.random.default_rng(5)
    jm = JGRL(JConfig(**kw))
    params = random_params(jm, rng, jnp.zeros((1, 32, 32, 1), jnp.float32))
    tm = GRL(GRLConfig(**kw))
    tm.load_state_dict(jax_params_to_state_dict(params), strict=True)
    lq = rng.random((2, 24, 24, 1)).astype(np.float32)
    gt = rng.random((2, 24, 24, 1)).astype(np.float32)
    loss_cfg = {"l1": 1.0, "cross_entropy": 1.0}

    def zeros(t):
        return jax.tree_util.tree_map(jnp.zeros_like, t)

    recorder = optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))
    jstep = jax.jit(jmake_train_step(jm, recorder, loss_cfg, jit_compile=False,
                                     classification=True, one_hot_label=one_hot))
    jstate, jmetrics = jstep(create_state(params, recorder),
                             {"img_lq": jnp.asarray(lq), "img_gt": jnp.asarray(gt)},
                             jax.random.PRNGKey(0))
    opt, sched = build_optimizer(tm.parameters(), "sgd", learning_rate=0.0)
    metrics = make_train_step(loss_cfg, classification=True, one_hot_label=one_hot)(
        TrainState(tm, opt, sched),
        {"img_lq": torch.from_numpy(lq), "img_gt": torch.from_numpy(gt)})
    assert sorted(metrics) == sorted(jmetrics)
    for k in jmetrics:
        want = float(jmetrics[k])
        assert abs(float(metrics[k]) - want) <= LOSS_REL * abs(want), (k, metrics[k], want)
    want = jax_params_to_state_dict({"params": jstate.opt_state})
    for n, p in tm.named_parameters():
        w = want[n].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=GRAD_ATOL * np.abs(w).max() + GRAD_FLOOR,
                                   err_msg=n)


def test_formed_image_model():
    """FormedImage: the model's logits through the class distribution to an
    image, by expectation or argmax."""
    torch.manual_seed(0)
    model = GRL(GRLConfig(**dict(TRUNK, depths=(1,), num_heads_window=(2,),
                                 num_heads_stripe=(2,)), in_channels=1,
                          out_channels=256, upsampler="", upscale=1)).eval()
    x = torch.rand(1, 32, 32, 1)
    with torch.no_grad():
        dist = tloss.logits_to_class_dist(model(x))
        for form, fn in tloss.FORMS.items():
            got = tloss.FormedImage(model, form)(x)
            assert got.shape == (1, 32, 32, 1)
            assert torch.equal(got, fn(dist))


def test_cli_trains_classification(data_root, tmp_path, capsys):  # noqa: F811
    """`loss=l1_ce` on gray denoising: a 256-class head a channel, trains,
    validates on the formed image, checkpoints, and resumes."""
    from grlir_torch.configs import load_config
    from grlir_torch.train import build_model_config, main

    toks = ["experiment=dn/grl_p256", "tag=cls", f"io.base_output_path={tmp_path}/out",
            "data_module.train.dataset=div2k", "data_module.val.dataset=cbsd68",
            "data_module.num_channels=1", "loss=l1_ce", "metric=classifier",
            "model.embed_dim=16", "model.depths=[1]", "model.num_heads_window=[2]",
            "model.num_heads_stripe=[2]", "model.window_size=8", "stripe_size1=8",
            "stripe_size2=16", "patch_size=16", "batch_size=2",
            "trainer.val_check_interval=2", "trainer.log_every_n_steps=1",
            "num_workers=1", "mixup=false"]
    cfg = load_config(toks)
    assert cfg["classification"] and build_model_config(cfg).out_channels == 256
    main(toks + ["trainer.max_steps=2", "device=cpu"])
    text = capsys.readouterr().out
    assert "step 2 val[cbsd68]: psnr=" in text and "ssim=" in text, text
    run = tmp_path / "out" / "cls" / "version_0"
    assert sorted(os.listdir(run / "checkpoints")) == ["step_2"]
    main(toks + ["trainer.max_steps=4", "device=cpu", "prob_to_image=argmax"])
    text = capsys.readouterr().out
    assert "resumed from step 2" in text and "step 4 val[cbsd68]: psnr=" in text
    rows = (run / "results.csv").read_text().splitlines()
    assert [r.split(",")[2] for r in rows[1:]] == ["2", "4"]
    psnr = [float(line.split("psnr=")[1].split()[0]) for line in text.splitlines()
            if "val[cbsd68]" in line]
    assert all(np.isfinite(psnr)) and osp.exists(run / "checkpoints" / "step_4")
