"""Real-world SR training through the port's CLI on the CPU, against
grlir's: `experiment=bsr/grl` (the GAN runner) on a tiny BSR folder, with
the perceptual term on a random VGG19 file: every step's losses, the
parameters after the run, the saved checkpoint's val_niqe, a resume, and
the stage-2 warm start from a PSNR generator; and stage 1
(`experiment=bsr/grl_psnr`) handing its checkpoint directory to stage 2.

Both runners train on the same batches: grlir's are recorded and replayed
into the port's runner, since the BSR data ends in JPEG, where one float
rounding can move an 8x8 block (the data's own parity is
tests/test_torch_bsr.py)."""

import json
import os

import numpy as np
import pytest
import torch

from grlir_torch.utils.imageio import imwrite
from torch_parity import one_torch_thread  # noqa: F401

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
NIQE_TOL = 1e-3        # as tests/test_torch_validate.py
# grlir reads without its HDF5 decode cache, where the port keeps .npy files
JAX_ONLY = ["num_devices=1", "data_module.use_cache=false"]
VGG19_CONVS = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34]


@pytest.fixture
def bsr_root(tmp_path, monkeypatch):
    """OST train images (under 400 pixels: reflect-padded) and a GT-free
    RealSR val image big enough for NIQE after x4."""
    root = tmp_path / "data"
    rng = np.random.default_rng(0)
    (root / "OST" / "train").mkdir(parents=True)
    (root / "test_set" / "RealSRSetPlus5images").mkdir(parents=True)
    items = []
    for i in range(3):
        imwrite(str(root / "OST" / "train" / f"{i:03d}.png"),
                (rng.random((80, 96, 3)) * 255).astype(np.uint8))
        items.append({"path": f"train/{i:03d}.png"})
    imwrite(str(root / "test_set" / "RealSRSetPlus5images" / "r0.png"),
            (rng.random((56, 56, 3)) * 255).astype(np.uint8))
    for name, entries in (("OST/train.json", items),
                          ("RealSRSetPlus5images/test.json",
                           [{"path": "RealSRSetPlus5images/r0.png"}])):
        path = root / "image_info" / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(entries))
    monkeypatch.setenv("GRLIR_DATA_ROOT", str(root))
    monkeypatch.setenv("GRLIR_CACHE_DIR", str(tmp_path / "cache"))
    return root


@pytest.fixture
def vgg_file(tmp_path):
    """A torchvision-layout vgg19 `features` state dict of random weights."""
    rng = np.random.default_rng(1)
    sd, cin = {}, 3
    widths = [64, 64, 128, 128] + [256] * 4 + [512] * 8
    for idx, cout in zip(VGG19_CONVS, widths):
        bound = 1 / np.sqrt(9 * cin)
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            rng.uniform(-bound, bound, (cout, cin, 3, 3)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            rng.normal(0, 0.05, cout).astype(np.float32))
        cin = cout
    path = tmp_path / "vgg19.pth"
    torch.save(sd, path)
    return path


def g_overrides(prefix):
    return [f"{prefix}embed_dim=32", f"{prefix}depths=[2]",
            f"{prefix}num_heads_window=[2]", f"{prefix}num_heads_stripe=[2]",
            f"{prefix}window_size=8", f"{prefix}drop_path_rate=0.0"]


def gan_args(tmp_path, tag, steps, extra=()):
    return ["experiment=bsr/grl", f"tag={tag}", f"io.base_output_path={tmp_path}/out",
            "data_module.train.dataset=ost", *g_overrides("model.model_g."),
            "stripe_size1=8", "stripe_size2=16", "model.model_d.num_feat=8",
            "patch_size=16", "batch_size=2", f"trainer.max_steps={steps}",
            "trainer.val_check_interval=2", "trainer.log_every_n_steps=1",
            "num_workers=1", "worker_mode=thread", *extra]


class Recorder:
    """Wraps a package's make_gan_train_step: keeps each step's metrics and
    (on grlir's side) its batch as numpy."""

    def __init__(self, monkeypatch, module, keep_batches):
        self.metrics, self.batches = [], []
        make = module.make_gan_train_step

        def wrapped(*a, **kw):
            step = make(*a, **kw)

            def run(*args):
                if keep_batches:
                    self.batches.append({k: np.asarray(v) for k, v in args[1].items()})
                out = step(*args)
                m = out[1] if isinstance(out, tuple) else out
                self.metrics.append({k: float(v) for k, v in m.items()})
                return out

            return run

        monkeypatch.setattr(module, "make_gan_train_step", wrapped)


def replay(monkeypatch, batches):
    """The port's train loader yields `batches` in order."""
    from grlir_torch.data.module import IRDataModule

    class Loader:
        def infinite(self):
            for b in batches:
                yield {k: np.array(v) for k, v in b.items()}

        def close(self):
            pass

    monkeypatch.setattr(IRDataModule, "train_loader", lambda self, *a, **kw: Loader())


@pytest.fixture
def warm_start(tmp_path):
    """Generator and discriminator files in the reference's layout
    (`model_g.` keys; `model_d.` keys with spectral_norm's weight_orig,
    weight_u and weight_v), of seeded random weights: both packages load
    them, so that both runs start from one set of weights."""
    from grlir_torch.configs import load_config
    from grlir_torch.models.discriminator import UNetDiscriminatorSN
    from grlir_torch.models.grl import GRL, init_weights
    from grlir_torch.train import build_model_config

    cfg = load_config(gan_args(tmp_path, "w", 1))
    gcfg = build_model_config({**cfg, "model": cfg["model"]["model_g"]})
    g = init_weights(GRL(gcfg), torch.Generator().manual_seed(5))
    g_path = tmp_path / "g.pth"
    torch.save({"state_dict": {f"model_g.{k}": v for k, v in g.state_dict().items()}},
               g_path)
    torch.manual_seed(6)
    d = UNetDiscriminatorSN(num_feat=8)
    sd = {}
    for k, v in d.state_dict().items():
        name = k.rsplit(".", 1)[0]
        if k.endswith(".u"):
            sd[f"model_d.{name}.weight_u"] = v
            sd[f"model_d.{name}.weight_v"] = torch.zeros(1)
        elif k.endswith(".weight") and f"{name}.u" in d.state_dict():
            sd[f"model_d.{name}.weight_orig"] = v
        else:
            sd[f"model_d.{k}"] = v
    d_path = tmp_path / "d.pth"
    torch.save({"state_dict": sd}, d_path)
    return [f"engine.bsr_psnr_checkpoint={g_path}",
            f"engine.bsr_discriminator_checkpoint={d_path}"]


def assert_metrics_close(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), i
        for k in w:
            np.testing.assert_allclose(g[k], w[k], **LOSS_TOL, err_msg=f"step {i} {k}")


def test_gan_cli_matches_grlir_with_resume(bsr_root, vgg_file, warm_start, tmp_path,
                                          monkeypatch, capsys):
    """grlir runs 3 steps; the port runs 2, saves, and resumes to 3 on the
    same batches: every step's losses equal grlir's, so the resume brought
    back the step, both optimizers, both schedules and the spectral
    vectors; the saved val_niqe is grlir's NIQE of the saved generator's
    restoration."""
    import grlir.engines.gan as JG
    import grlir_torch.engines.gan as TG
    from grlir.metrics.niqe import niqe_batch as jniqe_batch
    from grlir.train import main as jmain
    from grlir_torch.engines.inference import Restorer
    from grlir_torch.train import main as tmain
    from grlir_torch.utils.checkpoint import CheckpointManager
    from grlir_torch.utils.image import tensor_round
    from grlir_torch.utils.imageio import imread

    vgg = [f"vgg_pretrained={vgg_file}", *warm_start]
    jrec = Recorder(monkeypatch, JG, keep_batches=True)
    jmain(gan_args(tmp_path, "j", 3, vgg + JAX_ONLY))
    jout = capsys.readouterr().out
    assert "perceptual loss active" in jout and "GAN protocol: lightning-parity" in jout
    assert len(jrec.metrics) == 3

    trec = Recorder(monkeypatch, TG, keep_batches=False)
    replay(monkeypatch, jrec.batches[:2])
    state = tmain(gan_args(tmp_path, "t", 2, vgg + ["device=cpu"]))
    out = capsys.readouterr().out
    for line in ("GAN: G=", "loaded PSNR generator", "loaded pretrained discriminator",
                 "perceptual loss active", "GAN protocol: lightning-parity",
                 "gan step 2/2", "niqe=", "gan done"):
        assert line in out, (line, out)

    # the checkpoint: step 2 with everything a resume needs; its val_niqe
    # is the one printed, and grlir's NIQE of the saved generator's
    # restoration.  (grlir's own run prints another: Adam moves a
    # parameter whose gradient is at fp32 noise level by up to the LR
    # either way, and the 1/255 rounding of the restoration turns that into
    # NIQE changes of ~1e-2; the losses above and below are held to 1e-5.)
    tdir = tmp_path / "out" / "t" / "version_0" / "checkpoints"
    tm = CheckpointManager(str(tdir), monitor="val_niqe", mode="min")
    assert tm.all_steps() == [2]
    saved = tm.load()
    assert sorted(saved) == ["discriminator", "metrics", "model", "optimizer",
                             "optimizer_d", "scheduler", "scheduler_d", "step"]
    printed = float(out.split("step 2 val[realsr]: niqe=")[1].split()[0])
    assert abs(saved["metrics"]["val_niqe"] - printed) <= 1e-4
    state.generator.load_state_dict(saved["model"])
    lq = imread(str(bsr_root / "test_set" / "RealSRSetPlus5images" / "r0.png"))
    restored = Restorer(state.generator.eval(), "cpu", scale=4)(
        lq[None].astype(np.float32) / 255.0)
    restored = tensor_round(torch.from_numpy(restored)).numpy()
    assert abs(saved["metrics"]["val_niqe"] - float(jniqe_batch(restored)[0])) <= NIQE_TOL
    assert os.listdir(tmp_path / "out" / "j" / "version_0" / "checkpoints")

    u_saved = {k: v for k, v in saved["discriminator"].items() if k.endswith(".u")}
    replay(monkeypatch, jrec.batches[2:])
    state = tmain(gan_args(tmp_path, "t", 3, vgg + ["device=cpu"]))
    out = capsys.readouterr().out
    assert "resumed GAN from step 2" in out and "gan step 3/3" in out
    assert "gan step 2/" not in out
    assert_metrics_close(trec.metrics, jrec.metrics)
    assert state.step == 3
    assert state.opt_g.state_dict()["state"][0]["step"] == 3
    assert state.opt_d.state_dict()["state"][0]["step"] == 3
    for k, v in u_saved.items():       # the resumed step moved the restored u
        assert not torch.equal(state.discriminator.state_dict()[k], v)


def test_stage1_to_stage2_handoff(bsr_root, warm_start, tmp_path, monkeypatch, capsys):
    """Stage 1 (`experiment=bsr/grl_psnr`, the PSNR trainer on the BSR
    data) writes a checkpoint directory; stage 2 warm-starts its generator
    from it (single-forward protocol); and grlir and the port, warm-started
    from one released-layout .pth, take the same first GAN step."""
    import grlir.engines.gan as JG
    import grlir_torch.engines.gan as TG
    from grlir.train import main as jmain
    from grlir_torch.train import main as tmain
    from grlir_torch.utils.checkpoint import read_step_dir

    assert warm_start[1].startswith("engine.bsr_discriminator_checkpoint=")

    tmain(["experiment=bsr/grl_psnr", "tag=psnr", f"io.base_output_path={tmp_path}/out",
           "data_module.train.dataset=ost", "data_module.val.dataset=realsr",
           "data_module.val.with_gt=false", "metric.val=[niqe]",
           "model_checkpoint.monitor=val_niqe", "model_checkpoint.mode=min",
           *g_overrides("model."), "stripe_size1=8", "stripe_size2=16",
           "patch_size=16", "batch_size=2", "trainer.max_steps=2",
           "trainer.val_check_interval=2", "trainer.log_every_n_steps=1",
           "num_workers=1", "worker_mode=thread", "device=cpu"])
    out = capsys.readouterr().out
    assert "step 2/2 loss=" in out
    stage1 = tmp_path / "out" / "psnr" / "version_0" / "checkpoints"
    stage1_g = read_step_dir(str(stage1))["model"]

    state = tmain(gan_args(tmp_path, "s2", 1, [
        f"engine.bsr_psnr_checkpoint={stage1}", "engine.lightning_parity=false",
        "trainer.max_steps=0", "device=cpu"]))
    out = capsys.readouterr().out
    assert "loaded PSNR generator" in out and "GAN protocol: single-forward" in out
    for k, v in stage1_g.items():
        torch.testing.assert_close(state.generator.state_dict()[k], v, rtol=0, atol=0)

    # one .pth in the reference's layout warm-starts both packages
    pth = tmp_path / "g.pth"
    torch.save({"state_dict": {f"model_g.{k}": v for k, v in stage1_g.items()}}, pth)
    handoff = [f"engine.bsr_psnr_checkpoint={pth}", warm_start[1],
               "engine.lightning_parity=false"]
    jrec = Recorder(monkeypatch, JG, keep_batches=True)
    jmain(gan_args(tmp_path, "jh", 1, handoff + JAX_ONLY))
    assert "loaded PSNR generator" in capsys.readouterr().out
    trec = Recorder(monkeypatch, TG, keep_batches=False)
    replay(monkeypatch, jrec.batches)
    tmain(gan_args(tmp_path, "th", 1, handoff + ["device=cpu"]))
    assert "loaded PSNR generator" in capsys.readouterr().out
    assert_metrics_close(trec.metrics, jrec.metrics)
