"""The port's config system (`grlir_torch.configs`) against grlir's: the
YAML tree is a byte copy, the port's YAML reader equals `yaml.safe_load`
on every file and on CLI tokens, and `load_config` composes every
experiment as grlir does, with overrides, interpolation and 1e-5-style
tokens.  Also `build_model_config`'s mapping of the composed model."""

import filecmp
import os
import os.path as osp

import pytest
import torch
import yaml

import grlir.configs as J
import grlir_torch.configs as T
from grlir_torch.train import build_model_config, split_device

JDIR = osp.dirname(J.__file__)
TDIR = osp.dirname(T.__file__)


def _yaml_files(root):
    out = []
    for d, _, files in os.walk(root):
        out += [osp.relpath(osp.join(d, f), root) for f in files if f.endswith(".yaml")]
    return sorted(out)


def _experiments():
    root = osp.join(JDIR, "experiment")
    return [p[:-5] for p in _yaml_files(root)]


def test_yaml_tree_is_a_byte_copy():
    files = _yaml_files(JDIR)
    assert len(files) == 45 and files == _yaml_files(TDIR)
    match, mismatch, errors = filecmp.cmpfiles(JDIR, TDIR, files, shallow=False)
    assert not mismatch and not errors and len(match) == len(files)


@pytest.mark.parametrize("name", _yaml_files(JDIR))
def test_reader_equals_safe_load(name):
    with open(osp.join(TDIR, name)) as f:
        want = yaml.safe_load(f) or {}
    assert T.load_yaml(osp.join(TDIR, name)) == want


TOKENS = ["1e-5", "1.0e-5", "5.0e-5", "1.0e5", "[2]", "[16,8]", "[null, 4]",
          "true", "True", "on", "off", "no", "yes", "~", "null", "", "abc",
          '"quoted x"', "'single ''q'''", "0x1f", "017", "1_000", "-3", "+3",
          ".inf", "-.inf", "-.5", "1:30", "{a: 1, b: [1, 2]}", "[a, \"b\", 3.5]",
          "~/grlir_experiments", "${patch_size}", "sr_${model.name}_x4"]


@pytest.mark.parametrize("tok", TOKENS)
def test_tokens_parse_as_grlir_parses_them(tok):
    assert T.parse_value(tok) == yaml.safe_load(tok)
    assert T._parse_value(tok) == J._parse_value(tok)


OVERRIDES = ["patch_size=48", "batch_size=3", "optimizer.lr=1e-5",
             "trainer.max_steps=10", "model.depths=[2,2]", "mixup=false",
             "lr_scheduler.milestones=[5,8]", "tag=x_${patch_size}",
             "model.embed_dim=24", "seed=7"]


@pytest.mark.parametrize("experiment", _experiments())
def test_load_config_equals_grlir(experiment):
    for extra in ([], OVERRIDES, ["model=grl/grl_small", "loss=l2"] + OVERRIDES[:3]):
        toks = [f"experiment={experiment}"] + extra
        assert T.load_config(toks) == J.load_config(toks), toks
    assert T.load_config([]) == J.load_config([])
    assert T.load_config(["model=grl/grl_base", "loss=l1", "optimizer.lr=0.001"]) == \
        J.load_config(["model=grl/grl_base", "loss=l1", "optimizer.lr=0.001"])


def test_model_config_mapping():
    """The composed GRL-S SR recipe -> the port's GRLConfig; the pallas
    modes map to engines and kernels; the device token is split off."""
    cfg = T.load_config(["experiment=sr/grl_p256", "model.embed_dim=128",
                         "model.upsampler=pixelshuffle", "dtype=bfloat16",
                         "model.use_pallas_attention=v3", "remat=true"])
    m = build_model_config(cfg)
    assert (m.embed_dim, m.window_size, m.stripe_size, m.stripe_groups) == \
        (128, 32, (64, 64), (None, None))
    assert (m.upsampler, m.upscale, m.anchor_window_down_factor) == ("pixelshuffle", 4, 4)
    assert (m.engine, m.kernels, m.dtype, m.remat, m.drop_path_rate) == \
        ("v3", True, torch.bfloat16, True, 0.1)
    for mode, want in (("auto", ("v3", "auto")), (False, ("v3", False)),
                       (True, ("fused", True)), ("window", ("window", True)),
                       ("stripe", ("stripe", True))):
        cfg["model"]["use_pallas_attention"] = mode
        got = build_model_config(cfg)
        assert (got.engine, got.kernels) == want
    # the ablation fields, once refused, map one to one, as do the remat
    # policy and a classification head
    ablation = {"conv_type": "3conv", "qkv_proj_type": "separable_conv",
                "anchor_proj_type": "conv2d", "anchor_one_stage": False,
                "out_proj_type": "conv2d", "qkv_bias": False,
                "euclidean_dist": True, "double_window": True,
                "stripe_square": True, "num_out_feats": 32}
    cfg["model"].update(ablation, pretrained_window_size=[8, 8])
    got = build_model_config({**cfg, "remat_policy": "dots", "classification": True})
    assert {k: getattr(got, k) for k in ablation} == ablation
    assert (got.pretrained_window_size, got.remat_policy, got.out_channels) == \
        ((8, 8), "dots", 768)
    toks, dev = split_device(["experiment=dn/grl_p256", "device=cpu", "seed=1"])
    assert toks == ["experiment=dn/grl_p256", "seed=1"] and dev == torch.device("cpu")
