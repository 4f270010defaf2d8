"""The GAN step across processes, on the CPU: two gloo ranks of
`grlir_torch.parallel_cells` at per-device batch 2 against one process
on the global batch of 4, both protocols, 2 SGD steps at LR 0.05 (as
tests/test_torch_gan.py holds the step to grlir's): every metric of each
step, then G's and D's parameters and D's spectral vectors within rtol
1e-5 / atol 1e-6.  G draws its drop-path masks for the global batch, and
D's power-iteration vectors, which depend on D's weights only, are equal
on both ranks."""

import numpy as np
import pytest
import torch

from grlir_torch import parallel_cells as pc
from grlir_torch.models.discriminator import UNetDiscriminatorSN
from grlir_torch.models.grl import GRL, GRLConfig, init_weights
from torch_parity import one_torch_thread  # noqa: F401

STEP_TOL = dict(rtol=1e-5, atol=1e-6)
# tests/test_torch_gan.py's generator (head dim 8, nearest+conv x4) with
# drop path on
G_CFG = GRLConfig(embed_dim=32, depths=(2,), num_heads_window=(2,), num_heads_stripe=(2,),
                  window_size=8, stripe_size=(8, 8), stripe_groups=(None, None),
                  stripe_shift=True, mlp_ratio=2.0, anchor_window_down_factor=2,
                  local_connection=True, upsampler="nearest+conv", upscale=4,
                  drop_path_rate=0.1)
PROTOCOLS = {"lightning_parity": True, "single_forward": False}


@pytest.fixture(scope="module")
def gan(tmp_path_factory):
    """The initial G and D, two steps of global batches, the two ranks'
    results of both protocols."""
    d = tmp_path_factory.mktemp("gan")
    g = init_weights(GRL(G_CFG), torch.Generator().manual_seed(0))
    torch.save(g.state_dict(), d / "g.pt")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        torch.save(UNetDiscriminatorSN(num_in_ch=3, num_feat=8).state_dict(), d / "d.pt")
    rng = np.random.default_rng(2)
    lq = rng.random((2, 4, 16, 16, 3)).astype(np.float32)
    gt = rng.random((2, 4, 64, 64, 3)).astype(np.float32)
    usm = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, 1).astype(np.float32)
    np.savez(d / "data.npz", lq=lq, gt=gt, gt_usm=usm)
    kw = {name: dict(cfg=G_CFG, g_init=str(d / "g.pt"), d_init=str(d / "d.pt"),
                     data=str(d / "data.npz"), lightning_parity=lp)
          for name, lp in PROTOCOLS.items()}
    ranks = pc.launch(2, {name: ("gan", k) for name, k in kw.items()},
                      str(tmp_path_factory.mktemp("gan_ranks")), timeout=300)
    return kw, ranks


@pytest.mark.parametrize("protocol", sorted(PROTOCOLS))
def test_two_ranks_gan_steps_equal_one_process(gan, protocol):
    kw, ranks = gan
    a, b = (r[protocol] for r in ranks)
    assert a["metrics"] == b["metrics"]
    for net in ("g", "d"):
        for n, v in a[net].items():
            # lockstep: parameters and the spectral vectors u alike
            assert torch.equal(b[net][n], v), (net, n)
    # the spectral vectors took their power iterations
    init = torch.load(kw[protocol]["d_init"], weights_only=True)
    us = [n for n in a["d"] if n.endswith(".u")]
    assert us and all(not torch.equal(a["d"][n], init[n]) for n in us)
    want = pc.gan_run(**kw[protocol])
    assert len(a["metrics"]) == len(want["metrics"]) == 2
    for i, (got_m, want_m) in enumerate(zip(a["metrics"], want["metrics"])):
        assert sorted(got_m) == sorted(want_m)
        for k, v in want_m.items():
            np.testing.assert_allclose(got_m[k], v, **STEP_TOL, err_msg=f"step {i} {k}")
    for net in ("g", "d"):
        assert sorted(a[net]) == sorted(want[net])
        for n, v in want[net].items():
            np.testing.assert_allclose(a[net][n].numpy(), v.numpy(), **STEP_TOL,
                                       err_msg=f"{net} {n}")
