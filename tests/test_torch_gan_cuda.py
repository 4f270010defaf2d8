"""The GAN path on a card: the GAN step with the CUDA kernels on (B1 at
window 16 and B4 at 32x64 stripes, forward under grad, the plain
backward) against kernels off for both protocols, at GRL-base-bsr's width
cut to its first stage; and the discriminator, VGG19 features and LPIPS
on the card against their CPU results.

Needs an NVIDIA Hopper GPU and nvcc; skips without a CUDA device.  The file
imports no JAX, so it runs on a machine without it:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_gan_cuda.py

Cells and gates: `grlir_torch.gan_cells`.
"""

import numpy as np
import pytest
import torch

from grlir_torch import gan_cells as gc
from grlir_torch.ops import block_attn as tba

DEPTH = 1               # GRL-base-bsr's first stage: 4 blocks
CARD_REL = 1e-4         # card vs CPU, fp32 with TF32 off: x max|CPU value|
U_ATOL = 1e-5
GAN_KERNELS = ("window_half", "stripe_a2w_large", "stripe_w2a_large")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _launched():
    return {k.__name__: k.launches for k in tba.KERNELS}


@pytest.mark.cuda
@pytest.mark.parametrize("lightning_parity", [True, False])
def test_gan_fp32_step_kernels_vs_plain(cuda, lightning_parity):
    """One fp32 step: loss_g and loss_d within 1e-5 relative, every G and
    D gradient within 1e-3 max|g| + 1e-7, the u vectors within 1e-5 of
    kernels off; B1, B4a and B4b launched and no half unrouted."""
    tba.reset_launches()
    losses, worst, where, du = gc.gate_fp32(cuda, lightning_parity, depth=DEPTH)
    launched = _launched()
    assert all(launched[k] > 0 for k in GAN_KERNELS), launched
    assert tba.unrouted_halves == 0
    assert gc.fp32_gate_ok(losses, worst, du), (losses, worst, where, du)


@pytest.mark.cuda
@pytest.mark.parametrize("lightning_parity", [True, False])
def test_gan_bf16_steps_kernels_vs_plain(cuda, lightning_parity):
    """Ten bf16 steps: every loss finite and within 2e-2 of kernels off."""
    losses, rel = gc.gate_bf16(cuda, lightning_parity, depth=DEPTH)
    assert gc.bf16_gate_ok(losses, rel), (losses, rel)


def _close(got, want, what):
    got, want = got.detach().float().cpu(), want.detach().float()
    err = (got - want).abs().max().item()
    assert err <= CARD_REL * want.abs().max().item() + 1e-7, (what, err)


@pytest.mark.cuda
@pytest.mark.parametrize("update", [True, False])
def test_discriminator_card_vs_cpu(cuda, update):
    """UNet-SN (num_feat 64) on a 256^2 batch of 2: logits and the u
    vectors after the call."""
    from grlir_torch.models.discriminator import UNetDiscriminatorSN

    torch.manual_seed(0)
    d = UNetDiscriminatorSN(num_feat=64)
    x = torch.rand(2, 256, 256, 3, generator=torch.Generator().manual_seed(1))
    d_card = UNetDiscriminatorSN(num_feat=64).to(cuda)
    d_card.load_state_dict(d.state_dict())
    with torch.no_grad():
        want = d(x, update)
        got = d_card(x.to(cuda), update)
    _close(got, want, "logits")
    for (n, u), (_, uc) in zip(d.named_buffers(), d_card.named_buffers()):
        assert (uc.cpu() - u).abs().max().item() <= U_ATOL, n


@pytest.mark.cuda
def test_vgg_and_perceptual_loss_card_vs_cpu(cuda):
    from grlir_torch.models.vgg import perceptual_loss

    vgg = gc.random_vgg(3)
    vgg_card = gc.random_vgg(3).to(cuda)
    g = torch.Generator().manual_seed(4)
    x, y = torch.rand(1, 256, 256, 3, generator=g), torch.rand(1, 256, 256, 3, generator=g)
    with torch.no_grad():
        want, got = vgg(x), vgg_card(x.to(cuda))
        for k in gc.LAYERS:
            _close(got[k], want[k], k)
        pw, _ = perceptual_loss(vgg, x, y, gc.LAYERS)
        pg, _ = perceptual_loss(vgg_card, x.to(cuda), y.to(cuda), gc.LAYERS)
    assert abs(float(pg) - float(pw)) <= CARD_REL * abs(float(pw))


@pytest.mark.cuda
def test_lpips_card_vs_cpu(cuda):
    from grlir_torch.metrics.lpips import LPIPSVgg, lpips_batch

    torch.manual_seed(5)
    model = LPIPSVgg()
    with torch.no_grad():
        for i in range(5):
            getattr(model, f"lin{i}").uniform_(0, 1)
    card = LPIPSVgg().to(cuda)
    card.load_state_dict(model.state_dict())
    rng = np.random.default_rng(6)
    x = rng.random((2, 128, 160, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    want, got = lpips_batch(model, x, y), lpips_batch(card, x, y)
    np.testing.assert_allclose(got, want, rtol=CARD_REL)
