"""grlir_torch's Restorer vs grlir's (whole, bucketed, tiled), and the serve
CLI end to end on a small saved checkpoint, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grlir.engines.inference import Restorer as JRestorer
from grlir.models.grl import GRL as JGRL
from grlir.models.grl import GRLConfig as JConfig
from grlir_torch import serve
from grlir_torch.engines.inference import Restorer
from grlir_torch.models import zoo
from grlir_torch.models.grl import GRL, GRLConfig, init_weights
from grlir_torch.utils.convert import jax_params_to_state_dict
from torch_parity import random_params

SMALL = dict(embed_dim=16, depths=(2,), num_heads_window=(2,),
             num_heads_stripe=(2,), window_size=8, stripe_size=(8, None),
             stripe_groups=(None, 4), stripe_shift=True, mlp_ratio=2.0,
             anchor_window_down_factor=4, upsampler="pixelshuffle", upscale=2)


@pytest.fixture(scope="module")
def restorers():
    jmodel = JGRL(JConfig(**SMALL, drop_path_rate=0.0,
                          use_pallas_attention=False))
    params = random_params(jmodel, np.random.default_rng(0),
                           jnp.zeros((1, 32, 32, 3), jnp.float32))
    tmodel = GRL(GRLConfig(**SMALL)).eval()
    tmodel.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return jmodel, params, tmodel


# whole images; assorted sizes padded to a 16-bucket; 4 overlapping tiles
# run in groups of 3 (the last group padded)
@pytest.mark.parametrize("shape,kw", [
    ((2, 32, 32), {}),
    ((1, 24, 40), {"shape_bucket": 16}),
    ((1, 48, 40), {"tile": 32, "tile_overlap": 8, "tile_batch": 3}),
])
def test_restorer_matches_jax(restorers, shape, kw):
    jmodel, params, tmodel = restorers
    img = np.random.default_rng(1).random((*shape, 3)).astype(np.float32)
    want = JRestorer(jmodel.apply, params, scale=2, **kw)(img)
    got = Restorer(tmodel, "cpu", scale=2, **kw)(img)
    assert got.shape == (shape[0], shape[1] * 2, shape[2] * 2, 3)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)


def test_serve_cli_writes_pngs(tmp_path):
    cv2 = pytest.importorskip("cv2")
    model = init_weights(GRL(zoo.make_config("tiny")),
                         torch.Generator().manual_seed(0)).eval()
    ckpt = tmp_path / "grl_tiny.ckpt"
    torch.save({"state_dict": {f"model.{k}": v
                               for k, v in model.state_dict().items()}}, ckpt)
    src, dst = tmp_path / "lr", tmp_path / "sr"
    src.mkdir()
    rng = np.random.default_rng(2)
    imgs = {"a.png": rng.integers(0, 256, (20, 28, 3), np.uint8),
            "b.png": rng.integers(0, 256, (24, 24, 3), np.uint8)}
    for name, im in imgs.items():
        cv2.imwrite(str(src / name), im)

    serve.main(["--input", str(src), "--output", str(dst),
                "--checkpoint", str(ckpt), "--model", "tiny", "--device", "cpu",
                "--batch", "2", "--shape-bucket", "16"])

    with pytest.raises(KeyError):  # a checkpoint of another model is refused
        serve.load_checkpoint(GRL(zoo.make_config("tiny", upscale=2)), str(ckpt))
    restorer = Restorer(model, "cpu", scale=4, shape_bucket=16)
    for name, im in imgs.items():
        out = cv2.imread(str(dst / name))
        assert out.shape == (im.shape[0] * 4, im.shape[1] * 4, 3)
        rgb = cv2.cvtColor(im, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
        want = serve.to_uint8(restorer(rgb[None])[0])
        np.testing.assert_array_equal(cv2.cvtColor(out, cv2.COLOR_BGR2RGB), want)
