"""The port's training, evaluation and Restorer across processes, on the
CPU: gloo ranks of `grlir_torch.parallel_cells` (one intra-op thread
each) against one process on the global batch, and against grlir's step on
`make_mesh(2)`, its metric gather and its mesh-sharded tiled Restorer (the
conftest's virtual devices).  Also `grlir_torch.parallel`'s launch and mesh
helpers without processes.

- 2 ranks, per-device batch 2: 3 SGD steps with drop path and MixUp equal
  one process on the global batch of 4 (losses rel 1e-6, parameters rtol
  1e-5 / atol 1e-6); without them, grlir's mesh step (losses rel 1e-5,
  every step's gradients within 3e-5 max|g|); the tiled Restorer equals
  grlir's with mesh=make_mesh(2) (atol 1e-5).
- 4 ranks: the train loader's strides (3/3/2/2 of 10 items, grlir's order),
  the gathered validation metrics of an uneven split with padding
  duplicates against grlir's `MetricAccumulator` (1e-6), 2 AdamW steps and
  a rank-0 checkpoint; then 2 ranks restore it and train on, below the cold
  start's first loss (grlir's tests/test_multihost.py contract).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from grlir.data.loader import DataLoader as JLoader
from grlir.engines.inference import Restorer as JRestorer
from grlir.engines.train import create_state
from grlir.engines.train import make_train_step as jmake_train_step
from grlir.metrics.collect import MetricAccumulator as JAccumulator
from grlir.models.grl import GRL as JGRL
from grlir.models.grl import GRLConfig as JConfig
from grlir.parallel.mesh import make_mesh as jmake_mesh
from grlir.utils.convert import convert_torch_state_dict
from grlir_torch import parallel_cells as pc
from grlir_torch.models.grl import GRLConfig
from grlir_torch.parallel import launch as L
from grlir_torch.parallel import mesh as M
from grlir_torch.utils.convert import jax_params_to_state_dict
from grlir_torch.utils.imageio import imwrite
from torch_parity import random_params, one_torch_thread  # noqa: F401

# GRL-S's trunk at embed 32 (2 + 2 heads of d = 8), one stage of two
# blocks, the denoising tail
MODEL = dict(embed_dim=32, depths=(2,), num_heads_window=(2,), num_heads_stripe=(2,),
             window_size=8, stripe_size=(8, None), stripe_groups=(None, 4),
             stripe_shift=True, mlp_ratio=2.0, anchor_window_down_factor=4,
             upsampler="", upscale=1)
HW, GLOBAL, STEPS = 32, 4, 3
LR = 0.05
LOSS_REL, PARAM_TOL = 1e-6, dict(rtol=1e-5, atol=1e-6)       # ranks vs one process
JAX_LOSS_REL, GRAD_ATOL, GRAD_FLOOR = 1e-5, 3e-5, 1e-8       # ranks vs grlir's mesh
RESTORE_ATOL = 1e-5
GATHER_TOL = 1e-6


def _jax_model():
    return JGRL(JConfig(**MODEL, drop_path_rate=0.0))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """grlir's parameters drawn from numpy, their port state dict, the
    steps' global batches and a tiled image, written for the workers."""
    d = tmp_path_factory.mktemp("inputs")
    rng = np.random.default_rng(0)
    jm = _jax_model()
    params = random_params(jm, rng, jnp.zeros((1, HW, HW, 3), jnp.float32))
    torch.save(jax_params_to_state_dict(params), d / "init.pt")
    lq = rng.random((STEPS, GLOBAL, HW, HW, 3)).astype(np.float32)
    gt = np.clip(lq + rng.normal(0, 0.1, lq.shape), 0, 1).astype(np.float32)
    np.savez(d / "data.npz", lq=lq, gt=gt)
    np.save(d / "image.npy", rng.random((1, 64, 80, 3)).astype(np.float32))
    return {"dir": d, "jm": jm, "params": params, "lq": lq, "gt": gt}


def _psnr(inputs, drop_path, **kw):
    d = inputs["dir"]
    return ("psnr", dict(cfg=GRLConfig(**MODEL, drop_path_rate=drop_path),
                         init=str(d / "init.pt"), data=str(d / "data.npz"), **kw))


@pytest.fixture(scope="module")
def two_ranks(inputs, tmp_path_factory):
    d = inputs["dir"]
    return pc.launch(2, {
        "psnr_on": _psnr(inputs, drop_path=0.2, mixup=True),
        "psnr_off": _psnr(inputs, drop_path=0.0, mixup=False, record=True),
        "restorer": ("restorer", dict(cfg=GRLConfig(**MODEL, drop_path_rate=0.0),
                                      init=str(d / "init.pt"), image=str(d / "image.npy"),
                                      tile=32, overlap=8, scale=1)),
    }, str(tmp_path_factory.mktemp("two_ranks")), timeout=300)


def _assert_ranks_equal(outs, name):
    """Lockstep: every rank reports the same losses and parameters."""
    first = outs[0][name]
    for o in outs[1:]:
        assert o[name]["losses"] == first["losses"]
        for n, v in first["params"].items():
            assert torch.equal(o[name]["params"][n], v), n


def test_two_ranks_psnr_steps_equal_one_process(inputs, two_ranks):
    """Drop path and MixUp on: the masks and the mix are drawn for the
    global batch, so 2 ranks x 2 rows compute one process's 4 rows."""
    _assert_ranks_equal(two_ranks, "psnr_on")
    got = two_ranks[0]["psnr_on"]
    kw = _psnr(inputs, drop_path=0.2, mixup=True)[1]
    want = pc.psnr_run(**kw)
    for g, w in zip(got["losses"], want["losses"]):
        assert abs(g - w) <= LOSS_REL * abs(w), (got["losses"], want["losses"])
    assert got["step"] == want["step"] == STEPS
    for n, v in want["params"].items():
        np.testing.assert_allclose(got["params"][n].numpy(), v.numpy(), **PARAM_TOL,
                                   err_msg=n)
    # the draws matter: without them the run is another one
    assert got["losses"] != two_ranks[0]["psnr_off"]["losses"]


def test_two_ranks_psnr_steps_match_grlir_mesh(inputs, two_ranks):
    """Drop path and MixUp off: every step's loss and all-reduced gradients
    against grlir's jitted step on make_mesh(2) (the batch sharded over
    `data`, an optax transform recording the gradients) from the same
    parameters, the ranks' before that step."""
    _assert_ranks_equal(two_ranks, "psnr_off")
    got = two_ranks[1]["psnr_off"]

    def zeros(t):
        return jax.tree_util.tree_map(jnp.zeros_like, t)

    recorder = optax.GradientTransformation(zeros, lambda g, s, p=None: (g, g))
    opt = optax.chain(recorder, optax.sgd(LR))
    step = jmake_train_step(inputs["jm"], opt, {"l1": 1.0}, mesh=jmake_mesh(2))
    for i in range(STEPS):
        params = convert_torch_state_dict(
            {k: v.numpy() for k, v in got["before"][i].items()}, inputs["params"])
        batch = {"img_lq": jnp.asarray(inputs["lq"][i]), "img_gt": jnp.asarray(inputs["gt"][i])}
        state, metrics = step(create_state(params, opt), batch, jax.random.PRNGKey(i))
        want = float(metrics["loss"])
        assert abs(got["losses"][i] - want) <= JAX_LOSS_REL * abs(want), (i, got["losses"][i],
                                                                          want)
        wgrads = jax_params_to_state_dict({"params": state.opt_state[0]})
        assert sorted(wgrads) == sorted(got["grads"][i])
        for n, g in got["grads"][i].items():
            w = wgrads[n].numpy()
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=GRAD_ATOL * np.abs(w).max() + GRAD_FLOOR,
                                       err_msg=f"step {i} {n}")


def test_two_ranks_restorer_matches_grlir_mesh(inputs, two_ranks):
    """Tiles split over the ranks (a group of two, one each), gathered
    before the blend, against grlir's Restorer sharding its groups over
    make_mesh(2)."""
    a, b = (o["restorer"] for o in two_ranks)
    assert a["tile_batch"] == b["tile_batch"] == 2
    np.testing.assert_array_equal(a["out"], b["out"])
    jm, params = inputs["jm"], inputs["params"]
    ref = JRestorer(lambda p, x: jm.apply(p, x), params, scale=1, tile=32, tile_overlap=8,
                    mesh=jmake_mesh(2))
    assert ref.tile_batch == 2
    want = ref(np.load(inputs["dir"] / "image.npy"))
    assert a["out"].shape == want.shape == (1, 64, 80, 3)
    np.testing.assert_allclose(a["out"], want, atol=RESTORE_ATOL)


def _uneven_split(n=10, ranks=4):
    """A validation pass of n images over `ranks` processes as a
    distributed sampler splits it: strides of 3/3/2/2, the short ranks
    padded with a duplicate of the first images."""
    idx = [list(range(r, n, ranks)) for r in range(ranks)]
    longest = max(map(len, idx))
    pad = iter(range(n))
    for i in idx:
        while len(i) < longest:
            i.append(next(pad))
    values = {"psnr": [[30.0 + k for k in i] for i in idx],
              "ssim": [[0.5 + 0.01 * k for k in i] for i in idx]}
    return values, idx


def test_four_ranks_then_two(inputs, tmp_path):
    d = inputs["dir"]
    root = tmp_path / "data"
    (root / "DIV2K" / "train").mkdir(parents=True)
    rng = np.random.default_rng(1)
    for i in range(10):
        imwrite(str(root / "DIV2K" / "train" / f"{i:04d}.png"),
                (rng.random((16, 16, 3)) * 255).astype(np.uint8))
    (root / "image_info" / "DIV2K").mkdir(parents=True)
    (root / "image_info" / "DIV2K" / "train.json").write_text(
        json.dumps([{"path": f"train/{i:04d}.png"} for i in range(10)]))
    values, idx = _uneven_split()
    ckpt = str(tmp_path / "ckpt")
    train = dict(mixup=False, opt="adamw", lr=1e-3)
    data = str(tmp_path / "two_steps.npz")
    np.savez(data, lq=inputs["lq"][:2], gt=inputs["gt"][:2])
    cfg = GRLConfig(**MODEL, drop_path_rate=0.1)
    outs4 = pc.launch(4, {
        "loader": ("loader", dict(root=str(root))),
        "gather": ("gather", dict(values=values, idx=idx)),
        "train": ("psnr", dict(cfg=cfg, init=str(d / "init.pt"), data=data, save=ckpt,
                               **train)),
    }, str(tmp_path / "four"), timeout=300)

    # the train loader: grlir's stride of the shared shuffled order, 3/3/2/2
    class Items:
        def __len__(self):
            return 10

        def __getitem__(self, i):
            return {"i": i}

    items = [o["loader"] for o in outs4]
    assert [len(i) for i in items] == [3, 3, 2, 2]
    assert sorted(sum(items, [])) == list(range(10))
    for r, got in enumerate(items):
        want = JLoader(Items(), 1, shuffle=True, drop_last=True, seed=3, shard=(r, 4))
        assert got == [i for b in want._index_batches() for i in b]
    # the gathered metrics: every rank's, the padding duplicates once
    acc = JAccumulator(sorted(values))
    for r in range(4):
        acc.update({n: np.asarray(v[r], np.float32) for n, v in values.items()}, idx[r])
    want = acc.compute()
    assert want["psnr"] == pytest.approx(sum(30.0 + i for i in range(10)) / 10, abs=1e-6)
    for o in outs4:
        assert sorted(o["gather"]) == sorted(want)
        for n, v in want.items():
            assert abs(o["gather"][n] - v) <= GATHER_TOL, (n, o["gather"][n], v)
    # lockstep, and rank 0's checkpoint of step 2
    losses4 = outs4[0]["train"]["losses"]
    assert all(o["train"]["losses"] == losses4 for o in outs4)
    assert sorted(os.listdir(ckpt)) == ["step_2"]

    outs2 = pc.launch(2, {"resume": ("psnr", dict(
        cfg=cfg, init=str(d / "init.pt"), data=data, resume=ckpt, **train))},
        str(tmp_path / "two"), timeout=300)
    r0, r1 = (o["resume"] for o in outs2)
    assert r0["losses"] == r1["losses"] and r0["step"] == r1["step"] == 4
    # the restored state continues the 4-rank run's optimization
    assert r0["losses"][0] < losses4[0], (r0["losses"], losses4)


# ---- launch and mesh without processes

def test_launch_without_a_group(monkeypatch):
    for k in ("GRLIR_COORDINATOR", "GRLIR_NUM_PROCESSES", "GRLIR_PROCESS_ID",
              "GRLIR_DISTRIBUTED", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert L.init_distributed("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    assert M.world() == (0, 1) and L.per_host_batch(8) == 8
    assert M.make_mesh() == M.Mesh(0, 1)
    with pytest.raises(ValueError, match="one process a device"):
        M.make_mesh(2)
    assert not M.maybe_initialize_distributed()
    # a coordinator without the world's size and this process's rank
    monkeypatch.setenv("GRLIR_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(ValueError, match="GRLIR_NUM_PROCESSES"):
        L.init_distributed("cpu")
    # the card asked for without one: no fallback to the CPU
    if not torch.cuda.is_available():
        monkeypatch.setenv("GRLIR_NUM_PROCESSES", "2")
        monkeypatch.setenv("GRLIR_PROCESS_ID", "0")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            L.init_distributed("cuda")
    # torchrun's LOCAL_RANK picks the card
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert L.local_device(torch.device("cuda"), 5) == torch.device("cuda", 1)
    assert L.local_device(torch.device("cuda", 0), 5) == torch.device("cuda", 0)
    assert L.local_device(torch.device("cpu"), 5) == torch.device("cpu")


def test_an_existing_group_is_kept(monkeypatch):
    """A caller's own group (a world of one here) is left as it is, and the
    collectives are the identity in it."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{pc.free_port()}", world_size=1, rank=0)
    try:
        monkeypatch.setenv("GRLIR_COORDINATOR", "127.0.0.1:1")
        monkeypatch.setenv("GRLIR_NUM_PROCESSES", "4")
        monkeypatch.setenv("GRLIR_PROCESS_ID", "3")
        assert L.init_distributed("cpu") == torch.device("cpu")
        assert M.world() == (0, 1) and M.maybe_initialize_distributed()
        t = torch.arange(6.0)
        M.all_reduce_mean_([t])
        assert torch.equal(t, torch.arange(6.0))
        assert torch.equal(M.all_gather_rows(t), t)
        assert [a.tolist() for a in M.all_gather_ragged(np.arange(3))] == [[0, 1, 2]]
        M.barrier()
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("how", ["coordinator", "torchrun"])
def test_launch_forms_a_group_from_the_environment(how, monkeypatch):
    """grlir's variables (tcp:// to the coordinator) or torchrun's with
    GRLIR_DISTRIBUTED=1 (env://) form the group: a world of one, gloo on
    the CPU."""
    for k in ("GRLIR_COORDINATOR", "GRLIR_NUM_PROCESSES", "GRLIR_PROCESS_ID",
              "GRLIR_DISTRIBUTED", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    port = str(pc.free_port())
    if how == "coordinator":
        monkeypatch.setenv("GRLIR_COORDINATOR", f"127.0.0.1:{port}")
        monkeypatch.setenv("GRLIR_NUM_PROCESSES", "1")
        monkeypatch.setenv("GRLIR_PROCESS_ID", "0")
    else:
        for k, v in (("GRLIR_DISTRIBUTED", "1"), ("MASTER_ADDR", "127.0.0.1"),
                     ("MASTER_PORT", port), ("RANK", "0"), ("WORLD_SIZE", "1")):
            monkeypatch.setenv(k, v)
    try:
        assert L.init_distributed("cpu") == torch.device("cpu")
        assert torch.distributed.is_initialized()
        assert torch.distributed.get_backend() == "gloo" and M.world() == (0, 1)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("rows", [8, 16])
def test_shard_rows_is_grlir_batch_sharding(n, rows):
    """Rank r holds the rows grlir's `data` sharding gives device r."""
    mesh = jmake_mesh(n)
    index = NamedSharding(mesh, PartitionSpec("data")).devices_indices_map((rows, 3))
    for r, dev in enumerate(mesh.devices.flat):
        want = index[dev][0]
        got = M.shard_rows(rows, r, n)
        assert (got.start, got.stop) == (want.start or 0, want.stop or rows)
    with pytest.raises(ValueError, match="do not split"):
        M.shard_rows(rows + 1, 0, n)
