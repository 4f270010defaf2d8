"""The port's checkpoint manager (`grlir_torch.utils.checkpoint`) against
grlir's orbax one: the same saves keep the same steps (max and min mode,
saves without the monitored metric, ties); a restore round trip of the
model, optimizer and LR scheduler; restore_params_only; resume discovery;
and `serve.load_checkpoint` on the port's checkpoint directories."""

import os

import numpy as np
import pytest
import torch

from grlir.utils.checkpoint import CheckpointManager as JManager
from grlir_torch import serve
from grlir_torch.models import zoo
from grlir_torch.models.grl import GRL, init_weights
from grlir_torch.optim import build_optimizer
from grlir_torch.optim.schedules import multi_step_warmup
from grlir_torch.utils.checkpoint import (CheckpointManager, find_last_checkpoint_dir,
                                          read_step_dir)
from torch_parity import one_torch_thread  # noqa: F401

M = "val_psnr"
SEQUENCES = {
    "max_top2": ("max", 2, [(1, {M: 30.0}), (2, {M: 35.0}), (3, {M: 32.0}),
                            (4, {M: 31.0}), (5, {M: 34.0}), (6, {M: 36.0})]),
    "max_mixed": ("max", 1, [(1, None), (2, {M: 3.0}), (3, None), (4, {M: 1.0}),
                             (5, {M: 2.0}), (6, {M: 2.0}), (7, {}), (8, {M: 2.0})]),
    "min_top1": ("min", 1, [(1, {M: 6.0}), (2, {M: 4.0}), (3, {M: 5.5}), (4, {M: 5.8}),
                            (5, {}), (6, {M: 4.0})]),
    "no_metrics": ("max", 1, [(1, None), (2, None), (3, None), (4, None)]),
    "other_keys": ("max", 1, [(1, {"psnr": 30.0}), (2, {"psnr": 31.0}),
                              (3, {"psnr": 29.0})]),
}


def _jstate(step):
    return {"step": np.asarray(step, np.int32), "params": {"w": np.zeros(2, np.float32)}}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_kept_steps_equal_grlir(name, tmp_path):
    mode, top_k, saves = SEQUENCES[name]
    jm = JManager(str(tmp_path / "j"), monitor=M, mode=mode, save_top_k=top_k)
    tm = CheckpointManager(str(tmp_path / "t"), monitor=M, mode=mode, save_top_k=top_k)
    tiny = {"model": {"w": torch.zeros(2)}, "optimizer": {}, "scheduler": {}}
    for step, metrics in saves:
        jm.save(step, _jstate(step), metrics)
        tm.save(step, tiny, metrics)
        assert tm.all_steps() == sorted(jm._mgr.all_steps()), (name, step)
    assert tm.latest_step() == jm.latest_step()
    jm.close()
    # no temporary directory is left behind
    assert sorted(os.listdir(tmp_path / "t")) == [f"step_{s}" for s in tm.all_steps()]


def _model(seed):
    m = GRL(zoo.make_config("tiny", upscale=2, depths=(1,)))
    return init_weights(m, torch.Generator().manual_seed(seed))


def test_restore_round_trip(tmp_path):
    model = _model(0)
    opt, sched = build_optimizer(model.parameters(), "adamw",
                                 schedule=multi_step_warmup(1e-3, [2], 0.5, 2, 1e-4))
    x = torch.rand(1, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    for _ in range(3):
        opt.zero_grad()
        model(x, generator=torch.Generator().manual_seed(2)).mean().backward()
        opt.step()
        sched.step()
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(3, {"model": model.state_dict(), "optimizer": opt.state_dict(),
                 "scheduler": sched.state_dict()}, {"psnr": 20.0})
    assert mgr.metrics(3) == {"psnr": 20.0}

    other = _model(5)
    opt2, sched2 = build_optimizer(other.parameters(), "adamw",
                                   schedule=multi_step_warmup(1e-3, [2], 0.5, 2, 1e-4))
    assert mgr.restore(other, opt2, sched2) == 3
    for (k, a), b in zip(model.state_dict().items(), other.state_dict().values()):
        assert torch.equal(a, b), k
    assert sched2.last_epoch == 3 and opt2.param_groups[0]["lr"] == pytest.approx(5e-4)
    s1, s2 = opt.state_dict()["state"], opt2.state_dict()["state"]
    assert s1.keys() == s2.keys()
    for i in s1:
        for k in s1[i]:
            assert torch.equal(torch.as_tensor(s1[i][k]), torch.as_tensor(s2[i][k]))

    fresh = _model(7)
    mgr.restore_params_only(fresh)
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(fresh)


def test_resume_discovery_and_serve_load(tmp_path):
    out = tmp_path / "run"
    model = _model(0)
    for v, steps in ((0, (2, 4)), (1, ()), (2, (6,))):
        d = out / f"version_{v}" / "checkpoints"
        d.mkdir(parents=True)
        mgr = CheckpointManager(str(d))
        for s in steps:
            mgr.save(s, {"model": model.state_dict(), "optimizer": {}, "scheduler": {}})
    assert find_last_checkpoint_dir(str(out)) == str(out / "version_2" / "checkpoints")
    assert find_last_checkpoint_dir(str(tmp_path / "none")) is None
    ck = out / "version_0" / "checkpoints"
    assert read_step_dir(str(ck))["step"] == 4
    assert read_step_dir(str(ck / "step_2"))["step"] == 2
    for path in (ck, ck / "step_2"):
        target = _model(9)
        serve.load_checkpoint(target, str(path))
        for (k, a), b in zip(model.state_dict().items(), target.state_dict().values()):
            assert torch.equal(a, b), k
    with pytest.raises(KeyError, match="does not match"):
        serve.load_checkpoint(GRL(zoo.make_config("tiny")), str(ck))
    with pytest.raises(FileNotFoundError, match="orbax"):
        serve.load_checkpoint(_model(1), str(out / "version_1" / "checkpoints"))
