"""The port's span recorder (`grlir_torch/utils/profiling.py`): ids of the
enclosing and outermost span, nothing recorded and no clock read while
off, drain, a running profiler switching it on, a train step's and a CPU
`Restorer` call's spans, and `trace` writing the spans into its Chrome
trace on the trace's own time base."""

import json
import threading
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from grlir_torch.engines.inference import Restorer
from grlir_torch.engines.train import TrainState, make_train_step
from grlir_torch.models import zoo
from grlir_torch.models.grl import GRL
from grlir_torch.optim import build_optimizer
from grlir_torch.utils import profiling as prof

TINY = replace(zoo.GRL_TINY, embed_dim=32, depths=(2,), num_heads_window=(2,),
               num_heads_stripe=(2,), upscale=2, drop_path_rate=0.1)


@pytest.fixture(autouse=True)
def recorder_off():
    prof.record_spans(False)
    prof.drain_spans()
    yield
    prof.record_spans(False)
    prof.drain_spans()


def by_start(spans):
    return sorted(spans, key=lambda s: (s.start_ns, s.id))


def test_nesting_gives_parent_and_root_ids():
    prof.record_spans()
    with prof.span("a"):
        with prof.span("b"):
            with prof.span("c"):
                pass
        with prof.span("d"):
            pass
    with prof.span("e"):
        pass
    spans = prof.drain_spans()
    got = {s.name: s for s in spans}
    a, b, c, d, e = (got[n] for n in "abcde")
    assert len({s.id for s in spans}) == 5
    assert a.parent is None and a.root == a.id
    assert (b.parent, c.parent, d.parent) == (a.id, b.id, a.id)
    assert b.root == c.root == d.root == a.id
    assert e.parent is None and e.root == e.id != a.id
    assert (a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns
            <= d.start_ns <= d.end_ns <= a.end_ns <= e.start_ns <= e.end_ns)
    # recorded as each ends: a child before its parent
    assert [s.name for s in spans] == ["c", "b", "d", "a", "e"]


def test_off_reads_no_clock_allocates_nothing_and_records_nothing(monkeypatch):
    def no_clock():
        raise AssertionError("span read the clock while off")

    monkeypatch.setattr(prof, "time", SimpleNamespace(time_ns=no_clock))
    first = prof.span(prof.RESTORER_CALL)
    assert prof.span(prof.TRAIN_STEP) is first
    with prof.span("a"):
        with prof.span("b"):
            pass
    assert prof.recorded_spans() == [] and prof.drain_spans() == []


def test_a_span_left_by_an_exception_is_recorded_and_closed():
    prof.record_spans()
    with pytest.raises(ValueError):
        with prof.span("outer"):
            with prof.span("inner"):
                raise ValueError
    with prof.span("next"):
        pass
    got = {s.name: s for s in prof.drain_spans()}
    assert got["inner"].parent == got["outer"].id
    assert got["next"].parent is None


def test_drain_empties_the_buffer():
    prof.record_spans()
    with prof.span("a"):
        pass
    prof.record_spans(False)
    with prof.span("b"):
        pass
    assert [s.name for s in prof.recorded_spans()] == ["a"]
    assert [s.name for s in prof.drain_spans()] == ["a"]
    assert prof.drain_spans() == [] and prof.recorded_spans() == []


def test_a_running_profiler_records_spans():
    with profile(activities=[ProfilerActivity.CPU]):
        with prof.span("profiled"):
            torch.ones(8).add_(1)
    with prof.span("after"):
        pass
    assert [s.name for s in prof.drain_spans()] == ["profiled"]


def test_threads_keep_their_own_stacks():
    prof.record_spans()
    inside, done = threading.Event(), threading.Event()

    def other():
        with prof.span("other"):
            inside.set()
            done.wait(10)

    t = threading.Thread(target=other)
    with prof.span("main"):
        t.start()
        assert inside.wait(10)
        with prof.span("child"):
            pass
        done.set()
    t.join(10)
    assert not t.is_alive()
    got = {s.name: s for s in prof.drain_spans()}
    assert got["other"].parent is None and got["other"].root == got["other"].id
    assert got["child"].parent == got["main"].id


def tiny_train():
    torch.manual_seed(0)
    model = GRL(TINY)
    opt, sched = build_optimizer(model.parameters(), "adamw", learning_rate=1e-4)
    state = TrainState(model, opt, sched, generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    batch = {"img_lq": torch.rand(2, 16, 16, 3, generator=g),
             "img_gt": torch.rand(2, 32, 32, 3, generator=g)}
    return state, make_train_step({"l1": 1.0}), batch


def test_a_train_step_records_forward_backward_and_update_under_its_root():
    state, step, batch = tiny_train()
    prof.record_spans()
    step(state, batch)
    spans = prof.drain_spans()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == [prof.TRAIN_STEP]
    root = roots[0]
    parts = by_start(s for s in spans if s.parent == root.id)
    assert [s.name for s in parts] == [prof.TRAIN_FORWARD, prof.TRAIN_BACKWARD,
                                       prof.TRAIN_UPDATE]
    assert len(spans) == 4 and all(s.root == root.id for s in spans)
    ends = [root.start_ns] + [t for s in parts for t in (s.start_ns, s.end_ns)] + [root.end_ns]
    assert ends == sorted(ends)
    assert state.step == 1


def upscale2(x):
    return x.repeat_interleave(2, 1).repeat_interleave(2, 2)


@pytest.mark.parametrize("kwargs", [{"shape_bucket": 16}, {"tile": 12, "tile_overlap": 4}])
def test_a_cpu_restorer_call_records_one_root(kwargs):
    restorer = Restorer(upscale2, "cpu", scale=2, **kwargs)
    img = np.random.default_rng(0).random((1, 20, 28, 3), np.float32)
    prof.record_spans()
    y = restorer(img)
    spans = prof.drain_spans()
    assert y.shape == (1, 40, 56, 3)
    # the CPU runs the model eagerly: no graph, so no copy or replay spans
    assert [s.name for s in spans] == [prof.RESTORER_CALL]
    assert spans[0].parent is None


def test_trace_writes_the_block_spans_on_its_time_base(tmp_path):
    prof.record_spans()
    with prof.span("before"):
        pass
    prof.record_spans(False)
    with prof.trace(str(tmp_path)):
        with prof.span("outer"):
            with prof.span("inner"):
                torch.ones(32, 32) @ torch.ones(32, 32)
    doc = json.load(open(tmp_path / "trace.json"))
    ours = {e["name"]: e for e in doc["traceEvents"] if e.get("cat") == "grlir_torch"}
    assert set(ours) == {"outer", "inner"}
    outer, inner = ours["outer"], ours["inner"]
    assert outer["ph"] == "X" and inner["args"]["parent"] == outer["args"]["id"]
    mm = next(e for e in doc["traceEvents"] if e.get("name") == "aten::mm")
    # the profiler's own operator lies inside the span that ran it
    assert inner["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= inner["ts"] + inner["dur"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    # the block's spans are drained into the file; the earlier one stays
    assert [s.name for s in prof.recorded_spans()] == ["before"]
