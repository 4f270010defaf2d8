"""The readers of the port's spans (`program_spans.py` and the metrics it
serves) on a synthetic window with known spans and device intervals; a
program without the recorder gives them nothing to read; on the CPU a
traced run finds each request's or step's spans inside its window, and
an untraced run records none."""

import pytest
import torch

from h100_bench import program_spans, spec
from h100_bench import trace as tr
from h100_bench.metrics_context import Context
from h100_bench.tests import cells
from h100_bench.tests.tiny import tiny_cell
from grlir_torch.utils import profiling as P

MS = 1_000_000
SERVE, TRAIN = "grl_s_x4.sr_256", "grl_base_x4.train_sr_p64"
SEED = 5 * 2**32 + 9


class Event:
    """A device activity as `torch.profiler`'s events give it."""

    def __init__(self, a, b, name):
        self.a, self.b, self.n = int(a), int(b), name

    def is_user_annotation(self):
        return False

    def start_ns(self):
        return self.a

    def end_ns(self):
        return self.b

    def name(self):
        return self.n

    def device_type(self):
        return torch.autograd.DeviceType.CUDA


def timeline(busy, w0=0, w1=1000 * MS):
    marks = tr.Marks()
    marks.ranges[tr.WINDOW].append((w0, w1))
    return tr.Timeline([Event(a, b, "k") for a, b in busy], marks)


class Spans:
    def __init__(self):
        self.spans, self.ids = [], iter(range(1, 10**6))

    def add(self, name, a, b, root=None):
        i = next(self.ids)
        s = P.Span(name, int(a), int(b), i, root.id if root else None, root.id if root else i)
        self.spans.append(s)
        return s


def served(monkeypatch):
    """Three requests in the window and one before it: request k idles
    1 - x_in inside its copy in, 1 - x_r inside its replay, 1 inside its
    copy out and 5 - x_in - x_r in all (ms)."""
    sp, busy = Spans(), []
    for b, x_in, x_r in [(-50, 0.0, 0.0), (100, 0.5, 0.2), (200, 0.1, 0.9), (300, 0.3, 0.6)]:
        call = sp.add(P.RESTORER_CALL, b * MS, (b + 21) * MS)
        sp.add(P.RESTORER_COPY_IN, (b + 1) * MS, (b + 2) * MS, call)
        sp.add(P.RESTORER_REPLAY, (b + 2) * MS, (b + 3) * MS, call)
        sp.add(P.RESTORER_COPY_OUT, (b + 3) * MS, (b + 20) * MS, call)
        busy += [((b + 2 - x_in) * MS, (b + 2) * MS),      # the copy in
                 ((b + 3 - x_r) * MS, (b + 18) * MS),      # the replay's kernels
                 ((b + 18) * MS, (b + 19) * MS)]           # the copy out
    monkeypatch.setattr(P, "recorded_spans", lambda: list(sp.spans))
    return Context(spec.resolve(SERVE), timeline(busy), {})


def trained(monkeypatch):
    """Two steps in the window: step k idles f_k inside its forward, g_k
    inside its backward, and its update takes u_k (ms)."""
    sp, busy = Spans(), []
    for b, f, g, u in [(100, 4.0, 2.0, 30.0), (300, 6.0, 1.0, 36.0)]:
        step = sp.add(P.TRAIN_STEP, b * MS, (b + 150) * MS)
        sp.add(P.TRAIN_FORWARD, (b + 1) * MS, (b + 40) * MS, step)
        sp.add(P.TRAIN_BACKWARD, (b + 41) * MS, (b + 90) * MS, step)
        sp.add(P.TRAIN_UPDATE, (b + 91) * MS, (b + 91 + u) * MS, step)
        busy += [((b + 1 + f) * MS, (b + 40) * MS), ((b + 41 + g) * MS, (b + 91) * MS)]
    monkeypatch.setattr(P, "recorded_spans", lambda: list(sp.spans))
    return Context(spec.resolve(TRAIN), timeline(busy), {})


@pytest.mark.parametrize("metric,want", [("restorer_idle_ms.serve", 4.1),
                                         ("copy_idle_ms.serve", 1.7),
                                         ("launch_idle_ms.serve", 0.4)])
def test_serving_readers_on_a_known_window(metric, want, monkeypatch):
    ctx = served(monkeypatch)
    assert spec.reader(metric).read(ctx) == pytest.approx(want, rel=1e-9)
    assert spec.reader(metric).read(Context(spec.resolve(TRAIN), ctx.timeline, {})) is None


@pytest.mark.parametrize("metric,want", [("forward_idle_ms.train", 5.0),
                                         ("backward_idle_ms.train", 1.5),
                                         ("update_ms.train", 33.0)])
def test_training_readers_on_a_known_window(metric, want, monkeypatch):
    ctx = trained(monkeypatch)
    assert spec.reader(metric).read(ctx) == pytest.approx(want, rel=1e-9)
    assert spec.reader(metric).read(Context(spec.resolve(SERVE), ctx.timeline, {})) is None


def test_window_trees_keep_the_window_roots_and_their_spans(monkeypatch):
    ctx = served(monkeypatch)
    trees = program_spans.window_trees(ctx, P.RESTORER_CALL)
    assert [r.start_ns // MS for r, _ in trees] == [100, 200, 300]
    assert all(sorted(s.name for s in under) == sorted(
        [P.RESTORER_COPY_IN, P.RESTORER_REPLAY, P.RESTORER_COPY_OUT]) for _, under in trees)


NEW = ["restorer_idle_ms.serve", "copy_idle_ms.serve", "launch_idle_ms.serve",
       "forward_idle_ms.train", "backward_idle_ms.train", "update_ms.train"]


@pytest.mark.parametrize("metric", NEW)
def test_a_program_without_the_recorder_gives_nothing(metric, monkeypatch):
    ctx = (served if metric.endswith(".serve") else trained)(monkeypatch)
    monkeypatch.delattr(P, "recorded_spans")
    assert program_spans.port() is None
    assert spec.reader(metric).read(ctx) is None


@pytest.fixture
def recorder_off():
    P.record_spans(False)
    P.drain_spans()
    yield
    P.record_spans(False)
    P.drain_spans()


@pytest.mark.parametrize("workload", cells.workloads())
def test_an_untraced_run_records_no_span(workload):
    cells.no_span_untraced(spec.ROOT, workload, SEED)


@pytest.mark.parametrize("workload", [SERVE, TRAIN])
def test_a_traced_run_records_each_call_or_step_in_its_window(workload, recorder_off):
    cell = tiny_cell(workload, dtype="float32")
    r = cell.runner.run(cell, SEED, 0.5, True, "cpu", 0.0)
    ctx = Context(cell, r["timeline"], r["context"])
    root = P.RESTORER_CALL if cell.kind == "serve" else P.TRAIN_STEP
    trees = program_spans.window_trees(ctx, root)
    assert len(trees) == r["attempted"] > 0
    want = ({P.RESTORER_CALL} if cell.kind == "serve"    # the CPU runs no graph
            else {P.TRAIN_STEP, P.TRAIN_FORWARD, P.TRAIN_BACKWARD, P.TRAIN_UPDATE})
    assert {s.name for r_, under in trees for s in [r_, *under]} == want
    # nothing recorded outside the profiled window: set-up ran unprofiled
    assert {s.root for s in P.recorded_spans()} == {r_.id for r_, _ in trees}
