"""On the card: the port's spans and the device trace on one clock.  One
warm GRL-S 256x256 `Restorer` call under the harness's profiler: every
device activity after the input's copy lies between the start of
`restorer.replay` and the end of `restorer.copy_out`, the input's copy
between the start of `restorer.copy_in` and the start of the replay's
first kernel, and the answer's copy to the host inside
`restorer.copy_out`.  Skipped without a card."""

import pytest
import torch

from h100_bench import cell_serve, spec
from h100_bench import trace as tr
from grlir_torch.utils import profiling as P


@pytest.mark.cuda
def test_the_replay_and_the_copies_lie_inside_their_spans():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    device = torch.device("cuda")
    restorer, images, _ = cell_serve.setup(spec.resolve("grl_s_x4.sr_256"), 4294967311, device)
    P.drain_spans()
    prof, marks = tr.profiler(device), tr.Marks()
    torch.cuda.synchronize(device)
    prof.start()
    marks.start(tr.WINDOW)
    restorer(images[0][:1])
    marks.stop(tr.WINDOW)
    prof.stop()
    spans = {s.name: s for s in P.drain_spans()}
    assert set(spans) == {P.RESTORER_CALL, P.RESTORER_COPY_IN, P.RESTORER_REPLAY,
                          P.RESTORER_COPY_OUT}
    cin, rep, cout = (spans[n] for n in (P.RESTORER_COPY_IN, P.RESTORER_REPLAY,
                                         P.RESTORER_COPY_OUT))
    device_acts = sorted((e.start_ns(), e.end_ns(), e.name())
                         for e in prof.profiler.kineto_results.events()
                         if e.device_type() == torch.autograd.DeviceType.CUDA
                         and not e.is_user_annotation())
    h2d = [a for a in device_acts if "HtoD" in a[2]]
    d2h = [a for a in device_acts if "DtoH" in a[2]]
    rest = [a for a in device_acts if "HtoD" not in a[2]]
    assert len(h2d) == 1 and len(d2h) == 1 and len(rest) > 100, device_acts[:5]
    first = min(a for a, _, _ in rest)
    margins = {"h2d after copy_in starts": h2d[0][0] - cin.start_ns,
               "replay's kernels after replay starts": first - rep.start_ns,
               "device work before copy_out ends": cout.end_ns - max(b for _, b, _ in rest),
               "d2h after copy_out starts": d2h[0][0] - cout.start_ns,
               "d2h before copy_out ends": cout.end_ns - d2h[0][1]}
    print("margins ns", margins)
    assert all(v >= 0 for v in margins.values()), margins
    assert h2d[0][1] <= first
