"""The traffic generator: every seed serves the same mix, in its own order."""

import collections
import itertools

from h100_bench import spec, traffic


def test_assorted_blocks_give_the_same_mix_for_every_seed():
    mix = spec.resolve("grl_s_x4.sr_assorted").traffic
    n = len(mix["shapes"])
    assert n == 9
    orders = []
    for seed in (0, 1, 2**31 + 11, 3 * 2**33 + 5):
        reqs = list(itertools.islice(traffic.requests(mix, seed), 20 * n))
        for k in range(20):
            assert sorted(s for s, _ in reqs[k * n:(k + 1) * n]) == list(range(n))
        counts = collections.Counter(s for s, _ in reqs)
        assert set(counts.values()) == {20}
        per_shape = collections.defaultdict(list)
        for s, j in reqs:
            per_shape[s].append(j)
        assert all(js == [i % mix["pool"] for i in range(20)] for js in per_shape.values())
        orders.append([s for s, _ in reqs])
    assert len({tuple(o) for o in orders}) == len(orders)


def test_one_shape_mix_cycles_its_pool():
    mix = spec.resolve("grl_s_x4.sr_256").traffic
    reqs = list(itertools.islice(traffic.requests(mix, 5), 40))
    assert reqs == [(0, i % mix["pool"]) for i in range(40)]


def test_train_rows_differ_over_the_checked_steps():
    mix = spec.resolve("grl_base_x4.train_sr_p64").traffic
    rows = [set(range(*traffic.step_rows(mix, k).indices(mix["pool"])))
            for k in range(mix["checked_steps"] + mix["warmup_steps"])]
    assert all(len(r) == mix["batch"] for r in rows)
    assert len(set().union(*rows)) == mix["batch"] * len(rows)
