"""The rate, idle-share and roofline arithmetic of the readers, on made-up
event lists."""

import types

import pytest

from portbench import cells, flops, harness, profiling

CELL = cells.load("atari_impala.b1024")
MS = 1_000_000  # ns


def trace(updates=(), profile=None, window=None, peaks=flops.PEAKS["H100 80GB HBM3"]):
    config = types.SimpleNamespace(unroll_len=32, num_envs=1024)
    window = window or harness.Window(env_steps=0, seconds=0.0)
    return types.SimpleNamespace(cell=CELL, config=config, window=window, updates=list(updates),
                                 profile=profile, flops_per_env_step=4e8, peaks=peaks)


def read(metric, data):
    return CELL.reader(metric)(data)


def test_busy_is_the_union_of_intervals():
    events = [("a", 0, 10), ("b", 5, 10), ("c", 30, 5), ("d", 31, 2)]
    assert profiling.busy_ns(events) == 20
    assert profiling.gaps(events, min_ns=1) == [(15, 30)]


def test_top_ops_sum_by_name():
    events = [("k1", 0, 4), ("k2", 4, 3), ("k1", 7, 4)]
    assert profiling.top_ops(events) == [["k1", 8e-9], ["k2", 3e-9]]


def test_gaps_are_named_by_the_host_op_at_their_middle():
    host = [("portbench.update", 0, 100), ("portbench.collect", 10, 50),
            ("aten::cat", 20, 40), ("aten::mm", 60, 80)]
    named = profiling.name_gaps([(25, 35), (65, 75), (90, 94)], host)
    assert named == [["portbench.collect > aten::cat", 1e-8],
                     ["portbench.update > aten::mm", 1e-8],
                     ["portbench.update > portbench.update", 4e-9]]


def test_event_readers():
    data = trace(updates=[(700.0, 250.0), (690.0, 230.0)])
    assert read("rollout_ms", data) == pytest.approx(240.0)
    assert read("learner_ms", data) == pytest.approx(455.0)


def test_device_readers():
    events = [("fused_vtrace_kernel", 0, 3000), ("conv", 3000, MS),
              ("Memcpy HtoD", 2 * MS, 1000), ("fused_vtrace_kernel", 3 * MS, 3000)]
    profile = {"events": events, "updates": 2, "window_s": 0.004,
               "busy_s": profiling.busy_ns(events) / 1e9}
    data = trace(profile=profile, updates=[(0.6, 0.2), (0.8, 0.3)])
    bound_s = 2 * flops.vtrace_bytes(32, 1024) / 3.35e12
    assert read("vtrace_roofline", data) == pytest.approx(100 * bound_s / 6e-6)
    assert read("launches_per_update", data) == 1.5
    # busy 1.007 ms over 2 profiled updates, against the events' 0.7 ms an
    # update; the profiled stretch's wall (window_s) does not enter.
    assert read("device_idle_share", data) == pytest.approx(100 * (1 - 0.5035 / 0.7))
    assert read("device_idle_share", trace(profile=profile)) is None


@pytest.mark.parametrize("metric", [m["name"] for m in CELL.per_layer])
def test_a_split_metric_reads_as_its_quantity(metric):
    """``<metric>.host_paced`` is the same reading in the cells whose rate
    is ``env_steps_per_s.host_paced``."""
    events = [("fused_vtrace_kernel", 0, 3000), ("conv", 3000, MS)]
    profile = {"events": events, "updates": 1, "window_s": 0.002,
               "busy_s": profiling.busy_ns(events) / 1e9}
    data = trace(updates=[(2.0, 1.5)], profile=profile,
                 window=harness.Window(env_steps=1000, seconds=1.0))
    assert read(metric + ".host_paced", data) == read(metric, data) is not None


def test_mfu_is_model_flops_over_the_window():
    data = trace(window=harness.Window(env_steps=1_000_000, seconds=20.0))
    assert read("mfu", data) == pytest.approx(100 * 4e8 * 5e4 / 989e12)


@pytest.mark.parametrize("metric", [m["name"] for m in CELL.per_layer])
def test_nothing_to_read_reads_nothing(metric):
    """Off the card (no events, no profile, no peaks) a reader returns
    None, never 0."""
    assert read(metric, trace(profile=None, peaks=None)) is None
