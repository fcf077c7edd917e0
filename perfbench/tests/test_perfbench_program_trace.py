"""The program trace's arithmetic on synthetic spans and a synthetic Chrome
trace: launch-time attribution across threads, gap naming, sync crediting,
and the new readers' None where the program recorded nothing."""

from collections import namedtuple

import pytest

from perfbench.harness import program_trace as pt
from perfbench.harness import registry

Span = namedtuple("Span", "id name start end thread parent unit counters")
MAIN, AUTOGRAD = 0x7F00_1234_5678, 0x7F00_9ABC_DEF0   # get_ident() values
T_MARK, OFFSET_US = 10.0, 5_000_000.0   # host clock s; trace us = host + it


def span(i, name, start, end, thread=MAIN, parent=None, counters=None):
    return Span(i, name, start, end, thread, parent, 0, counters or {})


def chrome(ops, t_end):
    """A Chrome trace of ``ops`` ((name, launch s, launch thread, device
    start s, device s) on the host clock) between the two markers."""
    events, corr = [], 0

    def add(name, launch, thread, start, dur):
        nonlocal corr
        corr += 1
        events.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaLaunchKernel", "tid": pt.tid32(thread),
                       "ts": launch * 1e6 + OFFSET_US, "dur": 3.0,
                       "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "name": name, "tid": 7,
                       "ts": start * 1e6 + OFFSET_US, "dur": dur * 1e6,
                       "args": {"correlation": corr}})

    add("at::cuda::spin_kernel(long)", T_MARK, MAIN, T_MARK + 1e-5, 1e-6)
    for op in ops:
        add(*op)
    add("at::cuda::spin_kernel(long)", t_end + 2e-5, MAIN, t_end + 3e-5, 1e-6)
    return events


def program(spans, ops, bench=(), syncs=(), t0=T_MARK + 1e-4, t1=11.0,
            counters=None):
    got, check, lost = pt.chrome_ops(chrome(ops, t1), T_MARK, t1)
    assert check == pytest.approx(2e-5, abs=1e-9) and lost == 0
    return pt.ProgramTrace(spans, counters or {}, list(bench), got, t0, t1,
                           {"units": 1, "steps": 2, "env_steps": 4},
                           list(syncs), {"units": 1, "env_steps": 4}, MAIN,
                           check)


def test_tid32_is_the_profilers_signed_low_word():
    assert pt.tid32(0x1_0000_0005) == 5
    assert pt.tid32(0xFFFF_FFFF) == -1


def test_markers_are_found_by_their_launches_inside_the_padding():
    """The profiler may lose device records, the markers' among them: the
    markers are the launches ``pad`` in from each end, and the launches
    between them that lost their device record are counted."""
    pads = [("spin", T_MARK - 1e-3 + 1e-5 * i, MAIN, T_MARK - 1e-3, 1e-6)
            for i in range(3)]
    ops = [("k", 10.5, MAIN, 10.6, 0.01), ("gone", 10.7, MAIN, 10.8, 0.01)]
    events = chrome(ops, 11.0)
    tail = [("spin", 11.0 + 1e-3 * (i + 1), MAIN, 11.01, 1e-6)
            for i in range(3)]
    events = _launches(pads) + events + _launches(tail)
    events = [e for e in events if not (e["cat"] != "cuda_runtime" and (
        "spin" in e["name"] or e["name"] == "gone"))]
    got, check, lost = pt.chrome_ops(events, T_MARK, 11.0, pad=3)
    assert [o[0] for o in got] == ["k"] and lost == 1
    assert got[0][3] == pytest.approx(10.5)
    assert check == pytest.approx(2e-5, abs=1e-9)


def _launches(ops, first_corr=1000):
    out = []
    for i, (name, launch, thread, start, dur) in enumerate(ops):
        out.append({"ph": "X", "cat": "cuda_runtime",
                    "name": "cudaLaunchKernel", "tid": pt.tid32(thread),
                    "ts": launch * 1e6 + OFFSET_US, "dur": 3.0,
                    "args": {"correlation": first_corr + i
                             + (0 if launch < T_MARK else 100)}})
        out.append({"ph": "X", "cat": "kernel", "name": name, "tid": 7,
                    "ts": start * 1e6 + OFFSET_US, "dur": dur * 1e6,
                    "args": {"correlation": first_corr + i
                             + (0 if launch < T_MARK else 100)}})
    return out


def test_operations_go_to_the_launching_threads_span_else_the_main_ones():
    spans = [span(0, "train.step", 10.1, 10.9),
             span(1, "train.backward", 10.2, 10.8, parent=0),
             span(2, "composite.backward", 10.3, 10.4, thread=AUTOGRAD,
                  parent=1),
             span(3, "train.optimizer", 10.85, 10.88, parent=0)]
    ops = [("k3", 10.35, AUTOGRAD, 10.5, 0.01),     # the autograd thread's
           ("proj_bwd", 10.45, AUTOGRAD, 10.6, 0.02),  # none there: main's
           ("adam", 10.86, MAIN, 10.87, 0.004),
           ("late", 10.95, MAIN, 10.96, 0.001)]       # no span: unattributed
    p = program(spans, ops, bench=[("train_step", 10.05, 10.95)])
    labels = {name: label for name, _, _, _, label in p.ops}
    assert labels == {"k3": "composite.backward", "proj_bwd": "train.backward",
                      "adam": "train.optimizer", "late": "train_step"}
    # device time a step launched under train.backward counts its child's
    assert p.stat("device_ms", "train.backward", "steps") == pytest.approx(
        1e3 * 0.03 / 2)
    assert p.stat("device_ms", "train.optimizer", "steps") == pytest.approx(
        1e3 * 0.004 / 2)
    # the device times are on the host clock by the markers' offset
    k3 = next(o for o in p.ops if o[0] == "k3")
    assert k3[1] == pytest.approx(10.5) and k3[2] == pytest.approx(10.51)


def test_gaps_are_named_by_the_innermost_span_of_either_kind():
    spans = [span(0, "env.apply_cmd_for", 10.1, 10.3),
             span(1, "motion.read_scalar", 10.15, 10.25, parent=0)]
    bench = [("apply_cmd_for", 10.05, 10.35), ("get_rgbd", 10.4, 10.9)]
    ops = [("a", 10.11, MAIN, 10.11, 0.01),       # busy 10.11-10.12
           ("b", 10.26, MAIN, 10.26, 0.01),       # gap 10.12-10.26: read
           ("c", 10.41, MAIN, 10.8, 0.02)]        # gap 10.27-10.8: get_rgbd
    p = program(spans, ops, bench=bench, t0=10.11, t1=10.81)
    gaps = dict((round(v, 6), k) for k, v in p.breakdown()["idle_gaps"])
    assert gaps == {0.14: "motion.read_scalar", 0.53: "get_rgbd"}
    named = dict(p.breakdown()["device_ops"])
    assert set(named) == {"env.apply_cmd_for: a", "env.apply_cmd_for: b",
                          "get_rgbd: c"}


def test_syncs_are_credited_to_the_innermost_span_of_their_thread():
    spans = [span(0, "rollout.step", 1.0, 2.0),
             span(1, "camera.read_scalar", 1.1, 1.2, parent=0),
             span(2, "render", 1.3, 1.8, parent=0),
             span(3, "binning.read_live", 1.4, 1.5, parent=2),
             span(4, "composite.backward", 1.6, 1.7, thread=AUTOGRAD,
                  parent=2)]
    hits = [(1.15, MAIN), (1.45, MAIN), (1.35, MAIN), (1.65, AUTOGRAD),
            (1.65, 0xDEAD), (2.5, MAIN)]
    owner = pt.innermost(spans, hits, MAIN)
    assert [s and s.name for s in owner] == [
        "camera.read_scalar", "binning.read_live", "render",
        "composite.backward", "render", None]
    syncs = [(s and s.name, bench) for s, bench in
             zip(owner, [False] * 5 + [True])]
    p = program(spans, [], syncs=syncs)
    # render (twice) and composite.backward are unnamed; the benchmark's
    # own sync outside every program span is not the program's
    assert p.unnamed_syncs() == 3
    assert p.stat("unnamed_syncs", "rollout.step", "env_steps") == 0.75
    read = [(n, False) for n in ("camera.read_scalar", "env.read_frame")]
    assert program(spans, [], syncs=read + [(None, True)]).unnamed_syncs() == 0
    assert program(spans, [], syncs=[(None, False)]).unnamed_syncs() == 1


def test_host_spans_and_counters():
    spans = [span(0, "render", 1.0, 2.0, counters={}),
             span(1, "binning.read_live", 1.1, 1.2, parent=0),
             span(2, "binning.read_kept", 1.3, 1.35, parent=0),
             span(3, "rollout.step", 2.0, 2.5),
             span(4, "rollout.step", 2.5, 2.7)]
    p = program(spans, [], counters={"binning.kept_pairs": 30,
                                     "binning.live_slots": 120})
    wait = p.stat("host_ms", ["binning.read_live", "binning.read_kept"],
                  "env_steps")
    assert wait == pytest.approx(1e3 * 0.15 / 4)
    assert p.stat("median_ms", "rollout.step") == pytest.approx(350.0)
    assert p.counter_ratio("binning.kept_pairs", "binning.live_slots") == 0.25


class Data:
    """A traced run's data as a reader sees it."""


NEW = ["binning.span_device_ms.train", "train.backward.device_ms.train",
       "train.optimizer.device_ms.train", "binning.host_wait_ms.render",
       "env.copy_wait_ms.single", "rollout.step_ms.nav",
       "host.unnamed_syncs_per_step.nav", "binning.kept_share.render"]


@pytest.mark.parametrize("name", NEW)
def test_new_readers_give_none_where_their_span_is_absent(name):
    spec = registry.metric(name)
    data = Data()
    assert spec["read"](data, **spec["args"]) is None    # no runner's frame
    assert data.program is None and not hasattr(data, "breakdown")
    other = [span(0, "unrelated", 1.0, 2.0)]
    data = Data()
    data.program = program(other, [("x", 10.5, MAIN, 10.5, 0.1)])
    assert spec["read"](data, **spec["args"]) is None


def test_new_readers_read_the_program_trace():
    spans = [span(0, "train.step", 10.1, 10.9),
             span(1, "train.optimizer", 10.2, 10.4, parent=0),
             span(2, "render", 10.5, 10.8, parent=0,
                  counters={"binning.kept_pairs": 3,
                            "binning.live_slots": 12})]
    data = Data()
    data.program = program(spans, [("adam", 10.3, MAIN, 10.3, 0.002)],
                           counters={"binning.kept_pairs": 3,
                                     "binning.live_slots": 12})
    spec = registry.metric("train.optimizer.device_ms.train")
    assert spec["read"](data, **spec["args"]) == pytest.approx(1.0)
    spec = registry.metric("binning.kept_share.render")
    assert spec["read"](data, **spec["args"]) == pytest.approx(25.0)
