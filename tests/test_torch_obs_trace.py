"""Device traces over torch.profiler (``tpudl_torch.obs.trace``).

- A small trace in Kineto's format, written by the test (CPU ops, CUDA
  runtime calls, three flash-forward kernels on two streams, a copy and a
  fill on the GPU's pid), summarizes as stated: the device lanes are the
  ``kernel``/``gpu_memcpy``/``gpu_memset`` events, with tpudl's summary
  keys (device busy time and share, host stage totals, overlap, top ops).
- The merge is tpudl's on the same events (per-stream normalization).
- A CPU ``profile()`` writes a trace the loader finds, records its window
  on the tracer, and merges with the tracer's windowed export; the CLI's
  ``trace`` subcommand reads the directory.
- The marker kernels a capture on a card is fenced by count a loss at its
  head and flag a truncated capture, with or without another thread's
  kernels among them, and leave the trace exactly the block's; a
  truncated capture is written and raises, through ``profile()`` and the
  plain ``capture()`` every device-time reading takes."""

import gzip
import json
import os

import pytest
import torch

from tpudl.obs import trace as jtrace

from tpudl_torch.obs import __main__ as cli
from tpudl_torch.obs import metrics as tmetrics
from tpudl_torch.obs import trace as ttrace
from tpudl_torch.obs import tracer as ttracer

KERNEL = "void flash_fwd_kernel<float, 64>(FlashFwdParams)"


def kineto_events():
    """Kineto's shape: CPU pid 4242 (ops, runtime launches), GPU pid 0
    (streams 7 and 13). Device busy: [100, 160) ∪ [150, 200) ∪ [300, 340)
    ∪ [400, 410) ∪ [420, 425) = 100 + 40 + 10 + 5 = 155 µs of a 325 µs
    device window."""
    ev = [{"ph": "M", "name": "process_name", "pid": 4242, "tid": 0,
           "args": {"name": "python3"}},
          {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
           "args": {"name": "GPU 0"}},
          {"ph": "X", "cat": "cpu_op", "name": "aten::linear", "pid": 4242,
           "tid": 1, "ts": 0.0, "dur": 90.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "pid": 4242, "tid": 1, "ts": 10.0, "dur": 5.0}]
    for ts, dur, stream in ((100.0, 60.0, 7), (150.0, 50.0, 13),
                            (300.0, 40.0, 7)):
        ev.append({"ph": "X", "cat": "kernel", "name": KERNEL, "pid": 0,
                   "tid": stream, "ts": ts, "dur": dur,
                   "args": {"device": 0, "stream": stream,
                            "grid": [16, 16, 1]}})
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD "
               "(Pinned -> Device)", "pid": 0, "tid": 7, "ts": 400.0,
               "dur": 10.0, "args": {"bytes": 4096}})
    ev.append({"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
               "pid": 0, "tid": 7, "ts": 420.0, "dur": 5.0,
               "args": {"bytes": 512}})
    return ev


def host_events():
    return [{"ph": "M", "pid": 9, "name": "process_name",
             "args": {"name": "tpudl host"}},
            {"ph": "X", "name": "frame.dispatch", "pid": 9, "tid": 1,
             "ts": 5000.0, "dur": 120.0},
            {"ph": "X", "name": "frame.prepare", "pid": 9, "tid": 2,
             "ts": 5000.0, "dur": 30.0},
            {"ph": "X", "name": "frame.dispatch", "pid": 9, "tid": 1,
             "ts": 5300.0, "dur": 20.0}]


def test_device_lanes_are_kinetos_kernels_copies_and_fills():
    s = ttrace.summarize_device_trace(kineto_events())
    assert s["module_count"] == 5
    assert s["module_us"] == 60 + 50 + 40 + 10 + 5
    assert s["ops"][KERNEL]["count"] == 3
    assert s["ops"][KERNEL]["us"] == 150.0
    assert s["ops"][KERNEL]["category"] == "kernel"
    memcpy = s["ops"]["Memcpy HtoD (Pinned -> Device)"]
    assert (memcpy["category"], memcpy["bytes"]) == ("gpu_memcpy", 4096)
    assert [e["name"] for e in ttrace.device_events(kineto_events())] == \
        [KERNEL] * 3 + ["Memcpy HtoD (Pinned -> Device)", "Memset (Device)"]
    assert ttrace.summarize_device_trace(host_events())["module_count"] == 0


def test_merged_summary_as_stated():
    s = ttrace.summarize_merged(host_events(), kineto_events())
    # the device stream normalizes to its first event (the CPU op at 0)
    assert s["device_busy_us"] == 155.0
    assert s["device_busy_frac"] == round(155.0 / 325.0, 4)
    assert s["host_stage_us"] == {"frame.dispatch": 140.0,
                                  "frame.prepare": 30.0}
    assert s["host_stage_calls"] == {"frame.dispatch": 2,
                                     "frame.prepare": 1}
    # host spans normalize to 5000: [0, 120) ∪ [300, 320) = 140 µs busy,
    # overlapping the device's [100, 200) and [300, 320) for 40 µs
    assert s["host_busy_us"] == 140.0
    assert s["overlap_us"] == 40.0
    assert s["host_overlap_frac"] == round(40.0 / 140.0, 4)
    assert s["top_ops"][0] == {"name": KERNEL, "us": 150.0, "count": 3,
                               "category": "kernel"}
    assert sorted(s) == sorted(jtrace.summarize_merged([], []))


def test_merge_is_tpudls():
    ours = ttrace.merge_trace_events(host_events(), kineto_events())
    assert ours == jtrace.merge_trace_events(host_events(),
                                             kineto_events())
    assert {e["pid"] for e in ours} == {0, 1, 2}


def test_files_are_found_and_loaded_by_name(tmp_path):
    dev = tmp_path / "a" / "tpudl-1-0.trace.json.gz"
    dev.parent.mkdir()
    with gzip.open(dev, "wt") as f:
        json.dump({"traceEvents": kineto_events()}, f)
    host = tmp_path / "run.host.trace.json"
    host.write_text(json.dumps({"traceEvents": host_events()}))
    found = ttrace.find_trace_files(str(tmp_path))
    assert found == {"host": str(host), "device": str(dev)}
    assert ttrace.load_trace_events(str(tmp_path)) == kineto_events()
    assert ttrace.load_host_trace_events(str(host)) == host_events()
    assert cli.main(["trace", str(tmp_path)]) == 0
    merged = json.loads((tmp_path / "merged.trace.json").read_text())
    assert len(merged["traceEvents"]) == len(host_events()) + len(
        kineto_events())


def test_cpu_profile_merges_with_the_tracer(tmp_path):
    with ttrace.profile(str(tmp_path)) as prof:
        with ttracer.span("obs.test.profiled", rows=3):
            with ttrace.named_scope("obs.test.scope"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.exists(prof.trace_path)
    assert prof.trace_path.endswith(".trace.json.gz")
    window = ttracer.get_tracer().last_profile_window
    assert window is not None and window[0] <= window[1]
    events = ttrace.load_trace_events(str(tmp_path))
    names = {e.get("name") for e in events}
    assert "obs.test.scope" in names
    assert ttrace.summarize_device_trace(events)["module_count"] == 0
    host = ttracer.get_tracer().export_chrome_trace(
        str(tmp_path / "t.host.trace.json"), window="profile")
    s = ttrace.summarize_merged(ttrace.load_host_trace_events(host), events)
    assert s["host_stage_calls"].get("obs.test.profiled") == 1
    assert s["device_busy_us"] == 0.0 and s["device_busy_frac"] is None


MARK = "void at::cuda::(anonymous namespace)::spin_kernel<long>(long)"


def fenced(n_head, tail=True, launcher=False):
    """kineto_events() with ``n_head`` short marker kernels before the
    block's device events (from 50 µs) and a long closing one after them
    (at 500 µs, 600 µs long), each with its runtime launch and flow
    arrow; with ``launcher``, another thread's kernels from 0 µs on,
    among them."""
    ev = kineto_events()
    marks = [(50.0 + i * 0.1, 0.05) for i in range(n_head)] + (
        [(500.0, 600.0)] if tail else [])
    for i, (ts, dur) in enumerate(marks):
        corr = 9000 + i
        ev.append({"ph": "X", "cat": "kernel", "name": MARK, "pid": 0,
                   "tid": 7, "ts": ts, "dur": dur,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "pid": 4242, "tid": 1,
                   "ts": ts - 1.0, "dur": 0.5,
                   "args": {"correlation": corr}})
        ev.append({"ph": "s", "cat": "ac2g", "name": "ac2g", "id": corr,
                   "pid": 4242, "tid": 1, "ts": ts - 1.0})
    if launcher:
        ev += [{"ph": "X", "cat": "kernel", "name": "other_thread_kernel",
                "pid": 0, "tid": 21, "ts": float(t), "dur": 2.0,
                "args": {"correlation": 100 + t}} for t in range(0, 600, 40)]
    return ev


@pytest.mark.parametrize("n_head, tail, lost, truncated", [
    (8, True, 0, False),        # whole
    (5, True, 3, False),        # lost 3 events at its head, none of the block's
    (0, True, 8, True),         # lost every head marker: may reach the block
    (8, False, 0, True),        # the closing marker missing: the tail was cut
])
@pytest.mark.parametrize("launcher", [False, True])
def test_marker_kernels_count_a_head_loss_and_leave_the_trace(
        n_head, tail, lost, truncated, launcher):
    kept, cap = ttrace.account_marks(fenced(n_head, tail, launcher), 8)
    assert cap == {"head_marks": 8, "head_seen": n_head, "head_lost": lost,
                   "tail_seen": tail, "truncated": truncated,
                   "launches_without_kernel": 0}
    # the block's events (and the other thread's) stay exactly; every
    # marker and its launch goes
    assert kept == [e for e in fenced(0, False, launcher)]
    assert ttrace.summarize_device_trace(kept) == \
        ttrace.summarize_device_trace(fenced(0, False, launcher))


def test_a_launch_whose_kernel_is_lost_is_counted():
    ev = fenced(8)
    ev[3]["args"] = {"correlation": 77}       # the block's cudaLaunchKernel
    kernel = next(e for e in ev if e.get("cat") == "kernel")
    kernel["args"] = dict(kernel["args"], correlation=77)
    _, cap = ttrace.account_marks(ev, 8)
    assert cap["launches_without_kernel"] == 0
    kernel["args"] = dict(kernel["args"], correlation=78)
    _, cap = ttrace.account_marks(ev, 8)
    assert cap["launches_without_kernel"] == 1


def test_an_empty_block_keeps_its_markers_apart():
    ev = [e for e in fenced(8) if e.get("cat") not in ttrace.DEVICE_CATEGORIES
          or e["name"] == MARK]
    kept, cap = ttrace.account_marks(ev, 8)
    assert (cap["head_seen"], cap["tail_seen"], cap["truncated"]) == (
        8, True, False)
    assert not ttrace.device_events(kept)


def test_a_cpu_capture_has_no_markers_and_records_so(tmp_path, capsys):
    with ttrace.profile(str(tmp_path)) as prof:
        torch.ones(8) + 1
    assert prof.capture == {"head_marks": 0, "head_seen": 0, "head_lost": 0,
                            "tail_seen": None, "truncated": False,
                            "launches_without_kernel": 0}
    assert ttrace.load_capture(prof.trace_path) == prof.capture
    assert cli.main(["trace", str(tmp_path)]) == 0
    assert "capture:" not in capsys.readouterr().out


def test_a_truncated_capture_is_written_and_raises(tmp_path, monkeypatch):
    """A capture whose loss may reach the block gives no device totals:
    ``profile()`` writes its trace for inspection, counts it, and
    raises; so does the plain ``capture()`` every device reading takes."""
    real = ttrace.account_marks

    def truncated(events, marks):
        kept, cap = real(events, marks)
        return kept, dict(cap, head_marks=8, head_seen=0, head_lost=8,
                          tail_seen=True, truncated=True)

    monkeypatch.setattr(ttrace, "account_marks", truncated)
    before = tmetrics.counter("obs.profile.truncated").value
    with pytest.raises(ttrace.TruncatedCapture, match="truncated"):
        with ttrace.profile(str(tmp_path)) as prof:
            torch.ones(8) + 1
    assert ttrace.load_capture(prof.trace_path)["truncated"] is True
    with pytest.raises(ttrace.TruncatedCapture):
        with ttrace.capture(cpu=False):
            torch.ones(8) + 1
    assert tmetrics.counter("obs.profile.truncated").value == before + 2


def test_capture_is_the_marked_session_profile_writes(tmp_path):
    with ttrace.capture(cpu=False) as prof:
        torch.ones(8) + 1
    assert prof.capture["head_marks"] == 0 and not prof.capture["truncated"]
    assert isinstance(prof.trace["traceEvents"], list)
    assert prof.key_averages() is not None
    with ttrace.profile(str(tmp_path)) as prof:
        torch.ones(8) + 1
    assert ttrace.load_capture(prof.trace_path) == prof.capture
