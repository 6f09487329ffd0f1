"""``python -m tpudl_torch.obs`` — the observability CLI.

Port of ``tpudl/obs/__main__.py``: the same subcommands, arguments and
exit codes.

``trace <dir>`` merges the newest host-span export
(``*.host.trace.json[.gz]``, written by
``obs.get_tracer().export_chrome_trace``) with the newest torch.profiler
trace (``*.trace.json[.gz]``, written by ``obs.profile``) under
``<dir>``, writes the combined
Chrome trace to ``<dir>/merged.trace.json`` (open it in Perfetto /
chrome://tracing) and prints the merged summary: device busy time, host
stage totals, overlap, top ops. Either stream alone still summarizes —
a CPU-only run gets host totals, a host-blind capture gets device lanes.

``metrics <file.jsonl>`` schema-checks and tail-summarizes a
``TPUDL_METRICS_FILE`` emission (delegates the check to
``tools/validate_metrics.py``'s rules).

``doctor <dump-or-dir>`` merges flight-recorder dumps
(``tpudl-dump-*.json.gz``, one per process) and classifies the failure
— infeed stall vs decode-error storm vs dispatch slowdown vs clean
external kill — printing the timeline tail, per-stage throughput at
time of death, and the suspect stage (:mod:`tpudl_torch.obs.doctor`).

``ledger <dump-or-dir>`` re-checks the attribution plane's
reconciliation invariant offline — per-scope sums + the unattributed
bucket against the global counters, recomputed from each artifact's own
``ledger`` + ``metrics`` sections — over every flight dump and status
file under the path, then prints merged per-scope totals
(:mod:`tpudl_torch.obs.attribution`; rc 0 reconciled / 1 mismatch / 2
none).

``top <status-dir>`` renders a refreshing terminal view of every live
``tpudl-status-<pid>.json`` in the directory (written by processes
running with ``TPUDL_STATUS_DIR`` set): active runs with per-stage
times, rows done/total + ETA, heartbeat ages, and the roofline/advisor
verdict. ``--once`` prints one frame and exits (rc 2 when nothing is
running there). :mod:`tpudl_torch.obs.live` owns the file contract.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from tpudl_torch.obs import trace as T


# copied from tpudl/obs/__main__.py:_fmt_us
def _fmt_us(us: float) -> str:
    return f"{us / 1e3:.2f} ms" if us >= 1e3 else f"{us:.0f} us"


def cmd_trace(trace_dir: str, out_path: str | None = None) -> int:
    found = T.find_trace_files(trace_dir)
    host_events = (T.load_host_trace_events(found["host"])
                   if found["host"] else [])
    # load the exact file find_trace_files selected (a re-glob could
    # pick a newer gzipped HOST export as the device stream);
    # load_host_trace_events is format-wise just "events from one
    # [gzipped] trace JSON", which is what's needed here
    device_events = (T.load_host_trace_events(found["device"])
                     if found["device"] else [])
    if not host_events and not device_events:
        print(f"no host or device traces under {trace_dir}",
              file=sys.stderr)
        return 2
    print(f"host trace:   {found['host'] or '(none)'}")
    print(f"device trace: {found['device'] or '(none)'}")
    capture = T.load_capture(found["device"]) if found["device"] else None
    if capture and capture["head_marks"]:
        print(f"capture:      {capture['head_seen']} of "
              f"{capture['head_marks']} head markers, closing marker "
              f"{'seen' if capture['tail_seen'] else 'missing'}"
              + (" — TRUNCATED: the device totals are not the block's"
                 if capture["truncated"] else ""))
    merged = T.merge_trace_events(host_events, device_events)
    out_path = out_path or os.path.join(trace_dir, "merged.trace.json")
    with open(out_path, "w") as f:
        json.dump({"traceEvents": merged, "displayTimeUnit": "ms"}, f)
    print(f"merged trace: {out_path} (open in Perfetto / chrome://tracing)")
    s = T.summarize_merged(host_events, device_events)
    print("\n== merged timeline summary ==")
    print(f"wall window:        {_fmt_us(s['wall_us'])}")
    busy = s["device_busy_frac"]
    print(f"device busy:        {_fmt_us(s['device_busy_us'])}"
          + (f" ({busy:.1%} of device window)" if busy is not None else "")
          + f" across {s['device']['module_count']} device events")
    print(f"host busy:          {_fmt_us(s['host_busy_us'])}")
    ov = s["host_overlap_frac"]
    print(f"host/device overlap: {_fmt_us(s['overlap_us'])}"
          + (f" ({ov:.1%} of host work hidden under device compute)"
             if ov is not None else ""))
    if s["host_stage_us"]:
        print("host stages:")
        for name, us in sorted(s["host_stage_us"].items(),
                               key=lambda kv: -kv[1]):
            print(f"  {name:<28} {_fmt_us(us):>12}"
                  f"  x{s['host_stage_calls'][name]}")
    if s["top_ops"]:
        print("top device ops:")
        for op in s["top_ops"]:
            print(f"  {op['name']:<28} {_fmt_us(op['us']):>12}"
                  f"  x{op['count']}  {op['category']}")
    return 0


# copied from tpudl/obs/__main__.py:cmd_metrics
def cmd_metrics(path: str) -> int:
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "tools"))
    try:
        from validate_metrics import validate_metrics_file
    except ImportError:
        # the validator lives in the repo's tools/ dir, not in the
        # package
        print("tools/validate_metrics.py not found (run from a source "
              "checkout, or use tools/validate_metrics.py directly)",
              file=sys.stderr)
        return 2

    errors, n_lines, last = validate_metrics_file(path)
    for err in errors:
        print(f"INVALID: {err}", file=sys.stderr)
    print(f"{path}: {n_lines} lines, "
          f"{'OK' if not errors else f'{len(errors)} errors'}")
    if last:
        print(f"last snapshot ({last.get('event')}, pid {last.get('pid')}):")
        for name, m in sorted(last.get("metrics", {}).items()):
            if m["type"] == "counter":
                print(f"  {name:<40} {m['value']}")
            elif m["type"] == "gauge":
                print(f"  {name:<40} {m['value']} "
                      f"(mean {m.get('mean')}, max {m.get('max')})")
            else:
                print(f"  {name:<40} n={m['count']} mean={m.get('mean')} "
                      f"p95={m.get('p95')}")
    return 0 if not errors else 1


# copied from tpudl/obs/__main__.py:cmd_doctor
def cmd_doctor(path: str, tail: int = 12) -> int:
    from tpudl_torch.obs import doctor as D

    got = D.diagnose(path)
    if got is None:
        print(f"no flight-recorder dumps (tpudl-dump-*.json[.gz]) "
              f"under {path}", file=sys.stderr)
        return 2
    merged, diagnosis = got
    print(D.format_report(merged, diagnosis, tail=tail))
    # rc contract: 0 = readable + classified, 1 = unclassified (a human
    # must look), 2 = no dumps at all
    return 0 if diagnosis["classification"] != "unclassified" else 1


# copied from tpudl/obs/__main__.py:cmd_ledger
def cmd_ledger(path: str) -> int:
    """Offline attribution reconciliation: re-check the ledger
    invariant (per-scope sums + unattributed == global counters) in
    every flight dump and status file under ``path`` — recomputed from
    the artifact's OWN ledger + metrics sections, never trusting an
    embedded verdict — and print the merged per-scope totals.

    rc contract (sibling of doctor's): 0 = every artifact reconciles,
    1 = at least one mismatch, 2 = no ledger-bearing artifact found."""
    from tpudl_torch.obs import attribution as A
    from tpudl_torch.obs import doctor as D
    from tpudl_torch.obs import live as L

    artifacts = []  # (label, ledger snapshot, metrics snapshot)
    for d in D.load_dumps(path):
        led = d.get("ledger")
        if isinstance(led, dict):
            artifacts.append((f"dump pid {d.get('pid')} "
                              f"({d.get('_path', '?')})",
                              led, d.get("metrics") or {}))
    if os.path.isdir(path):
        for st in L.read_statuses(path):
            led = st.get("ledger")
            if isinstance(led, dict):
                artifacts.append((f"status pid {st.get('pid')} "
                                  f"({st.get('_path', '?')})",
                                  led, st.get("metrics") or {}))
    if not artifacts:
        print(f"no ledger-bearing dumps or status files under {path}",
              file=sys.stderr)
        return 2
    bad = 0
    merged: dict[str, dict] = {}
    for label, led, metrics in artifacts:
        rec = A.reconcile_snapshot(led, metrics)
        verdict = "RECONCILED" if rec["ok"] else "MISMATCH"
        print(f"{verdict}: {label} — "
              f"{len(led.get('scopes') or {})} scope(s), "
              f"{int(led.get('evicted') or 0)} evicted")
        for c in rec["checks"]:
            if not c["ok"]:
                bad += 1
                print(f"  {c['field']}: ledger {c['ledger']} != "
                      f"{c['metric']} {c['global']}")
        rows = list((led.get("scopes") or {}).items())
        una = led.get("unattributed") or {}
        if any(isinstance(v, (int, float)) and v for v in una.values()):
            rows.append(("(unattributed)", una))
        for key, row in rows:
            at = merged.setdefault(key, {})
            for f in A.LEDGER_FIELDS:
                v = row.get(f)
                if isinstance(v, (int, float)):
                    at[f] = at.get(f, 0.0) + float(v)
    print(f"\n== merged scope totals ({len(artifacts)} artifact(s)) ==")
    for key, row in sorted(merged.items()):
        bits = [f"{f} {row[f]:.0f}" for f in
                ("rows_in", "rows_out", "tokens_in", "tokens_out",
                 "wire_bytes", "hbm_bytes", "serve_completed")
                if row.get(f)]
        print(f"  {key:<28} " + ("  ".join(bits) or "(no charges)"))
    return 1 if bad else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpudl_torch.obs",
        description="merge + summarize tpudl_torch traces, metrics and "
                    "dumps")
    sub = p.add_subparsers(dest="cmd", required=True)
    pt = sub.add_parser("trace", help="merge host + device traces in a dir")
    pt.add_argument("trace_dir")
    pt.add_argument("--out", default=None,
                    help="merged trace path (default <dir>/merged.trace.json)")
    pm = sub.add_parser("metrics", help="validate + summarize a metrics JSONL")
    pm.add_argument("path")
    pd = sub.add_parser(
        "doctor", help="classify a failure from flight-recorder dump(s)")
    pd.add_argument("path", help="one tpudl-dump-*.json.gz or a dir of them")
    pd.add_argument("--tail", type=int, default=12,
                    help="timeline tail length (default 12 spans)")
    pl = sub.add_parser(
        "ledger",
        help="offline attribution reconciliation over dumps/status "
             "files")
    pl.add_argument("path",
                    help="one dump file or a dir of dumps/status files")
    pp = sub.add_parser(
        "top", help="live view of tpudl-status-*.json files in a dir")
    pp.add_argument("status_dir",
                    help="the TPUDL_STATUS_DIR processes write into")
    pp.add_argument("--once", action="store_true",
                    help="print one frame and exit (rc 2 when empty)")
    pp.add_argument("--interval", type=float, default=2.0,
                    help="refresh period in seconds (default 2)")
    args = p.parse_args(argv)
    if args.cmd == "trace":
        return cmd_trace(args.trace_dir, args.out)
    if args.cmd == "doctor":
        return cmd_doctor(args.path, args.tail)
    if args.cmd == "ledger":
        return cmd_ledger(args.path)
    if args.cmd == "top":
        from tpudl_torch.obs import live as L

        return L.top_main(args.status_dir, once=args.once,
                          interval=args.interval)
    return cmd_metrics(args.path)


if __name__ == "__main__":
    sys.exit(main())
