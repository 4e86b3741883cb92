"""One run of one cell: set-up, the measured window, the check, the result.

The harness knows no cell, configuration, traffic mix or per-layer metric
by name.  ``BENCHMARK.json`` names them; each lives in a file of its own:

- a configuration, ``configs/<config>.json`` (the spec's ``file``): its
  system (``systems/<system>.py``), constants, guarantees, the port's entry
  for each path, and the limits of the numbers that decide ``correct``;
- a traffic mix, ``traffic/<traffic>.json``: its driver
  (``drivers/<driver>.py``) and the driver's parameters (a live mix's
  ``trace_s``: the traced run records the window's first so many seconds);
- a per-layer metric, ``metrics/<metric>.py``: a ``read(r)`` of the traced
  window (:class:`Reading`) that returns a number, or None where it finds
  nothing to read.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "jeicyboodsp_tpu", "bench")


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration and traffic."""

    def __init__(self, name, root=ROOT, entry=None):
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))
        if entry is None:
            cells = {w["name"]: w for w in self.spec["workloads"]}
            if name not in cells:
                raise SystemExit(f"unknown workload {name!r}; the spec has {sorted(cells)}")
            entry = cells[name]
        self.name, self.entry = name, entry
        conf = {c["name"]: c["file"] for c in self.spec["configs"]}
        path = conf.get(entry["config"], f"portbench/configs/{entry['config']}.json")
        self.config = load_json(os.path.join(root, path))
        self.traffic = load_json(os.path.join(HERE, "traffic", entry["traffic"] + ".json"))
        self.path = "offline" if self.traffic["driver"] == "files" else "live"

    @classmethod
    def unlisted(cls, config, traffic, root=ROOT):
        """A configuration under a traffic mix that ``BENCHMARK.json`` does not
        list (yet): for readings and tests."""
        name = f"{config}.{traffic}"
        return cls(name, root, {"name": name, "config": config, "traffic": traffic, "chips": 1})

    def end_to_end(self):
        return [m for m in self.spec["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self):
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if self.name in m.get("workloads", [self.name] if m["moves"] in mine else [])]

    def limits(self):
        return self.config["checks"][self.path]


class Reading:
    """What a per-layer reader reads: the :class:`devtrace.Trace` of the
    window, the calls (``files``) or chunks (``live``) started in it, the
    input samples of the work complete in it, and the seconds of the
    harness's spans around each session call (``service_s``)."""

    def __init__(self, trace, calls=0, chunks=0, samples=0, service_s=0.0):
        self.trace, self.calls, self.chunks = trace, calls, chunks
        self.samples, self.service_s = samples, service_s


def reader(name):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_info():
    """The card's name and power limit from nvidia-smi ('' where it has none)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return ""
    return out[0] if out else ""


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's, the JAX package's
    or the old benchmark's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _judge(numbers, limits):
    checks = {}
    for name, lim in limits.items():
        v = numbers[name]
        ok = v >= lim["limit"] if lim["rule"] == ">=" else v <= lim["limit"]
        checks[name] = {"value": v, "limit": lim["limit"], "rule": lim["rule"], "ok": bool(ok)}
    return checks


def run_cell(cell, seed, seconds, trace=False, device="cuda", t_proc0=None, controls=(),
             traffic=None, marks=None, log=sys.stderr):
    """Run ``cell`` once.  Returns (result, checks, extra): the result line's
    keys, the compared numbers with their limits, and the driver's own
    numbers (with each control precision's numbers under ``controls``).
    ``marks`` holds the clock at the end of each set-up stage before this
    call (name: seconds), in order."""
    import numpy as np
    import torch

    from portbench import devtrace
    from portbench.drivers import files as files_driver
    from portbench.drivers import live as live_driver

    t_proc0 = time.perf_counter() if t_proc0 is None else t_proc0
    parts = dict(marks or {})
    traffic = traffic or cell.traffic
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        from jeicyboodsp_tpu_torch.kernels import _build

        torch.set_num_threads(1)  # one process, few threads: no idle pool spinning beside the server

        _build.load_library()
        if _build.build_seconds is not None:
            print(f"[set-up] nvcc built the kernels in {_build.build_seconds:.1f} s", file=log)
    system = importlib.import_module(f"portbench.systems.{cell.config['system']}").System(
        cell.config, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def fence():
        if not on_card:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def wait(ev):
        if ev is not None:
            ev.synchronize()

    extra = {}
    parts["library"] = time.perf_counter()
    if cell.path == "offline":
        items = system.make_items(traffic, gen)
        sync()
        parts["inputs"] = time.perf_counter()
        for it in items:  # every shape the window will use
            system.call(it)
        sync()
    else:
        chunk, n, loop = traffic["chunk_samples"], traffic["streams"], traffic["loop_chunks"]
        streams = system.make_streams(traffic, n, loop * chunk, gen)
        parts["inputs"] = time.perf_counter()
        warm = system.open_session()
        for k in range(traffic["warm_chunks"]):
            a = k % loop * chunk
            system.serve(warm, streams, 0, a, a + chunk)
        del warm
        sessions = [system.open_session() for _ in range(n)]
        served = {i: [0, []] for i in range(n)}  # samples given, outputs
        sync()
    parts["warm-up"] = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU])
        prof.__enter__()
    closed = []

    def close():  # the trace ends with the window, or at the traffic's trace_s into it
        if prof is not None and not closed:
            prof.__exit__(None, None, None)
            closed.append(True)

    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's way; the window's own are still collected
    parts["trace start" if trace else "rest"] = time.perf_counter()
    setup_s = parts[next(reversed(parts))] - t_proc0
    ends = list(parts.values())
    extra["setup_parts_s"] = {k: e - b for k, b, e in zip(parts, [t_proc0] + ends, ends)}
    print("[set-up] " + ", ".join(f"{k} {v:.2f} s" for k, v in extra["setup_parts_s"].items()),
          file=log)
    wall0, clk0 = time.time_ns(), time.perf_counter()

    if cell.path == "offline":
        run = files_driver.run(items, system.call, seconds, seed, fence, wait,
                               traffic["in_flight"], traffic["check_calls"])
        sync()
        e2e = {"samples_per_s": run.samples / seconds, "setup_s": setup_s}
        attempted, failed = run.issued, run.failed
        spans, t_a, t_b = run.spans, run.t0, run.t_end
        started = run.issued
        extra.update(calls_completed=run.completed, samples_completed=run.samples)
    else:
        def serve(i):
            a = served[i][0] // chunk % loop * chunk  # each stream's input loops
            out = system.serve(sessions[i], streams, i, a, a + chunk)
            served[i][0] += chunk
            if out is not None:  # a system keeps the outputs its check follows
                served[i][1].append(out)

        trace_s = min(seconds, traffic.get("trace_s", seconds))
        run = live_driver.run(n, serve, seconds, seed, close_at=trace_s, on_close=close)
        sync()
        e2e = {"live_samples_per_s": chunk * run.completed() / seconds, "setup_s": setup_s}
        attempted, failed = len(run.who), int((~run.ok).sum())
        spans, t_a, t_b = run.spans(), run.t0, run.t0 + trace_s
        started = int((run.start < t_b).sum())
        svc = 1e3 * (run.done - run.start)
        extra.update(streams=n, chunks_served=attempted, chunks_completed=run.completed(),
                     service_ms_p50=float(np.percentile(svc, 50)) if len(svc) else None,
                     service_ms_p95=float(np.percentile(svc, 95)) if len(svc) else None,
                     service_ms_max=float(svc.max()) if len(svc) else None)
    gc.unfreeze()
    result = {"correct": False, "attempted": attempted, "failed": failed}
    breakdown = None
    to_ns = lambda t: wall0 + int((t - clk0) * 1e9)  # noqa: E731
    if prof is not None:
        close()
        tr = devtrace.read(prof.profiler.kineto_results.events(), (to_ns(t_a), to_ns(t_b)),
                           [(n, to_ns(a), to_ns(b)) for n, a, b in spans])
        del prof
        service = sum(min(b, t_b) - a for n, a, b in spans if n == "process" and a < t_b)
        r = Reading(tr, calls=started if cell.path == "offline" else 0,
                    chunks=started if cell.path == "live" else 0,
                    samples=e2e["samples_per_s"] * seconds if cell.path == "offline" else 0,
                    service_s=service)
        metrics = {}
        for m in cell.per_layer():
            v = reader(m["name"])(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end()}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": 1,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev)) if on_card else 0}
    if breakdown is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
    # the check: the program's state goes first, the reference runs after
    t_check = time.perf_counter()
    if cell.path == "offline":
        held = run.held
        del run
        numbers = system.judge_offline(held, seed) if held else None
        ctrl = {p: system.judge_offline(held, seed, p) for p in controls} if held else {}
    else:
        for s in sessions:
            s.state = None
        del sessions, run
        numbers = system.judge_live(streams, served, seed)
        ctrl = {p: system.judge_live(streams, served, seed, p) for p in controls}
    extra["numbers"] = numbers
    extra["check_s"] = time.perf_counter() - t_check
    if ctrl:
        extra["controls"] = {p: _judge(v, cell.limits()) for p, v in ctrl.items()}
    checks = _judge(numbers, cell.limits()) if numbers else {
        "outputs_held": {"value": 0, "limit": 1, "rule": ">=", "ok": False}}
    result.update(correct=bool(all(c["ok"] for c in checks.values()) and failed == 0),
                  metrics=metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, checks, extra


def main(args, t_proc0):
    """The command: exits non-zero with no result line where there is no
    card, too few cards, or a forbidden module once the window has closed."""
    import torch

    marks = {"torch": time.perf_counter()}
    cell = Cell(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s), this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    info = card_info()
    marks["nvidia-smi"] = time.perf_counter()
    print(f"[card] {info} ({torch.cuda.device_count()} devices)", file=sys.stderr)
    result, checks, extra = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                     "cuda", t_proc0, marks=marks)
    bad = forbidden_modules()
    if bad:
        print(f"no result: the process loaded {bad}", file=sys.stderr)
        return 3
    result["device"]["nvidia_smi"] = info
    result["driver"] = extra
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']} {c['rule']} {c['limit']} "
              f"{'ok' if c['ok'] else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
