"""The port's own spans in the traced window, and the idle gaps named by them.

The port records spans (``jeicyboodsp_tpu_torch.utils.metrics.REGISTRY``:
``stage``, ``copy`` and ``wait`` intervals of its sessions and ops, on the
host's ``perf_counter_ns`` clock) while a ``torch.profiler`` records, so a
traced run's window holds them and an untraced run records none.  The
per-layer readers ``metrics/{copy,wait,issue}_ms.*``, ``syncs_per_chunk.live``
read them through :func:`trees`; a checkout whose port records no spans
gives them nothing to read (None).

:func:`split_gaps` names each idle gap of the device trace as
``devtrace.read`` does, with the innermost program span running at the
gap's middle put between the harness's span and the runtime call:
``process > nlms.state_out: host``.  Run as a program, it runs one traced
cell and prints that split after the result line:

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict

import numpy as np

TOP = 24


def recorded():
    """The port's spans recorded so far (``Span`` objects, start order), or
    None where the port records none."""
    try:
        from jeicyboodsp_tpu_torch.utils.metrics import REGISTRY
    except ImportError:
        return None
    get = getattr(REGISTRY, "spans", None)
    return get() if callable(get) else None


def trees(root, n):
    """The last ``n`` recorded trees whose root span is named ``root``
    (the calls or chunks started in the traced window, the latest the
    port recorded): [(root span, [its descendants])], or None where there
    is none."""
    spans = recorded()
    if not spans or n <= 0:
        return None
    top = []
    for i, s in enumerate(spans):
        top.append(i if s.parent < 0 else top[s.parent])
    picked = [i for i, s in enumerate(spans)
              if s.parent < 0 and s.name == root and s.end_ns is not None][-n:]
    if not picked:
        return None
    kids = {i: [] for i in picked}
    for i, s in enumerate(spans):
        if top[i] in kids and i != top[i] and s.end_ns is not None:
            kids[top[i]].append(s)
    return [(spans[i], kids[i]) for i in picked]


def per_tree_ms(root, n, kinds):
    """The mean over :func:`trees` of the summed ``kinds`` spans, in ms."""
    ts = trees(root, n)
    if ts is None:
        return None
    return sum(s.end_ns - s.start_ns for _, kids in ts for s in kids if s.kind in kinds) \
        / 1e6 / len(ts)


def _union_ns(intervals):
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def self_ms(root, n, kinds=("copy", "wait")):
    """The mean over :func:`trees` of the root's time outside the union of
    its ``kinds`` spans, in ms: the host's own time in the call."""
    ts = trees(root, n)
    if ts is None:
        return None
    return sum((r.end_ns - r.start_ns) - _union_ns([(s.start_ns, s.end_ns) for s in kids
                                                    if s.kind in kinds])
               for r, kids in ts) / 1e6 / len(ts)


def count_per_tree(root, n, kinds, drains=True):
    """The mean over :func:`trees` of the number of ``kinds`` spans, with
    the waits that recording itself adds (``REGISTRY.drain``, a name ending
    in ``.drain``) left out unless ``drains``."""
    ts = trees(root, n)
    if ts is None:
        return None
    return sum(1 for _, kids in ts for s in kids
               if s.kind in kinds and (drains or not s.name.endswith(".drain"))) / len(ts)


# ------------------------------------------------------------ idle gaps


def innermost(spans_ns, t):
    """For each time of sorted ``t``, the name of the deepest span of
    ``spans_ns`` = [(name, start, end)] running then (None outside them).
    The spans nest: each lies inside any span that runs at its start."""
    o = sorted(range(len(spans_ns)), key=lambda k: (spans_ns[k][1], -spans_ns[k][2]))
    stack, out, j = [], [], 0
    for x in t:
        while j < len(o) and spans_ns[o[j]][1] <= x:
            stack.append(spans_ns[o[j]])
            j += 1
        while stack and stack[-1][2] <= x:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


def split_gaps(events, window_ns, spans_ns, program_ns):
    """The idle gaps of ``devtrace.read(events, window_ns, spans_ns)``, all
    of them ([name, seconds], largest first), each name with the innermost
    of ``program_ns`` = [(name, start_ns, end_ns)] on the trace's clock
    running at the gap's middle: ``<harness span> > <program span>: <call>``,
    or ``devtrace.read``'s own name where none runs."""
    from torch.autograd import DeviceType

    from portbench import devtrace

    a, b = window_ns
    dev_s, dev_e, rt = [], [], []
    for ev in events:
        k = devtrace._kind(ev, DeviceType.CUDA)
        if k == "device":
            dev_s.append(ev.start_ns())
            dev_e.append(ev.start_ns() + ev.duration_ns())
        elif k == "runtime":
            rt.append((ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    dev_s, dev_e = np.array(dev_s, np.int64), np.array(dev_e, np.int64)
    cs, ce = np.clip(dev_s, a, b), np.clip(dev_e, a, b)
    keep = ce > cs
    us, ue = devtrace._union(cs[keep], ce[keep])
    gs = np.concatenate([[a], ue])
    ge = np.concatenate([us, [b]])
    g = ge > gs
    gs, ge = gs[g], ge[g]
    mid = (gs + ge) // 2
    def names_at(triples):
        return devtrace._names_at([x[0] for x in triples],
                                  np.array([x[1] for x in triples], np.int64),
                                  np.array([x[2] for x in triples], np.int64), mid)

    host, call = names_at(spans_ns), names_at(rt)
    prog = innermost(program_ns, mid.tolist())
    per_gap = defaultdict(int)
    for h, p, r, d in zip(host, prog, call, (ge - gs).tolist()):
        per_gap[f"{h or 'idle'}{' > ' + p if p else ''}: {r or 'host'}"] += d
    return sorted(([n, v / 1e9] for n, v in per_gap.items()), key=lambda x: -x[1])


def named_shares(gaps):
    """For each of ``devtrace.read``'s gap names (``<harness span>: <call>``)
    in ``gaps``, its seconds and the share of them a program span names."""
    out = defaultdict(lambda: [0.0, 0.0])
    for name, s in gaps:
        head, _, call = name.rpartition(": ")
        span, _, prog = head.partition(" > ")
        out[f"{span}: {call}"][0] += s
        out[f"{span}: {call}"][1] += s if prog else 0.0
    return {k: {"seconds": v[0], "named_pct": 100.0 * v[1] / v[0] if v[0] else 0.0}
            for k, v in sorted(out.items(), key=lambda kv: -kv[1][0])}


def main(argv=None):
    """One traced run of a cell, as ``portbench.run`` makes it, then one more
    line: the idle gaps split by the program's spans, the shares of the
    unsplit names that a program span names, and the spans a root holds."""
    from portbench.run import T_PROC0, cache_env, parse

    args = parse(argv)
    args.trace = 1
    cache_env()
    from portbench import devtrace, harness

    kept = {}
    read = devtrace.read

    def read_and_keep(events, window_ns, spans_ns):
        kept.update(events=list(events), window=window_ns, spans=spans_ns)
        return read(kept["events"], window_ns, spans_ns)

    devtrace.read = read_and_keep
    try:
        rc = harness.main(args, T_PROC0)
    finally:
        devtrace.read = read
    sys.stdout.flush()
    if rc or not kept:
        return rc
    from jeicyboodsp_tpu_torch.utils.metrics import clock_offset_ns

    off = clock_offset_ns()
    spans = [s for s in recorded() or [] if s.end_ns is not None]
    prog = [(s.name, s.start_ns + off, s.end_ns + off) for s in spans]
    gaps = split_gaps(kept["events"], kept["window"], kept["spans"], prog)
    counts = defaultdict(int)
    for s in spans:
        counts[f"{s.name} ({s.kind})"] += 1
    roots = sum(1 for s in spans if s.parent < 0)
    print(json.dumps({"program_gaps": gaps[:TOP], "named": named_shares(gaps),
                      "roots": roots, "spans_per_root": {k: v / max(roots, 1)
                                                         for k, v in counts.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
