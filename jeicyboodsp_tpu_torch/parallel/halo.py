"""Halo exchange and sharded associative scans over a time-sharded axis
(counterpart of ``jeicyboodsp_tpu/parallel/halo.py``).

The port's two communication primitives, on a ``torch.distributed`` process
group (a mesh axis's group):

- :func:`left_halo`: each rank receives the trailing ``width`` rows of the
  ranks before it (the overlap-save or STFT history), one
  ``batch_isend_irecv`` per hop;
- :func:`sharded_associative_scan`: an exact inclusive scan of a monoid over
  the block-sharded time axis: a local scan in JAX's grouping, one
  ``all_gather`` of the ranks' totals, the totals of the earlier ranks
  folded in rank order, one combine.

Both run on every rank of the group with the rank's own rows.  int16 and
bool tensors travel as int32 and uint8 (neither gloo nor NCCL carries
int16).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from jeicyboodsp_tpu_torch.utils.scan import associative_scan

_WIRE = {torch.int16: torch.int32, torch.bool: torch.uint8}


def _wire(x):
    return x.to(_WIRE.get(x.dtype, x.dtype)).contiguous()


def axis_info(group):
    """(this rank's index in ``group``, the group's size)."""
    return dist.get_rank(group), dist.get_world_size(group)


def left_halo(x, width: int, group, fill=0):
    """The ``width`` rows just before this rank's rows ``x`` (T_loc, ...) of
    a block-sharded array.  When the halo is wider than a shard the rows
    come from ceil(width / T_loc) ranks to the left, one hop each; rows
    before the global start are ``fill``."""
    t_loc = x.shape[0]
    idx, n = axis_info(group)
    hops = -(-width // t_loc)
    send = _wire(x)
    parts = []
    for h in range(hops, 0, -1):
        recv = torch.empty_like(send)
        ops = []
        if idx + h < n:
            ops.append(dist.P2POp(dist.isend, send, dist.get_global_rank(group, idx + h), group))
        if idx - h >= 0:
            ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, idx - h), group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if idx < h:
            recv.fill_(fill)
        parts.append(recv.to(x.dtype))
    return torch.cat(parts)[-width:]


def all_gather_rows(x, group, dim: int = 0):
    """Every rank's ``x`` concatenated along ``dim`` in rank order, on every
    rank."""
    _, n = axis_info(group)
    w = _wire(x)
    out = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(out, w, group=group)
    return torch.cat(out, dim).to(x.dtype)


def sharded_associative_scan(combine, elems, group, identity):
    """Exact inclusive scan over a block-sharded leading axis.

    combine: the monoid's combine over tuples of tensors batched along dim
    0, the earlier operand on the left; elems: this rank's (T_loc, ...)
    elements; identity: the unbatched identity element.  Returns (inclusive
    (T_loc, ...), shard_exclusive_prefix (1, ...)): the prefix is the
    composition of every element before this rank's first (the identity on
    rank 0)."""
    local = associative_scan(combine, elems)
    idx, n = axis_info(group)
    totals = [all_gather_rows(a[-1:], group) for a in local]  # (n, ...) each
    prefix = tuple(torch.as_tensor(i, device=a.device).to(a.dtype)[None]
                   for i, a in zip(identity, local))
    for i in range(idx):
        prefix = combine(prefix, tuple(t[i:i + 1] for t in totals))
    t_loc = local[0].shape[0]
    spread = tuple(p.expand(t_loc, *p.shape[1:]) for p in prefix)
    return combine(spread, local), prefix
