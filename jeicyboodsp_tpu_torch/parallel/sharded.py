"""Sharded versions of the streaming pipelines over ``torch.distributed``
(counterpart of ``jeicyboodsp_tpu/parallel/sharded.py``).

Each function takes JAX's arguments -- the whole array, a mesh
(:func:`~jeicyboodsp_tpu_torch.parallel.mesh.make_mesh`) and the axis name
-- runs on every rank of the mesh, and returns on every rank the whole
result and the write mask JAX returns.  Each rank takes its own rows of the
array and runs the path's ``*_local`` body, a function of the rank's rows
and the axis's process group that a caller already holding shards can call
itself; the results are gathered at the end.  The sequential state of each
pipeline was reformulated in ``ops`` as bounded halos and associative
prefixes, so the sharded forms equal the unsharded ops (exactly where no
prefix regroups a float sum):

- stream-parallel, no collective but the gather: :func:`nlms_sharded` (K8,
  either instance), :func:`bnlms_sharded` (the exact gate and K9), and
  :func:`data_parallel_sharding`, the rank's rows of a batch;
- time-sharded: :func:`fastconv_sharded` (a 7-block halo),
  :func:`enhance_sharded` and :func:`enhance_sharded2d` (a 2-block halo,
  the run-length and noise-affine scans, the leading frame recomputed for
  the first overlap-add tail; the VAD in f32 is K14), :func:`mvdr_sharded`
  (a 1-block halo, the prefix-summed 2x2 covariance),
  :func:`bnlms_sharded_time` (a 1-block halo, the affine scan, the
  exclusive shift by a second halo) and :func:`geq_sharded` (a 2-sample
  halo per band);
- all-reduce: :func:`mvdr_sharded_bins` (bins over the ``model`` axis, two
  all-reduces) and :func:`em_step_sharded` (the EM sums).

A path given no mesh raises: nothing runs silently on one process.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from jeicyboodsp_tpu_torch.models import gmm as GM
from jeicyboodsp_tpu_torch.ops import dft as D
from jeicyboodsp_tpu_torch.ops import enhance as E
from jeicyboodsp_tpu_torch.ops import fastconv as FC
from jeicyboodsp_tpu_torch.ops import geq as G
from jeicyboodsp_tpu_torch.ops import mvdr as MV
from jeicyboodsp_tpu_torch.ops import nlms as NL
from jeicyboodsp_tpu_torch.parallel.halo import (
    all_gather_rows, axis_info, left_halo, sharded_associative_scan,
)
from jeicyboodsp_tpu_torch.utils.cnum import c_short
from jeicyboodsp_tpu_torch.utils.scan import associative_scan


def axis_group(mesh, axis: str):
    """The process group of ``mesh``'s axis ``axis``; raises without a mesh."""
    if mesh is None or not dist.is_initialized():
        raise RuntimeError("a sharded path needs a mesh of an initialised process group")
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r} (axes {names})")
    return mesh.get_group(names.index(axis))


def _device(mesh):
    return torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda" \
        else torch.device(mesh.device_type)


def _tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _rows(x, group, mesh, dim: int = 0):
    """This rank's equal share of ``x`` along ``dim``, on the mesh's device."""
    idx, n = axis_info(group)
    x = _tensor(x)
    if x.shape[dim] % n:
        raise ValueError(f"{x.shape[dim]} rows do not split over {n} ranks")
    k = x.shape[dim] // n
    return x.narrow(dim, idx * k, k).contiguous().to(_device(mesh))


def _global_index(t_loc: int, group, device):
    idx, _ = axis_info(group)
    return idx * t_loc + torch.arange(t_loc, device=device)


# ---------------------------------------------------------------- stream-parallel


def nlms_local(xl, rl, dtype=torch.float64, compat: bool = True):
    """A rank's (B_loc, N) sessions of per-sample NLMS from zero state (K8)."""
    st = {k: v.expand(xl.shape[0], *v.shape).contiguous()
          for k, v in NL.nlms_init_state(dtype).items()}
    est, err, _ = NL.nlms_apply(xl, rl, st, dtype=dtype, compat=compat)
    return est, err


def nlms_sharded(x, ref, mesh, dtype=torch.float64, axis: str = "data", compat: bool = True):
    """Stream-parallel per-sample NLMS: (B, N) int16 far/near signals, the B
    sessions split over ``axis`` (each is an independent recursion,
    NormalLMS.cpp:96-130).  Returns (est, err) (B, N) int16."""
    g = axis_group(mesh, axis)
    est, err = nlms_local(_rows(x, g, mesh), _rows(ref, g, mesh), dtype, compat)
    return all_gather_rows(est, g), all_gather_rows(err, g)


def bnlms_local(xl, rl, dtype=torch.float64):
    """A rank's (B_loc, T, 1024) BNLMS sessions from zero state (the exact
    gate, then K9)."""
    st = {k: v.expand(xl.shape[0], *v.shape).contiguous()
          for k, v in NL.bnlms_init_state(dtype).items()}
    est, err, _ = NL.bnlms_apply(xl, rl, st, dtype=dtype)
    return est, err


def bnlms_sharded(x_blocks, ref_blocks, mesh, dtype=torch.float64, axis: str = "data"):
    """Stream-parallel BNLMS: (B, T, 1024) far/near blocks, the B sessions
    split over ``axis`` with no collective but the gather; equal to
    ``ops.nlms.bnlms_apply`` of the batch.  Returns (est, err) (B, T, 1024)."""
    g = axis_group(mesh, axis)
    est, err = bnlms_local(_rows(x_blocks, g, mesh), _rows(ref_blocks, g, mesh), dtype)
    return all_gather_rows(est, g), all_gather_rows(err, g)


@dataclass(frozen=True)
class DataParallel:
    """The rank's share of a batch split over a data axis: :meth:`local`
    takes the rank's rows of an array, :meth:`gather` puts the ranks' rows
    back together on every rank (what JAX's ``NamedSharding(mesh, P(axis))``
    does to a batch)."""

    mesh: object
    group: object

    def local(self, x):
        return _rows(x, self.group, self.mesh)

    def gather(self, y):
        return all_gather_rows(y, self.group)


def data_parallel_sharding(mesh, axis: str = "data"):
    """A :class:`DataParallel` that splits a leading batch axis over ``axis``."""
    return DataParallel(mesh, axis_group(mesh, axis))


# ---------------------------------------------------------------- time-sharded


def fastconv_local(local, H, group, dtype=torch.float64):
    """A rank's (T_loc, 1024) blocks -> (out (T_loc, 1024) int16, mask)."""
    t_loc = local.shape[0]
    gidx = _global_index(t_loc, group, local.device)
    keep = gidx >= FC.WARMUP_BLOCKS
    local_eff = torch.where(keep[:, None], local, torch.zeros_like(local))
    halo = left_halo(local_eff, FC.WARMUP_BLOCKS, group)
    ext = torch.cat([halo, local_eff]).to(dtype)
    segs = torch.cat([ext[i:i + t_loc] for i in range(FC.WARMUP_BLOCKS + 1)], 1)
    ctype = torch.complex128 if dtype == torch.float64 else torch.complex64
    y = torch.fft.ifft(torch.fft.fft(segs.to(ctype)) * H.to(ctype)).real
    out = c_short(y[:, FC.FILTER_LENGTH - 1:])
    return torch.where(keep[:, None], out, torch.zeros_like(out)), keep


def fastconv_sharded(blocks, Hr, Hi, mesh, dtype=torch.float64, axis: str = "time"):
    """(T, 1024) int16 -> ((T, 1024) int16, mask (t >= 7)): all T rows with a
    validity mask, so the sharding stays uniform (``ops.fastconv`` drops the
    warm-up rows)."""
    g = axis_group(mesh, axis)
    local = _rows(blocks, g, mesh)
    H = torch.complex(torch.as_tensor(np.asarray(Hr)), torch.as_tensor(np.asarray(Hi)))
    out, mask = fastconv_local(local, H.to(local.device), g, dtype)
    return all_gather_rows(out, g), all_gather_rows(mask, g)


def enhance_local(local, group, mode: str = "wiener", dtype=torch.float64):
    """A rank's (T_loc, ..., 512) blocks, time first (any batch axes after
    it) -> (out of the same shape int16, write mask (T_loc,))."""
    t_loc = local.shape[0]
    gidx = _global_index(t_loc, group, local.device)
    ext = torch.cat([left_halo(local, 2, group), local])  # x[t0-2], x[t0-1], then the shard
    X = E.frame_transform(torch.cat([ext[1:-1], ext[2:]], -1), dtype)
    speech = E.vad_flags(local, dtype)
    noise = ~speech
    batch = noise.shape[1:]
    (cnt, _), _ = sharded_associative_scan(
        E.runlen_combine, (noise.to(torch.int32), noise), group,
        (torch.zeros(batch, dtype=torch.int32), torch.ones(batch, dtype=torch.bool)))
    elems = E.noise_affine_elements(speech, cnt, X.abs())
    nb = X.shape[-1]
    rdt = elems[0].dtype
    ident = (torch.ones(batch, dtype=rdt), torch.zeros(*batch, nb, dtype=rdt),
             torch.zeros(batch, dtype=torch.bool), torch.zeros(batch, dtype=rdt),
             torch.zeros(*batch, nb, dtype=rdt))
    (_, _, s_, _, bh_), (_, _, ps, _, pbh) = sharded_associative_scan(
        E.noise_affine_combine, elems, group, ident)
    y = E.gain_and_resynth(X, E.latched_from_composed(s_, bh_), mode)
    # the leading frame (global t0 - 1) for the first local block's overlap-add tail
    X_lead = E.frame_transform(torch.cat([ext[0], ext[1]], -1)[None], dtype)
    y_lead = E.gain_and_resynth(X_lead, E.latched_from_composed(ps, pbh), mode)
    head = y[..., :E.BLOCK_LEN]
    tails = torch.cat([y_lead[..., E.BLOCK_LEN:], y[:-1, ..., E.BLOCK_LEN:]])
    shape = (t_loc,) + (1,) * (y.dim() - 1)
    valid, use_tail = (gidx >= 1).reshape(shape), (gidx >= 2).reshape(shape)
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    ola = torch.where(valid, head + torch.where(use_tail, tails, zero), zero)
    out = torch.where(use_tail, c_short(ola), torch.zeros((), dtype=torch.int16,
                                                          device=y.device))
    return out, gidx >= 2


def enhance_sharded(blocks, mesh, mode: str = "wiener", dtype=torch.float64, axis: str = "time"):
    """(T, 512) int16 (T divisible by the axis size) -> (out, write_mask),
    equal to ``ops.enhance.enhance_blocks`` up to the prefix's regrouped
    sums (one int16 step on few samples)."""
    g = axis_group(mesh, axis)
    out, mask = enhance_local(_rows(blocks, g, mesh), g, mode, dtype)
    return all_gather_rows(out, g), all_gather_rows(mask, g)


def enhance_sharded2d(blocks, mesh, mode: str = "wiener", dtype=torch.float32,
                      batch_axis: str = "data", time_axis: str = "time"):
    """(B, T, 512) int16 over a (data x time) mesh -> (out (B, T, 512),
    write_mask (B, T)): streams split over ``batch_axis`` with no
    communication, each stream's time axis over ``time_axis`` as
    :func:`enhance_sharded`."""
    gb, gt = axis_group(mesh, batch_axis), axis_group(mesh, time_axis)
    local = _rows(_rows(blocks, gb, mesh), gt, mesh, dim=1)  # (B_loc, T_loc, 512)
    out, mask = enhance_local(local.transpose(0, 1), gt, mode, dtype)
    out = out.transpose(0, 1).contiguous()
    mask = mask[None].expand(local.shape[0], -1).contiguous()
    out = all_gather_rows(all_gather_rows(out, gt, dim=1), gb)
    return out, all_gather_rows(all_gather_rows(mask, gt, dim=1), gb)


def mvdr_local(local_l, local_r, group, d_time=0.0, dtype=torch.float64):
    """A rank's (T_loc, 512) blocks of each channel -> (out int16, mask):
    ``ops.mvdr``'s stages with the previous block from a 1-block halo and
    the covariance's prefix sum across ranks."""
    t_loc = local_l.shape[0]
    gidx = _global_index(t_loc, group, local_l.device)
    ctype = torch.complex128 if dtype == torch.float64 else torch.complex64
    prev_l = torch.cat([left_halo(local_l, 1, group), local_l[:-1]])
    prev_r = torch.cat([left_halo(local_r, 1, group), local_r[:-1]])
    noise = ~MV.vad_energy_flags(local_l, dtype)
    (cnt, _), _ = sharded_associative_scan(
        E.runlen_combine, (noise.to(torch.int32), noise), group,
        (torch.zeros((), dtype=torch.int32), torch.ones((), dtype=torch.bool)))
    accumulate = noise & (cnt >= 2)
    Lfr, Lfi = MV._spectrum(torch.cat([prev_l, local_l], 1).to(dtype), ctype, "xla")
    Rfr, Rfi = MV._spectrum(torch.cat([prev_r, local_r], 1).to(dtype), ctype, "xla")
    contrib = MV.covariance_terms(Lfr, Lfi, Rfr, Rfi) * accumulate[:, None].to(dtype)
    (R,), _ = sharded_associative_scan(lambda l, r: (l[0] + r[0],), (contrib,), group,
                                       (torch.zeros(4, dtype=dtype),))
    w0, w1 = MV.mvdr_weights(R, torch.arange(MV.FFT_LEN, device=local_l.device), d_time, dtype)
    Lr, Li = MV._spectrum(MV.analysis_frames(prev_l, local_l, dtype), ctype, "xla")
    Rr, Ri = MV._spectrum(MV.analysis_frames(prev_r, local_r, dtype), ctype, "xla")
    y = torch.fft.ifft(torch.complex(*MV.beamform(Lr, Li, Rr, Ri, w0, w1))).real
    return c_short(y[:, MV.KEEP_LEN:MV.KEEP_LEN + MV.BLOCK_LEN]), gidx >= 1


def mvdr_sharded(blocks_l, blocks_r, mesh, d_time=0.0, dtype=torch.float64, axis: str = "time"):
    """Time-sharded MVDR, equal to ``ops.mvdr.mvdr_blocks`` up to the prefix
    sum's regrouping."""
    g = axis_group(mesh, axis)
    out, mask = mvdr_local(_rows(blocks_l, g, mesh), _rows(blocks_r, g, mesh), g, d_time, dtype)
    return all_gather_rows(out, g), all_gather_rows(mask, g)


def bnlms_time_local(xl, rl, group, dtype=torch.float32):
    """A rank's (T_loc, 1024) blocks of ONE session -> (est, err) int16."""
    prev_x = left_halo(xl, 1, group)[0]  # the previous block (zeros on the first rank)
    prev_r = left_halo(rl, 1, group)[0]
    A, v, W, _ = NL.bnlms_affine_elements(xl, rl, dtype=dtype, keep_in=prev_x, keep_ref=prev_r)
    ident = (torch.eye(NL.BNLMS_TAPS, dtype=dtype), torch.zeros(NL.BNLMS_TAPS, dtype=dtype))
    (_, v_incl), _ = sharded_associative_scan(NL.affine_combine, (A, v), group, ident)
    # c before block b is the exclusive prefix: the inclusive scan shifted one row, across ranks
    c = torch.cat([left_halo(v_incl, 1, group, fill=0), v_incl[:-1]])
    return NL._timeparallel_out(W, c, rl)


def bnlms_sharded_time(x_blocks, ref_blocks, mesh, dtype=torch.float32, axis: str = "time"):
    """Time-sharded BNLMS: one session's (T, 1024) blocks split over ``axis``
    (``ops.nlms.bnlms_affine_elements``' affine scan across ranks), equal to
    ``bnlms_apply_timeparallel`` up to the regrouped f32 sums.  Returns
    (est, err) (T, 1024) int16."""
    g = axis_group(mesh, axis)
    est, err = bnlms_time_local(_rows(x_blocks, g, mesh), _rows(ref_blocks, g, mesh), g, dtype)
    return all_gather_rows(est, g), all_gather_rows(err, g)


def geq_local(xl, b, a, group, dtype=torch.float64):
    """A rank's (N_loc,) samples of the linear 7-band cascade."""
    y = xl.to(dtype)
    b = torch.as_tensor(np.asarray(b), device=y.device).to(dtype)
    a = torch.as_tensor(np.asarray(a), device=y.device).to(dtype)
    ident = (torch.eye(2, dtype=dtype), torch.zeros(1, 2, dtype=dtype))
    for k in range(G.TOTAL_BANDS):
        halo = left_halo(y[:, None], 2, group)[:, 0]  # y[t0-2], y[t0-1]
        y1 = torch.cat([halo[1:], y[:-1]])
        y2 = torch.cat([halo, y[:-2]])[: y.shape[0]]
        f = G.biquad_fir(y, y1, y2, b[k, 0], b[k, 1], b[k, 2])
        (_, s), _ = sharded_associative_scan(
            G.state_space_combine, G.biquad_elements(f[:, None], a[k, 1], a[k, 2]), group, ident)
        y = s[:, 0, 0]
    return y


def geq_sharded(x, b, a, mesh, dtype=torch.float64, axis: str = "time"):
    """Time-sharded fast-mode 7-band GEQ: per band the affine 2x2 scan across
    ranks and a 2-sample halo for the FIR taps; equal to
    ``ops.geq.geq_apply_fast`` up to the regrouped sums (its f32 form
    overflows at the 44 Hz shelf's pole on long signals, as the unsharded
    one).  x: (N,) samples, N divisible by the axis size."""
    g = axis_group(mesh, axis)
    return all_gather_rows(geq_local(_rows(x, g, mesh), b, a, g, dtype), g)


# ---------------------------------------------------------------- all-reduce


def _bin_mats(n: int):
    """Full-bin forward (n, n) cos/sin and inverse real-part matrices."""
    Ch, Sh = D._rdft_mats(n)
    C = np.concatenate([Ch, Ch[:, -2:0:-1]], axis=1)  # cos even under k -> n - k
    S = np.concatenate([Sh, -Sh[:, -2:0:-1]], axis=1)
    IC, IS = D._icdft_real_mats(n)
    return C, S, IC, IS


def mvdr_bins_local(bl, br, mats, bins, group, d_time=0.0):
    """Replicated (T, 512) blocks and this rank's bins (column slices of the
    forward matrices, row slices of the inverse ones, their indices) ->
    (out (T, 512) int16, mask), through two all-reduces: ``ops.mvdr``'s
    stages on this rank's bins."""
    Cl, Sl, ICl, ISl = mats
    dtype = torch.float32
    noise = ~MV.vad_energy_flags(bl, dtype)
    cnt, _ = associative_scan(E.runlen_combine, (noise.to(torch.int32), noise))
    accumulate = noise & (cnt >= 2)
    prev_l, prev_r = MV.previous_blocks(bl), MV.previous_blocks(br)
    pairs_l = torch.cat([prev_l, bl], 1).to(dtype)
    pairs_r = torch.cat([prev_r, br], 1).to(dtype)
    parts = MV.covariance_terms(pairs_l @ Cl, pairs_l @ Sl, pairs_r @ Cl, pairs_r @ Sl)
    dist.all_reduce(parts, group=group)  # the column-parallel stage's sum over bins
    R = torch.cumsum(parts * accumulate[:, None].to(dtype), 0)
    w0, w1 = MV.mvdr_weights(R, bins, d_time, dtype)
    frame_l, frame_r = MV.analysis_frames(prev_l, bl, dtype), MV.analysis_frames(prev_r, br, dtype)
    re, im = MV.beamform(frame_l @ Cl, frame_l @ Sl, frame_r @ Cl, frame_r @ Sl, w0, w1)
    y = re @ ICl - im @ ISl
    dist.all_reduce(y, group=group)  # the row-parallel inverse's partial signals
    out = c_short(y[:, MV.KEEP_LEN:MV.KEEP_LEN + MV.BLOCK_LEN])
    return out, torch.arange(bl.shape[0], device=bl.device) >= 1


def mvdr_sharded_bins(blocks_l, blocks_r, mesh, d_time=0.0, axis: str = "model"):
    """Frequency-bin tensor-parallel MVDR in f32: the 1024 bins split over
    ``axis``, the forward DFT column-parallel, the covariance's sum over bins
    and the row-parallel inverse each one all-reduce.  Equal to
    ``ops.mvdr.mvdr_blocks(fft_engine="mxu3")`` up to f32 rounding."""
    g = axis_group(mesh, axis)
    bl, br = (_tensor(v).to(_device(mesh)) for v in (blocks_l, blocks_r))
    C, S, IC, IS = (torch.from_numpy(np.ascontiguousarray(m)).float() for m in
                    _bin_mats(MV.FFT_LEN))
    mats = (_rows(C, g, mesh, dim=1), _rows(S, g, mesh, dim=1), _rows(IC, g, mesh),
            _rows(IS, g, mesh))
    bins = _rows(torch.arange(MV.FFT_LEN), g, mesh)
    return mvdr_bins_local(bl, br, mats, bins, g, d_time)


def em_step_local(f_loc, m_loc, alpha, mean, cov, group):
    """One compat EM iteration over a rank's frames f_loc (..., N_loc, 12)
    and mask (..., N_loc), any leading class axes; the sufficient statistics
    are summed over the group (all-reduce)."""
    w = GM._mixture_probs(f_loc, mean, cov) * alpha[..., None, :]
    w = w / w.sum(-1, keepdim=True)
    w = torch.where(m_loc[..., None], w, torch.zeros((), dtype=w.dtype, device=w.device))
    n = m_loc.sum(-1).to(f_loc.dtype)
    sums = [n, w.sum(-2), w.transpose(-1, -2) @ f_loc]
    for s in sums:
        dist.all_reduce(s, group=group)
    n, w_sum, wx = sums
    n_of_key = alpha + w_sum
    alpha_new = n_of_key / n[..., None]
    mean_new = (mean + wx) / n_of_key[..., None]
    diff = f_loc[..., :, None, :] - mean_new[..., None, :, :]
    scatter = torch.einsum("...nk,...nki,...nkj->...kij", w, diff, diff)
    dist.all_reduce(scatter, group=group)
    return alpha_new, mean_new, scatter / n_of_key[..., None, None]


def em_step_sharded(frames, mask, alpha, mean, cov, mesh, axis: str = "data"):
    """One compat EM iteration with the frames split over ``axis``: the
    responsibilities local, the M-step sums all-reduced.  Equal to
    ``models.gmm.em_step`` up to summation order; every rank returns the
    new (alpha, mean, cov)."""
    g = axis_group(mesh, axis)
    rep = [_tensor(v).to(_device(mesh)) for v in (alpha, mean, cov)]
    return em_step_local(_rows(frames, g, mesh), _rows(mask, g, mesh), *rep, g)
