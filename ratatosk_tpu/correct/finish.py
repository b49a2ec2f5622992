"""Device-side finish statistics: banded target×path DP + acceptance.

Per-region host work after the beam returns used to dominate the
steady-state wall: a full NumPy DP matrix per open region
(engine._finish_open), an SHW trim per failed region (engine._record_partial),
and one device->host transfer per result field (each with its own fixed
latency). This module moves all of it onto the device as ONE jitted kernel
chained on the beam output (reference shape: the per-read tail of
correctSequence, Correction.cpp:727-958, and the generateConsensus trims,
Alignment.cpp:309-470):

- a banded edit DP of the raw target (rows) against the winning path (cols),
  carried as one W-wide row exactly like the beam's band (correct/beam.py),
  yielding per-target-prefix minima `dmin[i]` and max-tie end columns
  `endcol[i]`;
- open-region acceptance (engine's X-drop-style prefix rule): full-target
  SHW trim first, else the best (matched - 2*edits) prefix, gated by the
  region's certified base qualities — all argmax/cumsum ops;
- partial-path trims for failed closed regions: dist = dmin[best_end],
  cut = endcol[best_end];
- the winner's path packed 16 codes/word so the whole finish ships as TWO
  device->host transfers per launch (scalars + packed paths) instead of
  O(fields + regions).

Everything is static-shape per (R, NT, W, LMAX) bucket, so each bucket
compiles once and the while_loop-free scan pipelines behind the next bucket's
beam search.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

BIG = jnp.int32(1 << 20)


class FinishOut(NamedTuple):
    """Per-region finish decisions; every field is [R] (one transfer)."""

    scalars: jnp.ndarray    # int32 [R, 11]; see SCALAR_FIELDS
    seq_packed: jnp.ndarray  # int32 [R, ceil(L/16)] 2-bit-packed best path


SCALAR_FIELDS = (
    "best_len", "best_dist", "best_end", "second_dist", "completed",
    "istar", "jend_open", "s1_open_m", "ok_open",
    "pdist", "pjend",
)
_M = 1_000_000  # fixed-point scale for fractional scalars


def pack_codes(seq: jnp.ndarray) -> jnp.ndarray:
    """uint8 2-bit codes [R, L] -> int32 [R, ceil(L/16)] (16 codes/word)."""
    R, L = seq.shape
    Lp = -(-L // 16) * 16
    s = jnp.pad(seq, ((0, 0), (0, Lp - L))).astype(jnp.int32)
    s = s.reshape(R, Lp // 16, 16)
    sh = (2 * jnp.arange(16, dtype=jnp.int32))[None, None, :]
    return (s << sh).sum(axis=-1).astype(jnp.int32)


def unpack_codes(packed, L: int):
    """NumPy-side unpack: int32 [R, W] -> uint8 [R, L]."""
    import numpy as np
    p = np.asarray(packed).astype(np.uint32)
    R, Wn = p.shape
    sh = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    codes = ((p[:, :, None] >> sh) & 3).astype(np.uint8)
    return codes.reshape(R, Wn * 16)[:, :L]


def _window_start(i, seq_len, l1: int, w: int):
    """Band window start over path columns at target row i (per region)."""
    if w >= l1:
        return jnp.zeros(seq_len.shape, jnp.int32)
    hi = jnp.maximum(seq_len + 1 - w, 0)
    return jnp.clip(i - w // 2, 0, hi).astype(jnp.int32)


def _banded_prefix_scan(tgt_masks, tgt_len, seq_codes, seq_len, w: int):
    """Banded DP rows of target (query) vs path (target-of-DP).

    Returns (dmin [R, NT+1], endcol [R, NT+1]): per-target-prefix minimum
    edit distance over path-prefix columns <= seq_len, and the max tie
    column. Row semantics match ops/cigar.dp_matrix(tgt, seq, NW).
    """
    R, NT = tgt_masks.shape
    L = seq_codes.shape[1]
    l1 = L + 1
    W = l1 if w <= 0 or w >= l1 else w
    seq_masks = (jnp.int32(1) << jnp.clip(seq_codes.astype(jnp.int32), 0, 3))
    # column j compares against seq[j-1]; pad col 0 with mask 0
    padded = jnp.pad(seq_masks, ((0, 0), (1, 0)))             # [R, L+1]

    cols0 = jnp.arange(W, dtype=jnp.int32)[None, :]           # window offsets

    def stats(row, ws, i_val):
        cols = ws[:, None] + cols0
        valid = cols <= seq_len[:, None]
        masked = jnp.where(valid, row, BIG)
        dmin = jnp.min(masked, axis=1)
        is_min = masked == dmin[:, None]
        endc = jnp.max(jnp.where(is_min, cols, -1), axis=1)
        return dmin, endc

    ws0 = _window_start(jnp.int32(0), seq_len, l1, W)
    row0 = ws0[:, None] + cols0                                # E[0][j] = j
    btgt0 = jnp.take_along_axis(
        jnp.broadcast_to(padded, (R, l1)), jnp.minimum(ws0[:, None] + cols0, L),
        axis=1)
    d0, e0 = stats(row0, ws0, 0)

    jcol = jax.lax.broadcasted_iota(jnp.int32, padded.shape, 1)

    def step(carry, i):
        row, btgt, ws = carry          # row at window ws(i-1)
        ws_next = _window_start(i, seq_len, l1, W)
        delta = (ws_next - ws)[:, None]
        # advance carried seq-mask window by the newly-exposed column
        fetch = jnp.minimum(ws_next + (W - 1), L)[:, None]
        newcol = jnp.sum(jnp.where(jcol == fetch, padded, 0),
                         axis=1, keepdims=True).astype(btgt.dtype)
        shifted = jnp.concatenate([btgt[:, 1:], newcol], axis=1)
        btgt_n = jnp.where(delta == 1, shifted, btgt)
        shiftL = jnp.concatenate([row[:, 1:], jnp.full_like(row[:, :1], BIG)],
                                 axis=1)
        shiftR = jnp.concatenate([jnp.full_like(row[:, :1], BIG), row[:, :-1]],
                                 axis=1)
        prev_j = jnp.where(delta == 1, shiftL, row)
        prev_jm1 = jnp.where(delta == 1, row, shiftR)
        amask = tgt_masks[:, jnp.minimum(i - 1, NT - 1)]
        sub = ((amask[:, None].astype(jnp.int32) & btgt_n) == 0).astype(jnp.int32)
        cols = ws_next[:, None] + cols0
        d = jnp.minimum(prev_jm1 + sub, prev_j + 1)
        d = jnp.where(cols == 0, i, d)
        e = cols + jax.lax.cummin(d - cols, axis=1)
        e = jnp.minimum(e, BIG)
        dmin, endc = stats(e, ws_next, i)
        return (e, btgt_n, ws_next), (dmin, endc)

    (_, _, _), (dmins, endcs) = jax.lax.scan(
        step, (row0, btgt0, ws0), jnp.arange(1, NT + 1, dtype=jnp.int32))
    dmin = jnp.concatenate([d0[None], dmins], axis=0).T       # [R, NT+1]
    endcol = jnp.concatenate([e0[None], endcs], axis=0).T
    return dmin.astype(jnp.int32), endcol.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("w", "min_score_open"))
def finish_bundle(tgt_masks, tgt_len, tgt_qual, qv_max, min_k, res, *,
                  w: int, min_score_open: float) -> FinishOut:
    """Chain after beam_search: all finish decisions in one device pass.

    tgt_qual: int32 [R, NT] clipped linear qualities (q - 33, 0 when absent);
    qv_max, min_k: int32 scalars (traced, so kernels are shared across k).
    res: BeamResult.
    """
    R, NT = tgt_masks.shape
    n = tgt_len
    blen = res.best_len
    dmin, endcol = _banded_prefix_scan(tgt_masks, n, res.best_seq, blen, w)

    i_ax = jnp.arange(NT + 1, dtype=jnp.int32)[None, :]
    # mean certified quality of each target prefix (engine.gate_for)
    qc = jnp.minimum(tgt_qual.astype(jnp.float32), qv_max.astype(jnp.float32))
    qcum = jnp.cumsum(qc, axis=1)
    qcum = jnp.concatenate([jnp.zeros((R, 1), jnp.float32), qcum], axis=1)
    qmean = qcum / jnp.maximum(i_ax.astype(jnp.float32), 1.0)
    gate = jnp.maximum(jnp.float32(min_score_open),
                       qmean / jnp.maximum(qv_max.astype(jnp.float32), 1.0))

    nn = jnp.maximum(n, 1)
    d_n = jnp.take_along_axis(dmin, n[:, None], axis=1)[:, 0]
    s1_full = 1.0 - d_n.astype(jnp.float32) / nn.astype(jnp.float32)
    gate_n = jnp.take_along_axis(gate, n[:, None], axis=1)[:, 0]
    accept_full = s1_full >= gate_n

    valid_i = i_ax <= n[:, None]
    pscore = jnp.where(valid_i,
                       i_ax.astype(jnp.float32)
                       - 2.0 * dmin.astype(jnp.float32),
                       -jnp.inf)
    ibest = jnp.argmax(pscore, axis=1).astype(jnp.int32)
    istar = jnp.where(accept_full, n, ibest)
    d_i = jnp.take_along_axis(dmin, istar[:, None], axis=1)[:, 0]
    s1_open = 1.0 - d_i.astype(jnp.float32) / jnp.maximum(istar, 1).astype(jnp.float32)
    gate_i = jnp.take_along_axis(gate, istar[:, None], axis=1)[:, 0]
    ok_open = (blen > 0) & (accept_full
                            | ((istar >= min_k) & (s1_open >= gate_i)))
    jend_open = jnp.take_along_axis(endcol, istar[:, None], axis=1)[:, 0]
    ok_open = ok_open & (jend_open > 0)

    # partial trim for failed closed regions (engine._record_partial):
    # SHW(tgt[:end], seq) == row `end` of this DP
    end = jnp.clip(res.best_end, 0, NT)
    pdist = jnp.take_along_axis(dmin, end[:, None], axis=1)[:, 0]
    pjend = jnp.take_along_axis(endcol, end[:, None], axis=1)[:, 0]

    # the same score in fixed point, from exact integer arithmetic (truncated
    # toward zero and saturated like the float conversion), so that every
    # backend ships the identical value: float division differs in its last
    # bit between backends
    n_i = jnp.maximum(istar, 1).astype(jnp.int64)
    s1_open_m = jax.lax.div((n_i - d_i) * _M, n_i)
    s1_open_m = jnp.clip(s1_open_m, jnp.iinfo(jnp.int32).min,
                         jnp.iinfo(jnp.int32).max)

    scalars = jnp.stack([
        blen, res.best_dist, res.best_end, res.second_dist,
        res.completed.astype(jnp.int32),
        istar, jend_open, s1_open_m.astype(jnp.int32),
        ok_open.astype(jnp.int32),
        pdist, pjend,
    ], axis=1).astype(jnp.int32)
    return FinishOut(scalars=scalars, seq_packed=pack_codes(res.best_seq))
