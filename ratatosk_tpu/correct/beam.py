"""Device beam search over the unitig graph with banded, carried DP rows.

Batched, static-shape re-expression of the reference's weak-region path
enumeration
(explorePathsBFS/explorePathsBFS2 + exploreSubGraph, GraphTraversal.cpp:3-720)
and per-step SHW re-anchoring (GraphTraversal.cpp:57-62): instead of a queue
of variable-length paths each re-aligned from scratch, a fixed-width beam
advances ONE BASE per step; every beam entry carries a *band* of the last row
of its edit-distance DP against the raw region (edlib's banding,
edlib.h:102-107, reshaped for SPMD), so each step costs one vectorized row
update over the whole batch (ARCHITECTURE.md §6).

Because every live entry emits exactly one base per step, the band's window
start is one scalar per region (ws_r = clip(i - W/2, 0, tl_r+1-W): it tracks
the step until it stalls at the region's own tail) — window slicing is a
per-region dynamic_slice of one W-wide row, never a per-lane gather inside
the beam dimension. The per-region clip lets regions of very different
lengths share one bucket shape. With W >= NT+1 the band covers the whole row
and the search is exact.

Per step, an entry mid-unitig emits its unitig's next base deterministically;
an entry at a unitig boundary branches into <=4 successors filtered by
  - edge existence (graph topology),
  - edge read-support (UnitigData.shared_pids analog, Graph.cpp:2003),
  - |colors(successor) ∩ region colors| >= min_cov (GraphTraversal.cpp:485-489).
All candidates are scored (alignment prefix score + color score, mirroring
getScorePath's (align+color)/2, GraphTraversal.cpp:860) and the top `beam`
survive — selection runs as one-hot f32 matmuls instead of middle-axis
gathers and scatters (a choice made for the previous accelerator and not
re-measured on the GPU, ROADMAP A3). Entries reaching the right anchor k-mer
freeze, capturing their NW distance; dead ends and over-length paths freeze
capturing their prefix distance, so open regions keep their best partial path.

Everything is static-shape: regions are bucketed by padded target length NT,
path budget LMAX ~= 1.25*NT (the reference's +-25% length window,
getMinMaxLength, Common.hpp:435-438).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ratatosk_tpu.correct.graphdev import DeviceGraph
from ratatosk_tpu.ops import colorset as CS

NEG = jnp.float32(-1e9)
BIG = jnp.int32(1 << 20)
_CAPC = 16  # color-count saturation for the color score


class RegionBatch(NamedTuple):
    """[R]-leading device arrays describing weak regions (one bucket)."""

    tgt_masks: jnp.ndarray   # uint8 [R, NT] 4-bit IUPAC masks of the raw region
    tgt_len: jnp.ndarray     # int32 [R]
    start_tip: jnp.ndarray   # int32 [R] packed (uid<<1|dir) of the left anchor
    start_off: jnp.ndarray   # int32 [R] next oriented base to emit
    end_tip: jnp.ndarray     # int32 [R] right anchor tip, -1 = open region
    end_off: jnp.ndarray     # int32 [R] `off` value that completes the region
    colors_sig: jnp.ndarray  # int8 [R, SIG_BINS] hashed region color signature
                             # (0/1: the unweighted >= min_cov edge filter)
    colors_wsig: jnp.ndarray # int8 [R, SIG_BINS] weighted signature (the
                             # WeightsPairID score, Correction.cpp:417-427)
    max_plen: jnp.ndarray    # int32 [R] path length budget (+-25% window,
                             # getMinMaxLength, Common.hpp:435-438)
    tgt_qual: jnp.ndarray    # int32 [R, NT] clipped linear quality (q-33) of
                             # the raw region, 0 when absent. Unused by the
                             # beam itself; consumed by the chained device
                             # finish kernel (correct/finish.py)
    end_cyclic: jnp.ndarray  # bool [R] the right anchor's unitig lies on a
                             # short cycle: completion does NOT freeze the
                             # path (it may legitimately pass the anchor
                             # state once per repeat copy — the fixRepeats
                             # role, GraphTraversal.cpp:1149-1334); every
                             # arrival is captured on the completion
                             # scoreboard instead


class BeamState(NamedTuple):
    tip: jnp.ndarray     # int32 [R, B]
    off: jnp.ndarray     # int32 [R, B]
    plen: jnp.ndarray    # int32 [R, B]
    # path length of the region's live entries (all live entries share it);
    # regions advance at their own pace once sprint steps emit several bases
    # per outer step, so the band window tracks pcount, not the loop index
    pcount: jnp.ndarray  # int32 [R]
    # completion scoreboard (per region): every candidate that arrives at the
    # right anchor state is captured here — arrivals do NOT consume the entry
    # when the anchor is cyclic, so paths with more repeat copies keep
    # walking and later (better-aligned) arrivals can replace the best
    cbest: jnp.ndarray   # int32 [R] best completed NW distance (BIG = none)
    cstep: jnp.ndarray   # int32 [R] step index of the best arrival
    ccand: jnp.ndarray   # int32 [R] candidate index (b*4+c) of that arrival
    cplen: jnp.ndarray   # int32 [R] path length of that arrival
    csecond: jnp.ndarray  # int32 [R] runner-up completed distance
    cnum: jnp.ndarray    # int32 [R] number of arrivals captured
    # sprint bases of the best arrival's parent slot (they precede the
    # arrival base and may be absent from hist if the candidate lost the
    # rank cut): packed 2-bit bases + count, seeded during reconstruction
    csbits: jnp.ndarray  # int32 [R]
    cscnt: jnp.ndarray   # int32 [R]
    # emitted bases are NOT materialized per entry: each outer step records
    # (parent slot, branch base, sprint bases) per surviving slot in a
    # [LMAX, R, B] history, and only the winner's path is reconstructed
    # after the loop — the O(R*B*L) sequence-copy matmul per step was the
    # beam's dominant FLOP term for long buckets
    hist: jnp.ndarray    # int32 [LMAX, R, B]: bits0-1 branch base,
                         # bit2 emitted, bits3-9 parent slot,
                         # bits10-12 sprint count, bits13-26 sprint bases
    rwin: jnp.ndarray    # int32 [R, B, W] DP-row band at window ws(step)
    btgt: jnp.ndarray    # uint8 [R, W] target masks at window ws(step),
                         # carried incrementally: ws advances by <=1 per step,
                         # so the window update is one fetched column, not a
                         # per-row W-wide gather
    live: jnp.ndarray    # bool [R, B] slot holds a real path
    cmin: jnp.ndarray    # int32 [R, B] weakest-link shared-read count over
                         # the path's branch steps — the selectMostContiguous
                         # tie-break (GraphTraversal.cpp:911-964): among
                         # equal-scoring paths, the one whose junctions all
                         # carry read support end-to-end wins
    frozen: jnp.ndarray  # bool [R, B] stopped (completed/dead end/over budget)
    compl_: jnp.ndarray  # bool [R, B] reached the right anchor
    fdist: jnp.ndarray   # int32 [R, B] distance captured at freeze time
    fend: jnp.ndarray    # int32 [R, B] target end column captured at freeze
    ccsum: jnp.ndarray   # float32 [R, B] accumulated color score
    nvis: jnp.ndarray    # int32 [R, B] unitigs entered


class BeamResult(NamedTuple):
    best_seq: jnp.ndarray     # uint8 [R, L] 2-bit codes of the winning path
    best_len: jnp.ndarray     # int32 [R]
    best_dist: jnp.ndarray    # int32 [R] NW distance (closed) / prefix distance
    best_end: jnp.ndarray     # int32 [R] target prefix consumed
    second_dist: jnp.ndarray  # int32 [R] runner-up distance (quality margin)
    completed: jnp.ndarray    # bool [R] a path reached the right anchor
    n_done: jnp.ndarray       # int32 [R]


def _window_start(i, tgt_len, nt1: int, w: int):
    """Band start column at path length i (scalar, [R] or [R, S]), shared by
    a region's entries (all live entries carry plen == pcount_r).

    The upper clip is PER REGION (tl+1-w, not the bucket's nt1-w): once the
    path outruns the target the window must stall covering the target's tail,
    or frozen captures (prefix dist / NW dist at col tl) read columns past
    the region's end and come back BIG. With one clip per bucket that only
    held when NT ~= tl — i.e. it silently required one bucket per length.
    """
    if w >= nt1:
        shape = jnp.broadcast_shapes(jnp.shape(i), jnp.shape(tgt_len))
        return jnp.zeros(shape, jnp.int32)
    hi = jnp.maximum(tgt_len + 1 - w, 0)
    return jnp.clip(i - w // 2, 0, hi).astype(jnp.int32)


def _band_dists(row, cols, tgt_len):
    """(dist_pref, end_max, dist_nw) over a band. row [..., W], cols [..., W]
    absolute columns, tgt_len broadcastable to row[..., 0]."""
    tl = tgt_len[..., None]
    valid = cols <= tl
    masked = jnp.where(valid, row, BIG)
    dist_pref = jnp.min(masked, axis=-1)
    is_min = masked == dist_pref[..., None]
    end_max = jnp.max(jnp.where(is_min, cols, -1), axis=-1)
    dist_nw = jnp.min(jnp.where(cols == tl, row, BIG), axis=-1)
    return dist_pref, end_max, dist_nw


def _band_dists_from_d(dmat, cols, tgt_len):
    """Same stats, computed from the D column minima BEFORE the prefix-min
    scan. With E[j] = j + cummin_{l<=j}(D[l]-l):
      min_j E[j] = min_l D[l]          (the min is attained at j = l*),
      E[j] = minD  iff  D[j] = minD    (tie columns coincide),
      E[tl] = tl + min_{l<=tl}(D[l]-l),
    so prefix distance, tie end-columns and the NW distance are plain
    reductions over D — the O(W log W) cummin only ever needs to run on the
    `beam` selected rows, not on all 4*beam candidates."""
    tl = tgt_len[..., None]
    valid = cols <= tl
    masked = jnp.where(valid, dmat, BIG)
    dist_pref = jnp.min(masked, axis=-1)
    is_min = masked == dist_pref[..., None]
    end_max = jnp.max(jnp.where(is_min, cols, -1), axis=-1)
    in_win = (cols[..., :1] <= tl[..., 0:1]) & (tl[..., 0:1] <= cols[..., -1:])
    dist_nw = jnp.min(jnp.where(valid, dmat - cols, BIG), axis=-1) + tl[..., 0]
    dist_nw = jnp.where(in_win[..., 0], dist_nw, BIG)
    return dist_pref, end_max, jnp.minimum(dist_nw, BIG)


def _sprint_advance(g: DeviceGraph, rb: RegionBatch, padded_tgt,
                    st: BeamState, rec, smax: int):
    """Advance each region by up to smax-1 deterministic mid-unitig bases.

    Between branch points every live entry's next base is determined by its
    unitig (one successor, no selection, no freezing), so the expensive
    branch step — candidate scoring, rank selection, scoreboard — only needs
    to run when something can actually happen. The per-region stride s_r is
    capped so no event (unitig boundary, right-anchor arrival, path-budget
    freeze) can occur inside the sprint: s_r-1 bases advance here, and the
    following branch step emits base s_r and handles the event. This is the
    batched answer to the reference's per-base DFS stack walk
    (exploreSubGraph, GraphTraversal.cpp:456-720): the graph walk stays
    per-base, but all deterministic stretches collapse into vectorized
    multi-row band-DP updates.

    Returns (state', sbits [R,B], scnt [R,B]) — the packed sprint bases and
    counts, recorded into hist by the branch step.
    """
    R, B = st.tip.shape
    W = st.rwin.shape[-1]
    nt1 = rb.tgt_masks.shape[-1] + 1
    zero_bits = jnp.zeros((R, B), jnp.int32)
    if smax <= 1:
        return st, zero_bits, zero_bits
    d = st.tip & 1
    ul = rec[..., 4]
    uo = rec[..., 5]
    live = st.live & ~st.frozen

    # per-entry sprint cap: stay strictly before the boundary branch, the
    # anchor arrival and the budget freeze (INF for non-live entries)
    inf = jnp.int32(1 << 28)
    d_bound = ul - st.off + 1
    on_end = ((rb.end_tip[:, None] >= 0)
              & (st.tip == rb.end_tip[:, None])
              & (st.off < rb.end_off[:, None]))
    d_arr = jnp.where(on_end, rb.end_off[:, None] - st.off, inf)
    d_budget = rb.max_plen[:, None] - st.plen
    s_ent = jnp.minimum(jnp.minimum(d_bound, d_arr), d_budget)
    s_ent = jnp.where(live, s_ent, inf)
    has_live = live.any(axis=1)
    m_reg = jnp.clip(jnp.where(has_live, jnp.min(s_ent, axis=1) - 1, 0),
                     0, smax - 1)                           # [R] sprint bases

    # pre-gather the next smax-1 oriented bases per entry (a contiguous run
    # on the unitig) and the target-mask columns the windows will expose —
    # ONE gather each per outer step instead of one per emitted base
    j_i = jnp.arange(smax - 1, dtype=jnp.int32)
    pos = jnp.where(d[..., None] == 0, st.off[..., None] + j_i,
                    ul[..., None] - 1 - (st.off[..., None] + j_i))
    pos = jnp.clip(pos, 0, jnp.maximum(ul[..., None] - 1, 0))
    nb_all = g.useq[uo[..., None] + pos].astype(jnp.int32)
    nb_all = jnp.where(d[..., None] == 0, nb_all, 3 - nb_all)  # [R,B,smax-1]
    # window starts at path lengths pcount..pcount+smax-1 (substep j moves
    # the window ws(pcount+j) -> ws(pcount+j+1))
    wsall = _window_start(st.pcount[:, None] + jnp.arange(smax)[None, :],
                          rb.tgt_len[:, None], nt1, W)         # [R, smax]
    fetch_j = jnp.minimum(wsall[:, 1:] + (W - 1), nt1 - 1)
    newcols = jnp.take_along_axis(
        jnp.broadcast_to(padded_tgt, (R, nt1)), fetch_j, axis=1
    ).astype(st.btgt.dtype)                                    # [R, smax-1]

    with jax.named_scope("beam_sprint"):
        rwin, btgt = sprint_rows(st.rwin, st.btgt, nb_all, newcols, wsall,
                                 m_reg, live, st.plen)
    adv = jnp.where(live, m_reg[:, None], 0).astype(jnp.int32)   # [R, B]
    jmask = (j_i[None, None, :] < m_reg[:, None, None]) & live[..., None]
    sbits = jnp.where(jmask, nb_all << (2 * j_i), 0).sum(axis=-1)
    return (st._replace(rwin=rwin, btgt=btgt, off=st.off + adv,
                        plen=st.plen + adv, pcount=st.pcount + m_reg),
            sbits.astype(jnp.int32), adv)


def sprint_rows(rwin, btgt, nb_all, newcols, wsall, m_reg, live, plen):
    """Band-state evolution of a sprint: m_reg[r] one-base DP row updates.

    rwin [R, B, W] carried rows at window wsall[:, 0]; btgt [R, W] target
    masks of that window; nb_all [R, B, smax-1] the bases each entry emits;
    newcols [R, smax-1] the target column each window shift exposes; wsall
    [R, smax] window starts at path lengths pcount..pcount+smax-1; live
    [R, B] entries that advance; plen [R, B] their path lengths. Substep j
    (j < m_reg[r]) moves region r's window from wsall[r, j] to
    wsall[r, j+1] and extends every live row by base nb_all[..., j].
    Returns (rwin', btgt')."""
    W = rwin.shape[-1]
    cols0 = jnp.arange(W, dtype=jnp.int32)[None, :]

    def body(j, carry):
        rwin, btgt = carry
        adv_r = j < m_reg                                      # [R]
        adv = live & adv_r[:, None]                            # [R, B]
        ws_cur = jax.lax.dynamic_index_in_dim(wsall, j, axis=1,
                                              keepdims=False)
        ws_nxt = jax.lax.dynamic_index_in_dim(wsall, j + 1, axis=1,
                                              keepdims=False)
        delta = (ws_nxt - ws_cur)[:, None]                     # [R, 1]
        newcol = jax.lax.dynamic_slice_in_dim(newcols, j, 1, axis=1)
        shifted = jnp.concatenate([btgt[:, 1:], newcol], axis=1)
        shift_r = (delta[:, 0] == 1) & adv_r
        btgt_n = jnp.where(shift_r[:, None], shifted, btgt)
        delta3 = delta[..., None]
        shiftL = jnp.concatenate(
            [rwin[..., 1:], jnp.full_like(rwin[..., :1], BIG)], axis=-1)
        shiftR = jnp.concatenate(
            [jnp.full_like(rwin[..., :1], BIG), rwin[..., :-1]], axis=-1)
        prev_j = jnp.where(delta3 == 1, shiftL, rwin)
        prev_jm1 = jnp.where(delta3 == 1, rwin, shiftR)
        base = jax.lax.dynamic_index_in_dim(nb_all, j, axis=2,
                                            keepdims=False)
        cols = ws_nxt[:, None] + cols0                         # [R, W]
        sub = (((jnp.int32(1) << base)[..., None]
                & btgt_n[:, None, :].astype(jnp.int32)) == 0).astype(jnp.int32)
        dd = jnp.minimum(prev_jm1 + sub, prev_j + 1)
        dd = jnp.where(cols[:, None, :] == 0, (plen + j + 1)[..., None], dd)
        dd = jnp.minimum(dd, BIG)
        ee = cols[:, None, :] + jax.lax.cummin(dd - cols[:, None, :], axis=2)
        ee = jnp.minimum(ee, BIG)
        return jnp.where(adv[..., None], ee, rwin), btgt_n

    return jax.lax.fori_loop(0, jnp.max(m_reg), body, (rwin, btgt))


def _beam_step(g: DeviceGraph, rb: RegionBatch, padded_tgt, st: BeamState, i,
               min_cov: int, rec, sbits, scnt):
    R, B = st.tip.shape
    W = st.rwin.shape[-1]
    nt1 = rb.tgt_masks.shape[-1] + 1
    k = g.kval    # traced scalar: kernels are shared across k (passes)

    d = st.tip & 1
    # successor record gathered once per outer step (sprint keeps entries on
    # their unitig, so the pre-sprint gather is still valid here)
    e_raw = rec[..., :4]                   # -1 = absent OR not read-supported
    # bit 30 marks edges rescued by the k2 graph (graphdev.from_host):
    # exempt from the color branch filter below
    e_resc = (e_raw >= 0) & (((e_raw >> 30) & 1) == 1)
    e = jnp.where(e_raw >= 0, e_raw & ((1 << 30) - 1), e_raw)
    ul = rec[..., 4]
    uo = rec[..., 5]
    active = st.live & ~st.frozen
    at_bound = active & (st.off >= ul)
    mid = active & (st.off < ul)

    # mid-unitig next base (oriented)
    pos = jnp.where(d == 0, st.off, ul - 1 - st.off)
    pos = jnp.clip(pos, 0, jnp.maximum(ul - 1, 0))
    nb = g.useq[uo + pos].astype(jnp.int32)
    nb = jnp.where(d == 0, nb, 3 - nb)

    # branch candidates: successors of (uid, leaving strand = direction).
    # The color filter runs AFTER selection on the B winners (optimistic
    # expansion): a bad-color branch survives one step and is killed next —
    # 4x less signature traffic than filtering all 4B candidates.
    branch_ok = (e >= 0) & at_bound[..., None]

    cidx = jnp.arange(4, dtype=jnp.int32)[None, None, :]
    # slot c: boundary -> successor with base c; mid -> only slot nb advances
    valid = jnp.where(at_bound[..., None], branch_ok, mid[..., None] & (cidx == nb[..., None]))
    cand_tip = jnp.where(at_bound[..., None], e, st.tip[..., None])
    cand_off = jnp.where(at_bound[..., None], jnp.int32(k), st.off[..., None] + 1)
    # frozen entries persist through slot 0; an active boundary entry with no
    # viable successor freezes too (dead end — kept so open regions retain
    # their best partial path)
    no_succ = at_bound & ~branch_ok.any(axis=-1)
    keep = ((st.live & ~active) | no_succ)[..., None] & (cidx == 0)
    valid = valid | keep
    emits = valid & ~keep

    cand_tip = jnp.where(keep, st.tip[..., None], cand_tip)
    cand_off = jnp.where(keep, st.off[..., None], cand_off)
    cand_plen = jnp.where(emits, st.plen[..., None] + 1, st.plen[..., None])
    cand_branch = at_bound[..., None] & emits
    cand_ccsum = jnp.broadcast_to(st.ccsum[..., None], (R, B, 4))
    cand_nvis = jnp.where(cand_branch, st.nvis[..., None] + 1, st.nvis[..., None])
    # arrival at the right anchor state. On a CYCLIC anchor the entry is NOT
    # frozen — it may pass this state once per repeat copy (fixRepeats,
    # GraphTraversal.cpp:1149-1334) — every arrival is captured on the
    # completion scoreboard below
    arrive = (emits & (rb.end_tip[:, None, None] >= 0)
              & (cand_tip == rb.end_tip[:, None, None])
              & (cand_off == rb.end_off[:, None, None]))
    cand_compl = st.compl_[..., None] | (
        arrive & ~rb.end_cyclic[:, None, None])

    # --- banded DP candidate scoring (no prefix-min scan here) ---
    # every live entry of a region has plen == pcount_r, so the band window
    # start is one scalar per region; new row pcount+1 sits at window
    # ws(pcount+1), shifted by delta in {0,1} vs ws(pcount)
    ws = _window_start(st.pcount, rb.tgt_len, nt1, W)            # [R]
    ws_next = _window_start(st.pcount + 1, rb.tgt_len, nt1, W)   # [R]
    delta = (ws_next - ws)[:, None, None]                    # [R,1,1]
    cols = ws_next[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]  # [R,W]
    # advance the carried target window: fetch only the newly-exposed column.
    # The fetch is a one-hot compare-and-reduce, not a gather: per-row
    # dynamic gathers had a large fixed cost per step on the previous
    # accelerator (not re-measured on the GPU, ROADMAP A3).
    fetch = jnp.minimum(ws_next + (W - 1), nt1 - 1)[:, None]          # [R,1]
    jcol = jax.lax.broadcasted_iota(jnp.int32, padded_tgt.shape, 1)
    newcol = jnp.sum(jnp.where(jcol == fetch, padded_tgt, 0),
                     axis=1, keepdims=True).astype(jnp.uint8)         # [R,1]
    shifted = jnp.concatenate([st.btgt[:, 1:], newcol], axis=1)
    bslice = jnp.where(delta[..., 0] == 1, shifted, st.btgt)  # [R, W]

    shiftL = jnp.concatenate([st.rwin[..., 1:],
                              jnp.full_like(st.rwin[..., :1], BIG)], axis=-1)
    shiftR = jnp.concatenate([jnp.full_like(st.rwin[..., :1], BIG),
                              st.rwin[..., :-1]], axis=-1)
    prev_j = jnp.where(delta == 1, shiftL, st.rwin)          # prev row at col j
    prev_jm1 = jnp.where(delta == 1, st.rwin, shiftR)        # prev row at j-1

    base_mask = (jnp.int32(1) << cidx).astype(jnp.int32)     # [1,1,4]
    sub = ((base_mask[..., None] & bslice[:, None, None, :].astype(jnp.int32))
           == 0).astype(jnp.int32)                           # [R,B,4,W]
    dmat = jnp.minimum(prev_jm1[:, :, None, :] + sub,
                       prev_j[:, :, None, :] + 1)
    dmat = jnp.where(cols[:, None, None, :] == 0,
                     cand_plen[..., None], dmat)
    dmat = jnp.minimum(dmat, BIG)

    # newly-frozen: completed, dead end, or path length budget exhausted
    over = cand_plen >= rb.max_plen[:, None, None]
    cand_frozen = (st.frozen[..., None] | cand_compl | over
                   | (no_succ[..., None] & keep))

    tl = jnp.broadcast_to(rb.tgt_len[:, None, None], (R, B, 4))
    cols4 = jnp.broadcast_to(cols[:, None, None, :], (R, B, 4, W))
    dist_pref, end_max, dist_nw = _band_dists_from_d(dmat, cols4, tl)

    # --- completion scoreboard update (pre-selection: an arrival that loses
    # the rank cut is still a finished path) ---
    C = B * 4
    arr_d = jnp.where(arrive & valid, dist_nw, BIG).reshape(R, C)
    m1 = arr_d.min(axis=1)
    a1 = jnp.argmin(arr_d, axis=1).astype(jnp.int32)
    ar_r = jnp.arange(R)
    plen_at = cand_plen.reshape(R, C)[ar_r, a1]
    multi = (arr_d == m1[:, None]).sum(axis=1) >= 2
    m2 = jnp.where(multi, m1,
                   jnp.where(arr_d > m1[:, None], arr_d, BIG).min(axis=1))
    vals = jnp.sort(jnp.stack([st.cbest, st.csecond, m1, m2], axis=1), axis=1)
    take_new = m1 < st.cbest
    new_cbest = vals[:, 0]
    new_csecond = vals[:, 1]
    new_cstep = jnp.where(take_new, i, st.cstep).astype(jnp.int32)
    new_ccand = jnp.where(take_new, a1, st.ccand).astype(jnp.int32)
    new_cplen = jnp.where(take_new, plen_at, st.cplen).astype(jnp.int32)
    new_cnum = st.cnum + (arr_d < BIG).sum(axis=1).astype(jnp.int32)
    # the arrival's sprint bases live on its parent slot (pre-selection —
    # the candidate may lose the rank cut and be absent from hist)
    new_csbits = jnp.where(take_new, sbits[ar_r, a1 >> 2], st.csbits)
    new_cscnt = jnp.where(take_new, scnt[ar_r, a1 >> 2], st.cscnt)
    # non-emitting (keep) slots: stats of the parent's current row, which
    # lives at window ws(i)
    cols_prev = ws[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :]
    colsB = jnp.broadcast_to(cols_prev[:, None, :], (R, B, W))
    dist_pref_k, end_max_k, dist_nw_k = _band_dists(
        st.rwin, colsB, rb.tgt_len[:, None])
    dist_pref = jnp.where(emits, dist_pref, dist_pref_k[..., None])
    end_max = jnp.where(emits, end_max, end_max_k[..., None])
    dist_nw = jnp.where(emits, dist_nw, dist_nw_k[..., None])

    newly = cand_frozen & ~st.frozen[..., None]
    cand_fdist = jnp.where(newly,
                           jnp.where(cand_compl, dist_nw, dist_pref),
                           st.fdist[..., None])
    cand_fend = jnp.where(newly,
                          jnp.where(cand_compl, tl, end_max),
                          st.fend[..., None])

    # scores: frozen entries use their captured distance; live use the prefix
    eff_dist = jnp.where(cand_frozen, cand_fdist, dist_pref)
    denom = jnp.where(cand_compl, tl, jnp.maximum(cand_plen, 1))
    align = 1.0 - eff_dist.astype(jnp.float32) / jnp.maximum(denom, 1).astype(jnp.float32)
    color = cand_ccsum / jnp.maximum(cand_nvis, 1).astype(jnp.float32)
    score = 0.5 * jnp.clip(align, -1.0, 1.0) + 0.5 * color
    score = jnp.where(valid, score, NEG)

    # --- top-`beam` selection as one-hot matmuls ---
    # lax.top_k lowered to a serialized sort on the previous accelerator;
    # rank-by-pairwise-comparison is elementwise work: rank[c] = #candidates
    # strictly better (ties broken by slot index), P[b, c] = (rank[c] == b).
    # Tuned on the previous chip; not re-measured on the GPU (ROADMAP A3).
    fscore = score.reshape(R, C)
    sgt = fscore[:, :, None] > fscore[:, None, :]            # [R, C', C]
    seq_tie = (fscore[:, :, None] == fscore[:, None, :]) & (
        jnp.arange(C, dtype=jnp.int32)[None, :, None]
        < jnp.arange(C, dtype=jnp.int32)[None, None, :])
    rank = (sgt | seq_tie).sum(axis=1).astype(jnp.int32)     # [R, C]
    P = (rank[:, None, :] == jnp.arange(B, dtype=jnp.int32)[None, :, None]
         ).astype(jnp.float32)                               # [R, B, C]

    cand_rescued = cand_branch & e_resc
    cand_cmin = jnp.broadcast_to(st.cmin[..., None], (R, B, 4))
    cand_sbits = jnp.broadcast_to(sbits[..., None], (R, B, 4))
    cand_scnt = jnp.broadcast_to(scnt[..., None], (R, B, 4))
    scalars = jnp.stack([
        cand_tip.astype(jnp.float32),
        cand_off.astype(jnp.float32),
        cand_plen.astype(jnp.float32),
        cand_frozen.astype(jnp.float32),
        cand_compl.astype(jnp.float32),
        cand_ccsum,
        cand_nvis.astype(jnp.float32),
        emits.astype(jnp.float32),
        cand_fdist.astype(jnp.float32),
        cand_fend.astype(jnp.float32),
        cand_branch.astype(jnp.float32),
        valid.astype(jnp.float32),
        cand_rescued.astype(jnp.float32),
        cand_cmin.astype(jnp.float32),
        cand_sbits.astype(jnp.float32),   # < 2^14: exact in f32
        cand_scnt.astype(jnp.float32),
    ], axis=-1).reshape(R, C, 16)
    # precision=HIGHEST is LOAD-BEARING on every einsum that moves integer
    # state: GPU f32 matmuls default to TF32, whose 10-bit mantissa silently
    # rounds any integer above 2048 (off 4097 -> 4096, plen 2049 -> 2048).
    # A rounded plen freezes a path's progress without freezing the entry —
    # an immortal zombie that keeps the while_loop from ever exiting early.
    # True f32 (HIGHEST) is exact for every field here (all < 2^24).
    HI = jax.lax.Precision.HIGHEST
    selected = jnp.einsum("rbc,rcf->rbf", P, scalars, precision=HI,
                          preferred_element_type=jnp.float32)
    new_tip = selected[..., 0].astype(jnp.int32)
    new_off = selected[..., 1].astype(jnp.int32)
    new_plen = selected[..., 2].astype(jnp.int32)
    new_frozen = selected[..., 3] > 0.5
    new_compl = selected[..., 4] > 0.5
    new_ccsum = selected[..., 5]
    new_nvis = selected[..., 6].astype(jnp.int32)
    sel_emit = selected[..., 7] > 0.5
    new_fdist = selected[..., 8].astype(jnp.int32)
    new_fend = selected[..., 9].astype(jnp.int32)
    sel_branch = selected[..., 10] > 0.5
    # a beam slot whose rank matched no candidate (fewer valid candidates
    # than B) selects all-zeros: the valid flag kills it. Without this the
    # slot becomes a live, never-emitting, never-freezing zombie and the
    # all-frozen early exit below NEVER fires — every search runs to lmax.
    new_live = selected[..., 11] > 0.5
    sel_rescued = selected[..., 12] > 0.5
    sel_cmin = selected[..., 13].astype(jnp.int32)
    sel_sbits = (selected[..., 14] + 0.5).astype(jnp.int32)
    sel_scnt = (selected[..., 15] + 0.5).astype(jnp.int32)
    sel_score = jnp.einsum("rbc,rc->rb", P, fscore, precision=HI,
                           preferred_element_type=jnp.float32)
    new_live = new_live & (sel_score > NEG / 2)

    # post-selection color filter + color score on the B winners only
    # (|colors(successor) ∩ region colors| >= min_cov,
    # GraphTraversal.cpp:485-489, via hashed-signature dot)
    sel_sig = g.color_sig[jnp.maximum(new_tip >> 1, 0)]      # [R, B, H]
    shared_raw = CS.intersect_count_sig(sel_sig, rb.colors_sig[:, None, :],
                                        jnp)
    wshared_raw = CS.intersect_count_sig(sel_sig, rb.colors_wsig[:, None, :],
                                         jnp)
    # collision-bias correction: two UNRELATED sets still overlap
    # ~pop(u)*mass(region)/bins signature bins (tests/test_signature_accuracy
    # measured 100% false >= min_cov support at card 128 without this) —
    # subtract the expectation so the filter/score center on the true count
    H = sel_sig.shape[-1]
    pop_u = sel_sig.astype(jnp.float32).sum(-1)              # [R, B]
    mass = rb.colors_sig.astype(jnp.float32).sum(-1)         # [R]
    wmass = rb.colors_wsig.astype(jnp.float32).sum(-1)
    shared = shared_raw.astype(jnp.float32) - pop_u * mass[:, None] / H
    wshared = jnp.maximum(
        wshared_raw.astype(jnp.float32) - pop_u * wmass[:, None] / H, 0.0)
    # k2-rescued edges bypass the color filter (long-k context certifies the
    # junction, addCoverage phase 7) and score at least min_cov
    new_live = new_live & (~sel_branch | new_compl | sel_rescued
                           | (shared >= min_cov))
    wsh_eff = jnp.where(sel_rescued, jnp.maximum(wshared, min_cov), wshared)
    new_ccsum = jnp.where(
        sel_branch,
        new_ccsum + jnp.minimum(wsh_eff, _CAPC).astype(jnp.float32) / _CAPC,
        new_ccsum)
    # weakest junction support along the path (selectMostContiguous
    # tie-break); rescued junctions count as min_cov-supported
    sh_eff = jnp.where(sel_rescued, jnp.maximum(shared, min_cov), shared)
    new_cmin = jnp.where(sel_branch, jnp.minimum(sel_cmin, sh_eff),
                         sel_cmin).astype(jnp.int32)

    # path history: record (base, emitted, parent slot) per winner — the
    # winner's sequence is reconstructed once after the loop (backpointers),
    # so no [R, B, L] sequence copy happens per step
    carange = jnp.arange(C, dtype=jnp.int32)
    mpar = (carange[:, None] >> 2 == jnp.arange(B, dtype=jnp.int32)[None, :]
            ).astype(jnp.float32)                            # [C, B] const
    Pp = jnp.einsum("rbc,cp->rbp", P, mpar,
                    preferred_element_type=jnp.float32)      # [R, B, B]
    sel_c = jnp.einsum("rbc,c->rb", P, (carange & 3).astype(jnp.float32),
                       precision=HI, preferred_element_type=jnp.float32)
    sel_par = jnp.einsum("rbc,c->rb", P, (carange >> 2).astype(jnp.float32),
                         precision=HI, preferred_element_type=jnp.float32)
    # layout: base(2) | emitted(1) | parent(7) | sprint count(3) | bases(14)
    hrec = ((sel_c + 0.5).astype(jnp.int32)
            | (sel_emit.astype(jnp.int32) << 2)
            | ((sel_par + 0.5).astype(jnp.int32) << 3)
            | (sel_scnt << 10)
            | (sel_sbits << 13)).astype(jnp.int32)
    zero = jnp.zeros((), i.dtype)
    hist_new = jax.lax.dynamic_update_slice(st.hist, hrec[None],
                                            (i, zero, zero))

    # --- rebuild the winners' DP rows (prefix-min scan on B rows only) ---
    # gather each winner's parent row, then redo the one-row update for the
    # selected base; non-emitting winners keep the parent row verbatim
    # DP row values reach BIG=2^20: TF32 would quantize them (multiples of
    # 512 up there) and corrupt every carried row — HIGHEST is required
    rwin_par = jnp.einsum("rbp,rpw->rbw", Pp, st.rwin.astype(jnp.float32),
                          precision=HI,
                          preferred_element_type=jnp.float32).astype(jnp.int32)
    shiftL_s = jnp.concatenate([rwin_par[..., 1:],
                                jnp.full_like(rwin_par[..., :1], BIG)], axis=-1)
    shiftR_s = jnp.concatenate([jnp.full_like(rwin_par[..., :1], BIG),
                                rwin_par[..., :-1]], axis=-1)
    prev_j_s = jnp.where(delta == 1, shiftL_s, rwin_par)
    prev_jm1_s = jnp.where(delta == 1, rwin_par, shiftR_s)
    sel_ci = (sel_c + 0.5).astype(jnp.int32)
    sub_s = (((jnp.int32(1) << sel_ci)[..., None]
              & bslice[:, None, :].astype(jnp.int32)) == 0).astype(jnp.int32)
    d_sel = jnp.minimum(prev_jm1_s + sub_s, prev_j_s + 1)
    d_sel = jnp.where(cols[:, None, :] == 0, new_plen[..., None], d_sel)
    d_sel = jnp.minimum(d_sel, BIG)
    e_sel = cols[:, None, :] + jax.lax.cummin(d_sel - cols[:, None, :],
                                              axis=2)
    e_sel = jnp.minimum(e_sel, BIG)
    new_rwin_sel = jnp.where(sel_emit[..., None], e_sel, rwin_par)

    # regions advance one base whenever anything emitted this step; fully
    # frozen regions stall (their stale windows are never read again)
    new_pcount = st.pcount + emits.any(axis=(1, 2)).astype(jnp.int32)
    return BeamState(
        tip=new_tip, off=new_off, plen=new_plen, pcount=new_pcount,
        cbest=new_cbest, cstep=new_cstep, ccand=new_ccand,
        cplen=new_cplen, csecond=new_csecond, cnum=new_cnum,
        csbits=new_csbits, cscnt=new_cscnt,
        hist=hist_new, rwin=new_rwin_sel, btgt=bslice,
        live=new_live, cmin=new_cmin, frozen=new_frozen, compl_=new_compl,
        fdist=new_fdist, fend=new_fend,
        ccsum=new_ccsum, nvis=new_nvis,
    )


@functools.partial(jax.jit,
                   static_argnames=("beam", "lmax", "min_cov", "band",
                                    "sprint"))
def beam_search(g: DeviceGraph, rb: RegionBatch, *, beam: int, lmax: int,
                min_cov: int = 2, band: int = 0,
                sprint: int = 8) -> BeamResult:
    """band=0 (or >= NT+1) means exact full-row DP; otherwise a W-wide band.

    sprint: max bases an outer step advances per region (1 branch step plus
    up to sprint-1 deterministic mid-unitig bases, _sprint_advance). sprint=1
    reproduces the one-base-per-step schedule exactly."""
    assert 1 <= sprint <= 8, "sprint bases must fit the 14-bit hist field"
    R, NT = rb.tgt_masks.shape
    W = NT + 1 if band <= 0 or band >= NT + 1 else band
    slot0 = jnp.broadcast_to(jnp.arange(beam)[None, :] == 0, (R, beam))
    # initial window at ws(0)=0: row 0 is E[0][j] = j (NW boundary)
    rwin0 = jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32)[None, None, :],
                             (R, beam, W))
    # target mask for column j lives at tgt_masks[j-1]; pad col 0 with 0
    padded_tgt = jnp.pad(rb.tgt_masks, ((0, 0), (1, 0)))
    # carried window holds masks at ws(step); inside the step it advances by
    # delta = ws(step+1) - ws(step) in {0,1} to become the next row's window
    st = BeamState(
        tip=jnp.where(slot0, rb.start_tip[:, None], -1).astype(jnp.int32),
        off=jnp.broadcast_to(rb.start_off[:, None], (R, beam)).astype(jnp.int32),
        plen=jnp.zeros((R, beam), jnp.int32),
        pcount=jnp.zeros((R,), jnp.int32),
        cbest=jnp.full((R,), BIG, jnp.int32),
        cstep=jnp.zeros((R,), jnp.int32),
        ccand=jnp.zeros((R,), jnp.int32),
        cplen=jnp.zeros((R,), jnp.int32),
        csecond=jnp.full((R,), BIG, jnp.int32),
        cnum=jnp.zeros((R,), jnp.int32),
        csbits=jnp.zeros((R,), jnp.int32),
        cscnt=jnp.zeros((R,), jnp.int32),
        hist=jnp.zeros((lmax, R, beam), jnp.int32),
        rwin=rwin0,
        btgt=padded_tgt[:, :W],
        live=slot0,
        cmin=jnp.full((R, beam), BIG, jnp.int32),
        frozen=jnp.zeros((R, beam), bool),
        compl_=jnp.zeros((R, beam), bool),
        fdist=jnp.full((R, beam), BIG, jnp.int32),
        fend=jnp.zeros((R, beam), jnp.int32),
        ccsum=jnp.zeros((R, beam), jnp.float32),
        nvis=jnp.zeros((R, beam), jnp.int32),
    )

    # while_loop with an all-frozen early exit: most regions complete near
    # their target length, well before the bucket's worst-case lmax
    def cond(carry):
        i, s = carry
        return (i < lmax) & (s.live & ~s.frozen).any()

    def body(carry):
        i, s = carry
        uid = jnp.maximum(s.tip >> 1, 0)
        rec = g.utbl[uid, s.tip & 1]       # [R, B, 6] (shared by both phases)
        s, sbits, scnt = _sprint_advance(g, rb, padded_tgt, s, rec, sprint)
        with jax.named_scope("beam_step"):
            s = _beam_step(g, rb, padded_tgt, s, i, min_cov, rec, sbits, scnt)
        return i + 1, s

    T, st = jax.lax.while_loop(cond, body, (jnp.int32(0), st))

    # completed regions read the scoreboard (every right-anchor arrival was
    # captured there, pre-selection and regardless of freezing); regions with
    # no arrival fall back to the best partial entry (the engine merges fw/bw
    # partials, generateConsensus-style, Alignment.cpp:309-470)
    has_c = st.cnum > 0
    eligible = st.live
    denom = jnp.where(st.compl_, rb.tgt_len[:, None], jnp.maximum(st.plen, 1))
    align = 1.0 - st.fdist.astype(jnp.float32) / jnp.maximum(denom, 1).astype(jnp.float32)
    color = st.ccsum / jnp.maximum(st.nvis, 1).astype(jnp.float32)
    score = 0.5 * jnp.clip(align, -1.0, 1.0) + 0.5 * color
    escore = jnp.where(eligible, score, NEG)
    order = jnp.argsort(-escore, axis=1)
    # selectMostContiguous tie-break (GraphTraversal.cpp:911-964): among
    # entries within float tolerance of the best score, pick the one with
    # the highest weakest-link junction support
    mx = escore.max(axis=1, keepdims=True)
    tied = eligible & (escore >= mx - 1e-6)
    b0 = jnp.argmax(jnp.where(tied, st.cmin + 1, 0), axis=1)
    b1 = jnp.where(order[:, 0] == b0,
                   order[:, jnp.minimum(1, escore.shape[1] - 1)], order[:, 0])
    ar = jnp.arange(R)
    any_ok = eligible[ar, b0] & (st.fdist[ar, b0] < BIG)
    second_fb = jnp.where(eligible[ar, b1] & (b1 != b0), st.fdist[ar, b1], BIG)

    # --- winner path reconstruction from the backpointer history ---
    # hist[idx] maps each slot of the state AFTER step idx to (parent slot
    # BEFORE the step, emitted base, emitted?). Walk the winner backward,
    # writing emitted bases right-to-left. Completed regions start at their
    # scoreboard arrival (step, candidate): the arrival's own base is seeded
    # first (it may not have survived selection, so it is absent from hist),
    # then the walk continues from the candidate's parent slot. A while_loop
    # (not scan over lmax) stops at the latest needed step.
    blen_fb = jnp.where(any_ok, st.plen[ar, b0], 0)
    blen = jnp.where(has_c, st.cplen, blen_fb)
    slot_iota = jnp.arange(beam, dtype=jnp.int32)[None, :]

    start_idx = jnp.where(has_c, st.cstep - 1, T - 1)
    cur0 = jnp.where(has_c, st.ccand >> 2, b0).astype(jnp.int32)
    # the arrival step's bases are seeded directly: the branch base from the
    # scoreboard candidate, preceded by its parent slot's sprint bases (both
    # may be absent from hist if the candidate lost the rank cut)
    rem0 = jnp.where(has_c, st.cplen - 1 - st.cscnt, blen_fb).astype(jnp.int32)
    seq0 = jnp.zeros((R, lmax), jnp.uint8)
    seed_pos = jnp.clip(st.cplen - 1, 0, lmax - 1)
    seq0 = seq0.at[ar, seed_pos].set(
        jnp.where(has_c & (st.cplen > 0), (st.ccand & 3).astype(jnp.uint8),
                  seq0[ar, seed_pos]))
    for jj in range(sprint - 1):
        p = jnp.clip(st.cplen - 1 - st.cscnt + jj, 0, lmax - 1)
        m = has_c & (jj < st.cscnt)
        b = ((st.csbits >> (2 * jj)) & 3).astype(jnp.uint8)
        seq0 = seq0.at[ar, p].set(jnp.where(m, b, seq0[ar, p]))

    def recon_body(carry):
        idx, cur, rem, seq = carry
        h = jax.lax.dynamic_slice(
            st.hist, (jnp.maximum(idx, 0), jnp.int32(0), jnp.int32(0)),
            (1, R, beam))[0].astype(jnp.int32)                # [R, beam]
        act = idx <= start_idx
        hsel = jnp.sum(jnp.where(slot_iota == cur[:, None], h, 0), axis=1)
        emit = act & (((hsel >> 2) & 1) == 1) & (rem > 0)
        pos = jnp.maximum(rem - 1, 0)
        base = (hsel & 3).astype(jnp.uint8)
        seq = seq.at[ar, pos].set(jnp.where(emit, base, seq[ar, pos]))
        rem = (rem - emit.astype(jnp.int32)).astype(jnp.int32)
        # sprint bases precede the branch base: written backward
        hscnt = jnp.where(act, (hsel >> 10) & 7, 0)
        hsbits = (hsel >> 13) & 0x3FFF
        for jj in range(sprint - 1):
            m = (jj < hscnt) & (rem > 0)
            b = ((hsbits >> (2 * (hscnt - 1 - jj))) & 3).astype(jnp.uint8)
            pos = jnp.maximum(rem - 1, 0)
            seq = seq.at[ar, pos].set(jnp.where(m, b, seq[ar, pos]))
            rem = (rem - m.astype(jnp.int32)).astype(jnp.int32)
        cur = jnp.where(act, (hsel >> 3) & 127, cur).astype(jnp.int32)
        return idx - 1, cur, rem, seq

    _, _, _, best_seq = jax.lax.while_loop(
        lambda c: c[0] >= 0, recon_body,
        (jnp.max(start_idx), cur0, rem0, seq0))

    return BeamResult(
        best_seq=best_seq,
        best_len=blen,
        best_dist=jnp.where(has_c, st.cbest,
                            jnp.where(any_ok, st.fdist[ar, b0], BIG)),
        best_end=jnp.where(has_c, rb.tgt_len,
                           jnp.where(any_ok, st.fend[ar, b0], 0)),
        second_dist=jnp.where(has_c, st.csecond, second_fb),
        completed=has_c,
        n_done=st.cnum,
    )
