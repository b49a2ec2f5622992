"""Batched edit-distance DP: the device replacement for edlib.

Semantics follow edlib (reference src/edlib.h:36-62), the inner engine behind
~30 call sites in the reference's L3-L5 (SURVEY.md §2.2(6)):
  NW  — global: query and target fully aligned.
  SHW — prefix: query fully aligned to a *prefix* of the target (gaps after
        the query's end are free); distance = min over the last row.
  HW  — infix: target prefix and suffix free; row 0 is all zeros.

Formulation (ARCHITECTURE.md §5): the within-row dependence of
  E[i][j] = min(E[i-1][j]+1, E[i][j-1]+1, E[i-1][j-1]+sub)
dissolves into a prefix-min scan:
  D[j]    = min(E[i-1][j-1]+sub_j, E[i-1][j]+1),  D[0] = i+1
  E[i][j] = j + cummin_{l<=j}(D[l] - l)
One `jax.lax.cummin` per query base, batched over pairs — elementwise, no
bit-parallel tricks needed. IUPAC ambiguity (the 28-pair equality table,
reference src/Common.hpp:262-276) costs one AND: sequences are 4-bit base
masks (dna.py) and sub_j = ((mask_a & mask_b) == 0).

Inputs are padded [B, M] / [B, N] mask arrays with per-pair lengths.
`extend_rows` exposes the single-row update for the beam search's
incrementally-carried DP rows (correct/beam.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

NW, SHW, HW = 0, 1, 2
_BIG = jnp.int32(1 << 20)


class AlignResult(NamedTuple):
    dist: jnp.ndarray       # int32 [B]
    end: jnp.ndarray        # int32 [B]: target end column (max among ties)
    end_min: jnp.ndarray    # int32 [B]: min tie end column
    last_row: jnp.ndarray   # int32 [B, N+1]: E[a_len][:] (masked cols = BIG)


def row_init(batch: int, n: int, mode: int) -> jnp.ndarray:
    """E[0][:] — zeros for HW (free target prefix), 0..n otherwise."""
    j = jnp.arange(n + 1, dtype=jnp.int32)[None, :]
    if mode == HW:
        return jnp.zeros((batch, n + 1), dtype=jnp.int32)
    return jnp.broadcast_to(j, (batch, n + 1)).astype(jnp.int32)


def extend_rows(prev: jnp.ndarray, a_mask: jnp.ndarray, b_masks: jnp.ndarray,
                row_number: jnp.ndarray) -> jnp.ndarray:
    """One DP row step: append query base `a_mask` ([B] 4-bit masks).

    prev: [B, N+1] row E[i-1][:]; row_number: [B] the new row index i (1-based).
    Returns E[i][:]. Pure function of its args — usable inside scan/jit and by
    the beam engine (which gathers/carries rows across beam reordering).
    """
    sub = ((a_mask[:, None] & b_masks) == 0).astype(jnp.int32)   # [B, N]
    d = jnp.minimum(prev[:, :-1] + sub, prev[:, 1:] + 1)          # D[1..N]
    d = jnp.concatenate([row_number[:, None].astype(jnp.int32), d], axis=1)
    j = jnp.arange(d.shape[1], dtype=jnp.int32)[None, :]
    return j + jax.lax.cummin(d - j, axis=1)


@functools.partial(jax.jit, static_argnames=("mode",))
def edit_distance(a_masks: jnp.ndarray, a_len: jnp.ndarray,
                  b_masks: jnp.ndarray, b_len: jnp.ndarray,
                  mode: int = NW) -> AlignResult:
    """Batched edit distance.

    a_masks: [B, M] query 4-bit base masks (padding arbitrary)
    b_masks: [B, N] target masks; a_len/b_len: [B] true lengths.
    """
    bsz, m = a_masks.shape
    n = b_masks.shape[1]
    row = row_init(bsz, n, mode)
    captured = jnp.where(a_len[:, None] == 0, row, _BIG)

    def step(carry, i):
        row, captured = carry
        new = extend_rows(row, a_masks[:, i], b_masks, jnp.full((bsz,), i + 1, jnp.int32))
        is_last = (i + 1) == a_len
        captured = jnp.where(is_last[:, None], new, captured)
        return (new, captured), None

    (_, captured), _ = jax.lax.scan(step, (row, captured), jnp.arange(m), unroll=4)

    j = jnp.arange(n + 1, dtype=jnp.int32)[None, :]
    col_ok = j <= b_len[:, None]
    masked = jnp.where(col_ok, captured, _BIG)
    if mode == NW:
        dist = jnp.take_along_axis(captured, b_len[:, None].astype(jnp.int32), axis=1)[:, 0]
        end = b_len.astype(jnp.int32)
        return AlignResult(dist, end, end, masked)
    dist = jnp.min(masked, axis=1)
    is_min = masked == dist[:, None]
    end_max = jnp.max(jnp.where(is_min, j, -1), axis=1)
    end_min = jnp.min(jnp.where(is_min, j, _BIG), axis=1)
    return AlignResult(dist, end_max, end_min, masked)


def best_prefix_from_row(last_row: jnp.ndarray, b_len: jnp.ndarray):
    """SHW answer from a carried row: (dist, end_max, end_min).

    Used by the beam engine on its incrementally-maintained rows.
    """
    n1 = last_row.shape[-1]
    j = jnp.arange(n1, dtype=jnp.int32)[None, :]
    masked = jnp.where(j <= b_len[:, None], last_row, _BIG)
    dist = jnp.min(masked, axis=1)
    is_min = masked == dist[:, None]
    end_max = jnp.max(jnp.where(is_min, j, -1), axis=1)
    end_min = jnp.min(jnp.where(is_min, j, _BIG), axis=1)
    return dist, end_max, end_min
