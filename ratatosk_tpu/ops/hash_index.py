"""Device hash-directory k-mer lookup: O(1) gathers per probe, no per-query
canonicalization.

The sorted-array binary search (ops/kmer_index.py) costs ~2*log2(N) device
gathers per query — gather-bound on the device. And canonicalizing each query first
costs a reverse-complement + select in emulated uint64 arithmetic — the
dominant VECTOR cost when probing hundreds of 1-edit variants per window
(ops/plan_device.py). This module removes both:

- build (host): every canonical key is entered TWICE — in canonical (forward)
  form and in reverse-complement form — so the device probes a window in its
  READ orientation directly; the matched entry's flag says whether the window
  equals the canonical form (the `is_fw` the planner needs). k is odd in both
  passes (31/63), so no k-mer is its own reverse complement and the 2N keys
  stay unique.
- keys are hashed with 32-bit-word mixing (FNV-1a accumulate + lowbias32
  finalizer) — native u32 multiplies instead of emulated u64 splitmix — and
  sorted by hash with a bucket directory on the top `bits` hash bits. The
  hash whitens key skew, so the longest bucket is tiny (<= ~8).
- probe (device): h = hash(words); d0 = dir[h >> shift]; `dmax` fixed
  iterations gather one key row each and test equality. Keys are unique, so
  equality anywhere IS the key's slot. Total ~1 + dmax row-gathers/probe.

Payload `row` is the key's rank in the VALUE-sorted order (ops/kmer_index.py
rows), so device hits are interchangeable with host KeyArray.find results.

Reference role: Bifrost's minimizer-indexed k-mer hash table backing
CompactedDBG::find/searchSequence (SURVEY.md §2.3).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ratatosk_tpu.ops import kmers as K

_LO32 = np.uint64(0xFFFFFFFF)
_FNV_OFF = np.uint32(0x811C9DC5)
_FNV_P = np.uint32(0x01000193)
_LB1 = np.uint32(0x7FEB352D)
_LB2 = np.uint32(0x846CA68B)


def _lowbias32(h, xp):
    # uint32 multiplies wrap modulo 2^32 in both numpy and XLA
    h = h ^ (h >> np.uint32(16))
    h = h * _LB1
    h = h ^ (h >> np.uint32(15))
    h = h * _LB2
    return h ^ (h >> np.uint32(16))


def hash_words(w0, w1, w2=None, w3=None, xp=jnp):
    """32-bit hash of 2 or 4 uint32 words (FNV-1a + lowbias32 avalanche)."""
    with np.errstate(over="ignore"):
        h = (_FNV_OFF ^ w0) * _FNV_P
        h = (h ^ w1) * _FNV_P
        if w2 is not None:
            h = (h ^ w2) * _FNV_P
            h = (h ^ w3) * _FNV_P
        return _lowbias32(h.astype(xp.uint32), xp)


def split64(x):
    """uint64 -> (lo32, hi32) uint32 words."""
    return ((x & _LO32).astype(np.uint32) if isinstance(x, np.ndarray)
            else (x & _LO32).astype(jnp.uint32),
            (x >> np.uint64(32)).astype(np.uint32) if isinstance(x, np.ndarray)
            else (x >> np.uint64(32)).astype(jnp.uint32))


def hash_key64(lo, hi=None, xp=jnp):
    """Hash of one- or two-word packed k-mers given as uint64 arrays."""
    l0, l1 = split64(lo)
    if hi is None:
        return hash_words(l0, l1, xp=xp)
    h0, h1 = split64(hi)
    return hash_words(l0, l1, h0, h1, xp=xp)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class HashKmerIndex:
    """Hash-ordered two-orientation key table + bucket directory."""

    key_tbl: jnp.ndarray           # [2N, 2] u32 (k<=32) or [2N, 4] u32
    dir0: jnp.ndarray              # [2^bits] i32 bucket starts
    rowflag: jnp.ndarray           # [2N] i32: (value-order row << 1) | is_fw
    upa: jnp.ndarray               # [2N, 2] i32: (unitig_id, pos<<1|strand)
    k: int = dataclasses.field(metadata=dict(static=True), default=0)
    n: int = dataclasses.field(metadata=dict(static=True), default=0)
    bits: int = dataclasses.field(metadata=dict(static=True), default=0)
    dmax: int = dataclasses.field(metadata=dict(static=True), default=1)
    two_word: bool = dataclasses.field(metadata=dict(static=True),
                                       default=False)

    @staticmethod
    def build(index) -> "HashKmerIndex":
        """From a value-sorted ops/kmer_index.KmerIndex (host arrays)."""
        lo = np.asarray(index.keys_lo, dtype=np.uint64)
        n = len(lo)
        two = index.two_word
        k = index.k
        if two:
            hi = np.asarray(index.keys_hi, dtype=np.uint64)
            rhi, rlo = K.revcomp_kmer2(hi, lo, k, np)
            alo = np.concatenate([lo, rlo])
            ahi = np.concatenate([hi, rhi])
            h = hash_key64(alo, ahi, np)
        else:
            rlo = K.revcomp_kmer(lo, k, np)
            alo = np.concatenate([lo, rlo])
            ahi = None
            h = hash_key64(alo, None, np)
        n2 = 2 * n
        # is_fw=1 for the canonical-form entry, 0 for the rc-form entry
        flag = np.concatenate([np.ones(n, np.int32), np.zeros(n, np.int32)])
        rows = np.concatenate([np.arange(n, dtype=np.int32)] * 2)
        bits = max(int(np.ceil(np.log2(max(2 * n2, 2)))), 4)
        bits = min(bits, 28)
        order = np.argsort(h, kind="stable").astype(np.int64)
        hs = h[order]
        buck = (hs >> np.uint32(32 - bits)).astype(np.int64)
        counts = np.bincount(buck, minlength=1 << bits)
        dmax = int(counts.max()) if n else 1
        dir0 = np.zeros(1 << bits, np.int32)
        dir0[1:] = np.cumsum(counts[:-1]).astype(np.int32)
        slo = alo[order]
        cols = [(slo & _LO32).astype(np.uint32),
                (slo >> np.uint64(32)).astype(np.uint32)]
        if two:
            shi = ahi[order]
            cols += [(shi & _LO32).astype(np.uint32),
                     (shi >> np.uint64(32)).astype(np.uint32)]
        key_tbl = np.stack(cols, axis=1)
        rowflag = (rows[order] << 1) | flag[order]
        uid_h = np.asarray(index.unitig_id, np.int32)
        posstr = ((np.asarray(index.pos, np.int32) << 1)
                  | np.asarray(index.strand, np.int32))
        rr = rows[order]
        upa = np.stack([uid_h[rr], posstr[rr]], axis=1)
        return HashKmerIndex(
            k=k, n=n, bits=bits, dmax=max(dmax, 1),
            key_tbl=jnp.asarray(key_tbl), dir0=jnp.asarray(dir0),
            rowflag=jnp.asarray(rowflag.astype(np.int32)),
            upa=jnp.asarray(upa), two_word=two)


def probe_slots_raw(hx: HashKmerIndex, w_lo, w_hi=None, valid=None):
    """Hash-order slot of each READ-ORIENTATION window (-1 = absent)."""
    ql0, ql1 = split64(w_lo)
    if hx.two_word:
        qh0, qh1 = split64(w_hi)
        h = hash_words(ql0, ql1, qh0, qh1)
    else:
        h = hash_words(ql0, ql1)
    if hx.n == 0:
        # return before tracing the gather loop: key_tbl has a zero-size
        # leading dim and XLA's out-of-bounds clamp on an empty gather is
        # implementation-defined (ADVICE r4 #3)
        return jnp.full(w_lo.shape, -1, jnp.int32)
    bq = (h >> np.uint32(32 - hx.bits)).astype(jnp.int32)
    d0 = hx.dir0[bq]
    nn = max(2 * hx.n, 1)

    def body(i, hit):
        idx = jnp.minimum(d0 + i, nn - 1)
        kr = hx.key_tbl[idx]
        m = (kr[:, 0] == ql0) & (kr[:, 1] == ql1)
        if hx.two_word:
            m = m & (kr[:, 2] == qh0) & (kr[:, 3] == qh1)
        return jnp.where(m, idx, hit)

    hit = jax.lax.fori_loop(
        0, hx.dmax, body, jnp.full(w_lo.shape, -1, jnp.int32))
    if valid is not None:
        hit = jnp.where(valid, hit, -1)
    return hit


def probe_rowflag(hx: HashKmerIndex, w_lo, w_hi=None, valid=None):
    """(row, is_fw) of each read-orientation window; row = -1 at misses.

    row is the value-sorted index row; is_fw says the window equals the
    canonical key (the find_runs `is_fw`).
    """
    slot = probe_slots_raw(hx, w_lo, w_hi, valid)
    rf = hx.rowflag[jnp.maximum(slot, 0)]
    row = jnp.where(slot >= 0, rf >> 1, -1)
    return row, (rf & 1).astype(jnp.bool_), slot


def probe_upa_raw(hx: HashKmerIndex, w_lo, w_hi=None, valid=None):
    """(uid, pos, strand, is_fw) per read-orientation window; uid=-1 miss."""
    slot = probe_slots_raw(hx, w_lo, w_hi, valid)
    safe = jnp.maximum(slot, 0)
    pa = hx.upa[safe]
    rf = hx.rowflag[safe]
    uid = jnp.where(slot >= 0, pa[:, 0], -1)
    pos = jnp.where(slot >= 0, pa[:, 1] >> 1, 0)
    strand = jnp.where(slot >= 0, pa[:, 1] & 1, 0)
    return uid, pos, strand, (rf & 1).astype(jnp.bool_)


def probe_rows(hx: HashKmerIndex, q_lo, q_hi=None, valid=None):
    """Value-sorted row of CANONICAL queries — drop-in for KeyArray.find.

    A canonical query matches its forward-form entry directly.
    """
    row, _, _ = probe_rowflag(hx, q_lo, q_hi, valid)
    return row


def make_prefilter_bitmap(index, bits: Optional[int] = None):
    """Hashed occupancy bitmap over BOTH orientations, u32-word packed.

    One u32 gather + bit test rejects most absent 1-edit variant keys before
    the hash-table probe; no false negatives (tested). Uses a SECOND lowbias
    pass over the same 32-bit hash so the bitmap decorrelates from the
    directory's top bits.
    """
    n = max(int(index.n), 1)
    if bits is None:
        # ~0.7% occupancy over the 2n two-orientation entries: the survivor
        # buffers in ops/plan_device.py are sized for a ~1% pass rate, and
        # every false positive costs a phase-B probe (~10 gathers)
        bits = min(30, max(20, int(np.ceil(np.log2(256 * n)))))
    lo = np.asarray(index.keys_lo, np.uint64)
    k = index.k
    if index.two_word:
        hi = np.asarray(index.keys_hi, np.uint64)
        rhi, rlo = K.revcomp_kmer2(hi, lo, k, np)
        h = hash_key64(np.concatenate([lo, rlo]),
                       np.concatenate([hi, rhi]), np)
    else:
        rlo = K.revcomp_kmer(lo, k, np)
        h = hash_key64(np.concatenate([lo, rlo]), None, np)
    h2 = _lowbias32(h, np)
    idx = (h2 >> np.uint32(32 - bits)).astype(np.int64)
    tbl = np.zeros(1 << max(bits - 5, 0), np.uint32)
    np.bitwise_or.at(tbl, idx >> 5,
                     np.uint32(1) << (idx & 31).astype(np.uint32))
    return jnp.asarray(tbl), bits


def prefilter_test(tbl, bits: int, h):
    """1 = 32-bit hash may be present (one u32 gather per query)."""
    h2 = _lowbias32(h.astype(jnp.uint32), jnp)
    idx = (h2 >> np.uint32(32 - bits)).astype(jnp.int32)
    w = tbl[idx >> 5]
    return ((w >> (idx & 31).astype(jnp.uint32)) & 1).astype(jnp.bool_)


def make_half_bitmap(index, h: int, bits: Optional[int] = None):
    """Pigeonhole half-k-mer bitmap: h-prefixes and h-suffixes of every key
    in BOTH orientations.

    A 1-edit variant of a window keeps at least one of (first h bases,
    last h bases) intact, so a window whose h-prefix AND h-suffix are both
    absent from this table has NO 1-edit hit — two u32 gathers per WINDOW
    POSITION prune all ~3k+8k variant probes there. Exact (no false
    negatives): false positives only cost enumeration work downstream.
    h <= 31 so each half packs into one uint64.
    """
    n = max(int(index.n), 1)
    k = index.k
    lo = np.asarray(index.keys_lo, np.uint64)
    if index.two_word:
        hi = np.asarray(index.keys_hi, np.uint64)
        rhi, rlo = K.revcomp_kmer2(hi, lo, k, np)
        alo = np.concatenate([lo, rlo])
        ahi = np.concatenate([hi, rhi])
        # value = ahi * 2^64 + alo, bases big-endian (2k bits used)
        sh = 2 * (k - h)
        if sh >= 64:
            pre = ahi >> np.uint64(sh - 64)
        else:
            pre = ((ahi << np.uint64(64 - sh)) | (alo >> np.uint64(sh)))
            pre &= np.uint64((1 << (2 * h)) - 1)
    else:
        rlo = K.revcomp_kmer(lo, k, np)
        alo = np.concatenate([lo, rlo])
        pre = alo >> np.uint64(2 * (k - h))
    suf = alo & np.uint64((1 << (2 * h)) - 1)
    halves = np.concatenate([pre, suf])
    if bits is None:
        bits = min(30, max(20, int(np.ceil(np.log2(128 * len(halves))))))
    hh = hash_key64(halves, None, np)
    h2 = _lowbias32(hh, np)
    idx = (h2 >> np.uint32(32 - bits)).astype(np.int64)
    tbl = np.zeros(1 << max(bits - 5, 0), np.uint32)
    np.bitwise_or.at(tbl, idx >> 5,
                     np.uint32(1) << (idx & 31).astype(np.uint32))
    return jnp.asarray(tbl), bits
