"""Sharded k-mer index: range-partitioned keys over the device mesh.

The replicated index (parallel/mesh.py) matches the reference's
index-per-node semantics (Ratatosk.nf:280). For genomes whose index exceeds
one device's memory (the reference needs a 448 GB node for human, BASELINE.md),
the sorted canonical-key array is *range-partitioned*: device i holds keys in
[split[i], split[i+1]). A batched lookup runs under shard_map: every device
binary-searches the full (replicated) query batch against its local shard —
keys are sorted, so each query hits exactly one shard and misses return -1 —
and one `pmax` combines the per-shard answers. One collective per lookup
batch, O(log(N/D)) gathers per device: the all-gather-free analog of the
reference's "replicate index to every node" scaled past one node's memory.

Both key widths shard: k<=32 (one uint64 word) and 32<k<=64 (two words,
ordered by (hi, lo) — the pass-2 k=63 index, the one that actually outgrows
device memory, partitions the same way).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ratatosk_tpu.ops.kmer_index import KmerIndex


class ShardedKmerIndex:
    """Sorted key array split into equal contiguous ranges across a mesh axis."""

    def __init__(self, index: KmerIndex, mesh: Mesh):
        self.axis = mesh.axis_names[0]
        self.mesh = mesh
        self.k = index.k
        self.two_word = index.two_word
        n_dev = mesh.devices.size
        n = index.n
        per = -(-n // n_dev)
        self.n = n
        self.per = per
        pad = per * n_dev - n
        maxkey = np.uint64(0xFFFFFFFFFFFFFFFF)

        def padk(x, fill):
            return np.concatenate([np.asarray(x), np.full(pad, fill, x.dtype)])

        sh = NamedSharding(mesh, P(self.axis))
        self.keys = jax.device_put(
            padk(index.keys_lo, maxkey).reshape(n_dev, per), sh)
        self.keys_hi = None if not index.two_word else jax.device_put(
            padk(index.keys_hi, maxkey).reshape(n_dev, per), sh)
        self.uid = jax.device_put(
            padk(index.unitig_id, -1).reshape(n_dev, per), sh)
        self.pos = jax.device_put(
            padk(index.pos, 0).reshape(n_dev, per), sh)
        self.strand = jax.device_put(
            padk(index.strand.astype(np.int32), 0).reshape(n_dev, per), sh)
        self._lookup = self._build_lookup()

    def _build_lookup(self):
        per = self.per
        mesh = self.mesh
        axis = self.axis
        two = self.two_word

        def local(keys, keys_hi, uid, pos, strand, q_lo, q_hi):
            # keys [1, per] local shard; q [Q] replicated
            k = keys[0]
            kh = keys_hi[0] if two else None
            steps = max(1, int(np.ceil(np.log2(per + 1))))
            # carries become axis-varying once they touch the local shard
            lo = jax.lax.pcast(jnp.zeros(q_lo.shape, jnp.int32), (axis,),
                               to="varying")
            hi = jax.lax.pcast(jnp.full(q_lo.shape, per, jnp.int32), (axis,),
                               to="varying")

            def body(_, lh):
                lo, hi = lh
                mid = (lo + hi) >> 1
                m = jnp.minimum(mid, per - 1)
                if two:
                    go = (kh[m] < q_hi) | ((kh[m] == q_hi) & (k[m] < q_lo))
                else:
                    go = k[m] < q_lo
                return jnp.where(go, mid + 1, lo), jnp.where(go, hi, mid)

            lo, _ = jax.lax.fori_loop(0, steps, body, (lo, hi))
            safe = jnp.minimum(lo, per - 1)
            found = (lo < per) & (k[safe] == q_lo)
            if two:
                found = found & (kh[safe] == q_hi)
            hit_uid = jnp.where(found, uid[0][safe], -1)
            hit_pos = jnp.where(found, pos[0][safe], -1)
            hit_strand = jnp.where(found, strand[0][safe], -1)
            # each query exists in exactly one shard; pmax combines (-1 = miss)
            return (jax.lax.pmax(hit_uid, axis),
                    jax.lax.pmax(hit_pos, axis),
                    jax.lax.pmax(hit_strand, axis))

        fn = jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(axis, None), P(axis, None), P(axis, None),
                      P(axis, None), P(axis, None), P(), P()),
            out_specs=(P(), P(), P()),
        )
        return jax.jit(fn)

    def lookup(self, q_lo: jnp.ndarray, q_hi: Optional[jnp.ndarray] = None):
        """Canonical uint64 queries [Q] -> (uid, pos, strand) int32 [Q],
        -1 where absent. Two-word indexes require q_hi."""
        if self.two_word and q_hi is None:
            raise ValueError("two-word index lookup requires q_hi")
        kh = self.keys_hi if self.two_word else self.keys
        qh = q_hi if self.two_word else q_lo
        return self._lookup(self.keys, kh, self.uid, self.pos, self.strand,
                            jnp.asarray(q_lo), jnp.asarray(qh))
