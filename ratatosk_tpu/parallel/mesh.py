"""Device mesh + shardings for multi-chip correction.

The reference scales by chunk-scattering long reads across SLURM nodes with
the index replicated per node (Ratatosk_nf/Ratatosk.nf:5-59,280; SURVEY.md
§2.4). JAX equivalent: a flat `jax.sharding.Mesh` with one `data` axis over
the local devices — weak-region batches shard across it, the DeviceGraph
replicates — and XLA inserts any collectives. A flat axis suits GPUs joined
all to all by NVLink: no device pair is closer than another. For indexes
that exceed one device's memory, parallel/sharded_index.py range-partitions
the k-mer index over the same axis.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ratatosk_tpu.correct import beam as BM
from ratatosk_tpu.correct.graphdev import DeviceGraph

DATA_AXIS = "data"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (DATA_AXIS,))


def replicate_graph(g: DeviceGraph, mesh: Mesh) -> DeviceGraph:
    sh = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), g)


def shard_regions(rb: BM.RegionBatch, mesh: Mesh) -> BM.RegionBatch:
    """Shard a region batch over the data axis (leading dim must divide)."""
    def put(x):
        spec = P(DATA_AXIS, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree_util.tree_map(put, rb)


def pad_regions_to(rb: BM.RegionBatch, r_pad: int) -> BM.RegionBatch:
    """Pad the leading axis to r_pad (dummy regions are inert: tgt_len=1)."""
    r = rb.tgt_masks.shape[0]
    if r == r_pad:
        return rb

    def pad(x):
        width = [(0, r_pad - r)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, width)

    rb2 = jax.tree_util.tree_map(pad, rb)
    return rb2._replace(
        tgt_len=rb2.tgt_len.at[r:].set(1),
        end_tip=rb2.end_tip.at[r:].set(-1),
        max_plen=rb2.max_plen.at[r:].set(1),
    )


def sharded_beam_search(g: DeviceGraph, rb: BM.RegionBatch, mesh: Mesh, *,
                        beam: int, lmax: int, min_cov: int = 2) -> BM.BeamResult:
    """beam_search with regions data-parallel over the mesh, graph replicated.

    The beam kernel is purely per-region, so XLA partitions it with zero
    collectives — the multi-chip throughput path (scaling efficiency target,
    BASELINE.md north star).
    """
    n = mesh.devices.size
    r = rb.tgt_masks.shape[0]
    r_pad = ((r + n - 1) // n) * n
    rb = pad_regions_to(rb, r_pad)
    g = replicate_graph(g, mesh)
    rb = shard_regions(rb, mesh)
    out_sh = NamedSharding(mesh, P(DATA_AXIS))
    fn = jax.jit(
        lambda g_, rb_: BM.beam_search(g_, rb_, beam=beam, lmax=lmax,
                                       min_cov=min_cov),
        out_shardings=jax.tree_util.tree_map(lambda _: out_sh,
                                             BM.BeamResult(*([0] * 7))),
    )
    res = fn(g, rb)
    return jax.tree_util.tree_map(lambda x: x[:r], res)
