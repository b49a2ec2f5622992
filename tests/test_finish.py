"""Device finish bundle: the fixed-point open-region score is exact.

s1_open_m ships 1 - d/n in millionths. It is computed in integers, so the
GPU and the CPU backend return the same value; a float32 division differs in
its last bit between backends, and float32 truncation gives 962963 here."""

import jax.numpy as jnp
import numpy as np

from ratatosk_tpu import dna
from ratatosk_tpu.correct import beam as BM
from ratatosk_tpu.correct import finish as FN


def test_open_score_fixed_point_is_exact():
    n, nt = 27, 32
    rng = np.random.default_rng(1)
    tgt = rng.integers(0, 4, n).astype(np.uint8)
    seq = tgt.copy()
    seq[13] = (seq[13] + 1) % 4                 # NW distance exactly 1
    masks = np.zeros((1, nt), np.uint8)
    masks[0, :n] = dna.codes_to_masks(tgt)
    best = np.zeros((1, nt), np.uint8)
    best[0, :n] = seq
    i32 = lambda v: jnp.asarray([v], jnp.int32)   # noqa: E731
    res = BM.BeamResult(best_seq=jnp.asarray(best), best_len=i32(n),
                        best_dist=i32(1), best_end=i32(n),
                        second_dist=i32(1 << 20),
                        completed=jnp.asarray([False]), n_done=i32(0))
    out = FN.finish_bundle(jnp.asarray(masks), i32(n),
                           jnp.zeros((1, nt), jnp.int32), jnp.int32(40),
                           jnp.int32(21), res, w=0, min_score_open=0.6)
    row = dict(zip(FN.SCALAR_FIELDS, np.asarray(out.scalars)[0].tolist()))
    assert row["ok_open"] == 1 and row["istar"] == n
    assert row["s1_open_m"] == (n - 1) * 1_000_000 // n == 962962
