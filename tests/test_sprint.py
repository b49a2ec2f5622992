"""Sprint-mode beam equivalence: multi-base advancement is a pure schedule
change.

Between branch points every live entry's next base is deterministic, so
advancing up to sprint-1 mid-unitig bases per outer step (beam._sprint_advance)
must reproduce the one-base-per-step search EXACTLY — same winning paths,
distances, scoreboard contents, reconstruction. The stride is capped so no
event (unitig boundary, right-anchor arrival, budget freeze) can occur inside
a sprint; events land on the branch step that follows.

The sprint's band update itself (beam.sprint_rows) is pinned to a
straight-line NumPy replica of the E-transformed row recurrence.
"""

import numpy as np
import jax.numpy as jnp

from ratatosk_tpu import testing
from ratatosk_tpu.correct import beam as BM
from ratatosk_tpu.correct.engine import make_region_batch

BIG = 1 << 20


def _specs(seed, k, n, nt):
    rng = np.random.default_rng(seed)
    genome, corr = testing.build_toy_corrector(seed=seed, glen=30000, k=k)
    specs = testing.toy_region_specs(corr, genome, rng, n)
    return corr, [s for s in specs if len(s.tgt) <= nt]


def test_sprint_bit_identical_exact_band():
    corr, specs = _specs(7, 21, 48, 256)
    assert len(specs) >= 16
    rb, lmax = make_region_batch(specs, 256, corr.colors.cap,
                                 r_pad=max(len(specs), 8))
    for band in (0, 64):
        r1 = BM.beam_search(corr.g, rb, beam=8, lmax=lmax, min_cov=2,
                            band=band, sprint=1)
        r8 = BM.beam_search(corr.g, rb, beam=8, lmax=lmax, min_cov=2,
                            band=band, sprint=8)
        for f in BM.BeamResult._fields:
            assert np.array_equal(np.asarray(getattr(r1, f)),
                                  np.asarray(getattr(r8, f))), (band, f)


def test_sprint_bit_identical_mirrored():
    corr, specs = _specs(13, 17, 32, 256)
    specs = [s for s in specs if s.mirror is not None]
    assert specs
    rb, lmax = make_region_batch(specs, 256, corr.colors.cap, mirrored=True,
                                 r_pad=max(len(specs), 8))
    r1 = BM.beam_search(corr.g, rb, beam=8, lmax=lmax, min_cov=2, sprint=1)
    r4 = BM.beam_search(corr.g, rb, beam=8, lmax=lmax, min_cov=2, sprint=4)
    for f in BM.BeamResult._fields:
        assert np.array_equal(np.asarray(getattr(r1, f)),
                              np.asarray(getattr(r4, f))), f


def _ref_sprint(rwin, btgt, nb, newcols, wsall, mreg, live, plen, smax):
    """NumPy oracle for the sprint's band-state evolution."""
    rwin = rwin.copy()
    btgt = btgt.copy()
    R, B, W = rwin.shape
    for r in range(R):
        for j in range(smax - 1):
            if j >= mreg[r]:
                break
            ws_n = wsall[r, j + 1]
            delta = ws_n - wsall[r, j]
            if delta == 1:
                btgt[r, :-1] = btgt[r, 1:]
                btgt[r, -1] = newcols[r, j]
            cols = ws_n + np.arange(W)
            for b in range(B):
                if not live[r, b]:
                    continue
                row = rwin[r, b]
                prev_j = np.concatenate([row[1:], [BIG]]) if delta == 1 else row
                prev_jm1 = row if delta == 1 else np.concatenate([[BIG], row[:-1]])
                sub = ((1 << nb[r, b, j]) & btgt[r]) == 0
                dd = np.minimum(prev_jm1 + sub, prev_j + 1)
                dd = np.where(cols == 0, plen[r, b] + j + 1, dd)
                dd = np.minimum(dd, BIG)
                ee = cols + np.minimum.accumulate(dd - cols)
                rwin[r, b] = np.minimum(ee, BIG)
    return rwin, btgt


def test_sprint_rows_match_numpy_oracle():
    rng = np.random.default_rng(0)
    R, B, W, smax = 5, 4, 37, 8
    rwin = rng.integers(0, 200, (R, B, W)).astype(np.int32)
    btgt = (1 << rng.integers(0, 4, (R, W))).astype(np.int32)
    nb = rng.integers(0, 4, (R, B, smax - 1)).astype(np.int32)
    newcols = (1 << rng.integers(0, 4, (R, smax - 1))).astype(np.int32)
    # plausible monotone window starts (delta in {0,1} per substep); one
    # window starts at column 0, so the NW boundary column is exercised
    ws0 = rng.integers(0, 50, R)
    ws0[0] = 0
    deltas = rng.integers(0, 2, (R, smax - 1))
    wsall = (ws0[:, None] + np.concatenate(
        [np.zeros((R, 1), int), np.cumsum(deltas, axis=1)], axis=1)
    ).astype(np.int32)
    mreg = rng.integers(0, smax, R).astype(np.int32)
    mreg[1] = smax - 1
    live = rng.integers(0, 2, (R, B)).astype(bool)
    plen = rng.integers(0, 100, (R, B)).astype(np.int32)

    got_r, got_b = BM.sprint_rows(
        jnp.asarray(rwin), jnp.asarray(btgt), jnp.asarray(nb),
        jnp.asarray(newcols), jnp.asarray(wsall), jnp.asarray(mreg),
        jnp.asarray(live), jnp.asarray(plen))
    want_r, want_b = _ref_sprint(rwin, btgt, nb, newcols, wsall, mreg, live,
                                 plen, smax)
    np.testing.assert_array_equal(np.asarray(got_r), want_r)
    np.testing.assert_array_equal(np.asarray(got_b), want_b)
