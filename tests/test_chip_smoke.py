"""chip_smoke.py's CPU-checkable parts: the device gate, the NW oracle, the
GPU-vs-CPU comparison and the trace reduction.

The phases themselves need a GPU; `python chip_smoke.py` runs them there.
"""

import glob
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

import chip_smoke as CS
from ratatosk_tpu import testing
from ratatosk_tpu.correct import engine as E
from ratatosk_tpu.correct import finish as FN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_device_gate_exits_nonzero_on_cpu():
    p = _run(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "needs an NVIDIA GPU" in p.stderr


def test_device_gate_alone_in_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    p = _run(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_bench_exits_nonzero_without_gpu():
    p = _run(os.path.join(ROOT, "bench.py"), ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "needs an NVIDIA GPU" in p.stderr


def _toy_launch(nt, n=16):
    rng = np.random.default_rng(5)
    genome, corr = testing.build_toy_corrector(seed=5, glen=20000, k=21)
    specs = [s for s in testing.toy_region_specs(corr, genome, rng, 48)
             if len(s.tgt) <= 256][:n]
    assert len(specs) >= 8
    args, statics, lmax = CS.region_batch(corr, specs, nt, n)
    fin = jax.device_get(E._beam_finish_jit(*args, **statics))
    return fin, args[1], lmax, len(specs)


def test_nw_oracle_agrees_on_toy_batch():
    for nt in (256, 2048):      # exact DP, then the banded bucket
        fin, rb, lmax, n = _toy_launch(nt)
        checked, bad = CS.nw_oracle_mismatches(
            fin.scalars, fin.seq_packed, rb.tgt_masks, rb.tgt_len, lmax, n)
        assert checked >= 4, nt
        assert bad == [], nt


def test_nw_oracle_catches_a_wrong_distance():
    fin, rb, lmax, n = _toy_launch(256)
    scal = np.array(fin.scalars)
    i_c = FN.SCALAR_FIELDS.index("completed")
    i_d = FN.SCALAR_FIELDS.index("best_dist")
    row = int(np.flatnonzero(scal[:n, i_c])[0])
    scal[row, i_d] += 1
    _, bad = CS.nw_oracle_mismatches(scal, fin.seq_packed, rb.tgt_masks,
                                     rb.tgt_len, lmax, n)
    assert [b[0] for b in bad] == [row]


def test_compare_finish_reports_differing_regions():
    fin, rb, lmax, n = _toy_launch(256)
    other = FN.FinishOut(scalars=np.array(fin.scalars),
                         seq_packed=np.array(fin.seq_packed))
    i_d = FN.SCALAR_FIELDS.index("best_dist")
    other.scalars[3, i_d] += 2
    other.seq_packed[5, 0] ^= 1
    cmp = CS.compare_finish(fin, other, n, np.asarray(rb.tgt_len))
    assert cmp["identical"] == n - 2
    assert [d["row"] for d in cmp["diffs"]] == [3, 5]
    assert cmp["diffs"][0]["fields"] == ["best_dist"]
    assert cmp["diffs"][0]["score_gap"] == 2 / int(rb.tgt_len[3])
    assert cmp["diffs"][1]["fields"] == ["path"]


def test_reduce_trace_counts_loop_steps(tmp_path):
    """Every instruction under the beam_step scope runs once per outer step,
    so the most frequent one counts the while_loop's iterations."""
    def body(i, x):
        with jax.named_scope("beam_step"):
            return jnp.sin(x) * 2.0 + i

    f = jax.jit(lambda x: jax.lax.fori_loop(0, 7, body, x))
    x = jnp.ones((64, 64))
    jax.block_until_ready(f(x))
    with jax.profiler.trace(str(tmp_path)):
        jax.block_until_ready(f(x))
    path = glob.glob(str(tmp_path / "**" / "*.xplane.pb"), recursive=True)[0]
    scopes = CS.hlo_scopes(f.lower(x).compile().as_text())
    assert any("beam_step" in v for v in scopes.values())
    res = CS.reduce_trace(path, scopes, plane_prefix="/host:CPU",
                          line_match="xla")
    assert res["outer_steps"] == 7
    assert res["device_ms_by_scope"]["beam_step"] > 0
    assert 0.0 <= res["idle_share"] <= 1.0
