"""True multi-process distribution: run_distributed_correct under a real
2-process jax.distributed runtime (CPU backend), no cluster required
(VERDICT r1 #9). Shard/correct/merge + the psum barrier ordering."""

import os
import subprocess
import sys

import numpy as np
import pytest

from ratatosk_tpu import dna
from ratatosk_tpu.io import fastx
from tests import sim

K1, K2 = 17, 31

_RUNNER = r"""
import os
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=1")
import jax
jax.config.update("jax_platforms", "cpu")
# must precede any backend-touching jax call
jax.distributed.initialize(coordinator_address="localhost:%(port)d",
                           num_processes=2,
                           process_id=int(os.environ["PID_ARG"]))
from ratatosk_tpu.config import CorrectOpt
from ratatosk_tpu.parallel.distributed import run_distributed_correct

opt = CorrectOpt(
    small_k=%(k1)d, k=%(k2)d,
    filename_seq_in=[%(sr)r],
    filename_long_in=[%(lr)r],
    prefix_filename_out=%(out)r,
    pass1_only=%(p1)s, beam_width=8, batch_regions=16,
)
run_distributed_correct(opt,
                        coordinator="localhost:%(port)d",
                        num_processes=2,
                        process_id=int(os.environ["PID_ARG"]))
"""


def _simulate(tmp_path, seed=1500):
    rng = np.random.default_rng(seed)
    genome = sim.random_genome(rng, 9000)
    sreads = sim.short_reads(rng, genome, coverage=40.0, read_len=100)
    sr_path = str(tmp_path / "short.fa")
    with open(sr_path, "w") as f:
        for i, r in enumerate(sreads):
            f.write(f">s{i}\n{dna.decode(r)}\n")
    lreads = sim.long_reads(rng, genome, n=4, min_len=1200, max_len=1800,
                            err=0.08)
    lr_path = str(tmp_path / "long.fq")
    with open(lr_path, "w") as f:
        for i, (noisy, _, _) in enumerate(lreads):
            f.write(f"@lr{i}\n{dna.decode(noisy)}\n+\n{'!' * len(noisy)}\n")
    return sr_path, lr_path


def _run_two_proc(tmp_path, sr_path, lr_path, pass1_only, port):
    out_prefix = str(tmp_path / "multi")
    script = _RUNNER % dict(k1=K1, k2=K2, sr=sr_path, lr=lr_path,
                            out=out_prefix, port=port,
                            p1="True" if pass1_only else "False")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    # keep subprocesses off any parent jax state
    procs = []
    for pid in range(2):
        e = dict(env)
        e["PID_ARG"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script], env=e,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=540) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]
    return open(out_prefix + ".fastq").read()


def _run_single(tmp_path, sr_path, lr_path, pass1_only):
    from ratatosk_tpu.config import CorrectOpt
    from ratatosk_tpu import pipeline
    opt = CorrectOpt(small_k=K1, k=K2, filename_seq_in=[sr_path],
                     filename_long_in=[lr_path],
                     prefix_filename_out=str(tmp_path / "single"),
                     pass1_only=pass1_only, beam_width=8, batch_regions=16)
    pipeline.run_correct(opt)
    return open(str(tmp_path / "single") + ".fastq").read()


def test_two_process_shard_correct_merge(tmp_path):
    sr_path, lr_path = _simulate(tmp_path)
    expected = _run_single(tmp_path, sr_path, lr_path, True)
    got = _run_two_proc(tmp_path, sr_path, lr_path, True, port=17645)
    assert got == expected


def test_two_process_full_two_pass(tmp_path):
    """Full 2-pass distributed == single-host bit-exactly: the pass-2 graph
    must be colored by ALL shards' pass-1 output (Ratatosk.nf:166-192), the
    indexes built once on host 0 and loaded elsewhere."""
    sr_path, lr_path = _simulate(tmp_path, seed=1501)
    expected = _run_single(tmp_path, sr_path, lr_path, False)
    got = _run_two_proc(tmp_path, sr_path, lr_path, False, port=17646)
    assert got == expected
    # the once-built index artifacts exist (host 0 persisted them)
    assert os.path.exists(str(tmp_path / f"multi.index.k{K1}.npz"))
    assert os.path.exists(str(tmp_path / f"multi.index.k{K2}.npz"))
