"""Chromosome-scale single-device run (BASELINE configs[3]).

Simulates a human-chr20-sized genome (default 60 Mbp), 40x short reads
(2.4 Gbp) and ONT-like long reads, then drives the FULL production two-pass
pipeline on the accelerator, recording what the 4 Mbp bench cannot show:
index-build time at scale (bucketed native counting path), peak RSS,
correction throughput, and residual error vs ground truth.

Usage: python scripts/scale_run.py [genome_bp] [n_long_reads] [out.json]
Writes one JSON line to stdout and the same object to out.json
(default scale_run.json in the working directory).
"""
from __future__ import annotations

import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(msg):
    print(f"[scale] {msg}", file=sys.stderr, flush=True)


def rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)


def main():
    glen = int(float(sys.argv[1])) if len(sys.argv) > 1 else 60_000_000
    n_lr = int(sys.argv[2]) if len(sys.argv) > 2 else 25_000
    out_path = sys.argv[3] if len(sys.argv) > 3 else "scale_run.json"
    read_len = 4000
    phases = {}

    def phase(name, t0):
        phases[name] = round(time.time() - t0, 1)
        log(f"{name}: {phases[name]}s (peak RSS {rss_gb():.1f} GB)")

    from ratatosk_tpu import dna, testing
    from ratatosk_tpu.config import CorrectOpt
    from ratatosk_tpu.correct.engine import Corrector
    from ratatosk_tpu.graph import build as B
    from ratatosk_tpu.graph.colors import color_graph
    from ratatosk_tpu.io import fastx
    from ratatosk_tpu.pipeline import build_pass2_index, correct_file, _pass_opt
    from ratatosk_tpu.ops import cigar as CG

    rng = np.random.default_rng(20)
    t0 = time.time()
    log(f"simulating {glen/1e6:.0f} Mbp genome + 40x short reads + "
        f"{n_lr} x {read_len}bp long reads")
    genome = testing.random_genome(rng, glen, repeat_frac=0.10,
                                   repeat_len=300)
    sreads = list(testing.short_read_matrix(rng, genome, 40.0, read_len=100))
    phase("simulate_sr", t0)

    t0 = time.time()
    import tempfile
    tmpdir = tempfile.mkdtemp(prefix="rtpu_scale_")
    lr_path = os.path.join(tmpdir, "long.fq")
    truths = {}
    total_bases = 0
    with open(lr_path, "w") as f:
        for i in range(n_lr):
            start = int(rng.integers(0, glen - read_len))
            noisy, true = testing.noisy_read(rng, genome, start, read_len,
                                             err=0.10)
            if i < 400:
                truths[f"L{i}"] = true
            total_bases += len(noisy)
            f.write(f"@L{i}\n{dna.decode(noisy)}\n+\n{'!' * len(noisy)}\n")
    phase("simulate_lr", t0)

    opt = CorrectOpt(small_k=31, k=63, beam_width=16, batch_regions=512,
                     nb_threads=2, read_batch_bp=1 << 20)
    o1 = _pass_opt(opt, 1)

    # ---- pass-1 index (untimed in the bench metric; THE scale question) ----
    t0 = time.time()
    cdbg = B.build_cdbg(sreads, 31, min_count=2)
    phase("p1_cdbg_build", t0)
    log(f"pass-1 graph: {cdbg.n_unitigs} unitigs, {cdbg.index.n} k-mers")
    t0 = time.time()
    colors = color_graph(cdbg, sreads)
    phase("p1_coloring", t0)
    t0 = time.time()
    corr1 = Corrector(cdbg, colors, o1)
    corr1.warmup_compile()
    phase("p1_init_warmup", t0)

    p1_path = os.path.join(tmpdir, "out.2.fastq")
    t0 = time.time()
    n1, bp1 = correct_file(corr1, o1, [lr_path], p1_path, 1)
    t_p1 = time.time() - t0
    phase("p1_correct", t0)
    log(f"pass-1: {total_bases} bases in {t_p1:.1f}s "
        f"({total_bases/t_p1:.0f} b/s); timers {corr1.timers}")
    del corr1, cdbg, colors

    # ---- pass-2 ----
    t0 = time.time()
    cdbg2, colors2 = build_pass2_index(
        opt, ((r.codes, r.qual) for r in fastx.read_fastx(p1_path)),
        sreads, list(range(len(sreads))))
    phase("p2_index_build", t0)
    log(f"pass-2 graph: {cdbg2.n_unitigs} unitigs, {cdbg2.index.n} k-mers")
    del sreads
    o2 = _pass_opt(opt, 2)
    t0 = time.time()
    corr2 = Corrector(cdbg2, colors2, o2)
    corr2.warmup_compile()
    phase("p2_init_warmup", t0)
    p2_path = os.path.join(tmpdir, "out.fastq")
    t0 = time.time()
    n2, bp2 = correct_file(corr2, o2, [p1_path], p2_path, 2)
    t_p2 = time.time() - t0
    phase("p2_correct", t0)
    log(f"pass-2: {t_p2:.1f}s; timers {corr2.timers}")

    # ---- residual error on the truth sample ----
    t0 = time.time()
    def err_of(path):
        d = n = 0
        for rec in fastx.read_fastx(path):
            t = truths.get(rec.name)
            if t is None:
                continue
            d += CG.aln_dist(dna.codes_to_masks(rec.codes),
                             dna.codes_to_masks(t), CG.NW)
            n += len(t)
        return d / max(n, 1)
    raw_err = 0.10
    e1 = err_of(p1_path)
    e2 = err_of(p2_path)
    phase("scoring", t0)

    bps = total_bases / (t_p1 + t_p2)
    result = {
        "metric": "chr-scale corrected bases/s/chip (2-pass)",
        "genome_bp": glen, "long_read_bp": total_bases,
        "short_read_bp": int(glen * 40),
        "value": round(bps, 1), "unit": "bases/s",
        "pass1_s": round(t_p1, 1), "pass2_s": round(t_p2, 1),
        "residual_err_pass1": round(e1, 5),
        "residual_err_pass2": round(e2, 5),
        "raw_err": raw_err,
        "peak_rss_gb": round(rss_gb(), 2),
        "phases_s": phases,
    }
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
