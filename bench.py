"""Benchmark: corrected long-read bases/sec/chip over the FULL two-pass flow.

Runs on an NVIDIA GPU only: the device (platform, device_kind, count) and
the card's name and power limit are logged on stderr, and without a GPU the
benchmark exits with status 1 instead of timing the CPU.

The driver-defined metric (BASELINE.json "metric") is corrected long-read
bases/sec/chip for pass1+pass2: every input base is counted once, and the
clock covers both correction passes (pass 1 at k=31, pass 2 at k=63 on the
pass-1 output). Index construction is untimed — it is the separate `index`
step of the reference's 4-step contract (Ratatosk.cpp:1137-1144).

Default config is a multi-Mbp workload (4 Mbp genome with heavy repeat
content -> >=10^4 unitigs; 20 Mbp of 10%-error long reads), so host-side
costs that grow with graph size are inside the measurement. `python bench.py
small` runs the historical 100 kb toy for comparison with earlier rounds;
`python bench.py <genome_bp> <n_reads>` picks custom sizes.

Prints ONE JSON line to stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

The reference publishes no throughput numbers (BASELINE.md: published is
empty); vs_baseline is reported against a fixed reference point of
100k corrected bases/sec/chip (a 32-core node correcting ~40 Mbp/day/core-hour
scale — the Nextflow profile's 50x32-core x 24h budget for a human genome,
BASELINE.md cluster sizing), so >1.0 means faster than the reference's
per-node budget.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

BASELINE_BASES_PER_SEC = 100_000.0


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


PHASES = {}
_t_last = [time.time()]


def phase(name: str) -> None:
    """Close the previous wall-clock phase and open `name` (full-wall
    accounting: the phases sum to ~total wall, VERDICT r3 weak #3)."""
    now = time.time()
    if PHASES or name != "_init":
        prev = getattr(phase, "_cur", "startup")
        PHASES[prev] = PHASES.get(prev, 0.0) + now - _t_last[0]
    phase._cur = name
    _t_last[0] = now


def main() -> None:
    t_all = time.time()
    phase("imports")
    from ratatosk_tpu import devinfo
    dev = devinfo.require_gpu("bench")
    log(f"device: platform={dev['platform']} kind={dev['kind']} "
        f"count={dev['count']}")
    for line in devinfo.nvidia_smi():
        log(f"nvidia-smi name, power.limit: {line}")
    from ratatosk_tpu import dna, testing
    from ratatosk_tpu.config import CorrectOpt
    from ratatosk_tpu.correct.engine import Corrector
    from ratatosk_tpu.graph import build as B
    from ratatosk_tpu.graph.colors import color_graph
    from ratatosk_tpu.io import fastx
    from ratatosk_tpu.pipeline import build_pass2_index, correct_file, _pass_opt

    if len(sys.argv) > 1 and sys.argv[1] == "small":
        glen, n_reads = 100_000, 64
        repeat_frac, repeat_len = 0.1, 300
    elif len(sys.argv) > 1:
        glen = int(float(sys.argv[1]))
        n_reads = int(sys.argv[2]) if len(sys.argv) > 2 else max(glen // 800, 8)
        repeat_frac, repeat_len = 0.15, 250
    else:
        # default: multi-Mbp config — >=10^4 unitigs, 20 Mbp of long reads
        glen, n_reads = 4_000_000, 5000
        repeat_frac, repeat_len = 0.15, 250
    read_len = 4000

    phase("simulate")
    rng = np.random.default_rng(1234)
    log(f"simulating genome={glen}bp (repeats {repeat_frac:.0%} x "
        f"{repeat_len}bp), {n_reads} long reads x {read_len}bp, "
        f"40x short reads")
    genome = testing.random_genome(rng, glen, repeat_frac=repeat_frac,
                                   repeat_len=repeat_len)
    sreads = testing.short_reads(rng, genome, coverage=40.0)

    # nb_threads=2 double-buffers host planning against device execution;
    # ~1MB read batches keep full-width region batches on the device.
    opt = CorrectOpt(small_k=31, k=63, beam_width=16, batch_regions=512,
                     nb_threads=2, read_batch_bp=1 << 20)
    o1 = _pass_opt(opt, 1)

    # warm the kernel cache CONCURRENTLY with the (untimed) index build: a
    # toy corrector pads to the same device shape classes, and XLA compiles
    # release the GIL, so the cold-start compile cost hides under the
    # host-side graph construction
    import threading
    from ratatosk_tpu import testing as _t

    def prewarm():
        _, toy = _t.build_toy_corrector(seed=3, glen=3000, k=31)
        toy.opt = o1
        toy.warmup_compile()

    warm_thread = threading.Thread(target=prewarm, daemon=True)
    warm_thread.start()

    phase("p1_graph_build")
    log("building pass-1 colored cDBG k=31 (host, untimed index step; "
        "kernel compiles overlap in background)")
    t0 = time.time()
    cdbg = B.build_cdbg(sreads, 31, min_count=2)
    colors = color_graph(cdbg, sreads)
    log(f"pass-1 graph: {cdbg.n_unitigs} unitigs, {cdbg.index.n} k-mers "
        f"({time.time() - t0:.1f}s)")
    warm_thread.join()
    phase("p1_corrector_init")
    corr1 = Corrector(cdbg, colors, o1)

    phase("simulate_long_reads")
    tmpdir = tempfile.mkdtemp(prefix="rtpu_bench_")
    lr_path = os.path.join(tmpdir, "long.fq")
    total_bases = 0
    with open(lr_path, "w") as f:
        for i in range(n_reads):
            start = int(rng.integers(0, glen - read_len))
            noisy, _ = testing.noisy_read(rng, genome, start, read_len,
                                          err=0.10)
            total_bases += len(noisy)
            f.write(f"@L{i}\n{dna.decode(noisy)}\n+\n{'!' * len(noisy)}\n")

    # warm up: compile all bucket shapes concurrently, then run a small slice
    # so the steady path (native libs, planner caches) is hot too
    phase("p1_warmup")
    log("pass-1 warmup (compiles bucket kernels concurrently)")
    t0 = time.time()
    corr1.warmup_compile()
    warm_path = os.path.join(tmpdir, "warm.fq")
    with open(warm_path, "w") as f, open(lr_path) as src:
        for _ in range(min(n_reads, 64) * 4):
            f.write(src.readline())
    p1_path = os.path.join(tmpdir, "out.2.fastq")
    correct_file(corr1, o1, [warm_path], p1_path, 1)
    warm1 = time.time() - t0
    log(f"pass-1 warmup done ({warm1:.1f}s)")

    phase("p1_timed")
    corr1.timers = {k: 0.0 for k in corr1.timers}
    t0 = time.time()
    n1, bp1 = correct_file(corr1, o1, [lr_path], p1_path, 1)
    t_pass1 = time.time() - t0
    log(f"pass-1: {total_bases} bases in {t_pass1:.2f}s "
        f"({total_bases / t_pass1:.0f} b/s); breakdown: "
        + ", ".join(f"{k}={v:.2f}s" for k, v in corr1.timers.items()))

    phase("p2_graph_build")
    log("building pass-2 cDBG k=63 colored by pass-1 output (untimed)")
    t0 = time.time()
    cdbg2, colors2 = build_pass2_index(
        opt, ((r.codes, r.qual) for r in fastx.read_fastx(p1_path)),
        sreads, list(range(len(sreads))))
    log(f"pass-2 graph: {cdbg2.n_unitigs} unitigs, {cdbg2.index.n} k-mers "
        f"({time.time() - t0:.1f}s)")
    phase("p2_corrector_init")
    o2 = _pass_opt(opt, 2)
    corr2 = Corrector(cdbg2, colors2, o2)
    p2_path = os.path.join(tmpdir, "out.fastq")

    phase("p2_warmup")
    log("pass-2 warmup")
    t0 = time.time()
    corr2.warmup_compile()
    warm2_path = os.path.join(tmpdir, "warm2.fq")
    with open(warm2_path, "w") as f, open(p1_path) as src:
        for _ in range(min(n_reads, 64) * 4):
            f.write(src.readline())
    correct_file(corr2, o2, [warm2_path], p2_path, 2)
    warm2 = time.time() - t0
    log(f"pass-2 warmup done ({warm2:.1f}s)")

    phase("p2_timed")
    corr2.timers = {k: 0.0 for k in corr2.timers}
    t0 = time.time()
    n2, bp2 = correct_file(corr2, o2, [p1_path], p2_path, 2)
    t_pass2 = time.time() - t0
    log(f"pass-2: {t_pass2:.2f}s; breakdown: "
        + ", ".join(f"{k}={v:.2f}s" for k, v in corr2.timers.items()))

    phase("end")
    dt = t_pass1 + t_pass2
    bps = total_bases / dt
    wall = time.time() - t_all
    acc = sum(PHASES.values())
    log("wall breakdown: " + ", ".join(
        f"{k}={v:.1f}s" for k, v in PHASES.items())
        + f"; phases sum {acc:.1f}s of {wall:.1f}s wall")
    log(f"corrected {total_bases} bases through 2 passes in {dt:.2f}s -> "
        f"{bps:.0f} bases/s (output {bp2} bases); warmup {warm1 + warm2:.1f}s; "
        f"total wall {time.time() - t_all:.1f}s")

    print(json.dumps({
        "metric": "corrected_long_read_bases_per_sec_per_chip_2pass",
        "value": round(bps, 1),
        "unit": "bases/s",
        "vs_baseline": round(bps / BASELINE_BASES_PER_SEC, 3),
        "phases_s": {k: round(v, 1) for k, v in PHASES.items()},
        "pass1_s": round(t_pass1, 1), "pass2_s": round(t_pass2, 1),
        "total_wall_s": round(time.time() - t_all, 1),
    }))


if __name__ == "__main__":
    main()
