#!/usr/bin/env python3
"""Smoke test of the correction path on NVIDIA GPUs.

    python chip_smoke.py           # one GPU: phases main..planner
    python chip_smoke.py --four    # four GPUs of one host: phase four only

Phases, all in this one process (a JAX child would find the card's memory
already held by this one):

  main      `ratatosk_tpu.cli correct`, both passes (k=31 then k=63), on a
            seeded bacterial-scale deployment (BASELINE.json configs[0-1]):
            a 4 Mbp genome with 15% repeats of 250 bp, 40x short reads of
            120 bp with eight 3 kbp coverage holes (short-read dropout, which
            is what sends pass 2 regions into the 5376 bucket), and 1,000
            long reads of 4 kbp at 10% error. Prints the residual error of
            the raw, pass-1 and pass-2 reads against the truth and the
            (k, NT, R) launch shapes reached; fails unless pass 2 is at
            least 5x below raw and every bucket and R tier ran.
  buckets   per bucket NT 256/2048/5376 at R=512, on region batches the main
            phase launched: first-call compile time in the main phase,
            compiled.memory_analysis(), median of 3 warm launches.
  trace     one jax.profiler trace of a warm NT=2048, R=512 launch: device
            time under the beam_sprint and beam_step scopes, outer steps,
            and device idle time between kernels inside the while_loop.
  numerics  the production beam+finish jit on the GPU and on the CPU backend
            of this process, on identical region batches (NT 256 at R=512,
            2048 and 5376 at R=128): >= 99.5% of regions identical; and the
            NW distance of every completed GPU path equals ops/cigar's NumPy
            DP of that path against its target.
  planner   the device batch planner (plan_on_device) against the native
            host planner on one read batch: identical runs and seeds.
  four      (--four only) the same reads through Corrector(mesh=4 GPUs),
            with and without the sharded k-mer index, against one GPU:
            identical FASTQ for both passes; sharded index lookups at k=31
            and k=63 (two-word) against the replicated index.

Exits 1, without the final line, when JAX finds no GPU or any phase fails.
The last line of standard output is
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
Per-phase details are written to chiprun_out/chip_smoke/<phase>.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import statistics
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out", "chip_smoke")
WORK_DIR = os.path.join(HERE, ".smoke_work")


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


@dataclasses.dataclass
class Deployment:
    """Bacterial-scale two-pass deployment (BASELINE.json configs[0-1])."""

    genome_bp: int = 4_000_000
    repeat_frac: float = 0.15
    repeat_len: int = 250
    short_cov: float = 40.0
    short_len: int = 120
    n_holes: int = 8
    hole_len: int = 3000
    n_long: int = 1000
    long_len: int = 4000
    long_err: float = 0.10
    seed: int = 1234


def simulate(dep: Deployment, work: str):
    """Write short.fa / long.fq under `work`; returns (paths, truth by name)."""
    from ratatosk_tpu import dna, testing
    rng = np.random.default_rng(dep.seed)
    genome = testing.random_genome(rng, dep.genome_bp,
                                   repeat_frac=dep.repeat_frac,
                                   repeat_len=dep.repeat_len)
    step = dep.genome_bp // (dep.n_holes + 1)
    holes = [(step * (i + 1), step * (i + 1) + dep.hole_len)
             for i in range(dep.n_holes)]
    sr = testing.short_read_matrix(rng, genome, dep.short_cov,
                                   read_len=dep.short_len, holes=holes)
    chars = np.frombuffer(b"ACGTN", np.uint8)[sr]
    short_path = os.path.join(work, "short.fa")
    with open(short_path, "wb") as f:
        f.write(b"".join(b">S%d\n%s\n" % (i, row.tobytes())
                         for i, row in enumerate(chars)))
    long_path = os.path.join(work, "long.fq")
    truth = {}
    with open(long_path, "w") as f:
        for i in range(dep.n_long):
            start = int(rng.integers(0, dep.genome_bp - dep.long_len))
            noisy, truth[f"L{i}"] = testing.noisy_read(
                rng, genome, start, dep.long_len, err=dep.long_err)
            f.write(f"@L{i}\n{dna.decode(noisy)}\n+\n{'!' * len(noisy)}\n")
    return short_path, long_path, truth


def residual_error(path: str, truth: dict, names) -> float:
    """Edit distance per true base (testing.error_rate) over `names`."""
    from ratatosk_tpu import testing
    from ratatosk_tpu.io import fastx
    want = set(names)
    d = n = 0.0
    for rec in fastx.read_fastx(path):
        if rec.name in want:
            true = truth[rec.name]
            d += testing.error_rate(rec.codes, true) * len(true)
            n += len(true)
    return d / max(n, 1.0)


class Launches:
    """Records every beam launch of the main path: (k, NT, R) shapes, the
    compile seconds spent inside each shape's launches, and the largest
    forward region batch per bucket (reused by later phases)."""

    def __init__(self):
        self.shapes: dict = {}
        self.batches: dict = {}      # nt -> (corrector, specs)
        self.correctors: dict = {}   # k -> corrector
        self.compile_s = 0.0
        self.cache = {"hits": 0, "misses": 0}

    def install(self):
        import jax
        from ratatosk_tpu.correct.engine import Corrector

        def on_duration(event, duration, **_):
            if event == "/jax/core/compile/backend_compile_duration":
                self.compile_s += duration

        def on_event(event, **_):
            if event == "/jax/compilation_cache/cache_hits":
                self.cache["hits"] += 1
            elif event == "/jax/compilation_cache/cache_misses":
                self.cache["misses"] += 1

        jax.monitoring.register_event_duration_secs_listener(on_duration)
        jax.monitoring.register_event_listener(on_event)
        orig = Corrector._launch_bucket

        def launch(corr, specs, nt, mirrored, beam=None):
            c0 = self.compile_s
            fin, lmax = orig(corr, specs, nt, mirrored, beam)
            key = (int(corr.cdbg.k), nt, int(fin.scalars.shape[0]))
            ent = self.shapes.setdefault(key, {"launches": 0, "compile_s": 0.0})
            ent["launches"] += 1
            ent["compile_s"] += self.compile_s - c0
            self.correctors[int(corr.cdbg.k)] = corr
            best = self.batches.get(nt)
            if not mirrored and (best is None or len(specs) > len(best[1])):
                self.batches[nt] = (corr, list(specs))
            return fin, lmax

        Corrector._launch_bucket = launch


def region_batch(corr, specs, nt: int, r: int):
    """(args, statics, lmax) of the production _beam_finish launch for
    `specs` padded to R=r, exactly as Corrector._launch_bucket builds it."""
    import jax.numpy as jnp
    from ratatosk_tpu.correct import engine as E
    opt = corr.opt
    rb, lmax = E.make_region_batch(specs[:r], nt, corr.colors.cap, r_pad=r,
                                   len_factor=opt.weak_region_len_factor)
    band = E.bucket_band(nt, opt.band_width)
    statics = dict(beam=opt.beam_width, lmax=lmax,
                   min_cov=opt.min_cov_vertices, band=band, w=band,
                   min_score_open=opt.min_score_open_region)
    args = (corr.g, rb, jnp.int32(corr.qv_max), jnp.int32(corr.cdbg.k))
    return args, statics, lmax


# ---------------------------------------------------------------- phases

def phase_main(dep: Deployment, launches: Launches) -> dict:
    from ratatosk_tpu import cli
    from ratatosk_tpu.correct.engine import BUCKETS
    t0 = time.time()
    short_path, long_path, truth = simulate(dep, WORK_DIR)
    t_sim = time.time() - t0
    launches.install()
    out = os.path.join(WORK_DIR, "out")
    t0 = time.time()
    rc = cli.main(["correct", "-s", short_path, "-l", long_path, "-o", out,
                   "--batch-regions", "512", "-v"])
    t_cli = time.time() - t0
    # every 10th read: testing.error_rate is a NumPy row DP
    names = [f"L{i}" for i in range(0, dep.n_long, 10)]
    raw_err = residual_error(long_path, truth, names)
    e1 = residual_error(out + ".2.fastq", truth, names)
    e2 = residual_error(out + ".fastq", truth, names)
    shapes = sorted(launches.shapes.items())
    buckets = {nt for _, nt, _ in launches.shapes}
    tiers = {r for _, _, r in launches.shapes}
    res = {
        "simulate_s": t_sim, "cli_s": t_cli, "cli_rc": rc,
        "err_raw": raw_err, "err_pass1": e1, "err_pass2": e2,
        "raw_over_pass2": raw_err / max(e2, 1e-12),
        "scored_reads": len(names),
        "launch_shapes": [{"k": k, "nt": nt, "R": r, **v}
                          for (k, nt, r), v in shapes],
        "compile_s_total": launches.compile_s,
        "compile_cache": dict(launches.cache),
    }
    res["ok"] = (rc == 0 and e2 * 5 <= raw_err
                 and buckets == set(BUCKETS) and tiers == {128, 256, 512})
    log(f"main: simulate {t_sim:.1f}s, cli correct {t_cli:.1f}s (rc {rc})")
    log(f"main: residual error raw {raw_err:.5f} pass1 {e1:.5f} "
        f"pass2 {e2:.5f} ({res['raw_over_pass2']:.1f}x below raw; need 5x)")
    for s in res["launch_shapes"]:
        log(f"main: launches k={s['k']} NT={s['nt']} R={s['R']}: "
            f"{s['launches']} (compile {s['compile_s']:.1f}s)")
    log(f"main: backend compile {launches.compile_s:.1f}s total; "
        f"persistent cache {launches.cache}")
    return res


def phase_buckets(launches: Launches) -> dict:
    import jax
    from ratatosk_tpu.correct import engine as E
    res = {"buckets": []}
    for nt in E.BUCKETS:
        corr, specs = launches.batches[nt]
        args, statics, _ = region_batch(corr, specs, nt, 512)
        t0 = time.time()
        compiled = E._beam_finish_jit.lower(*args, **statics).compile()
        t_load = time.time() - t0
        ma = compiled.memory_analysis()
        mem = {f: int(getattr(ma, f)) for f in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")} \
            if ma is not None else None
        jax.block_until_ready(compiled(*args))
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(compiled(*args))
            times.append(time.perf_counter() - t0)
        main_compile = launches.shapes.get(
            (int(corr.cdbg.k), nt, 512), {}).get("compile_s")
        b = {"nt": nt, "R": 512, "k": int(corr.cdbg.k),
             "real_regions": min(len(specs), 512),
             "compile_s_main_path": main_compile,
             "lower_compile_s_now": t_load,
             "memory_analysis": mem,
             "launch_s": times, "launch_s_median": statistics.median(times)}
        res["buckets"].append(b)
        where = (f"compile {main_compile:.1f}s in the main phase"
                 if main_compile is not None else
                 f"not launched at R=512 in the main phase, compiled here in "
                 f"{t_load:.1f}s")
        log(f"buckets: NT={nt} R=512 k={b['k']} ({b['real_regions']} real "
            f"regions): {where}; median warm launch "
            f"{b['launch_s_median'] * 1e3:.1f} ms of {times}; memory {mem}")
    res["ok"] = True
    return res


def hlo_scopes(hlo_text: str) -> dict:
    """HLO instruction name -> op_name metadata, from compiled HLO text.

    Each name is also entered as its GPU kernel name ('.' and '-' become
    '_'): inside a command buffer a kernel's trace event carries the fusion's
    kernel name, not the HLO op."""
    import re
    out = {}
    pat = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name=\"([^\"]*)\"")
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if m:
            out[m.group(1)] = m.group(2)
            out[re.sub(r"[.\-]", "_", m.group(1))] = m.group(2)
    return out


def reduce_trace(path: str, op_names: dict, plane_prefix: str = "/device:GPU",
                 line_match: str = "stream") -> dict:
    """Device time by scope, outer steps and idle gaps of one traced launch.

    A kernel's scope is beam_sprint or beam_step when either name appears in
    its trace stats or in the op_name of its HLO instruction (looked up by
    the event's name, then by its hlo_op stat); device memory copies are
    `memcpy` (on the GPU they include the while_loop predicate each
    iteration reads back to the host); kernels of the chained finish_bundle
    are `finish`; everything else (sprint set-up, loop control, winner
    reconstruction) is `other`. Each beam_step instruction
    runs once per outer step, so the most frequent one counts the steps.
    Idle is the part of a window in which nothing runs on the device: over
    the whole launch, and inside the while_loop (first to last scoped
    kernel)."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(path)
    events = []
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            if line_match not in line.name.lower():
                continue
            for ev in line.events:
                st = {k: v for k, v in ev.stats}
                op = ev.name if ev.name in op_names else \
                    str(st.get("hlo_op", ev.name))
                text = " ".join(str(v) for v in st.values()) + " " + \
                    op_names.get(op, "")
                scope = ("beam_sprint" if "beam_sprint" in text else
                         "beam_step" if "beam_step" in text else
                         "memcpy" if ev.name.lower().startswith("memcpy")
                         else "finish" if "finish_bundle" in text
                         else "other")
                events.append((ev.start_ns, ev.start_ns + ev.duration_ns,
                               scope, op))
    if not events:
        raise RuntimeError(f"no {plane_prefix} {line_match} events in {path}")
    events.sort()

    def busy(evs):
        tot, cur_s, cur_e = 0.0, None, None
        for s, e, _, _ in evs:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    tot += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        return tot + (cur_e - cur_s)

    by_scope, n_scope = {}, {}
    for s, e, sc, _ in events:
        by_scope[sc] = by_scope.get(sc, 0.0) + (e - s)
        n_scope[sc] = n_scope.get(sc, 0) + 1
    step_ops = {}
    for _, _, sc, op in events:
        if sc == "beam_step":
            step_ops[op] = step_ops.get(op, 0) + 1
    steps = max(step_ops.values()) if step_ops else 0
    window = events[-1][1] - events[0][0]
    loop = [ev for ev in events if ev[2] in ("beam_sprint", "beam_step")]
    loop_evs = [ev for ev in events
                if loop and loop[0][0] <= ev[0] and ev[1] <= loop[-1][1]]
    loop_window = (loop[-1][1] - loop[0][0]) if loop else 0
    loop_idle = loop_window - busy(loop_evs) if loop_evs else 0
    return {
        "kernels": len(events),
        "device_ms_by_scope": {k: v / 1e6 for k, v in by_scope.items()},
        "events_by_scope": n_scope,
        "outer_steps": steps,
        "kernels_per_step": len(loop_evs) / max(steps, 1),
        "window_ms": window / 1e6,
        "idle_share": 1.0 - busy(events) / window,
        "loop_window_ms": loop_window / 1e6,
        "loop_idle_ms": loop_idle / 1e6,
        "loop_idle_share": loop_idle / max(loop_window, 1),
        "loop_idle_us_per_step": loop_idle / 1e3 / max(steps, 1),
    }


def phase_trace(launches: Launches) -> dict:
    import glob
    import jax
    from ratatosk_tpu.correct import engine as E
    corr, specs = launches.batches[2048]
    args, statics, _ = region_batch(corr, specs, 2048, 512)
    jax.block_until_ready(E._beam_finish_jit(*args, **statics))
    tdir = os.path.join(WORK_DIR, "trace")
    shutil.rmtree(tdir, ignore_errors=True)
    t0 = time.perf_counter()
    with jax.profiler.trace(tdir):
        jax.block_until_ready(E._beam_finish_jit(*args, **statics))
    t_traced = time.perf_counter() - t0
    path = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    hlo = E._beam_finish_jit.lower(*args, **statics).compile().as_text()
    res = reduce_trace(path, hlo_scopes(hlo))
    res["traced_launch_s"] = t_traced
    sc = res["device_ms_by_scope"]
    res["ok"] = res["outer_steps"] > 0 and sc.get("beam_sprint", 0) > 0
    log(f"trace: NT=2048 R=512 k={int(corr.cdbg.k)}: {res['outer_steps']} "
        f"outer steps, {res['kernels']} kernels "
        f"({res['kernels_per_step']:.1f}/step); device ms "
        + ", ".join(f"{k} {v:.1f} ({res['events_by_scope'][k]} events)"
                    for k, v in sorted(sc.items()))
        + f"; launch window {res['window_ms']:.1f} ms, idle share "
        f"{res['idle_share']:.3f}; inside the while_loop idle "
        f"{res['loop_idle_ms']:.1f} of {res['loop_window_ms']:.1f} ms "
        f"({res['loop_idle_us_per_step']:.1f} us/step)")
    return res


def nw_oracle_mismatches(scalars, seq_packed, tgt_masks, tgt_len, lmax: int,
                         n: int):
    """Completed regions (first n rows) whose reported NW distance differs
    from ops/cigar's NumPy DP of the returned path against the target.
    Returns (regions checked, [(row, reported, oracle)])."""
    from ratatosk_tpu import dna
    from ratatosk_tpu.correct import finish as FN
    from ratatosk_tpu.ops import cigar as CG
    scalars = np.asarray(scalars)
    seqs = FN.unpack_codes(np.asarray(seq_packed), lmax)
    tgt_masks = np.asarray(tgt_masks)
    tgt_len = np.asarray(tgt_len)
    checked, bad = 0, []
    for r in range(n):
        blen, dist, completed = (int(scalars[r, FN.SCALAR_FIELDS.index(f)])
                                 for f in ("best_len", "best_dist",
                                           "completed"))
        if not completed or blen == 0:
            continue
        path = dna.codes_to_masks(seqs[r, :blen])
        tgt = tgt_masks[r, :tgt_len[r]]
        want = int(CG.dp_matrix(path, tgt, CG.NW)[-1, -1])
        checked += 1
        if want != dist:
            bad.append((r, dist, want))
    return checked, bad


def compare_finish(a, b, n: int, tgt_len) -> dict:
    """Row-wise identity of two FinishOut results over the first n regions;
    each differing region is reported with its score gap (1 - dist/len)."""
    from ratatosk_tpu.correct import finish as FN
    sa, sb = np.asarray(a.scalars)[:n], np.asarray(b.scalars)[:n]
    pa, pb = np.asarray(a.seq_packed)[:n], np.asarray(b.seq_packed)[:n]
    same = (sa == sb).all(axis=1) & (pa == pb).all(axis=1)
    i_d = FN.SCALAR_FIELDS.index("best_dist")
    i_s = FN.SCALAR_FIELDS.index("s1_open_m")
    diffs = []
    for r in np.flatnonzero(~same):
        tl = max(int(tgt_len[r]), 1)
        diffs.append({
            "row": int(r),
            "fields": [f for j, f in enumerate(FN.SCALAR_FIELDS)
                       if sa[r, j] != sb[r, j]]
            + (["path"] if (pa[r] != pb[r]).any() else []),
            "dist": [int(sa[r, i_d]), int(sb[r, i_d])],
            "score_gap": (int(sb[r, i_d]) - int(sa[r, i_d])) / tl,
            "open_score_gap": (int(sa[r, i_s]) - int(sb[r, i_s])) / 1e6})
    return {"regions": n, "identical": int(same.sum()),
            "match_rate": float(same.mean()) if n else 1.0, "diffs": diffs}


def phase_numerics(launches: Launches) -> dict:
    import jax
    from ratatosk_tpu.correct import engine as E
    cpu = jax.devices("cpu")[0]
    res = {"buckets": []}
    ok = True
    for nt, r in ((256, 512), (2048, 128), (5376, 128)):
        corr, specs = launches.batches[nt]
        args, statics, lmax = region_batch(corr, specs, nt, r)
        n = min(len(specs), r)
        rb = args[1]
        t0 = time.time()
        fin_g = jax.device_get(E._beam_finish_jit(*args, **statics))
        t_g = time.time() - t0
        t0 = time.time()
        fin_c = jax.device_get(
            E._beam_finish_jit(*jax.device_put(args, cpu), **statics))
        t_c = time.time() - t0
        cmp = compare_finish(fin_g, fin_c, n, np.asarray(rb.tgt_len))
        checked, bad = nw_oracle_mismatches(
            fin_g.scalars, fin_g.seq_packed, rb.tgt_masks, rb.tgt_len, lmax,
            n)
        b_ok = cmp["match_rate"] >= 0.995 and not bad
        ok &= b_ok
        res["buckets"].append({"nt": nt, "R": r, "k": int(corr.cdbg.k),
                               "band": statics["band"], "gpu_s": t_g,
                               "cpu_s": t_c, **cmp,
                               "oracle_checked": checked,
                               "oracle_mismatches": bad, "ok": b_ok})
        log(f"numerics: NT={nt} R={r} band={statics['band']} k="
            f"{int(corr.cdbg.k)}: GPU vs CPU {cmp['identical']}/{n} regions "
            f"identical ({cmp['match_rate']:.4f}); NW oracle {checked} "
            f"completed paths, {len(bad)} mismatches; gpu {t_g:.1f}s "
            f"cpu {t_c:.1f}s")
        for d in cmp["diffs"]:
            log(f"numerics:   differs row {d['row']}: {d['fields']} dist "
                f"gpu/cpu {d['dist']} score gap {d['score_gap']:.6f} "
                f"open-score gap {d['open_score_gap']:.6f}")
        for row, got, want in bad:
            log(f"numerics:   oracle row {row}: reported {got}, NumPy DP "
                f"{want}")
    res["ok"] = ok
    return res


def _run_key(r):
    return (r.s, r.e, r.uid, r.direction, r.o_s, r.weak, r.rspan)


def phase_planner(launches: Launches, n_reads: int = 64) -> dict:
    from ratatosk_tpu.correct import seeds as SD
    from ratatosk_tpu.correct.engine import _NEAR_EXACT_SKIP
    from ratatosk_tpu.io import fastx
    from ratatosk_tpu.ops.plan_device import DevicePlanner
    corr = launches.correctors[31]
    cdbg, opt = corr.cdbg, corr.opt
    reads = []
    for rec in fastx.read_fastx(os.path.join(WORK_DIR, "long.fq")):
        reads.append(rec.codes)
        if len(reads) == n_reads:
            break
    dp = DevicePlanner.build(cdbg)
    t0 = time.time()
    got_runs = dp.collect_runs(dp.dispatch_runs(reads))
    spans = [(i, 0, len(r)) for i, r in enumerate(reads)]
    got_seeds = dp.collect_probe(dp.dispatch_probe(
        reads, spans, stride=opt.weak_seed_stride,
        near_exact_skip=_NEAR_EXACT_SKIP))
    t_dev = time.time() - t0
    want_runs = [SD.find_runs(cdbg, r) for r in reads]
    want_seeds = SD.find_weak_seeds_batch(
        cdbg, reads, spans, stride=opt.weak_seed_stride,
        near_exact_skip=_NEAR_EXACT_SKIP)

    def same(got, want):
        return got is not None and all(
            [_run_key(x) for x in g] == [_run_key(x) for x in w]
            for g, w in zip(got, want))

    res = {"reads": len(reads), "k": int(cdbg.k), "device_s": t_dev,
           "runs": sum(map(len, want_runs)),
           "seeds": sum(map(len, want_seeds)),
           "runs_identical": same(got_runs, want_runs),
           "seeds_identical": same(got_seeds, want_seeds)}
    res["ok"] = res["runs_identical"] and res["seeds_identical"]
    log(f"planner: k={res['k']} {len(reads)} reads: {res['runs']} runs "
        f"identical={res['runs_identical']}, {res['seeds']} seeds "
        f"identical={res['seeds_identical']} (device {t_dev:.1f}s incl. "
        f"compile)")
    return res


def phase_four(dep: Deployment) -> dict:
    """One GPU against a 4-GPU mesh (replicated and sharded index) on the
    same reads, both passes; sharded lookups against the replicated index."""
    import jax
    from ratatosk_tpu.config import CorrectOpt
    from ratatosk_tpu.correct.engine import Corrector
    from ratatosk_tpu.graph import build as B
    from ratatosk_tpu.graph.colors import color_graph
    from ratatosk_tpu.graph.keys import KeyArray
    from ratatosk_tpu.io import fastx
    from ratatosk_tpu.parallel import mesh as M
    from ratatosk_tpu.parallel.sharded_index import ShardedKmerIndex
    from ratatosk_tpu.pipeline import (_pass_opt, build_pass2_index,
                                       correct_file)
    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--four needs 4 devices, JAX has {len(devs)}")
    mesh = M.make_mesh(devices=devs[:4])
    short_path, long_path, _ = simulate(dep, WORK_DIR)
    sreads = [r.codes for r in fastx.read_fastx(short_path)]
    opt = CorrectOpt(small_k=31, k=63, batch_regions=512)
    res = {"mesh_devices": [str(d) for d in devs[:4]], "passes": [],
           "lookups": []}
    ok = True

    def lookups(index, k):
        rng = np.random.default_rng(k)
        sidx = ShardedKmerIndex(index, mesh)
        lo = np.asarray(index.keys_lo)
        hi = np.asarray(index.keys_hi) if index.two_word else None
        q_lo = np.concatenate([lo, rng.integers(0, 1 << 62, 1 << 16,
                                                dtype=np.uint64)])
        q_hi = None if hi is None else np.concatenate(
            [hi, rng.integers(0, 1 << 60, 1 << 16, dtype=np.uint64)])
        uid, pos, strand = (np.asarray(x) for x in sidx.lookup(q_lo, q_hi))
        rows = KeyArray(k, lo, hi).find(KeyArray(k, q_lo, q_hi))
        hit = rows >= 0
        r0 = np.maximum(rows, 0)
        want = (np.where(hit, np.asarray(index.unitig_id)[r0], -1),
                np.where(hit, np.asarray(index.pos)[r0], -1),
                np.where(hit, np.asarray(index.strand)[r0].astype(int), -1))
        same = all(np.array_equal(g, w) for g, w in
                   zip((uid, pos, strand), want))
        out = {"k": k, "keys": int(index.n), "queries": int(len(q_lo)),
               "hits": int(hit.sum()), "identical": same}
        log(f"four: sharded index k={k} ({index.n} keys over 4 devices): "
            f"{out['queries']} lookups, {out['hits']} hits, identical to the "
            f"replicated index: {same}")
        return out

    inputs = [long_path]
    for p in (1, 2):
        o = _pass_opt(opt, p)
        if p == 1:
            g = B.build_cdbg(sreads, 31, min_count=opt.min_count_kmer)
            c = color_graph(g, sreads)
        else:
            g, c = build_pass2_index(
                o, ((r.codes, r.qual) for r in fastx.read_fastx(inputs[0])),
                sreads, list(range(len(sreads))))
        res["lookups"].append(lookups(g.index, g.k))
        ok &= res["lookups"][-1]["identical"]
        outs = {}
        for name, m, o_run in (
                ("one_gpu", None, o),
                ("mesh4", mesh, o),
                ("mesh4_sharded_index", mesh,
                 dataclasses.replace(o, shard_index_min_keys=0))):
            corr = Corrector(g, c, o_run, mesh=m)
            path = os.path.join(WORK_DIR, f"four_p{p}_{name}.fastq")
            t0 = time.time()
            correct_file(corr, o_run, inputs, path, p)
            with open(path, "rb") as f:
                outs[name] = (f.read(), time.time() - t0)
        ref = outs["one_gpu"][0]
        same = {n: v[0] == ref for n, v in outs.items()}
        res["passes"].append({"pass": p, "k": g.k, "identical": same,
                              "wall_s": {n: v[1] for n, v in outs.items()},
                              "fastq_bytes": len(ref)})
        ok &= all(same.values())
        log(f"four: pass {p} (k={g.k}) FASTQ identical to one GPU: {same}; "
            f"wall " + ", ".join(f"{n} {v[1]:.1f}s" for n, v in outs.items()))
        inputs = [os.path.join(WORK_DIR, f"four_p{p}_one_gpu.fastq")]
    res["ok"] = ok
    return res


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU phase (needs 4 devices)")
    args = ap.parse_args(argv)

    import jax
    from ratatosk_tpu import devinfo, nativebuild
    dev = devinfo.require_gpu("chip_smoke")
    print("nvidia-smi --query-gpu=name,power.limit:", flush=True)
    for line in devinfo.nvidia_smi():
        print(line, flush=True)
    log(f"JAX {jax.__version__}: {dev}; compile cache "
        f"{jax.config.jax_compilation_cache_dir}")
    t0 = time.time()
    nativebuild.build_all()
    log(f"native libraries ready ({time.time() - t0:.1f}s)")
    os.makedirs(OUT_DIR, exist_ok=True)
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    os.makedirs(WORK_DIR)

    dep = Deployment()
    launches = Launches()
    if args.four:
        phases = [("four", lambda: phase_four(
            dataclasses.replace(dep, genome_bp=1_000_000, n_holes=2,
                                n_long=250)))]
    else:
        phases = [("main", lambda: phase_main(dep, launches)),
                  ("buckets", lambda: phase_buckets(launches)),
                  ("trace", lambda: phase_trace(launches)),
                  ("numerics", lambda: phase_numerics(launches)),
                  ("planner", lambda: phase_planner(launches))]
    failed = []
    try:
        for name, fn in phases:
            t0 = time.time()
            try:
                res = fn()
            except Exception:
                traceback.print_exc()
                res = {"ok": False, "error": traceback.format_exc()}
            res["wall_s"] = time.time() - t0
            res["device"] = dev
            with open(os.path.join(OUT_DIR, f"{name}.json"), "w") as f:
                json.dump(res, f, indent=1, default=str)
            log(f"phase {name}: {'ok' if res['ok'] else 'FAILED'} "
                f"({res['wall_s']:.1f}s)")
            if not res["ok"]:
                failed.append(name)
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)
    if failed:
        log(f"failed phases: {failed}")
        return 1
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
