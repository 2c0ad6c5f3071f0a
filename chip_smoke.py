#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py          # from the root of a checkout

Phases, in order; any failure exits non-zero and prints no result:

1. Build: compile the lookup kernel (src/repro_torch/kernels/csrc) with
   nvcc for sm_90a into src/repro_torch/kernels/build/.
2. Kernel: the hand-written lookup kernel against its plain PyTorch
   version on the card, bit for bit, over 1, 2, 8 and 20 segments with
   mixed bucket counts, max_matches 1, 8 and 64, absent, EMPTY and
   extreme keys, truncated chains, garbage prev lanes at or above fill,
   and a query count that no block size divides.
3. Slice: the local IndexedFrame path at a deployment's size — one
   cached partition of 2**25 rows (int64 key over about 2**22 distinct
   keys, v float32, tag int32 = row number): from_columns, a lookup of
   2**16 keys, two divergent non-donated appends of 2**16 rows, a
   coalesced list of 4 deltas of 2**14 rows on one child, a donated
   in-class append of 2**16 rows on that result, and a join with a
   2**20-row probe side.  Answers for a sample of 4096 keys are checked
   against an independent numpy reference built from host copies of each
   version's columns, and the kernel's launch count must rise on both the
   read and the ingest path.
4. Timings: the kernel at the lookup batch beside its bound and its
   plain version, lookup keys/s, append ms, join probe rows/s and peak
   device memory, one JSON line each.

The last three lines are the card's name and power limit (as nvidia-smi
reports them), the per-kernel JSON record, and the run's result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

N_ROWS = 1 << 25            # one cached partition
KEY_SPACE = 1 << 22         # about 2**22 distinct keys, ~8 rows each
LOOKUP_Q, LOOKUP_M = 1 << 16, 32
APPEND_ROWS = 1 << 16
COALESCED_DELTAS, COALESCED_ROWS = 4, 1 << 14
JOIN_ROWS, JOIN_M = 1 << 20, 8
SAMPLE = 4096
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
L2_FLUSH_BYTES = 256 << 20  # > the 50 MB L2


class SmokeError(RuntimeError):
    pass


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise SmokeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def import_port():
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").exists():
        raise SmokeError(f"no src/repro_torch beside {__file__}: run from "
                         f"a checkout of the repository")
    sys.path.insert(0, str(src))
    import repro_torch
    check(Path(repro_torch.__file__).resolve().is_relative_to(src),
          f"imported repro_torch from {repro_torch.__file__}, not {src}")
    return repro_torch


# ---------------------------------------------------------------------------
# Timing helpers (CUDA events; the host clock only around synchronized work)
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, reps, flush=None):
    """Median device time of ``fn`` in ms over ``reps`` runs, each after
    an optional L2 flush outside the timed window."""
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def host_ms(torch, fn, reps):
    """Median wall time of ``fn`` in ms, synchronized on both sides."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 2: kernel vs plain version
# ---------------------------------------------------------------------------

def kernel_sweep(torch, np, dev):
    import dataclasses
    from repro_torch.core import Schema, append, create_index
    from repro_torch.kernels import hash_probe, ref

    sch = Schema.of("k", k="int64", v="float32", tag="int32")
    rng = np.random.default_rng(SEED)
    i64 = np.iinfo(np.int64)
    key_range = 3000

    def cols(n, tag0):
        return {"k": rng.integers(0, key_range, n).astype(np.int64),
                "v": rng.random(n).astype(np.float32),
                "tag": np.arange(tag0, tag0 + n, dtype=np.int32)}

    queries = torch.from_numpy(np.concatenate([
        rng.integers(0, key_range, 2987),              # present, dup-heavy
        rng.integers(key_range, 2 * key_range, 11),    # absent
        [i64.min, i64.max, -1]])                       # EMPTY and extremes
        .astype(np.int64)).to(dev)                     # Q = 3001

    def compare(snap, m, what):
        rows, last = hash_probe.fused_lookup_tiles(queries, snap,
                                                   max_matches=m)
        want_rows, want_last = ref.fused_lookup_ref(queries, snap, m)
        torch.cuda.synchronize()
        check(torch.equal(rows, want_rows) and torch.equal(last, want_last),
              f"kernel disagrees with its plain version: {what}, "
              f"max_matches={m}")
        return int((last >= 0).sum())

    t = create_index(cols(20_000, 0), sch, rows_per_batch=256, reserve=0,
                     device=dev)
    cases = truncated = 0
    counts = set()
    for s in range(1, 21):
        if s > 1:
            n = int(rng.choice([7, 600, 9000]))
            t = append(t, cols(n, 100_000 * s), mode="segment")
        if s in (1, 2, 8, 20):
            counts |= set(t.snapshot.bucket_counts)
            for m in (1, 8, 64):
                truncated += compare(t.snapshot, m, f"{s} segments")
                cases += 1

    # garbage in every prev lane at or above fill, with written lanes and
    # one bucket pointer forged to point there
    snap = t.snapshot
    cap = snap.capacity
    fill = cap - 5000
    g = torch.Generator(device=dev).manual_seed(SEED)
    prev = snap.prev.clone()
    prev[fill:] = torch.randint(-3, cap, (cap - fill,), generator=g,
                                device=dev, dtype=torch.int32)
    forged = torch.randperm(fill, generator=g, device=dev)[:500]
    prev[forged] = torch.randint(fill, cap, (500,), generator=g, device=dev,
                                 dtype=torch.int32)
    blk = snap.blocks[-1]
    ptrs = blk.ptrs.clone()
    i, j = map(int, torch.nonzero(ptrs >= 0)[0])
    ptrs[i, j] = fill + 1
    garbage = dataclasses.replace(
        snap, blocks=snap.blocks[:-1] + (dataclasses.replace(blk,
                                                             ptrs=ptrs),),
        prev=prev, fill=torch.tensor(fill, dtype=torch.int32, device=dev))
    for m in (1, 8, 64):
        compare(garbage, m, "garbage past fill")
        cases += 1
    check(truncated > 0, "the sweep produced no truncated chain")
    check(len(counts) > 2, f"bucket counts not mixed: {sorted(counts)}")
    emit({"phase": "kernel", "cases": cases, "mismatches": 0,
          "segments": [1, 2, 8, 20], "max_matches": [1, 8, 64],
          "queries": int(queries.shape[0]),
          "bucket_counts": sorted(counts), "truncated_chains": truncated})


# ---------------------------------------------------------------------------
# Phase 3: the slice at a deployment's size, with a numpy reference
# ---------------------------------------------------------------------------

class Reference:
    """Newest-first ``tag`` lists per sampled key, from host copies of the
    columns a version holds (in append order) — independent of the port."""

    def __init__(self, np, sample):
        self.np = np
        self.sample = np.sort(sample)

    def select(self, host_cols):
        np = self.np
        m = np.isin(host_cols["k"], self.sample)
        return host_cols["k"][m], host_cols["tag"][m]

    def answers(self, parts):
        np = self.np
        k = np.concatenate([p[0] for p in parts])
        tag = np.concatenate([p[1] for p in parts])
        order = np.argsort(k, kind="stable")
        k, tag = k[order], tag[order]
        keys, starts = np.unique(k, return_index=True)
        ends = np.append(starts[1:], len(k))
        return {int(x): tag[a:b][::-1] for x, a, b in zip(keys, starts,
                                                          ends)}


def check_answers(np, tags, valid, queries, positions, ref, m, what):
    tags, valid = tags.cpu().numpy(), valid.cpu().numpy()
    for p in positions:
        want = ref.get(int(queries[p]), np.empty(0, np.int32))[:m]
        n = int(valid[p].sum())
        check(valid[p][:n].all() and not valid[p][n:].any(),
              f"{what}: matches of key {int(queries[p])} are not a prefix")
        check(n == len(want) and (tags[p][:n] == want).all(),
              f"{what}: key {int(queries[p])} gave tags {tags[p][:n]}, "
              f"want {want}")


def time_b1(torch, dev, batch, q, snap, m, flush):
    """The lookup kernel at one batch: checked against its plain version,
    then timed (median of L2-flushed launches) beside its bound."""
    from repro_torch.core import hashing
    from repro_torch.kernels import hash_probe, ref as kref

    rows, last = hash_probe.fused_lookup_tiles(q, snap, max_matches=m)
    want_rows, want_last = kref.fused_lookup_ref(q, snap, m)
    err = max(int((rows - want_rows).abs().max()),
              int((last - want_last).abs().max()))
    check(err == 0, f"kernel disagrees at the {batch} batch: {err}")
    ms = cuda_ms(torch, lambda: hash_probe.fused_lookup_tiles(
        q, snap, max_matches=m), 30, flush)
    plain_ms = cuda_ms(torch, lambda: kref.fused_lookup_ref(q, snap, m), 5,
                       flush)
    # bytes this run's data needs: the query keys, each probed segment's
    # key and pointer rows, one 4-byte prev read per emitted row id, and
    # the outputs.  The sector figure charges each prev read the 32-byte
    # sector the memory system moves for it.
    slots = snap.blocks[0].keys.shape[1]
    probed = torch.zeros(q.shape[0], dtype=torch.int64, device=dev)
    done = torch.zeros(q.shape[0], dtype=torch.bool, device=dev)
    for blk in reversed(snap.blocks):
        probed += (~done).long()
        b = hashing.bucket_hash(q, blk.num_buckets).long()
        done |= ((blk.keys[b] == q[:, None]) & (blk.ptrs[b] >= 0)).any(1)
    hops = int((rows >= 0).sum())
    io = q.shape[0] * 8 + rows.numel() * 4 + last.numel() * 4
    nbytes = io + int(probed.sum()) * slots * 12 + hops * 4
    sector_bytes = io + int(probed.sum()) * slots * 12 + hops * 32
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    emit({"metric": "b1_kernel_ms", "batch": batch, "value": ms,
          "bound_ms": bound_ms, "bound_bytes": nbytes,
          "sector_bound_ms": sector_bytes / HBM_BYTES_PER_S * 1e3,
          "achieved_GB_per_s": nbytes / ms / 1e6, "plain_ms": plain_ms,
          "queries": int(q.shape[0]), "max_matches": m,
          "segments": len(snap.blocks), "emitted_rows": hops,
          "l2_flushed": True})
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, max_abs_err=err)


def profile_ops(torch, ops, reps=3):
    """Device time by kernel for each operation, from torch.profiler,
    against the operation's unprofiled synchronized wall time: the
    profiler's own host cost inflates a traced call's wall time several
    times over, so the idle share is device-busy ms over ``host_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, fn in ops:
        fn()                                     # warm
        wall = host_ms(torch, fn, reps)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            traced = (time.perf_counter() - t0) * 1e3
        kernels = [(ev.self_device_time_total / 1e3, ev.count, ev.key[:60])
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0]
        kernels.sort(reverse=True)
        busy = sum(k[0] for k in kernels)
        emit({"profile": name, "host_ms": wall, "traced_wall_ms": traced,
              "device_busy_ms": busy if kernels else None,
              "device_idle_share": 1 - busy / wall if kernels else None,
              "top": [{"kernel": k, "ms": t, "count": c}
                      for t, c, k in kernels[:6]]})


def slice_phase(torch, np, dev, timings):
    from repro_torch import IndexedFrame, Schema
    from repro_torch.kernels import hash_probe

    sch = Schema.of("k", k="int64", v="float32", tag="int32")
    g = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    next_tag = [0]

    def make(n):
        c = {"k": torch.randint(0, KEY_SPACE, (n,), generator=g, device=dev,
                                dtype=torch.int64),
             "v": torch.rand(n, generator=g, device=dev),
             "tag": torch.arange(next_tag[0], next_tag[0] + n, device=dev,
                                 dtype=torch.int32)}
        next_tag[0] += n
        return c

    def host(c):
        return {k: v.cpu().numpy() for k, v in c.items()}

    torch.cuda.reset_peak_memory_stats(dev)
    base = make(N_ROWS)
    base_h = host(base)
    sample = np.unique(np.concatenate([
        rng.choice(np.unique(base_h["k"]), SAMPLE - 96, replace=False),
        KEY_SPACE + np.arange(96)]))                   # 96 absent keys
    ref = Reference(np, sample)
    ns = len(sample)

    def with_sample(c, n_keys):
        """Route ``n_keys`` sampled keys into a delta so that every
        version's answers differ on sampled keys."""
        idx = rng.choice(ns, n_keys, replace=False)
        c["k"][:n_keys] = torch.from_numpy(sample[idx]).to(dev)
        return c

    q_np = np.concatenate([sample, rng.integers(0, KEY_SPACE,
                                                LOOKUP_Q - ns)])
    q = torch.from_numpy(q_np.astype(np.int64)).to(dev)
    pos = np.arange(ns)
    deltas = {name: with_sample(make(APPEND_ROWS), 256)
              for name in ("a", "b")}
    coal = [with_sample(make(COALESCED_ROWS), 64)
            for _ in range(COALESCED_DELTAS)]
    donated = with_sample(make(APPEND_ROWS), 256)
    probe = {"k": torch.from_numpy(np.concatenate([
        sample, rng.integers(-1000, KEY_SPACE + 1000, JOIN_ROWS - ns)])
        .astype(np.int64)).to(dev),
        "pid": torch.arange(JOIN_ROWS, device=dev, dtype=torch.int32)}
    sel = {"base": ref.select(base_h)}
    for name, c in deltas.items():
        sel[name] = ref.select(host(c))
    sel["coal"] = [ref.select(host(c)) for c in coal]
    sel["donated"] = ref.select(host(donated))
    torch.cuda.synchronize()

    # ---- the main path: counts from 0 just before, read just after -------
    hash_probe.LAUNCHES = 0
    steps = {}
    t0 = time.perf_counter()
    frame = IndexedFrame.from_columns(base, sch)
    torch.cuda.synchronize()
    steps["from_columns_s"] = time.perf_counter() - t0
    check(frame.device.type == "cuda", f"frame on {frame.device}")

    n0 = hash_probe.LAUNCHES
    cols, valid = frame.lookup(q, max_matches=LOOKUP_M)
    read_launches = hash_probe.LAUNCHES - n0
    check_answers(np, cols["tag"], valid, q_np, pos,
                  ref.answers([sel["base"]]), LOOKUP_M, "lookup")

    n0 = hash_probe.LAUNCHES
    child_a = frame.append(deltas["a"])
    child_b = frame.append(deltas["b"])
    ingest_launches = hash_probe.LAUNCHES - n0
    check(child_a.data.num_segments == 1 and child_b.version == 1,
          "divergent appends did not land in place")
    for fr, parts, what in [
            (child_a, [sel["base"], sel["a"]], "child a"),
            (child_b, [sel["base"], sel["b"]], "child b"),
            (frame, [sel["base"]], "parent after appends")]:
        cols, valid = fr.lookup(q, max_matches=LOOKUP_M)
        check_answers(np, cols["tag"], valid, q_np, pos, ref.answers(parts),
                      LOOKUP_M, what)

    n0 = hash_probe.LAUNCHES
    child_c = child_a.append(coal)
    ingest_launches += hash_probe.LAUNCHES - n0
    check(child_c.version == 2, f"coalesced version {child_c.version}")
    parts_c = [sel["base"], sel["a"], *sel["coal"]]
    cols, valid = child_c.lookup(q, max_matches=LOOKUP_M)
    check_answers(np, cols["tag"], valid, q_np, pos, ref.answers(parts_c),
                  LOOKUP_M, "coalesced child")

    n0 = hash_probe.LAUNCHES
    child_d = child_c.append(donated, donate=True)
    ingest_launches += hash_probe.LAUNCHES - n0
    check(child_d.data.num_segments == 1, "donated append left the class")
    bcols, pcols, bvalid = child_d.join(probe, "k", max_matches=JOIN_M)
    torch.cuda.synchronize()
    steps["main_path_s"] = time.perf_counter() - t0
    launches = hash_probe.LAUNCHES
    # ---- end of the main path ---------------------------------------------

    check(read_launches > 0, "the lookup did not launch the kernel")
    check(ingest_launches > 0, "the ingest did not launch the kernel")
    parts_d = parts_c + [sel["donated"]]
    check_answers(np, bcols["tag"], bvalid, probe["k"].cpu().numpy(), pos,
                  ref.answers(parts_d), JOIN_M, "join")
    check(torch.equal(pcols["pid"][:, 0], probe["pid"]),
          "join probe columns out of order")
    try:
        child_c.lookup(q[:4], max_matches=1)
        consumed = False
    except RuntimeError as e:
        consumed = "consumed" in str(e)
    check(consumed, "the donated parent is still readable")
    emit({"phase": "slice", "rows": N_ROWS, "key_space": KEY_SPACE,
          "sample_keys": ns, "versions_checked": 6,
          "launches": launches, "read_launches": read_launches,
          "ingest_launches": ingest_launches,
          "capacity": frame.data.capacity,
          "index_bytes": frame.index_nbytes(),
          "data_bytes": frame.data_nbytes(), **steps})

    # ---- timings (after the counts were read) ------------------------------
    flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    b1 = time_b1(torch, dev, "lookup", q, frame.data.snapshot, LOOKUP_M,
                 flush_buf.zero_)
    timings["b1"] = dict(b1, launches=launches)
    time_b1(torch, dev, "join", probe["k"], child_d.data.snapshot, JOIN_M,
            flush_buf.zero_)
    del flush_buf

    lk = host_ms(torch, lambda: frame.lookup(q, max_matches=LOOKUP_M), 10)
    emit({"metric": "lookup_keys_per_s", "value": LOOKUP_Q / lk * 1e3,
          "ms": lk, "queries": LOOKUP_Q, "max_matches": LOOKUP_M,
          "path": "IndexedFrame.lookup (probe, chain walk, row gather)"})

    extra = [make(APPEND_ROWS) for _ in range(8)]
    it = iter(extra)
    nd = host_ms(torch, lambda: frame.append(next(it)), 3)
    emit({"metric": "append_ms", "donate": False, "value": nd,
          "rows": APPEND_ROWS, "table_rows": N_ROWS})
    holder = [frame.append(next(it))]

    def donated_step():
        holder[0] = holder[0].append(next(it), donate=True)

    dn = host_ms(torch, donated_step, 3)
    emit({"metric": "append_ms", "donate": True, "value": dn,
          "rows": APPEND_ROWS, "table_rows": N_ROWS})
    del holder

    jn = host_ms(torch, lambda: child_d.join(probe, "k",
                                             max_matches=JOIN_M), 3)
    emit({"metric": "join_probe_rows_per_s", "value": JOIN_ROWS / jn * 1e3,
          "ms": jn, "probe_rows": JOIN_ROWS, "max_matches": JOIN_M})
    emit({"metric": "peak_device_bytes",
          "value": torch.cuda.max_memory_allocated(dev)})

    spare = [make(APPEND_ROWS) for _ in range(6)]
    chain = [frame.append(spare.pop())]

    def append_donated():
        chain[0] = chain[0].append(spare.pop(), donate=True)

    profile_ops(torch, [
        ("lookup", lambda: frame.lookup(q, max_matches=LOOKUP_M)),
        ("join", lambda: child_d.join(probe, "k", max_matches=JOIN_M)),
        ("append_donated", append_donated)])


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("no CUDA device: this script runs on the card")
    import_port()
    from repro_torch.kernels import hash_probe
    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the port imported JAX or the JAX package")
    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    path = hash_probe.build()
    emit({"phase": "build", "kernel": "fused_lookup", "library": path.name,
          "nvcc_s": hash_probe.BUILD_INFO["seconds"],
          "wall_s": time.perf_counter() - t0})
    print(hash_probe.BUILD_INFO["log"], flush=True)

    kernel_sweep(torch, np, dev)
    timings = {}
    slice_phase(torch, np, dev, timings)
    emit({"phase": "done", "wall_s": time.perf_counter() - t_start})

    b1 = timings["b1"]
    print(card, flush=True)
    emit({"kernels": [{
        "name": "fused_lookup",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_lookup.cu",
        "replaces": "src/repro/kernels/hash_probe.py:151",
        "launches": b1["launches"],
        "max_abs_err": b1["max_abs_err"],
        "ms": b1["ms"],
        "plain_ms": b1["plain_ms"],
        "bound_ms": b1["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:                   # report every failure, exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
