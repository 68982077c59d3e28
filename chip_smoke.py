"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no `ok` line):

1. device   — the card's name and power limit (nvidia-smi);
2. build    — nvcc builds the kernel libraries (one process per source)
              and g++ the host runtime, from this checkout's sources, in
              parallel; ptxas' registers and spills of each kernel, and
              the SASS instructions one lane of K1/K2 executes in each
              branch of the evaluation (the instruction bound's count);
3. kernels  — each kernel against its plain PyTorch version on the same
              card and inputs: K1 (dict wire) and K2 (per-lane columns),
              narrow and wide (also in 5 rounds that reuse slots, and
              past the lanes one launch holds), and the GLOBAL kernels K3 (answer
              rounds, also past the lanes one launch holds), K4 (sync),
              K5 (replica commit) and K6 (replica clear), the row gather
              (K7) and row scatter (K8), the tier move (K9, its records
              in both orders, with the window's two hazards, also on a
              window past what one launch holds), and the compact
              commit (K10, on the
              dict wire and on per-lane columns, every write lane listed
              or half of them, two calls back to back with disjoint
              lists; also held against K1/K2 on the same
              single-round batch); small seeded cases plus one at the
              paths' full size; outputs, state and replica-column bytes
              must be identical (tolerance 0: all integer);
4. service  — a V1Service on the card answers token, leaky, validation,
              duplicate-key and GLOBAL requests (with a GLOBAL sync on
              both) exactly as one on the CPU;
5. main     — the columnar path at full size: the "leaky bucket, 1M
              unique keys, Zipf" deployment (BASELINE.json configs[1],
              bench_full.py config 2) on an 8-shard store of 2,097,152
              slots, 131,072-lane batches two in flight, plus one
              monthly-Gregorian (wide) batch and one batch with more than
              256 configs (K2); every answer and the final state must
              equal the same traffic through a store on the plain
              versions (CPU); then launch fusion on the card: a stalled
              stage step queues batches at the launch gate, so they run
              as groups of K1 launches back to back, == a CPU store;
6. global   — the GLOBAL path at full size (bench_full.py config 7:
              8 x 65,536 slots, 65,536 gslots, 50,000 GLOBAL keys; the
              hot-key skew of config 4): a ramp of 2,048-lane batches
              and a full sync, skewed batches with a sync after every
              4th, a replica commit that recycles gslots, a batch for
              remote owners; every answer, sync result, state row and
              replica column must equal a store on the plain versions
              (CPU), and the hot keys' counters must converge exactly;
              then a churn batch of 2,048 new GLOBAL keys into the full
              gslot table, whose recycled gslots take one K6 launch
              (`[numbers]` line: its apply latency, and the clear done
              one call a lane, as the JAX store does, beside it);
7. persist  — the persistence path at the main path's deployment size
              (S = 8 x 262,144 slots), on the card and on the plain
              versions (CPU) side by side: a 1,000,000-lane snapshot
              restored at boot (one K7 and one K8), four 131,072-lane
              batches, a dump on both (byte-identical files, one K7), the
              file restored into stores with traffic of their own (the
              merge's live branch), a Loader of 50,000 items through boot,
              two batches and close(), and a Store SPI over a 50,000-key
              cache (8 batches of 2,048 lanes with algorithm switches and
              RESET_REMAINING); state, algo_mirror, slot tables, answers,
              files, store calls and items must be identical;
9. two-tier — the two-tier table at full size (bench_full.py config
              3b on 8 shards: 8 x 32,768 front and 8 x 217,232 back
              slots, a 10,000,000-key space, 131,072-lane batches of
              mixed token and leaky buckets with daily and monthly
              Gregorian durations over 4 rotating key windows, two in
              flight): each batch demotes the window before last and
              promotes its own through K9; a dataclass batch and a
              GLOBAL sync promote demoted GLOBAL keys; snapshot_items
              reads the back rows with K7; answers, sync, items, front
              and back state, tier stats and tables must equal a store
              on the plain versions (CPU); then one more batch step by
              step, and the same batch on a single-tier store;
10. shard   — the one-shard store at full size (bench.py's headline:
              ShardStore(capacity=300_000), 100,000 keys, Zipf, 131,072-
              lane batches of mixed token and leaky buckets): 2 warm
              batches, then two dispatcher threads of 4 batches two in
              flight each; a 400-config batch narrow and wide (K2) and a
              monthly-Gregorian batch; the dataclass leg
              (ShardStore(capacity=200_000).apply, 2 warm and 4 timed);
              a Store SPI over a 50,000-slot store; an express store
              (1-lane batches take K1 on the card, the host slot on the
              CPU), launch fusion as in phase 5; everything == a
              ShardStore on the plain versions (CPU) replayed in ticket
              order;
8. numbers  — kernel time per launch at the paths' shapes, the plain
              version's, the library call's where one computes the same
              function, and the bound (bytes; for K1/K2 also the
              instruction bound, the larger of the two); device times
              from the profiler (one device kernel a call for K1, K2,
              K3, K6, K9 and K10) and, for K3, K6, K9 and K10 (beside
              K1), queued behind a spin kernel;
              K3 also on a seeded 5-round batch and on the path batch's
              live lanes without the host's padding, and the launch
              floor (an empty kernel, an empty cooperative kernel with
              one grid barrier at K3's grid), as one JSON line (after
              phases 9 and 10, whose inputs it times K9 and K7 on the
              back tier with, K1 on a 32,768-slot front against a
              262,144-slot single tier, K1 and K2 at S = 1, and K10
              beside K1 on the headline's single-round batch);
11. serve   — the one-node serving tier: a V1Service built from
              setup_daemon_config (GUBER_CACHE_SIZE=2097152, the main
              path's 8 x 262,144 slots; GUBER_BATCH_WAIT=500us; the
              GLOBAL sync run by the phase), its kernels' first launches
              in MeshBucketStore.warmup, then (a) BASELINE config 2 at
              the service: 32 callers with disjoint keys, 16 requests of
              1,000 leaky BATCHING lanes each over a 1,000,000-key Zipf
              space, half through get_rate_limits_columns and half
              through the async entry; (b) BASELINE config 1: 8 callers
              x 200 NO_BATCHING token requests of 1 and 4 lanes, and
              100 BATCHING requests of 1 and 4 lanes that take the
              express bypass (a K1 each on the card); (c) GLOBAL lanes
              beside more than four batched lanes, one key in both
              groups, and a GLOBAL sync; (d) 3 requests at
              GUBER_TRACE_SAMPLE=1 whose batch.window span links the
              request and parents the five dispatch.* spans; (e) a
              monthly-Gregorian batch of more than 256 configs (K2).
              Every answer, the per-key rows, the replica columns and
              the GLOBAL counters must equal a service on the plain
              versions (CPU) fed each caller's requests serially;
              `[serve]` lines give checks/s, request latency p50 / max,
              flushes and lanes a flush, the pipeline's stage times, the
              saturation reservoirs, occupancy and the K1-K6 launches;
12. edge    — the HTTP edge of one node over real sockets: phase 11's
              service with a ring of itself, served by the native epoll
              edge with its ingress pump and by the stdlib gateway:
              (a) BASELINE config 2 as GUBC kind-5 frames, 32
              connections x 16 frames of 1,000 leaky lanes, through the
              native pump (K1); (b) the same traffic as JSON on the
              stdlib gateway; (c) BASELINE config 1, NO_BATCHING JSON of
              1 and 4 lanes from 8 connections; a monthly batch of more
              than 256 configs (K2); GLOBAL lanes (K3) and a sync (K4);
              (d) the peer API's receiving half: a kind-1 frame of owned
              lanes, a globals frame (K5), a transfer of 10,000 keys (one
              K7 and one K8) and a fenced one (409); (e) HealthCheck and
              the debug routes (200 with their keys; /debug/device shows
              the card's memory).  Every body, the per-key rows and the
              replica columns must equal a node on the plain versions
              (CPU) fed each connection's bodies serially through the
              same gateway handler; `[edge]` lines give checks/s, request
              latency p50 / max, takes and lanes a take, the pump's
              stats and the K1-K8 launches of each leg;
13. daemon  — the port's server binary as its own process on the card
              (`python3 -m gubernator_tpu_torch.cmd.server -config
              FILE -frozen-clock-ms NOW`; GUBER_CACHE_SIZE=2097152,
              GUBER_BATCH_WAIT=500us, static discovery of itself, the
              native edge with its pump, a snapshot file): (a) BASELINE
              config 2 as kind-5 frames through 32 ColumnsV1Clients x
              16 frames of 1,000 leaky lanes; (b) the same shape over
              gRPC, 8 GrpcV1Client channels x 8 GetRateLimitsColumns;
              (c) config 1 NO_BATCHING JSON of 1 and 4 lanes, 8 x 50,
              GLOBAL lanes with the daemon's own sync between two
              requests, a monthly batch of 300 configs (K2), a globals
              frame (K5); (d) GET /metrics: its families == the sets of
              scripts/check_metrics_parity.py, hits, misses and request
              counts == the CPU replay's (and the counts == the requests
              sent); (e) SIGTERM writes the snapshot (K7), a restart
              from the same file restores it (one K7, one K8) and
              answers one more request of each kind; (f) a TLS daemon
              (GUBER_TLS_AUTO=1 on a CA made here, the stdlib gateway)
              answers JSON over HTTPS and gRPC over TLS.  Every answer
              of (a)-(f), the snapshot's header and every key's row must
              equal a port daemon on the plain versions (CPU) in this
              process fed each connection's requests serially on the
              same frozen clock; the launches come from the daemon's
              POST /debug/launches (zeroed before (a), read after (d))
              and its stop line; `[daemon]` lines give startup s,
              checks/s and p50 / max of (a) and (b), (c)'s p50, the
              scrape, save and restore s and each kernel's launches;
14. cluster — four of the port's server binaries as one cluster on the
              card (the reference's docker-compose.yaml gubernator-1 to
              -4, with file discovery; phase 13's size each): nodes 1-3
              start from a peers file listing the three, node 4 from one
              listing all four; (a) BASELINE config 2 frames through 32
              ColumnsV1Clients x 16 over nodes 1-3, about two thirds of
              each frame forwarded to its owners, and a 300-config
              monthly batch of keys node 1 owns (K2); (b) config 4's 64
              hot keys as GLOBAL lanes from nodes 1-3, the daemons' own
              sync timers, until every node reads the owner's exact
              count; (c) nodes 1-3's file rewritten to list all four:
              the old owners drain the keys they no longer own (K7) and
              transfer them to node 4 (K8); once every reshard plane is
              idle and the double-dispatch window closed, 32 x 4 more
              frames over all four; (d) each node's /metrics (every
              breaker closed, its forwarded frames), its launches
              (POST /debug/launches, zeroed before (a) and read after
              each leg) and SIGTERM with its snapshot.  Every answer of
              (a) and (c) and the K2 batch equal a port node on the
              plain versions (CPU) in this process fed each
              connection's requests serially; each answer's owner is
              the ring's; each key's row lives in exactly one node's
              snapshot, its owner's under the four-node ring, and
              equals the replay's; `[cluster]` lines, each beside the
              card's name and power limit, give each node's startup,
              (a)'s and (c)'s checks/s and p50 / max, the lanes and
              frames forwarded, (b)'s GLOBAL apply p50 and time to
              convergence, the handoff's seconds, keys and bytes, and
              each node's K1-K8 launches by leg;
15. federation — two regions of two of the port's server binaries
              each on the card (BASELINE config 5, bench_full.py
              config5's two logical regions, the first named dc-west;
              phase 13's size each), found by member-list gossip with
              node 1's gossip address as the known node; node 4 runs
              GUBER_REGION_COLUMNS=0, so the region sends to and from
              it take the classic per-item encoding: (a) every node's
              /debug/status lists the four peers, two a region, and its
              `region` section names the other region; (b) MULTI_REGION
              token and leaky frames through 16 ColumnsV1Clients x 4
              into both regions, then the 100 ms flushes: every node
              applies the other region's hits (K1); (c) config 5's
              storm, 100 callers x 512 MULTI_REGION token lanes of 16
              hot keys (hits 5, limit 10) round-robin over the four
              gateways, a warm epoch then a timed one: zero error
              lanes, over the four nodes region_sent_hits ==
              region_agg_hits == every hit sent, region_recv_hits ==
              region_applied_hits == the hits sent columnar, none
              dropped, no region invariant violated, both encodings in
              gubernator_region_batches; (d) each node's launches and
              SIGTERM with its snapshot.  Every answer of (b) and every
              (b) key's row in both regions equal two port nodes on the
              plain versions (CPU) in this process, one a region, fed
              each connection's frames serially and flushed by hand;
              the rings must not change during the run; `[federation]`
              lines, each beside the card's name and power limit, give
              each node's startup and the time to gossip convergence,
              (b)'s and (c)'s checks/s and request p50 / max, the
              flushes, region batches by encoding, the ledger, one
              flush's bytes a region in each encoding, and each node's
              K1-K8 launches;
16. blackbox — the incident black box on two in-process port nodes on
              the card (phase 13's size each, each its own bundle
              directory): (a) BASELINE config 2 through node 1's native
              pump, 16 ColumnsV1Clients x 4 frames of 1,000 leaky lanes,
              about half of each frame forwarded to node 2, in ABBA quads
              of blackbox.force_disable: checks/s on and off and their
              median quad ratio, the public and peer rings' frame counts
              == the frames sent and forwarded (the 64 MiB budget holds
              a run), one write_bundle at 16 MiB rings; (b) the seeded
              incident of tests/test_blackbox.py (FaultPlan seed 11
              duplicating GetPeerRateLimits, the armed auditor, a probe
              of hits 3 forwarded by node 1): forward_conservation's
              auto-dump writes a bundle that
              scripts/torch_blackbox_fsck.py passes, listing
              audit-violation, its peer ring holding a duplicated frame
              pair; node 2 takes 8 kind-1 frames over HTTP and answers
              POST /debug/incident 202 (a second bundle), 403 with the
              box force-disabled and 409 without a directory; (c)
              scripts/torch_replay.py replays each bundle twice on the
              card and once on the plain versions (CPU): the three
              reports byte-identical, node 1's violation reproduced,
              node 2's frames launching K1 on the card; (d)
              measure_sync_cost_s on a fresh phase 6 store (iters 6):
              a sync's seconds beside K4's device time, K4 launched
              iters + 1 times, and refused on a store with a live GLOBAL
              key.  `[blackbox]` lines give each number beside the
              card's name and power limit.

The last line is `{"ok": true, "device": {...}}`.  Exits 2 without a
CUDA device.
"""

import collections
import gc
import heapq
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

S = 8
C_FULL = 262_144  # slots per shard: 2,097,152 in all
BATCH = 131_072
N_KEYS = 1_000_000
NOW = 1_700_000_000_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# The GLOBAL path (bench_full.py config 7 and the skew of config 4)
C_GLOBAL = 65_536  # slots per shard
G_FULL = 65_536  # gslots
GLOBAL_KEYS = 50_000
GLOBAL_BATCH = 2_048
HOT_KEYS = 64
PEER_KEYS = 16_384  # a replica commit that overflows the gslot table
# The two-tier path (bench_full.py config 3b on the port's 8 shards)
TT_FRONT = 32_768  # front slots per shard: 262,144 in all
TT_BACK = 217_232  # back slots per shard: 1,737,856 in all, config 3's 2,000,000 with the front
TT_KEYS = 10_000_000
TT_WINDOWS = 4  # rotating key windows, offset by TT_KEYS / TT_WINDOWS ids
TT_WARM, TT_TIMED = 4, 8
TT_MOVES = 15_700  # demotions and promotions per shard in a full-size K9 case
# The first instant of December 2023: the monthly lanes' reset is a
# whole month away, more than an int32 delta of milliseconds.
TT_NOW = 1_701_388_800_000
# The one-shard store (bench.py main(), the JAX package's headline)
SHARD_C = 300_000  # ShardStore(capacity=300_000)
SHARD_KEYS = 100_000
SHARD_DC_C = 200_000  # its dataclass leg: ShardStore(capacity=200_000)
SHARD_THREADS, SHARD_ITERS = 2, 4
SHARD_DC_WARM, SHARD_DC_TIMED = 2, 4


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------
# phase 1 and 2
# ---------------------------------------------------------------------
def device_phase(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch.cuda: {name}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")
    return smi, name


def build_phase():
    from gubernator_tpu_torch import native
    from gubernator_tpu_torch.ops import _kernels

    logs = {"kernels": [], "host_runtime": []}
    errors = []

    def run(name, fn):
        try:
            fn(log=logs[name])
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t0 = time.perf_counter()
    # _kernels.build starts one nvcc per source itself
    threads = [threading.Thread(target=run, args=("kernels", _kernels.build)),
               threading.Thread(target=run, args=("host_runtime", native.build))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    log(f"[build] kernels and host runtime built in {time.perf_counter() - t0:.1f} s")
    report = ptxas_report("".join(logs["kernels"]))
    for name, regs, spills in report:
        log(f"[build] ptxas {rounds_label(name)}{name}: {regs}; {spills}")
    if not report:
        log("[build] ptxas: no report (the kernel library was built before this run)")
    return rounds_sass(_kernels.build())


# the rounds kernel's instantiations (rounds.cuh): (Sink or Source in
# the mangled name, kernel)
_ROUNDS_KERNELS = (("CompactOut", "K10"), ("AnswerOut", "K3"), ("DictSource", "K1"),
                   ("ColsSource", "K2"))


def rounds_label(name):
    """'K10 dict narrow ' etc. for an instantiation of the rounds
    kernel named `name` (mangled), else ''."""
    if "bucket_rounds_kernel" not in name:
        return ""
    kernel = next(k for key, k in _ROUNDS_KERNELS if key in name)
    wire = "dict" if "DictSource" in name else "cols"
    width = "wide" if re.search(r"Source(ILb1E)", name) else "narrow"
    return f"{kernel} {wire} {width} "


def ptxas_report(text):
    """(kernel, registers line, spill line) for each entry function in
    nvcc's -Xptxas -v output."""
    out, name, spills = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = m.group(1), ""
        elif name and "spill" in line:
            spills = line.strip()
        elif name and "Used" in line and "registers" in line:
            out.append((name, line.split(":", 1)[1].strip(), spills))
            name = None
    return out


# ---------------------------------------------------------------------
# SASS: the instructions one lane of K1/K2 executes (the issue bound)
# ---------------------------------------------------------------------
EVAL_PATHS = ("token_reset", "token_exist", "token_create", "leaky_exist", "leaky_create")
# Lane results an SM delivers a clock on Hopper (CUDA C++ Programming
# Guide, throughput of native arithmetic instructions, compute
# capability 9.0): every instruction issues at 4 warps a clock (128),
# 32-bit integer arithmetic at 64, FP64 at 64, conversions and the
# special-function and bit-count units at 16.  An opcode of no class
# here ("other") is held to the issue rate alone.
ISSUE_LANES_PER_SM_CLOCK = 128
PIPE_LANES_PER_SM_CLOCK = {"int": 64, "fp64": 64, "slow": 16}
_PIPE_OPS = {
    "int": ("IADD", "IMAD", "IMUL", "ISCADD", "LEA", "LOP", "SHF.", "SHL", "SHR", "ISETP",
            "ICMP", "IMNMX", "VIMNMX", "IABS", "SEL", "SGXT", "BMSK", "PRMT"),
    "fp64": ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX"),
    "slow": ("I2F.", "F2I.", "F2F", "I2I", "FRND", "MUFU", "POPC", "FLO", "BREV"),
}
_SASS_FUNC = re.compile(r"^\.text\.(\S+):\s*$")
_SASS_LABEL = re.compile(r"^\s*(\.L_\w+|[^\s/.][^\s]*):\s*$")
_SASS_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SASS_LOC = re.compile(r'//## File "([^"]+)", line (\d+)(?: inlined at "([^"]+)", line (\d+))?')
_SASS_TARGET = re.compile(r"`\(([^)]+)\)")


def parse_sass(text):
    """nvdisasm -c -gi output by function: {name: {"ins": [(text,
    frozenset of (file, line) it was compiled from, inlined callers
    included)], "labels": {label: index of the next instruction}}}."""
    funcs, cur, loc, in_loc = {}, None, frozenset(), False
    for line in text.splitlines():
        m = _SASS_FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), {"ins": [], "labels": {}})
            loc, in_loc = frozenset(), False
            continue
        if cur is None:
            continue
        m = _SASS_LOC.search(line)
        if m:
            pairs = {(os.path.basename(m.group(1)), int(m.group(2)))}
            if m.group(3):
                pairs.add((os.path.basename(m.group(3)), int(m.group(4))))
            loc = (loc | pairs) if in_loc else frozenset(pairs)
            in_loc = True
            continue
        m = _SASS_INS.search(line)
        if m:
            cur["ins"].append((m.group(2), loc))
            in_loc = False
            continue
        m = _SASS_LABEL.match(line)
        if m:
            cur["labels"][m.group(1)] = len(cur["ins"])
    return funcs


def _opcode(text):
    return (text.split(None, 1)[1] if text.startswith("@") else text).split()[0]


def _pipe(op):
    return next((p for p, ops in _PIPE_OPS.items() if op.startswith(ops)), "other")


def lane_instructions(fn, anchors):
    """The fewest instructions a thread executes from the function's
    entry to an EXIT on a path that meets each of `anchors` (predicates
    on an instruction's (text, locations)) in order, as a Counter by
    pipe class (_PIPE_OPS; "other" for the rest): every branch not
    pinned by an anchor takes its cheaper side (a division's 32-bit
    form, a loop's exit, a jump past the rest of a function), so this is
    a lower bound on the lane's count.  A CALL counts its subroutine's
    fewest instructions to RET.  None when no such path exists."""
    ins, labels = fn["ins"], fn["labels"]
    succ, calls = [], {}
    for i, (text, _) in enumerate(ins):
        op = _opcode(text)
        cond = text.startswith("@")
        nxt = [i + 1] if i + 1 < len(ins) else []
        m = _SASS_TARGET.search(text)
        tgt = labels.get(m.group(1)) if m else None
        if op.startswith(("EXIT", "RET")):
            succ.append(nxt if cond else [])
        elif op.startswith("BRA"):
            succ.append(([] if tgt in (None, i) else [tgt]) + (nxt if cond else []))
        else:
            if op.startswith("CALL") and tgt is not None:
                calls[i] = tgt
            succ.append(nxt)

    def fewest(start, done, stages):
        s0 = (start, stages(start, 0))
        dist, prev = {s0: sum(weigh(start).values())}, {s0: None}
        heap = [(dist[s0], start, s0[1])]
        while heap:
            d, i, k = heapq.heappop(heap)
            if d > dist[(i, k)]:
                continue
            if done(i, k):
                out, st = collections.Counter(), (i, k)
                while st is not None:
                    out.update(weigh(st[0]))
                    st = prev[st]
                return out
            for j in succ[i]:
                nk, nd = stages(j, k), d + sum(weigh(j).values())
                if nd < dist.get((j, nk), 1 << 62):
                    dist[(j, nk)], prev[(j, nk)] = nd, (i, k)
                    heapq.heappush(heap, (nd, j, nk))
        return None

    sub, memo = {}, {}

    def weigh(i):
        if i not in memo:
            c = collections.Counter({_pipe(_opcode(ins[i][0])): 1})
            if i in calls:
                t = calls[i]
                if t not in sub:
                    sub[t] = collections.Counter()  # a recursive call costs nothing more
                    sub[t] = fewest(t, lambda j, k: _opcode(ins[j][0]).startswith("RET"),
                                    lambda j, k: 0) or collections.Counter()
                c.update(sub[t])
            memo[i] = c
        return memo[i]

    def stages(i, k):
        return k + 1 if k < len(anchors) and anchors[k](*ins[i]) else k

    return fewest(0, lambda i, k: k == len(anchors) and _opcode(ins[i][0]).startswith("EXIT"),
                  stages)


def function_span(path, name):
    """(first, last) line of the definition of function `name` in
    `path` (its body ends at the first line that starts with "}")."""
    with open(path) as f:
        lines = f.read().splitlines()
    for a, line in enumerate(lines):
        if re.search(r"\b%s\(" % name, line) and "__device__" in line:
            for b in range(a, len(lines)):
                if lines[b].startswith("}"):
                    return a + 1, b + 1
    raise ValueError(f"no definition of {name} in {path}")


def disassemble(lib_path, unit):
    """nvdisasm -c -gi of the cubin of source `unit` in the built
    library."""
    bindir = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin")
    with tempfile.TemporaryDirectory() as d:
        subprocess.run([os.path.join(bindir, "cuobjdump"), "-xelf", "all", lib_path],
                       cwd=d, check=True, capture_output=True, timeout=120)
        cubin = next(os.path.join(d, f) for f in os.listdir(d)
                     if f.startswith(unit + ".") and f.endswith(".cubin"))
        return subprocess.run([os.path.join(bindir, "nvdisasm"), "-c", "-gi", cubin],
                              check=True, capture_output=True, text=True, timeout=300).stdout


def rounds_sass(lib_path, root=None):
    """Instructions one lane of K1/K2 executes, from the SASS of the
    built library at `lib_path` (compiled from the sources under `root`,
    this checkout by default): for each instantiation (source, wide) and
    each branch of eval_lane, {"writer", "reader": Counter by pipe
    class} of the fewest instructions from the kernel's entry to its
    exit for a lane the thread holds, in a one-round batch: its head and
    request words read, its rows gathered, its branch evaluated, its
    output written, the grid barrier and, for a writer, its rows stored.
    Lower bounds of this implementation (see lane_instructions), not of
    the work the function needs.  The anchors are functions of
    bucket_rounds.cuh found by name.  None, logged as not measured, when
    the count cannot be taken."""
    try:
        counts = _rounds_sass(lib_path, root or os.path.dirname(os.path.abspath(__file__)))
    except Exception as e:  # noqa: BLE001 — the count is a measurement, not a check
        log(f"[sass] instruction count not measured: {type(e).__name__}: {e}")
        return None
    for (kind, wide), per in sorted(counts.items()):
        log(f"[sass] {'K1' if kind == 'dict' else 'K2'} {kind} {'wide' if wide else 'narrow'}: "
            "instructions a held lane executes, writer/reader (the reader's by pipe): "
            + ", ".join(f"{p} {sum(c['writer'].values())}/{sum(c['reader'].values())} "
                        f"{dict(sorted(c['reader'].items()))}" for p, c in per.items()))
    return counts


def _rounds_sass(lib_path, root):
    cuh = os.path.join(root, "gubernator_tpu_torch", "csrc", "bucket_rounds.cuh")
    cuh_name = os.path.basename(cuh)
    spans = {p: function_span(cuh, p) for p in EVAL_PATHS}
    ea, eb = function_span(cuh, "eval_lane")
    ga, gb = function_span(cuh, "gather_eval")
    sa, sb = function_span(cuh, "store_rows")

    def within(loc, a, b):
        return any(f == cuh_name and a <= ln <= b for f, ln in loc)

    def store(text, loc):
        return "STG" in text and within(loc, sa, sb)

    funcs = parse_sass(disassemble(lib_path, "bucket_rounds"))
    counts = {}
    for name, fn in funcs.items():
        if "bucket_rounds_kernel" not in name:
            continue
        key = ("dict" if "DictSource" in name else "cols", "ILb1E" in name)
        per = {}
        for path, (a, b) in spans.items():
            # a held lane's branch: not the evaluation the excess lanes
            # gather for themselves
            def branch(text, loc, a=a, b=b):
                return within(loc, a, b) and not within(loc, ga, gb)

            if not any(branch(*x) for x in fn["ins"]):
                # folded into eval_lane's selects: the fewest of any
                # branch, still a lower bound
                def branch(text, loc):
                    return within(loc, ea, eb) and not within(loc, ga, gb)
            per[path] = {"writer": lane_instructions(fn, [branch, store]),
                         "reader": lane_instructions(fn, [branch])}
        counts[key] = per
    if len(counts) != 4 or any(v is None for per in counts.values() for c in per.values()
                               for v in c.values()):
        raise ValueError(f"count of K1/K2 incomplete: {counts}")
    return counts


def sm_clock_hz():
    """The card's top SM clock (nvidia-smi clocks.max.sm)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def lane_paths(hot, cold, req, now):
    """The branch of eval_lane each lane of `req` takes against the rows
    it reads in `hot`/`cold` (the state before the batch: a lane of a
    later round that reads a row an earlier round wrote is classed by
    the row as it was), and whether it stores its rows.  Returns
    ({branch: bool [S, P]}, writer bool [S, P]); lanes with slot < 0 are
    in no branch."""
    import torch

    S, P = req.slot.shape
    C = hot.shape[1]
    valid = req.slot >= 0
    sh = torch.arange(S, device=hot.device)[:, None].expand(S, P)
    sl = req.slot.clamp(0, C - 1).long()
    h, c = hot[sh, sl].long(), cold[sh, sl].long()

    def word64(t, i):
        return (t[..., i + 1] << 32) | (t[..., i] & 0xFFFFFFFF)

    g_algo, g_exp, g_stamp, g_dur = h[..., 0] & 3, word64(h, 5), word64(h, 3), word64(c, 2)
    live = req.exists & (g_exp >= now)
    exist = live & (g_algo == req.algorithm)
    tok = req.algorithm == 0
    reset = (req.behavior & 8) != 0
    greg = (req.behavior & 4) != 0
    t_reset = tok & live & reset
    t_exp = torch.where(greg, req.greg_expire, g_stamp + req.duration)
    t_exist = tok & ~t_reset & exist & ~reset & ((g_dur == req.duration) | (t_exp >= now))
    paths = {"token_reset": t_reset, "token_exist": t_exist,
             "token_create": tok & ~t_reset & ~t_exist, "leaky_exist": ~tok & exist,
             "leaky_create": ~tok & ~exist}
    return {k: v & valid for k, v in paths.items()}, req.write & valid & (req.slot < C)


def rounds_bound(torch, sass, kind, hot0, cold0, args, nbytes):
    """K1/K2's bound on one batch: the larger of the bytes bound
    (`nbytes` over the HBM rate) and the issue bound — the instructions
    the batch's lanes execute (each lane its branch's count from
    rounds_sass, writer or reader, classed from the state before the
    batch), each pipe class over its rate and all of them over the
    issue rate (SMs x lanes a clock x the top SM clock), the slowest of
    these.  Without a SASS count (`sass` None) the bytes bound alone.
    Returns (bound_ms, bound_by, a line that gives both)."""
    from gubernator_tpu_torch.ops import buckets

    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    text = f"bytes bound {bytes_ms:.6g} ms ({nbytes} bytes)"
    if sass is None:
        return bytes_ms, "bytes", text + ", issue bound not measured; bound by bytes"
    now, wide = int(args[-2]), bool(args[-1])
    if kind == "dict":
        req, _ = buckets._dict_request(args[0], now, wide)
    else:
        req, _ = buckets._cols_request(args[0], args[1], now, wide)
    paths, writer = lane_paths(hot0, cold0, req, now)
    per = sass[(kind, wide)]
    instr, lanes = collections.Counter(), {}
    for p, mask in paths.items():
        w, r = int((mask & writer).sum()), int((mask & ~writer).sum())
        lanes[p] = w + r
        for pipe in set(per[p]["writer"]) | set(per[p]["reader"]):
            instr[pipe] += w * per[p]["writer"][pipe] + r * per[p]["reader"][pipe]
    clk = sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pipe_ms = {"issue": sum(instr.values()) / (sms * ISSUE_LANES_PER_SM_CLOCK * clk) * 1e3}
    for pipe, rate in PIPE_LANES_PER_SM_CLOCK.items():
        pipe_ms[pipe] = instr[pipe] / (sms * rate * clk) * 1e3
    slowest = max(pipe_ms, key=pipe_ms.get)
    issue_ms = pipe_ms[slowest]
    by = "bytes" if bytes_ms >= issue_ms else "operations"
    rate = ("all at the issue rate" if slowest == "issue"
            else f"its {slowest} instructions at their pipe's rate")
    text += (f", issue bound {issue_ms:.6g} ms ({rate}; {sum(instr.values())} "
             f"instructions, by pipe {dict(sorted(instr.items()))}, on {sms} SMs at "
             f"{clk / 1e6:.0f} MHz; lanes by branch {lanes}); bound by "
             f"{'bytes' if by == 'bytes' else 'issue'}")
    return max(bytes_ms, issue_ms), by, text


# ---------------------------------------------------------------------
# seeded kernel inputs (numpy), shapes as the mesh store plans them
# ---------------------------------------------------------------------
def _split(v):
    v = np.asarray(v, np.int64)
    return (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32), (v >> 32).astype(np.int32)


def random_state(rng, C, wide, shards=S):
    n = shards * C
    algo = rng.integers(0, 2, n)
    limit = np.where(rng.random(n) < 0.8, rng.integers(0, 200, n),
                     rng.integers(0, 2**40 if wide else 200, n))
    duration = rng.choice([1000, 30_000, 60_000, 3_600_000], n)
    rem = (rng.random(n) * (limit + 1)).astype(np.int64)
    rem = np.where(algo == 1, rem * (1 << 20) + rng.integers(0, 1 << 20, n), rem)
    stamp = NOW - rng.integers(0, 2 * 3_600_000, n)
    expire = NOW + rng.integers(-60_000, 3_600_000, n)
    pick = rng.random(n)
    expire = np.select([pick < 0.05, pick < 0.1, pick < 0.15, pick < 0.2],
                       [NOW, NOW - 1, 0, NOW + (1 << 40)], expire)
    hot = np.zeros((n, 8), np.int32)
    cold = np.zeros((n, 8), np.int32)
    hot[:, 0] = algo | (rng.integers(0, 2, n) << 2)
    hot[:, 1], hot[:, 2] = _split(rem)
    hot[:, 3], hot[:, 4] = _split(stamp)
    hot[:, 5], hot[:, 6] = _split(expire)
    cold[:, 0], cold[:, 1] = _split(limit)
    cold[:, 2], cold[:, 3] = _split(duration)
    return hot.reshape(shards, C, 8), cold.reshape(shards, C, 8)


def random_configs(rng, k, wide):
    """k configs (algo, behavior, hits, limit, duration, greg_expire
    delta, greg_duration); wide ones add >2**31 values and durations
    that take the 128-bit leak division."""
    algo = rng.integers(0, 2, k)
    behavior = np.where(rng.random(k) < 0.15, 8, 0)
    hits = rng.choice([0, 1, 1, 1, 2, 3, 5, 50], k)
    limit = rng.choice([0, 1, 5, 10, 30, 100, 199], k)
    duration = rng.choice([1000, 30_000, 60_000, 3_600_000], k)
    greg = rng.random(k) < 0.2
    behavior = np.where(greg, behavior | 4, behavior)
    gd = np.where(greg, 86_400_000, 0)
    ge = np.where(greg, rng.integers(0, 86_400_000, k), 0)
    if wide:
        big = rng.random(k) < 0.4
        limit = np.where(big, 2**42, limit)
        hits = np.where(big & (rng.random(k) < 0.5), 2**41, hits)
        duration = np.where(big & (rng.random(k) < 0.5), 2**44, duration)
        ge = np.where(greg & (rng.random(k) < 0.5), 2**33, ge)
    return [np.asarray(c, np.int64) for c in (algo, behavior, hits, limit, duration, ge, gd)]


def random_plan(rng, C, P, rounds, shards=S, reuse=0.0):
    """Per-shard lanes as the grouped planner emits them: unique slots
    per (round, shard), uniform groups with consecutive occ and one
    writer, 20% padding, lanes shuffled.  With `reuse`, that share of
    each later round's groups takes slots the round before used."""
    cols = {k: np.zeros((shards, P), np.int64) for k in ("slot", "ex", "wr", "occ", "rid", "grp")}
    cols["slot"][:] = -1
    used = int(P * 0.8)
    for s in range(shards):
        sizes = rng.choice([1, 1, 1, 2, 3, 5], used)
        ends = np.cumsum(sizes)
        g = int(np.searchsorted(ends, used)) + 1
        sizes = sizes[:g]
        sizes[-1] -= ends[g - 1] - used
        ends = np.cumsum(sizes)
        grid = rng.integers(0, rounds, g)
        slots = np.empty(g, np.int64)
        prev = np.zeros(0, np.int64)
        for r in range(rounds):  # unique within a round, reused across rounds
            sel = grid == r
            k = int(sel.sum())
            again = min(int(k * reuse), prev.size) if r else 0
            if again:
                kept = rng.choice(prev, again, replace=False)
                fresh = rng.choice(np.setdiff1d(np.arange(C), kept), k - again, replace=False)
                slots[sel] = rng.permutation(np.concatenate([kept, fresh]))
            else:
                slots[sel] = rng.choice(C, k, replace=False)
            prev = slots[sel]
        gid = np.repeat(np.arange(g), sizes)
        first = np.repeat(ends[:g] - sizes, sizes)
        occ = np.arange(used) - first
        lanes = rng.permutation(P)[:used]
        cols["slot"][s, lanes] = slots[gid]
        cols["ex"][s, lanes] = (rng.random(g) < 0.8)[gid]
        cols["wr"][s, lanes] = occ == sizes[gid] - 1
        cols["occ"][s, lanes] = occ
        cols["rid"][s, lanes] = grid[gid]
        cols["grp"][s, lanes] = gid
    return cols


def make_case(seed, C, P, rounds, wide, kind, n_cfg, reuse=0.0):
    """Kernel inputs for one seeded case: (hot, cold, args, n_rounds)
    where args follow (hot, cold) in bucket_rounds_dict /
    bucket_rounds_cols (`reuse`: see random_plan)."""
    from gubernator_tpu_torch.ops import buckets

    rng = np.random.default_rng(seed)
    hot, cold = random_state(rng, C, wide)
    cfgs = random_configs(rng, n_cfg, wide)
    plan = random_plan(rng, C, P, rounds, reuse=reuse)
    cfg = rng.integers(0, n_cfg, (S, P))
    # lanes of one group share one config
    for s in range(S):
        cfg[s] = cfg[s][plan["grp"][s] % P]
    n_rounds = int(plan["rid"].max()) + 1
    if kind == "dict":
        table = [np.concatenate([c, np.zeros(256 - n_cfg, np.int64)]) for c in cfgs]
        wire = buckets.pack_dict_wire(plan["slot"], plan["ex"], plan["wr"], cfg,
                                      plan["occ"], plan["rid"], table)
        return hot, cold, (wire,), n_rounds
    vals = [c[cfg] for c in cfgs]
    if wide:  # absolute greg_expire on the wide per-lane wire
        vals[5] = np.where(vals[6] != 0, NOW + vals[5], 0)
    lanes = np.stack([plan["slot"], plan["ex"] | (plan["wr"] << 1), vals[0], vals[1],
                      plan["occ"], plan["rid"]], axis=1).astype(np.int32)
    values = np.stack(vals[2:7], axis=1).astype(np.int64 if wide else np.int32)
    return hot, cold, (lanes, values), n_rounds


# ---------------------------------------------------------------------
# phase 3: kernels against their plain versions on the card
# ---------------------------------------------------------------------
KERNELS = {
    "dict": ("bucket_rounds_dict", "gubernator_tpu/parallel/mesh.py:179"),
    "cols": ("bucket_rounds_cols", "gubernator_tpu/parallel/mesh.py:158"),
}


def run_kernel(torch, dev, kind, hot, cold, args, n_rounds, wide, plain):
    from gubernator_tpu_torch.ops import buckets

    h = torch.tensor(hot, device=dev)  # copies: the case is reused
    c = torch.tensor(cold, device=dev)
    targs = [torch.tensor(a, device=dev) for a in args]
    if kind == "cols":
        fn = buckets.bucket_rounds_cols_plain if plain else buckets.bucket_rounds_cols
        out = fn(h, c, *targs, n_rounds, NOW, wide)
    elif plain:
        out = buckets.bucket_rounds_dict_plain(h, c, *targs, n_rounds, NOW, wide)
    else:
        # into slice 1 of a stacked result, as a fused launch group writes
        P = (targs[0].shape[1] - buckets.DICT_WIRE_TABLE_WORDS) // 3
        stacked = torch.zeros((2, targs[0].shape[0], 4, P), device=dev,
                              dtype=torch.int64 if wide else torch.int32)
        out = buckets.bucket_rounds_dict(h, c, *targs, n_rounds, NOW, wide, out=stacked[1])
    return out.cpu().numpy(), h.cpu().numpy(), c.cpu().numpy()


def max_abs_err(a, b):
    return max(int(np.abs(x.astype(np.int64) - y.astype(np.int64)).max()) for x, y in zip(a, b))


def distinct_rows(slot, mask) -> int:
    """The distinct (shard, slot) rows among the lanes `mask` picks of
    `slot` [S, P] (tensors or arrays): what a bound counts once, however
    many lanes of a key group touch the row."""
    slot, mask = (np.asarray(a.cpu() if hasattr(a, "cpu") else a) for a in (slot, mask))
    shard = np.broadcast_to(np.arange(slot.shape[0], dtype=np.int64)[:, None], slot.shape)
    return int(np.unique((shard << 32 | slot.astype(np.int64))[mask]).size)


def kernel_phase(torch, dev="cuda", full=(C_FULL, 32_768), over=65_536):
    """K1 and K2, narrow and wide, against their plain versions: seeded
    cases of 1-3 rounds, one case at the main path's size (S = 8,
    C = 262,144, P = 32,768), the same size in 5 rounds that reuse half
    the slots of the round before, and a 3-round case of P = `over`
    whose S * P lanes exceed what one launch holds (the rest re-read
    each round)."""
    from gubernator_tpu_torch.ops import _kernels

    if dev == "cuda":
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    errs = {k: 0 for k in KERNELS}
    n, held = 0, {}
    for kind in KERNELS:
        for wide in (False, True):
            n_cfg = 12 if kind == "dict" else 300
            cases = [(seed, 512, 256, 1 + seed % 3, 0.0) for seed in range(6)]
            cases += [(100, *full, 1, 0.0), (101, *full, 5, 0.5), (102, full[0], over, 3, 0.5)]
            if dev == "cuda":
                held[(kind, wide)] = _kernels.held_lanes(kind == "dict", wide)
                if S * over <= held[(kind, wide)]:
                    raise AssertionError(f"the {S} x {over} case fits the "
                                         f"{held[(kind, wide)]} held lanes")
            for seed, C, P, rounds, reuse in cases:
                hot, cold, args, nr = make_case(seed, C, P, rounds, wide, kind, n_cfg, reuse)
                if rounds > 1 and nr != rounds:
                    raise AssertionError(f"case {seed} planned {nr} rounds, not {rounds}")
                got = run_kernel(torch, dev, kind, hot, cold, args, nr, wide, plain=False)
                want = run_kernel(torch, dev, kind, hot, cold, args, nr, wide, plain=True)
                err = max_abs_err(got, want)
                if err != 0 or any(g.tobytes() != w.tobytes() for g, w in zip(got, want)):
                    raise AssertionError(
                        f"{kind} wide={wide} seed={seed} C={C} P={P} rounds={nr}: kernel != "
                        f"plain (max abs err {err})")
                errs[kind] = max(errs[kind], err)
                n += 1
    peak = torch.cuda.max_memory_allocated() - base if dev == "cuda" else 0
    log(f"[kernels] {n} cases, kernel == plain bit for bit, among them S={S} x P={full[1]} "
        f"in 1 and in 5 rounds (half the slots reused from the round before) and S={S} x "
        f"P={over} in 3 rounds past the {held} lanes one launch holds (launches "
        f"{dict(_kernels.LAUNCHES)}); peak device memory of the phase {peak / 2**20:.1f} MiB "
        f"(K1/K2 allocate no scratch)")
    return errs


# ---------------------------------------------------------------------
# phase 3, GLOBAL kernels: seeded cases (numpy) and runs
# ---------------------------------------------------------------------
GLOBAL_KERNELS = {
    "answer": ("global_answer_rounds", "gubernator_tpu/parallel/mesh.py:116"),
    "sync": ("global_sync", "gubernator_tpu/parallel/mesh.py:308"),
    "replica": ("set_replica", "gubernator_tpu/parallel/mesh.py:251"),
    "clear": ("clear_gslots", "gubernator_tpu/parallel/mesh.py:258"),
}


def random_gcols(rng, G):
    """Replica columns: live entries (a fifth of them expiring within
    a ms of NOW, exactly at NOW included), dead ones, and pending hits
    of either sign."""
    expire = np.where(rng.random((S, G)) < 0.2, NOW + rng.integers(-1, 2, (S, G)),
                      NOW + rng.integers(-2, 3_600_000, (S, G)))
    return [
        rng.integers(0, 2, (S, G)).astype(np.int32),
        rng.integers(0, 200, (S, G)).astype(np.int64),
        rng.integers(0, 200, (S, G)).astype(np.int64),
        NOW + rng.integers(-1000, 3_600_000, (S, G)),
        np.where(rng.random((S, G)) < 0.5, expire, 0),
        rng.integers(-3, 9, (S, G)).astype(np.int64),
    ]


def global_case(kind, seed, C, G, P=0, n_rounds=1):
    """Inputs of one GLOBAL kernel: (hot, cold, gcols, args)."""
    rng = np.random.default_rng(seed)
    hot, cold = random_state(rng, C, False)
    gc = random_gcols(rng, G)
    if kind == "answer":
        used = P * 3 // 4
        slot = np.full((S, P), -1, np.int64)
        rid = np.zeros((S, P), np.int64)
        gslot = np.full((S, P), -1, np.int64)
        for s in range(S):
            rid[s, :used] = rng.integers(0, n_rounds, used)
            for r in range(n_rounds):
                sel = np.nonzero(rid[s, :used] == r)[0]
                slot[s, sel] = rng.choice(C, sel.size, replace=False)
            gslot[s, :used] = np.where(rng.random(used) < 0.6,
                                       rng.integers(0, G, used), -1)
        gslot[0, :4] = 5  # duplicate gslots in one shard's batch
        slot = np.where((gslot >= 0) & (rng.random((S, P)) < 0.3), -1, slot)  # replica hints
        cfgs = random_configs(rng, 12, False)
        cfg = rng.integers(0, 12, (S, P))
        vals = [c[cfg] for c in cfgs]
        vals[1] |= 2  # GLOBAL
        vals[2] = np.where(rng.random((S, P)) < 0.1, -2, vals[2])  # negative hits
        vals[5] = np.where(vals[6] != 0, NOW + vals[5], 0)  # absolute greg_expire
        write = slot >= 0
        lanes = np.stack([slot, (rng.random((S, P)) < 0.8) | (write << 1), vals[0],
                          vals[1], np.zeros((S, P), np.int64), rid], axis=1).astype(np.int32)
        values = np.stack(vals[2:7], axis=1).astype(np.int64)
        return hot, cold, gc, (lanes, values, gslot.astype(np.int32), n_rounds)
    if kind == "sync":
        cfgs = random_configs(rng, G, False)
        owner_shard = rng.integers(-1, S, G)  # -1: a remote owner
        owner_slot = np.where(rng.random(G) < 0.95,
                              rng.permutation(max(C, G))[:G] % C, -1)
        cfg = np.stack([owner_slot, owner_shard, cfgs[0], cfgs[1], cfgs[3], cfgs[4],
                        np.where(cfgs[6] != 0, NOW + cfgs[5], 0), cfgs[6]]).astype(np.int64)
        return hot, cold, gc, (cfg, rng.random((S, G)) < 0.2)
    if kind == "replica":
        M = P
        g = rng.permutation(G)[:M].astype(np.int64)
        g[rng.random(M) < 0.1] = -1  # padding
        g[-1] = G + 1  # out of range: dropped
        upd = np.stack([g, rng.integers(0, 2, M), rng.integers(0, 200, M),
                        rng.integers(0, 200, M), NOW + rng.integers(0, 3_600_000, M)])
        return hot, cold, gc, (upd.astype(np.int64),)
    idx = np.full(P, G, np.int64)  # pow2 padding with G
    idx[: P * 7 // 8] = rng.integers(0, G, P * 7 // 8)  # duplicates are harmless
    if seed % 2 == 0:  # sorted, as the stores hand it over; odd seeds in any order
        idx.sort()
    return hot, cold, gc, (idx,)


def run_global(torch, dev, kind, case, plain):
    """One GLOBAL kernel (or its plain version) on copies of a case;
    returns every output and every updated tensor as numpy."""
    from gubernator_tpu_torch.ops import _kernels, global_ops

    hot, cold, gc, args = case
    h, c = torch.tensor(hot, device=dev), torch.tensor(cold, device=dev)
    g = global_ops.global_columns_from_numpy(gc, dev)
    if kind == "answer":
        lanes, values, gslot, nr = args
        fn = global_ops.answer_rounds_plain if plain else global_ops.answer_rounds
        out = [fn(h, c, g, torch.tensor(lanes, device=dev), torch.tensor(values, device=dev),
                  torch.tensor(gslot, device=dev), nr, NOW)]
    elif kind == "sync":
        cfg, dirty = args
        fn = global_ops.global_sync_plain if plain else global_ops.global_sync
        out = [fn(h, c, g, torch.tensor(cfg, device=dev), torch.tensor(dirty, device=dev), NOW)]
    else:
        fns = {"replica": (global_ops.set_replica_plain, _kernels.set_replica),
               "clear": (global_ops.clear_gslots_plain, _kernels.clear_gslots)}
        fns[kind][0 if plain else 1](g, torch.tensor(args[0], device=dev))
        out = []
    return [t.cpu().numpy() for t in (*out, h, c, *g)]


def global_kernel_phase(torch, dev="cuda", full=(C_GLOBAL, G_FULL, GLOBAL_BATCH),
                        past=65_536):
    """K3-K6 against their plain versions: seeded small cases and one at
    the GLOBAL path's full size (S=8, 65,536 slots and gslots, 2,048
    lanes per shard, a 16,384-gslot replica commit, a 1,024-index clear
    sorted and a 4,096-index one in any order);
    K3 also on 8 x `past` lanes in 3 rounds, more than its launch holds."""
    from gubernator_tpu_torch.ops import _kernels

    Cf, Gf, Pf = full
    if dev != "cpu" and S * past <= _kernels.answer_launch_shape(S * past)[1]:
        raise AssertionError(f"K3 holds all {S * past} lanes: no case past them")
    shapes = {
        "answer": [(seed, 256, 64, 128, 1 + seed % 3) for seed in range(4)]
        + [(100, Cf, Gf, Pf, 1), (101, Cf, Gf, Pf, 3), (102, max(Cf, past), Gf, past, 3)],
        "sync": [(seed, 256, 64, 0, 1) for seed in range(4)] + [(100, Cf, Gf, 0, 1)],
        "replica": [(seed, 256, 64, 32, 1) for seed in range(4)]
        + [(100, Cf, Gf, min(Gf, PEER_KEYS), 1)],
        "clear": [(seed, 256, 64, 32, 1) for seed in range(4)]
        + [(100, Cf, Gf, 1024, 1), (101, Cf, Gf, 2 * Pf, 1)],
    }
    errs = {}
    n = 0
    for kind, cases in shapes.items():
        errs[kind] = 0
        for seed, C, G, P, nr in cases:
            case = global_case(kind, seed, C, G, P, nr)
            got = run_global(torch, dev, kind, case, plain=False)
            want = run_global(torch, dev, kind, case, plain=True)
            err = max_abs_err(got, want)
            if err != 0 or any(a.tobytes() != b.tobytes() for a, b in zip(got, want)):
                raise AssertionError(f"{kind} seed={seed} C={C} G={G} P={P}: kernel != "
                                     f"plain (max abs err {err})")
            errs[kind] = max(errs[kind], err)
            n += 1
    log(f"[kernels] {n} GLOBAL cases, kernel == plain bit for bit "
        f"(launches {dict(_kernels.LAUNCHES)})")
    return errs


# ---------------------------------------------------------------------
# phase 3, row kernels: seeded cases (numpy) and runs
# ---------------------------------------------------------------------
ROW_KERNELS = {
    "gather": ("gather_rows", "gubernator_tpu/parallel/mesh.py:279"),
    "write": ("write_rows", "gubernator_tpu/parallel/mesh.py:288"),
}
INT64_EXTREMES = np.array([0, 1, -1, 2**31 - 1, -2**31, 2**31, 2**32 - 1, 2**32, 2**62,
                           2**63 - 1, -2**63], np.int64)


def rows_case(seed, C, M):
    """Inputs of K7 and K8: (hot, cold, lanes i32[2, M], c32 i32[2, M],
    c64 i64[5, M], keep).  8% of the lanes are padding (slot -1) and 2%
    out of range; (shard, slot) pairs repeat; the columns hold int64
    extremes, and algo/status values beyond their bits.  K8 takes the
    lanes `keep`: the padding and, of each repeated pair, the last lane
    (the host's dedup, ops/buckets.py last_lane_per_slot)."""
    from gubernator_tpu_torch.ops import buckets

    rng = np.random.default_rng(seed)
    hot, cold = random_state(rng, C, True)
    shard = rng.integers(0, S, M)
    pick = rng.random(M)
    slot = np.where(pick < 0.08, -1, np.where(pick < 0.1, C + rng.integers(0, 3, M),
                                              rng.integers(0, C, M)))
    c64 = np.where(rng.random((5, M)) < 0.3, rng.choice(INT64_EXTREMES, (5, M)),
                   NOW + rng.integers(-2**40, 2**40, (5, M)))
    c32 = rng.integers(-2, 6, (2, M)).astype(np.int32)
    keep = np.union1d(buckets.last_lane_per_slot(shard, slot), np.nonzero(slot < 0)[0])
    return (hot, cold, np.stack([shard, slot]).astype(np.int32), c32,
            c64.astype(np.int64), keep)


def run_rows(torch, dev, kind, case, plain):
    """K7 or K8 (or its plain version) on copies of a case; returns the
    outputs and the state as numpy."""
    from gubernator_tpu_torch.ops import _kernels, buckets

    hot, cold, lanes, c32, c64, keep = case
    h, c = torch.tensor(hot, device=dev), torch.tensor(cold, device=dev)
    if kind == "gather":
        fn = buckets.read_rows_plain if plain else _kernels.gather_rows
        out = list(fn(h, c, torch.tensor(lanes, device=dev)))
    else:
        fn = buckets.write_rows_plain if plain else _kernels.write_rows
        fn(h, c, *[torch.tensor(np.ascontiguousarray(a[:, keep]), device=dev)
                   for a in (lanes, c32, c64)])
        out = []
    return [t.cpu().numpy() for t in (*out, h, c)]


def rows_kernel_phase(torch, dev="cuda", full=(C_FULL, N_KEYS)):
    """K7 and K8 against their plain versions: seeded small cases (many
    repeated pairs) and one at the persistence path's size (S=8 x
    262,144 slots, 1,000,000 lanes)."""
    from gubernator_tpu_torch.ops import _kernels

    errs, n = {}, 0
    for kind in ROW_KERNELS:
        errs[kind] = 0
        for seed, C, M in [(seed, 64, 300) for seed in range(4)] + [(100, *full)]:
            case = rows_case(seed, C, M)
            got = run_rows(torch, dev, kind, case, plain=False)
            want = run_rows(torch, dev, kind, case, plain=True)
            err = max_abs_err(got, want)
            if err != 0 or any(a.tobytes() != b.tobytes() for a, b in zip(got, want)):
                raise AssertionError(f"{kind} rows seed={seed} C={C} M={M}: kernel != plain "
                                     f"(max abs err {err})")
            errs[kind] = max(errs[kind], err)
            n += 1
    log(f"[kernels] {n} row cases, kernel == plain bit for bit "
        f"(launches {dict(_kernels.LAUNCHES)})")
    return errs


# ---------------------------------------------------------------------
# phase 3, the tier move: seeded cases (numpy) and runs
# ---------------------------------------------------------------------
MOVE_KERNEL = ("apply_moves", "gubernator_tpu/ops/buckets.py:1360")
BACK_ROWS_KERNEL = ("gather_back_rows", "gubernator_tpu/ops/buckets.py:1406")


def random_moves(rng, C, Cb, n_demo, n_promo):
    """One drain window of each shard's moves, shaped as
    NativeSlotTable.take_moves gives them: distinct destinations, 10%
    cancelled records (src -1), and the two hazards of a window: a
    demotion's source front slot reused as a promotion's destination,
    and a kind-1 promotion reading a demotion's source front slot."""
    moves = []
    for _ in range(S):
        ds = rng.choice(C, n_demo, replace=False).astype(np.int32)
        dd = rng.choice(Cb, n_demo, replace=False).astype(np.int32)
        reused = ds[: min(n_promo // 3, n_demo)]
        pd = np.concatenate([reused, rng.choice(np.setdiff1d(np.arange(C), reused),
                                                n_promo - reused.size, replace=False)])
        pd = rng.permutation(pd).astype(np.int32)
        pk = (rng.random(n_promo) < 0.4).astype(np.int32)
        ps = np.where(pk == 1, rng.choice(ds if n_demo else np.arange(C), n_promo),
                      rng.choice(Cb, n_promo)).astype(np.int32)
        ds = np.where(rng.random(n_demo) < 0.1, -1, ds).astype(np.int32)
        ps = np.where(rng.random(n_promo) < 0.1, -1, ps).astype(np.int32)
        moves.append((pk, ps, pd, ds, dd))
    return moves


def moves_case(seed, C, Cb, n_demo, n_promo):
    """Inputs of K9: (hot, cold, back_hot, back_cold, records i32[3, N]):
    random tier tables, random_moves' window as flat records, plus
    records that must do nothing: cancelled ones (src -1) aimed at live
    destinations, an unknown kind, a shard and a destination out of
    range."""
    from gubernator_tpu_torch.ops import buckets

    rng = np.random.default_rng(seed)
    tiers = [rng.integers(-2**31, 2**31, (S, n, 8), dtype=np.int64).astype(np.int32)
             for n in (C, C, Cb, Cb)]
    records = buckets.moves_to_records(random_moves(rng, C, Cb, n_demo, n_promo))
    live_dst = records[2, 0] if records.shape[1] else 0
    dead = np.array([[2, 0, 3, S << 2, 2, 0],  # op = shard << 2 | kind
                     [-1, -1, 0, 0, 0, Cb],  # src
                     [live_dst, 1, 2, 0, Cb, 0]], np.int32)  # dst
    return (*tiers, np.ascontiguousarray(np.concatenate([records, dead], axis=1)))


def run_moves(torch, dev, case, plain, reverse=False):
    """K9 (or its plain version) on copies of a case, the records in
    their order or reversed; returns the four tables as numpy."""
    from gubernator_tpu_torch.ops import _kernels, buckets

    *tiers, records = case
    if reverse:
        records = np.ascontiguousarray(records[:, ::-1])
    t = [torch.tensor(a, device=dev) for a in tiers]
    fn = buckets.apply_moves_plain if plain else _kernels.apply_moves
    fn(*t, torch.tensor(records, device=dev))
    return [x.cpu().numpy() for x in t]


def moves_kernel_phase(torch, dev="cuda", full=(TT_FRONT, TT_BACK, TT_MOVES),
                       past=(65_536, 262_144, 22_000, 20_000)):
    """K9 against its plain version: seeded small cases with both
    hazards, the records in both orders, one case at the two-tier
    path's size (S=8 x 32,768 front and 217,232 back rows, ~226,000
    live records) and one of ~300,000 records, more than its launch holds
    in registers (`past`)."""
    from gubernator_tpu_torch.ops import _kernels

    err, n = 0, 0
    C, Cb, m = full
    for seed, args in [(s, (64, 256, 20, 15)) for s in range(4)] + [(100, (C, Cb, m, m)),
                                                                    (101, past)]:
        case = moves_case(seed, *args)
        if seed == 101 and dev != "cpu" and not _kernels.moves_spill(case[-1].shape[1]):
            raise AssertionError("K9 holds the whole window: no case past it")
        want = run_moves(torch, dev, case, plain=True)
        for reverse in (False, True):
            got = run_moves(torch, dev, case, plain=False, reverse=reverse)
            e = max_abs_err(got, want)
            if e != 0 or any(a.tobytes() != b.tobytes() for a, b in zip(got, want)):
                raise AssertionError(f"moves seed={seed} {args} reverse={reverse}: "
                                     f"kernel != plain (max abs err {e})")
            err = max(err, e)
            n += 1
    log(f"[kernels] {n} tier-move cases (both record orders), kernel == plain bit for bit "
        f"(launches {_kernels.LAUNCHES['apply_moves']})")
    return err


# ---------------------------------------------------------------------
# phase 3, the compact commit (K10): one-shard single-round cases
# ---------------------------------------------------------------------
COMPACT_KERNEL = ("bucket_compact", "gubernator_tpu/ops/buckets.py:849")


def _pad_wlane(wl):
    """Write lanes as the host hands them over: i32[1, Pw], -1 padded
    to a multiple of 256."""
    out = np.full((1, (len(wl) // 256 + 1) * 256), -1, np.int32)
    out[0, :len(wl)] = wl
    return out


def compact_args(kind, plan, cfgs, cfg):
    """A one-shard single-round plan's lanes as K10 (and K1/K2) take
    them: the dict wire, or the narrow per-lane columns."""
    from gubernator_tpu_torch.ops import buckets

    if kind == "dict":
        table = [np.concatenate([c, np.zeros(256 - len(c), np.int64)]) for c in cfgs]
        return (buckets.pack_dict_wire(plan["slot"], plan["ex"], plan["wr"], cfg,
                                       plan["occ"], plan["rid"], table),)
    vals = [c[cfg] for c in cfgs]
    lanes = np.stack([plan["slot"], plan["ex"] | (plan["wr"] << 1), vals[0], vals[1],
                      plan["occ"], plan["rid"]], axis=1).astype(np.int32)
    return lanes, np.stack(vals[2:7], axis=1).astype(np.int32)


def compact_case(seed, C, P, kind, n_cfg, subset=False):
    """A seeded one-shard single-round batch (uniform groups, one writer
    each) and its write lanes: (hot, cold, args, wlane).  With `subset`,
    wlane lists half of the write lanes."""
    rng = np.random.default_rng(seed)
    hot, cold = random_state(rng, C, False, shards=1)
    cfgs = random_configs(rng, n_cfg, False)
    plan = random_plan(rng, C, P, 1, shards=1)
    cfg = rng.integers(0, n_cfg, (1, P))
    cfg[0] = cfg[0][plan["grp"][0] % P]
    wl = np.nonzero(plan["wr"][0] & (plan["slot"][0] >= 0))[0]
    if subset:
        wl = np.sort(rng.choice(wl, wl.size // 2, replace=False))
    return hot, cold, compact_args(kind, plan, cfgs, cfg), _pad_wlane(wl)


def zipf_compact_case(seed, C, P, n_keys, kind):
    """A full-size K10 case from the C++ planner: the headline's Zipf
    traffic (`key_id % 2` algorithms) planned on a C-slot table that an
    earlier batch filled, so most lanes find their bucket; the state is
    seeded rows.  Returns (hot, cold, args, wlane)."""
    from gubernator_tpu_torch import native
    from gubernator_tpu_torch.models.shard import make_columns
    from gubernator_tpu_torch.ops import buckets

    rng = np.random.RandomState(seed)
    table = native.NativeSlotTable(C)
    for _ in range(2):
        ids = zipf_ids(rng, n_keys, P)
        cols = make_columns((ids % 2).astype(np.int32), np.zeros(P, np.int32),
                            np.ones(P, np.int64), np.full(P, 1_000_000, np.int64),
                            np.full(P, 3_600_000, np.int64), P)
        planner = native.NativeBatchPlanner(table, [f"k{k}" for k in ids], NOW)
        rid, slot, ex, occ, wr, n_rounds = planner.plan_grouped(cols, 8)
        planner.commit_plan(np.full(P, NOW + 3_600_000, np.int64), np.zeros(P, bool))
    assert n_rounds == 1, n_rounds
    cfg_idx, cfgs = buckets.build_config_dict(cols, NOW)
    plan = {"slot": slot[None], "ex": ex[None], "wr": wr[None], "occ": occ[None],
            "rid": rid[None]}
    hot, cold = random_state(np.random.default_rng(seed), C, False, shards=1)
    cfgs = [np.asarray(c[:int(cfg_idx.max()) + 1], np.int64) for c in cfgs]
    return (hot, cold, compact_args(kind, plan, cfgs, cfg_idx[None].astype(np.int64)),
            _pad_wlane(np.nonzero(wr)[0]))


def _compact_fns():
    """{wire: (K10's dispatcher, its plain version)}"""
    from gubernator_tpu_torch.ops import buckets

    return {"dict": (buckets.compact_dict, buckets.apply_compact_packed_plain),
            "cols": (buckets.compact_cols, buckets.apply_compact32_plain)}


def run_compact(torch, dev, kind, case, plain):
    """K10 (or its plain version) on copies of a case: (out, hot, cold)."""
    hot, cold, args, wlane = case
    h, c = torch.tensor(hot, device=dev), torch.tensor(cold, device=dev)
    targs = [torch.tensor(a, device=dev) for a in args]
    wl = torch.tensor(wlane, device=dev)
    out = _compact_fns()[kind][1 if plain else 0](h, c, *targs, wl, NOW)
    return out.cpu().numpy(), h.cpu().numpy(), c.cpu().numpy()


def compact_kernel_phase(torch, dev="cuda", full=(SHARD_C, BATCH, SHARD_KEYS)):
    """K10 against its plain version and against K1 (dict wire) or K2
    (columns) on the same single-round batch: seeded cases (every write
    lane listed, or half of them) and one at the headline ShardStore's
    size (C = 300,000, a 131,072-lane Zipf plan over 100,000 keys).
    With every write lane listed, the output and the state must equal
    the rounds kernel's; with half, the output."""
    from gubernator_tpu_torch.ops import _kernels

    err = 0
    n = 0
    for kind in ("dict", "cols"):
        cases = [(seed, compact_case(seed, 512, 256, kind, 12 if kind == "dict" else 300,
                                     subset=seed % 2 == 1)) for seed in range(6)]
        cases.append((100, zipf_compact_case(100, *full[:2], full[2], kind)))
        for seed, case in cases:
            got = run_compact(torch, dev, kind, case, plain=False)
            want = run_compact(torch, dev, kind, case, plain=True)
            e = max_abs_err(got, want)
            if e != 0 or any(g.tobytes() != w.tobytes() for g, w in zip(got, want)):
                raise AssertionError(f"compact {kind} seed={seed}: kernel != plain "
                                     f"(max abs err {e})")
            hot, cold, args, _ = case
            rounds = run_kernel(torch, dev, kind, hot, cold, args, 1, False, plain=False)
            full_list = seed % 2 == 0 or seed == 100
            for g, r in list(zip(got, rounds))[:3 if full_list else 1]:
                if g.tobytes() != r.tobytes():
                    raise AssertionError(f"compact {kind} seed={seed}: K10 != the rounds "
                                         f"kernel on the same batch")
            err = max(err, e)
            n += 1
        # two calls back to back on one state with disjoint write lists
        # (the full-size case's even and odd write lanes): a lane the
        # first call listed must store nothing in the second
        hot, cold, args, wlane = cases[-1][1]
        listed = wlane[0][wlane[0] >= 0]
        targs = [torch.tensor(a, device=dev) for a in args]
        sides = [(fn, torch.tensor(hot, device=dev), torch.tensor(cold, device=dev))
                 for fn in _compact_fns()[kind]]
        for own in (listed[0::2], listed[1::2]):
            wl = torch.tensor(_pad_wlane(own), device=dev)
            (ok, h, c), (op, hp, cp) = [(fn(h, c, *targs, wl, NOW), h, c) for fn, h, c in sides]
            if not (torch.equal(ok, op) and torch.equal(h, hp) and torch.equal(c, cp)):
                raise AssertionError(f"compact {kind}: back-to-back calls with disjoint write "
                                     f"lists != plain")
            n += 1
    log(f"[kernels] {n} compact cases, K10 == plain bit for bit and == K1/K2 on the same "
        f"single-round batch, also two calls back to back with disjoint write lists "
        f"(launches {dict(_kernels.LAUNCHES)})")
    return err


# ---------------------------------------------------------------------
# phase 4: service on the card against the service on the CPU
# ---------------------------------------------------------------------
def service_phase(devices=("cuda", "cpu")):
    from gubernator_tpu_torch.config import BehaviorConfig
    from gubernator_tpu_torch.service import IngressColumns, ServiceConfig, V1Service
    from gubernator_tpu_torch.types import (
        Algorithm, Behavior, GetRateLimitsRequest, RateLimitRequest, Status)
    from gubernator_tpu_torch.utils.clock import Clock

    svcs = []
    for device in devices:
        clock = Clock()
        clock.freeze(NOW)
        # GLOBAL syncs run only where this phase calls run_once
        svcs.append((V1Service(ServiceConfig(
            cache_size=4096, clock=clock, device=device,
            behaviors=BehaviorConfig(global_sync_wait_s=3600.0))), clock))

    def req(key, hits=1, limit=5, algo=Algorithm.TOKEN_BUCKET, name="smoke", behavior=0):
        return RateLimitRequest(name=name, unique_key=key, hits=hits, limit=limit,
                                duration=10_000, algorithm=algo, behavior=behavior)

    GL, NB = int(Behavior.GLOBAL), int(Behavior.NO_BATCHING)

    steps = [[req("tok")] for _ in range(6)]  # drained to OVER_LIMIT
    steps.append([req(f"leaky{i}", hits=2, limit=4, algo=Algorithm.LEAKY_BUCKET)
                  for i in range(4)])
    steps.append([req("ok"), req("")])  # empty unique_key
    answers = []
    for svc, clock in svcs:
        got = []
        for reqs in steps:
            got.append(svc.get_rate_limits(GetRateLimitsRequest(requests=reqs)).responses)
            clock.advance(300)
        cols = IngressColumns(
            names=["dup"] * 6, unique_keys=["a", "b", "a", "a", "c", "b"],
            algorithm=np.array([0, 1, 0, 0, 1, 1], np.int32),
            behavior=np.zeros(6, np.int32), hits=np.full(6, 2, np.int64),
            limit=np.full(6, 5, np.int64), duration=np.full(6, 10_000, np.int64))
        r = svc.get_rate_limits_columns(cols)
        got.append([r.response_at(i) for i in range(6)])
        # GLOBAL lanes beside plain ones, through both entry points, with
        # a GLOBAL sync after each step
        for step in range(3):
            reqs = [req(f"g{i % 3}", hits=1 + i % 2, limit=9, behavior=GL if i % 4 else 0,
                        algo=i % 2) for i in range(8)]
            got.append(svc.get_rate_limits(GetRateLimitsRequest(requests=reqs)).responses)
            cols = IngressColumns(
                names=["gc"] * 6, unique_keys=["x", "y", "x", "z", "x", "y"],
                algorithm=np.zeros(6, np.int32),
                behavior=np.array([GL, 0, GL | NB, GL, GL, NB], np.int32),
                hits=np.full(6, 1 + step, np.int64), limit=np.full(6, 8, np.int64),
                duration=np.full(6, 10_000, np.int64))
            r = svc.get_rate_limits_columns(cols)
            got.append([r.response_at(i) for i in range(6)])
            got.append([svc.global_mgr.run_once()]
                       + [c.cpu().numpy().tobytes() for c in svc.store.gcols])
            clock.advance(200)
        svc.close()
        answers.append(got)
    gpu, cpu = answers
    if gpu != cpu:
        raise AssertionError(f"service on the card != service on the CPU:\n{gpu}\n{cpu}")
    assert gpu[5][0].status == Status.OVER_LIMIT, gpu[5]
    assert gpu[7][1].error == "field 'unique_key' cannot be empty", gpu[7]
    assert gpu[8][3].status == Status.OVER_LIMIT, gpu[8]  # third "a" of the batch
    assert gpu[-1][0] is True, "the GLOBAL sync broadcast nothing"
    assert not any(x.error for step in gpu[9:] if not isinstance(step[0], bool)
                   for x in step), gpu[9:]
    log("[service] card == CPU on token drain, leaky, validation, duplicate keys "
        "and GLOBAL lanes with syncs")


# ---------------------------------------------------------------------
# phase 5: the main path at full size
# ---------------------------------------------------------------------
def zipf_ids(rng, n_keys, batch, hot_frac=0.1, hot_traffic=0.8):
    """bench_full.py's Zipf stand-in: 80% of traffic on 10% of keys."""
    hot = rng.randint(0, max(int(n_keys * hot_frac), 1), size=batch)
    cold = rng.randint(0, n_keys, size=batch)
    return np.where(rng.random(batch) < hot_traffic, hot, cold)


def main_traffic():
    """The main path's batches: (name, keys, columns, now, greg)."""
    from gubernator_tpu_torch import native
    from gubernator_tpu_torch.models.shard import GregResolver
    from gubernator_tpu_torch.utils import gregorian

    rng = np.random.RandomState(2)
    batches = []
    for i in range(10):
        ids = zipf_ids(rng, N_KEYS, BATCH)
        keys = native.PackedKeys(*native.pack_keys([f"c2:{k}" for k in ids]))
        cols = dict(
            algorithm=np.ones(BATCH, np.int32),  # LEAKY
            behavior=np.zeros(BATCH, np.int32),  # BATCHING
            hits=np.ones(BATCH, np.int64),
            limit=np.full(BATCH, 1_000_000, np.int64),
            duration=np.full(BATCH, 3_600_000, np.int64),
        )
        batches.append(("warm" if i < 2 else "timed", keys, cols, NOW + 10 * i))
    # The first instant of December 2023: a whole month to the reset,
    # more than an int32 delta of milliseconds, so the wide output.
    now = 1_701_388_800_000
    ids = zipf_ids(rng, N_KEYS, BATCH)
    ge, gd = GregResolver(now).resolve(gregorian.GREGORIAN_MONTHS)
    assert ge - now > (1 << 31) - 1, ge - now
    keys = native.PackedKeys(*native.pack_keys([f"c2m:{k}" for k in ids]))
    batches.append(("monthly", keys, dict(
        algorithm=np.ones(BATCH, np.int32),
        behavior=np.full(BATCH, 4, np.int32),  # DURATION_IS_GREGORIAN
        hits=np.ones(BATCH, np.int64),
        limit=np.full(BATCH, 1_000_000, np.int64),
        duration=np.full(BATCH, gregorian.GREGORIAN_MONTHS, np.int64),
        greg_expire=np.full(BATCH, ge, np.int64),
        greg_duration=np.full(BATCH, gd, np.int64)), now))
    now += 10
    ids = zipf_ids(rng, N_KEYS, BATCH)
    keys = native.PackedKeys(*native.pack_keys([f"c2:{k}" for k in ids]))
    batches.append(("configs", keys, dict(
        algorithm=np.ones(BATCH, np.int32),
        behavior=np.zeros(BATCH, np.int32),
        hits=np.ones(BATCH, np.int64),
        limit=(1_000_000 + ids % 400).astype(np.int64),  # 400 configs: K2
        duration=np.full(BATCH, 3_600_000, np.int64)), now))
    return batches


def drive(store, items):
    """Dispatch `items` through the store with two batches in flight
    (batch i+1 is dispatched before batch i is read back); returns the
    answers and each batch's dispatch-to-answer latency in seconds."""
    answers, lat = [], []
    pending = None

    def finish(p):
        answers.append(p[0].result())
        lat.append(time.perf_counter() - p[1])

    for _, keys, cols, now in items:
        t = time.perf_counter()
        h = store.apply_columns_async(keys, now_ms=now, **cols)
        if pending is not None:
            finish(pending)
        pending = (h, t)
    finish(pending)
    return answers, lat


def main_phase(torch, dev="cuda"):
    from gubernator_tpu_torch.ops import _kernels
    from gubernator_tpu_torch.parallel.mesh import MeshBucketStore

    t0 = time.perf_counter()
    batches = main_traffic()
    log(f"[main] traffic made in {time.perf_counter() - t0:.1f} s: "
        f"{len(batches)} batches of {BATCH} lanes over {N_KEYS} keys")
    store = MeshBucketStore(capacity_per_shard=C_FULL, n_shards=S, device=dev)
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    warm = [b for b in batches if b[0] == "warm"]
    timed = [b for b in batches if b[0] == "timed"]
    extra = [b for b in batches if b[0] not in ("warm", "timed")]
    answers, _ = drive(store, warm)
    t0 = time.perf_counter()
    got, lat = drive(store, timed)
    timed_s = time.perf_counter() - t0
    answers += got
    answers += drive(store, extra)[0]
    launches = {k: _kernels.LAUNCHES[k] for k in ("bucket_rounds_dict", "bucket_rounds_cols")}
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    lats = np.array(lat) * 1e3
    log(f"[main] launches on the main path: {launches}")
    log(f"[main] {len(timed)} timed batches in {timed_s:.3f} s: "
        f"{len(timed) * BATCH / timed_s:.0f} checks/s, batch latency "
        f"p50 {np.percentile(lats, 50):.2f} ms, max {lats.max():.2f} ms of {lats.size}; "
        f"peak device memory {peak / 2**20:.1f} MiB")
    for kname, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {kname} was not launched on the main path")

    # the same traffic through a store on the plain versions
    t0 = time.perf_counter()
    ref = MeshBucketStore(capacity_per_shard=C_FULL, n_shards=S, device="cpu")
    for (name, keys, cols, now), got in zip(batches, answers):
        want = ref.apply_columns(keys, now_ms=now, **cols)
        for f in ("status", "limit", "remaining", "reset_time"):
            if not np.array_equal(np.asarray(got[f]), np.asarray(want[f])):
                raise AssertionError(f"main path batch {name}: {f} differs from the plain store")
    for a, b in ((store.state.hot, ref.state.hot), (store.state.cold, ref.state.cold)):
        if not torch.equal(a.cpu(), b):
            raise AssertionError("main path: final state differs from the plain store")
    over = sum(int((a["status"] == 1).sum()) for a in answers)
    log(f"[main] answers and final state == plain store (CPU) for all {len(batches)} "
        f"batches ({over} OVER_LIMIT lanes), checked in {time.perf_counter() - t0:.1f} s")
    fused_backlog(torch, lambda d: MeshBucketStore(capacity_per_shard=C_FULL, n_shards=S,
                                                   device=d),
                  fuse_items("c2", N_KEYS, 7, lambda ids: np.ones_like(ids)), dev, "main path")
    return store, batches, launches


FUSE_LANES = 16_384  # lanes of a batch in the launch-fusion legs
FUSE_STALL_S = 0.5


def fused_backlog(torch, make_store, items, dev, path):
    """Launch fusion on the card: the first batch's stage step stalls
    while the other batches, one dispatcher thread each, plan, stage and
    wait at the launch gate, so the first launches them with it as one
    group, K launches of K1 back to back on one stream (the JAX
    package's tests/test_dispatch_pipeline.py
    test_launch_fusion_under_backlog).  `items` [(keys, cols, now)] are
    sent twice over; every answer, taken in ticket order, and the final
    state and slot tables must equal a store on the plain versions
    (`make_store("cpu")`) replayed in ticket order.  Returns the launch
    group sizes."""
    from gubernator_tpu_torch.ops import _kernels

    card, ref = make_store(dev), make_store("cpu")
    groups, results, errors = [], {}, []
    real_launch, real_stage = card._launch_group, card._stage_columns
    stall = threading.Event()  # set: the next stage step stalls

    def launch_group(group):
        groups.append(len(group))
        return real_launch(group)

    def stage(prep):
        if stall.is_set():
            stall.clear()
            time.sleep(FUSE_STALL_S)
        return real_stage(prep)

    card._launch_group, card._stage_columns = launch_group, stage
    before = _kernels.LAUNCHES["bucket_rounds_dict"]

    def send(i, keys, cols, now):
        try:
            h = card.apply_columns_async(keys, now_ms=now, **cols)
            results[h.ticket] = (i, now, h.result())
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    for rep in range(2):
        stall.set()
        threads = []
        for i, (keys, cols, now) in enumerate(items):
            threads.append(threading.Thread(target=send, args=(i, keys, cols, now + rep)))
            threads[-1].start()
            time.sleep(0.02)  # they plan in this order
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
    launched = _kernels.LAUNCHES["bucket_rounds_dict"] - before
    for ticket in sorted(results):
        i, now, got = results[ticket]
        keys, cols, _ = items[i]
        same_answers(f"fused batch {ticket}", got, ref.apply_columns(keys, now_ms=now, **cols),
                     path)
    same_stores(torch, "launch fusion", card, ref, path)
    if max(groups) < 2 or sum(groups) != 2 * len(items) or \
            (dev == "cuda" and launched != 2 * len(items)):
        raise AssertionError(f"{path}: launch groups {groups}, K1 launches {launched} for "
                             f"{2 * len(items)} batches: no fused group")
    log(f"[fused] {path}: {2 * len(items)} batches of {FUSE_LANES} lanes, one dispatcher "
        f"thread each, the first stalled {FUSE_STALL_S} s in its stage step: launch groups "
        f"{groups}, {launched} K1 launches; answers in ticket order and final state == plain "
        f"store (CPU)")
    return groups


def fuse_items(prefix, n_keys, seed, algorithm):
    """Four FUSE_LANES-lane Zipf batches of keys `prefix:<id>`, hits 1,
    limit 1,000,000, duration 3,600,000, the algorithm `algorithm(ids)`,
    10 ms apart."""
    rng = np.random.RandomState(seed)
    items = []
    for i in range(4):
        ids = zipf_ids(rng, n_keys, FUSE_LANES)
        items.append((native_keys([f"{prefix}:{k}" for k in ids]), dict(
            algorithm=algorithm(ids).astype(np.int32), behavior=np.zeros(FUSE_LANES, np.int32),
            hits=np.ones(FUSE_LANES, np.int64), limit=np.full(FUSE_LANES, 1_000_000, np.int64),
            duration=np.full(FUSE_LANES, 3_600_000, np.int64)), NOW + 1000 + 10 * i))
    return items


# ---------------------------------------------------------------------
# phase 6: the GLOBAL path at full size
# ---------------------------------------------------------------------
def apply_steps(torch, store, reqs, now, **kw):
    """MeshBucketStore.apply one step at a time with the card synchronized
    between steps: (responses, step seconds, the kernel's inputs)."""
    from gubernator_tpu_torch.models.shard import _readback
    from gubernator_tpu_torch.types import RateLimitResponse

    store._drain_then_lock()
    try:
        t = [time.perf_counter()]
        prep = store._prepare_apply(reqs, now, **kw)
        t.append(time.perf_counter())
        staged = store._stage_answer(prep)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        packed = store._launch_answer(prep, *staged, now)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        packed_np = _readback(packed)()
        t.append(time.perf_counter())
        store._decode_commit_respond(packed_np, prep)
        t.append(time.perf_counter())
    finally:
        store._unlock_drained()
    resps = [r if r is not None else RateLimitResponse() for r in prep.responses]
    return resps, np.diff(t), (prep, staged, packed_np)


def sync_steps(torch, store, now):
    """MeshBucketStore.sync_globals one step at a time (as apply_steps)."""
    from gubernator_tpu_torch.models.shard import _readback

    store._drain_then_lock()
    try:
        t = [time.perf_counter()]
        prep = store._prepare_sync(now)
        t.append(time.perf_counter())
        staged = store._stage_sync(prep)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        packed = store._launch_sync(*staged, now)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        packed_np = _readback(packed)()
        t.append(time.perf_counter())
        res = store._finish_sync(prep, packed_np)
        t.append(time.perf_counter())
    finally:
        store._unlock_drained()
    return res, np.diff(t), (staged, packed_np)


def global_phase(torch, dev="cuda"):
    """bench_full.py config 7 at full size, with config 4's hot-key skew,
    on the card store and on a store on the plain versions (CPU)."""
    from gubernator_tpu_torch.ops import _kernels
    from gubernator_tpu_torch.parallel.global_mgr import GlobalsColumns
    from gubernator_tpu_torch.parallel.mesh import MeshBucketStore, shard_of_key
    from gubernator_tpu_torch.types import Algorithm, Behavior, RateLimitRequest

    t_phase = time.perf_counter()
    card, ref = (MeshBucketStore(capacity_per_shard=C_GLOBAL, n_shards=S, device=d,
                                 g_capacity=G_FULL) for d in (dev, "cpu"))

    def check(what, a, b):
        if a != b:
            raise AssertionError(f"GLOBAL path, {what}: card store != plain store")

    def same_state(what):
        for x, y in ((card.state.hot, ref.state.hot), (card.state.cold, ref.state.cold),
                     *zip(card.gcols, ref.gcols)):
            if not torch.equal(x.cpu(), y):
                raise AssertionError(f"GLOBAL path, {what}: state differs from the plain store")

    def fields(resps):
        return [(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in resps]

    def sync_fields(res):
        out = [res.did_work]
        for cols in (res.broadcast_cols, res.remote_hit_cols):
            out.append(None if cols is None else
                       [np.asarray(getattr(cols, f)).tobytes() for f in vars(cols)])
        return out

    lat = []

    def apply(what, reqs, now, **kw):
        t = time.perf_counter()
        a = card.apply(reqs, now, **kw)
        lat.append(time.perf_counter() - t)
        check(what, fields(a), fields(ref.apply(reqs, now, **kw)))
        same_state(what)
        return a

    def sync(what, now):
        a = card.sync_globals(now)
        check(what, sync_fields(a), sync_fields(ref.sync_globals(now)))
        same_state(what)
        return a

    def c7(lo, hi, hits=1):
        return [RateLimitRequest(name="c7", unique_key=f"g{k}", hits=hits, limit=1_000_000,
                                 duration=3_600_000, algorithm=Algorithm.TOKEN_BUCKET,
                                 behavior=Behavior.GLOBAL) for k in range(lo, hi)]

    _kernels.reset_launch_counts()
    now = NOW
    # ramp: 50,000 GLOBAL keys arriving at rotating shards, then a full sync
    for i, lo in enumerate(range(0, GLOBAL_KEYS, GLOBAL_BATCH)):
        apply(f"ramp batch {i}", c7(lo, min(lo + GLOBAL_BATCH, GLOBAL_KEYS)), now + i,
              home_shard=i % S)
    ramp_lat = np.array(lat) * 1e3
    now += 1000
    res = sync("ramp sync", now)
    ramp_sync_s = card.last_sync_cost_s
    log(f"[global] ramp: {len(ramp_lat)} batches of {GLOBAL_BATCH} lanes, apply latency "
        f"p50 {np.percentile(ramp_lat, 50):.2f} ms, "
        f"max {ramp_lat.max():.2f} ms of {ramp_lat.size}; "
        f"full sync at {len(card.gtable)} active gslots: last_sync_cost_s "
        f"{ramp_sync_s:.4f} s, {res.broadcast_count} broadcasts")

    # skew: 64 hot keys (bench_full.py config 4), a sync after every 4th batch
    rng = np.random.RandomState(4)
    hot = [RateLimitRequest(name="c4", unique_key=f"hot{k}", hits=1, limit=10_000_000,
                            duration=3_600_000, algorithm=Algorithm.TOKEN_BUCKET,
                            behavior=Behavior.GLOBAL) for k in range(HOT_KEYS)]
    sent = np.zeros(HOT_KEYS, np.int64)

    def hot_batch():
        ids = rng.randint(0, HOT_KEYS, size=GLOBAL_BATCH)
        np.add.at(sent, ids, 1)
        return [hot[i] for i in ids]

    now += 1000
    apply("skew warm batch", hot_batch(), now)
    sync("skew warm sync", now)
    lat.clear()
    breakdown = None
    for i in range(8):
        now += 10
        reqs = hot_batch()
        if i == 7:  # one batch step by step, on the card clock
            step_now = now
            t = time.perf_counter()
            a, steps, answer_inputs = apply_steps(torch, card, reqs, now, home_shard=i % S)
            lat.append(time.perf_counter() - t)
            check("skew batch 7", fields(a), fields(ref.apply(reqs, now, home_shard=i % S)))
            same_state("skew batch 7")
            breakdown = steps
        else:
            apply(f"skew batch {i}", reqs, now, home_shard=i % S)
        if i % 4 == 3 and i != 7:
            sync(f"skew sync {i}", now)
    skew_lat = np.array(lat) * 1e3
    res, sync_breakdown, sync_inputs = sync_steps(torch, card, now)
    check("skew final sync", sync_fields(res), sync_fields(ref.sync_globals(now)))
    same_state("skew final sync")
    log(f"[global] skew: 8 batches of {GLOBAL_BATCH} lanes over {HOT_KEYS} hot keys, "
        f"apply latency p50 {np.percentile(skew_lat, 50):.2f} ms; final sync "
        f"{res.broadcast_count} broadcasts")
    log(f"[breakdown] GLOBAL batch, host clock: prepare+plan {breakdown[0] * 1e3:.2f} ms, "
        f"upload {breakdown[1] * 1e3:.2f} ms, kernel+sync {breakdown[2] * 1e3:.3f} ms, "
        f"readback {breakdown[3] * 1e3:.2f} ms, decode+commit {breakdown[4] * 1e3:.2f} ms")
    log(f"[breakdown] GLOBAL sync at {len(card.gtable)} active gslots, host clock: "
        f"resolve+pack {sync_breakdown[0] * 1e3:.2f} ms, upload "
        f"{sync_breakdown[1] * 1e3:.2f} ms, kernel+sync {sync_breakdown[2] * 1e3:.3f} ms, "
        f"readback {sync_breakdown[3] * 1e3:.2f} ms, decode+commit "
        f"{sync_breakdown[4] * 1e3:.2f} ms")

    # replica commit from a peer: more keys than free gslots, so the
    # assignment recycles the least recently used ones (K6, then K5)
    prng = np.random.default_rng(9)
    peer = GlobalsColumns(
        keys=[f"peer_p{k}" for k in range(PEER_KEYS)],
        algorithm=prng.integers(0, 2, PEER_KEYS).astype(np.int32),
        status=prng.integers(0, 2, PEER_KEYS).astype(np.int32),
        limit=np.full(PEER_KEYS, 500, np.int64),
        remaining=prng.integers(0, 500, PEER_KEYS).astype(np.int64),
        reset_time=now + prng.integers(1, 3_600_000, PEER_KEYS))
    held = set(card.gtable._key_to_gslot.values())
    for st in (card, ref):
        st.set_replica_batch(peer, now)
    same_state("replica commit")
    check("replica commit gtable", card.gtable._key_to_gslot, ref.gtable._key_to_gslot)
    # the kernels' inputs of this commit, for the numbers phase
    gsl = np.array([card.gtable._key_to_gslot[k] for k in peer.keys], np.int64)
    upd = np.stack([gsl, peer.status, peer.limit, peer.remaining, peer.reset_time])
    ev = sorted(set(gsl.tolist()) & held)
    idx = np.full(1 << max(3, (len(ev) - 1).bit_length()), G_FULL, np.int64)
    idx[:len(ev)] = ev
    if card.replica_commit_dispatches != 2 or not ev:
        raise AssertionError("the replica commit recycled no gslot")

    # remote owners: the newest ramp keys owned by another daemon
    now += 10
    lo = GLOBAL_KEYS - GLOBAL_BATCH
    apply("remote batch", c7(lo, GLOBAL_KEYS, hits=2), now, remote_global=True)
    res = sync("remote sync", now)
    rh = res.remote_hit_cols
    if rh is None or sorted(rh.hash_key_at(i) for i in range(len(rh))) != sorted(
            f"c7_g{k}" for k in range(lo, GLOBAL_KEYS)) or not (rh.hits == 2).all():
        raise AssertionError("remote owners: the sync's hit totals are wrong")

    # convergence: each hot key's owner holds limit - (all hits sent to it)
    now += 10
    probe = [RateLimitRequest(**{**vars(r), "hits": 0}) for r in hot]
    got = apply("convergence probe", probe, now)
    want = [10_000_000 - int(sent[k]) for k in range(HOT_KEYS)]
    if [r.remaining for r in got] != want:
        raise AssertionError(f"hot keys did not converge: {[r.remaining for r in got]} "
                             f"!= {want}")
    owners = {shard_of_key(f"c4_hot{k}", S) for k in range(HOT_KEYS)}

    churn = global_churn(torch, card, apply, lat, now + 10)
    launches = {k: _kernels.LAUNCHES[k] for k in
                ("global_answer_rounds", "global_sync", "set_replica", "clear_gslots")}
    global_churn_clears(torch, card, churn)
    log(f"[global] launches on the GLOBAL path: {launches}")
    for kname, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {kname} was not launched on the GLOBAL path")
    log(f"[global] answers, sync results, state and replica columns == plain store (CPU) "
        f"at every step; {HOT_KEYS} hot keys (owners on {len(owners)} shards) converged "
        f"exactly to limit - {int(sent.sum())} hits; {len(rh)} remote-owner totals "
        f"exact; phase took {time.perf_counter() - t_phase:.1f} s")
    summary = dict(apply_p50_ms=float(np.percentile(np.concatenate([ramp_lat, skew_lat]), 50)),
                   last_sync_cost_s=ramp_sync_s, now=step_now)
    return card, launches, (answer_inputs, sync_inputs, (upd.astype(np.int64), idx)), summary


def global_churn(torch, card, apply, lat, now):
    """The GLOBAL churn batch: one batch of GLOBAL_BATCH keys never seen
    before into the full gslot table (the replica commit filled it), so
    every lane recycles a gslot, and the store clears them all with one
    K6 launch; then the same keys again, which recycle nothing.  `apply`
    checks both against the plain store.  Returns what
    global_churn_clears needs."""
    from gubernator_tpu_torch.ops import _kernels
    from gubernator_tpu_torch.types import Algorithm, Behavior, RateLimitRequest

    if card.gtable._free:
        raise AssertionError("GLOBAL churn: the gslot table is not full")
    reqs = [RateLimitRequest(name="churn", unique_key=f"n{k}", hits=1, limit=1_000,
                             duration=60_000, algorithm=Algorithm(k % 2),
                             behavior=Behavior.GLOBAL) for k in range(GLOBAL_BATCH)]
    gcols_before = [c.clone() for c in card.gcols]
    k6 = _kernels.LAUNCHES["clear_gslots"]
    apply("GLOBAL churn batch", reqs, now, home_shard=1)
    churn_ms, churn_k6 = lat[-1] * 1e3, _kernels.LAUNCHES["clear_gslots"] - k6
    # in a full table lane i's key takes the gslot it recycled
    ev = [card.gtable._key_to_gslot[r.hash_key()] for r in reqs]
    if churn_k6 != 1 or len(set(ev)) != GLOBAL_BATCH:
        raise AssertionError(f"GLOBAL churn: {len(set(ev))} gslots recycled with {churn_k6} "
                             f"K6 launches, not {GLOBAL_BATCH} with 1")
    k6 = _kernels.LAUNCHES["clear_gslots"]
    apply("GLOBAL churn batch again", reqs, now + 1, home_shard=1)
    again_ms = lat[-1] * 1e3
    if _kernels.LAUNCHES["clear_gslots"] != k6:
        raise AssertionError("GLOBAL churn: a batch that recycles nothing launched K6")
    return gcols_before, ev, churn_ms, again_ms


def global_churn_clears(torch, card, churn):
    """The churn batch's clear both ways on copies of the replica
    columns as the batch found them: one K6 call for the batch's sorted
    list (the stores' way) and one clear_gslots call per recycling lane
    (the JAX store's way); both must leave the same columns.  The
    launches here are comparisons and happen after the path's counts
    are read."""
    from gubernator_tpu_torch.ops import global_ops

    gcols_before, ev, churn_ms, again_ms = churn
    one, per_lane = (global_ops.GlobalColumns(*[c.clone() for c in gcols_before])
                     for _ in range(2))
    idx = np.full(1 << max(3, (len(ev) - 1).bit_length()), card.g_capacity, np.int64)
    idx[:len(ev)] = sorted(ev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    global_ops.clear_gslots(one, idx)
    torch.cuda.synchronize()
    t_one = time.perf_counter()
    for g in ev:
        global_ops.clear_gslots(per_lane, [g])
    torch.cuda.synchronize()
    t_lanes = time.perf_counter()
    if any(not torch.equal(a, b) for a, b in zip(one, per_lane)):
        raise AssertionError("GLOBAL churn: one clear != a clear per lane")
    log(f"[numbers] GLOBAL churn batch: {len(ev)} lanes of new GLOBAL keys into a full "
        f"table of {card.g_capacity} gslots, {len(set(ev))} gslots recycled, K6 launches 1; "
        f"apply {churn_ms:.2f} ms (the same keys again, nothing recycled: {again_ms:.2f} ms); "
        f"its clear, host clock to a synchronize: one call (K={idx.size}) "
        f"{(t_one - t) * 1e3:.3f} ms; the old way, one clear_gslots a lane, {len(ev)} "
        f"launches, {(t_lanes - t_one) * 1e3:.2f} ms; columns identical")


# ---------------------------------------------------------------------
# phase 7: the persistence path at full size
# ---------------------------------------------------------------------
def snapshot_traffic(rng):
    """1,000,000 snapshot lanes of the main path's deployment: keys as
    its traffic names them, leaky, limit 1,000,000 per 3,600,000 ms,
    seeded remaining and stamp, 5% already expired, 1% duplicate keys."""
    from gubernator_tpu_torch.reshard import TransferColumns

    n = N_KEYS
    ids = np.arange(n)
    dup = rng.random(n) < 0.01
    ids[dup] = rng.integers(0, n, int(dup.sum()))
    stamp = NOW - rng.integers(0, 3_600_000, n)
    expire = stamp + 3_600_000
    dead = rng.random(n) < 0.05
    expire[dead] = NOW - 1 - rng.integers(0, 3_600_000, int(dead.sum()))
    return TransferColumns(
        keys=[f"c2_{k}" for k in ids], algorithm=np.ones(n, np.int32),
        status=np.zeros(n, np.int32), limit=np.full(n, 1_000_000, np.int64),
        remaining=rng.integers(0, (1_000_000 << 20) + 1, n),
        duration=np.full(n, 3_600_000, np.int64), stamp=stamp, expire_at=expire)


def ingress(names, ids, algorithm=None, behavior=None, limit=1_000_000):
    """IngressColumns of one batch: unique keys str(id)."""
    from gubernator_tpu_torch.service import IngressColumns

    n = len(ids)
    return IngressColumns(
        names=[names] * n, unique_keys=[str(k) for k in ids],
        algorithm=np.ones(n, np.int32) if algorithm is None else algorithm,
        behavior=np.zeros(n, np.int32) if behavior is None else behavior,
        hits=np.ones(n, np.int64), limit=np.full(n, limit, np.int64),
        duration=np.full(n, 3_600_000, np.int64))


def result_bytes(res):
    """A ColumnarResult as comparable bytes."""
    return ([a.tobytes() for a in (res.status, res.limit, res.remaining, res.reset_time)]
            + sorted((i, r.error, r.status, r.remaining) for i, r in res.overrides.items()))


def same_stores(torch, what, a, b, path="persistence path"):
    """State, algo_mirror and slot tables (keys in order, slots,
    expiries) of two port stores (MeshBucketStores or ShardStores)
    identical."""
    for x, y in ((a.state.hot, b.state.hot), (a.state.cold, b.state.cold)):
        if not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"{path}, {what}: state differs from the plain store")
    if a.algo_mirror.tobytes() != b.algo_mirror.tobytes():
        raise AssertionError(f"{path}, {what}: algo_mirror differs")
    every = np.arange(a.state.hot.shape[1], dtype=np.int32)
    def tables(st):
        return st.tables if hasattr(st, "tables") else [st.table]

    for ta, tb in zip(tables(a), tables(b)):
        (ka, sa), (kb, sb) = ta.entries(), tb.entries()
        if ka != kb or sa.tobytes() != sb.tobytes() or \
                ta.get_expire_bulk(every).tobytes() != tb.get_expire_bulk(every).tobytes():
            raise AssertionError(f"{path}, {what}: slot tables differ")


def preloaded_store(pre_algo):
    """A MockStore holding len(pre_algo) items `st_<i>` (leaky where
    pre_algo[i], else token) of limit 100 an hour, half used."""
    from gubernator_tpu_torch import store as spi

    st = spi.MockStore()
    for i, leaky in enumerate(pre_algo.tolist()):
        v = (spi.LeakyBucketItem(limit=100, duration=3_600_000, remaining=50.5,
                                 updated_at=NOW - i) if leaky else
             spi.TokenBucketItem(limit=100, duration=3_600_000, remaining=50,
                                 created_at=NOW - i))
        st.cache_items[f"st_{i}"] = spi.CacheItem(
            algorithm=int(leaky), key=f"st_{i}", value=v, expire_at=NOW + 3_600_000)
    return st


def item_tuples(st):
    """A MockStore's items as comparable tuples."""
    return {k: (it.algorithm, it.expire_at, type(it.value).__name__,
                tuple(vars(it.value).values())) for k, it in st.cache_items.items()}


class RowCalls:
    """Keeps the tensors of the last row gather and row scatter a card
    store makes (the numbers phase times the kernels on them)."""

    def __init__(self):
        from gubernator_tpu_torch.ops import buckets

        self.buckets, self.real = buckets, (buckets.gather_rows, buckets.write_rows)
        self.gather = self.write = None

    def __enter__(self):
        real_g, real_w = self.real

        def gather(hot, cold, lanes):
            if hot.device.type == "cuda":
                self.gather = (hot, cold, lanes)
            return real_g(hot, cold, lanes)

        def write(hot, cold, lanes, c32, c64):
            if hot.device.type == "cuda":
                self.write = (hot, cold, lanes, c32, c64)
            return real_w(hot, cold, lanes, c32, c64)

        self.buckets.gather_rows, self.buckets.write_rows = gather, write
        return self

    def __exit__(self, *exc):
        self.buckets.gather_rows, self.buckets.write_rows = self.real
        return False


class StepTimes:
    """Host-clock seconds spent in named functions while active, the card
    synchronized before and after each call so that its work lands in
    the step that launched it.  `targets` are (label, module or class,
    attribute name)."""

    def __init__(self, torch, targets):
        self.torch, self.targets = torch, targets
        self.seconds = dict.fromkeys((label for label, _, _ in targets), 0.0)

    def __enter__(self):
        self.saved = [(owner, attr, getattr(owner, attr)) for _, owner, attr in self.targets]
        for (label, owner, attr), (_, _, real) in zip(self.targets, self.saved):
            setattr(owner, attr, self._timed(label, real))
        return self

    def _timed(self, label, real):
        sync = self.torch.cuda.synchronize

        def timed(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                sync()
                self.seconds[label] += time.perf_counter() - t0

        return timed

    def __exit__(self, *exc):
        for owner, attr, real in self.saved:
            setattr(owner, attr, real)
        return False

    def line(self, total):
        parts = ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in self.seconds.items())
        return f"{parts}; total {total * 1e3:.1f} ms"


def persist_phase(torch, dev="cuda"):
    """The persistence path at the main path's deployment size (BASELINE
    configs[1]: S = 8 x 262,144 slots), on the card and on the plain
    versions (CPU) side by side: a 1,000,000-lane snapshot restored,
    traffic, a dump, a restore into a store with traffic of its own, a
    Loader of 50,000 items and a Store SPI over a 50,000-key cache."""
    import tempfile

    from gubernator_tpu_torch import native, snapshot
    from gubernator_tpu_torch import store as spi
    from gubernator_tpu_torch.models import shard
    from gubernator_tpu_torch.ops import _kernels, buckets
    from gubernator_tpu_torch.parallel.mesh import MeshBucketStore
    from gubernator_tpu_torch.config import BehaviorConfig
    from gubernator_tpu_torch.service import ServiceConfig, V1Service
    from gubernator_tpu_torch.utils.clock import Clock

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    devs = {"card": dev, "cpu": "cpu"}  # side -> device

    def service(d, cache, **kw):
        clock = Clock()
        clock.freeze(NOW)
        return V1Service(ServiceConfig(cache_size=cache, clock=clock, device=d,
                                       behaviors=BehaviorConfig(global_sync_wait_s=3600.0,
                                                                snapshot_interval_s=0.0),
                                       **kw))

    def counts():
        return {k: _kernels.LAUNCHES[k] for k in
                ("gather_rows", "write_rows", "global_answer_rounds")}

    def delta(before):
        return {k: v - before[k] for k, v in counts().items()}

    _kernels.reset_launch_counts()
    rng = np.random.default_rng(7)
    # (a) the file
    cols = snapshot_traffic(rng)
    path = f"{tmp.name}/boot.snap"
    t0 = time.perf_counter()
    file_bytes = snapshot.write_snapshot(path, cols, NOW - 1000)
    write_s = time.perf_counter() - t0
    # (b) boot restore on the card and on the CPU
    paths = {d: f"{tmp.name}/{d}.snap" for d in devs}
    svcs, restore_launches = {}, None
    rows = RowCalls()
    restore_steps = StepTimes(torch, [
        ("file read+decode", snapshot, "read_snapshot"),
        ("slot assignment (C++)", native, "mesh_lookup_or_assign"),
        ("row gather (upload, K7, readback)", MeshBucketStore, "_read_rows"),
        ("of which K7", buckets, "gather_rows"),
        ("merge", shard, "merge_transfer_rows"),
        ("row scatter (upload, K8)", MeshBucketStore, "_write_rows"),
        ("of which K8", buckets, "write_rows"),
        ("table expiry (C++)", native, "mesh_set_expire"),
    ])
    for d in devs:
        with open(path, "rb") as f, open(paths[d], "wb") as g:
            g.write(f.read())
        before = counts()
        if d == "card":
            with rows, restore_steps:
                svcs[d] = service(devs[d], S * C_FULL, snapshot_path=paths[d])
            restore_launches = delta(before)
        else:
            svcs[d] = service(devs[d], S * C_FULL, snapshot_path=paths[d])
        if svcs[d].snapshots.restore_result != "ok":
            raise AssertionError(f"persistence path: restore on {d} did not succeed")
    card, cpu = svcs["card"], svcs["cpu"]
    restored = card.snapshots.restored_lanes
    same_stores(torch, "boot restore", card.store, cpu.store)
    if restore_launches["gather_rows"] != 1 or restore_launches["write_rows"] != 1:
        raise AssertionError(f"persistence path: restore launched {restore_launches}")
    log(f"[persist] restore of {len(cols)} lanes ({restored} committed, {file_bytes} bytes): "
        f"last_restore_seconds card {card.snapshots.last_restore_seconds:.3f} s, CPU "
        f"{cpu.snapshots.last_restore_seconds:.3f} s; K7/K8 launches {restore_launches}")
    log(f"[breakdown] restore on the card, host clock: "
        f"{restore_steps.line(card.snapshots.last_restore_seconds)} (the rest: key dedup, "
        f"algo_mirror)")
    # (c) main-path batches over the restored keys
    zrng = np.random.RandomState(3)
    for i in range(4):
        batch = ingress("c2", zipf_ids(zrng, N_KEYS, BATCH))
        got = [svcs[d].get_rate_limits_columns(batch, max_lanes=BATCH) for d in devs]
        if result_bytes(got[0]) != result_bytes(got[1]):
            raise AssertionError(f"persistence path: batch {i} after the restore differs")
        for d in devs:
            svcs[d].clock.advance(10)
    same_stores(torch, "traffic after the restore", card.store, cpu.store)
    # (d) dump on both: byte-identical files
    dump_steps = StepTimes(torch, [
        ("snapshot_columns", MeshBucketStore, "snapshot_columns"),
        ("of which slot lookup (C++)", native, "mesh_get_slots"),
        ("of which row gather (upload, K7, readback)", MeshBucketStore, "_read_rows"),
        ("of which K7", buckets, "gather_rows"),
        ("write_snapshot", snapshot, "write_snapshot"),
        ("of which encode", snapshot, "encode_snapshot"),
    ])
    for d in devs:
        before = counts()
        if d == "card":
            with dump_steps:
                saved_ok = svcs[d].snapshots.save_now("smoke")
            dump_launches = delta(before)
        else:
            saved_ok = svcs[d].snapshots.save_now("smoke")
        if not saved_ok:
            raise AssertionError(f"persistence path: save on {d} failed")
    raw = {d: open(paths[d], "rb").read() for d in devs}
    if raw["card"] != raw["cpu"]:
        raise AssertionError("persistence path: the card's snapshot != the CPU's")
    if dump_launches["gather_rows"] != 1 or dump_launches["write_rows"]:
        raise AssertionError(f"persistence path: dump launched {dump_launches}")
    log(f"[persist] dump: {len(raw['card'])} bytes, card == CPU byte for byte; save seconds "
        f"card {card.snapshots.last_save_seconds:.3f}, CPU {cpu.snapshots.last_save_seconds:.3f};"
        f" K7 launches {dump_launches['gather_rows']}")
    log(f"[breakdown] dump on the card, host clock: "
        f"{dump_steps.line(card.snapshots.last_save_seconds)} (snapshot_columns' rest: key "
        f"enumeration, columns; write_snapshot's rest: file write, fsync, rename)")
    # (e) that file into stores that took traffic of their own: the
    # merge's live branch
    dumped, _ = snapshot.read_snapshot(paths["card"])
    third = {d: MeshBucketStore(capacity_per_shard=C_FULL, n_shards=S, device=devs[d])
             for d in devs}
    trng = np.random.RandomState(5)
    for i in range(2):
        ids = zipf_ids(trng, N_KEYS, BATCH)
        keys = [f"c2_{k}" for k in ids]
        got = [third[d].apply_columns(keys, np.ones(BATCH, np.int32),
                                      np.zeros(BATCH, np.int32), np.full(BATCH, 3, np.int64),
                                      np.full(BATCH, 1_000_000, np.int64),
                                      np.full(BATCH, 3_600_000, np.int64), NOW + 100 + i)
               for d in devs]
        if any(not np.array_equal(got[0][f], got[1][f]) for f in got[0]):
            raise AssertionError(f"persistence path: third store batch {i} differs")
    resident = int((native.mesh_get_slots(third["card"].tables, dumped.keys)[1] >= 0).sum())
    before = counts()
    t0 = time.perf_counter()
    merged = third["card"].commit_transfer(dumped, NOW + 200)
    merge_s = time.perf_counter() - t0
    merge_launches = delta(before)
    if third["cpu"].commit_transfer(dumped, NOW + 200) != merged:
        raise AssertionError("persistence path: merge-restore counts differ")
    same_stores(torch, "restore into a live store", third["card"], third["cpu"])
    if merge_launches["gather_rows"] != 1 or merge_launches["write_rows"] != 1:
        raise AssertionError(f"persistence path: merge-restore launched {merge_launches}")
    log(f"[persist] restore into a store with traffic: {merged} lanes, {resident} met a "
        f"resident row, {merge_s:.3f} s on the card store; card == CPU")
    # (f) Loader: 50,000 mixed items at boot, 2 batches, close()
    lrng = np.random.default_rng(11)
    n_items = 50_000
    algo = lrng.integers(0, 2, n_items)
    rem = lrng.integers(0, 1001, n_items)
    frac = lrng.integers(0, 1 << 20, n_items) / (1 << 20)
    stamp = NOW - lrng.integers(0, 3_600_000, n_items)
    expire = NOW + lrng.integers(-60_000, 3_600_000, n_items)

    def items(mod):
        out = []
        for i in range(n_items):
            if algo[i]:
                v = mod.LeakyBucketItem(limit=1000, duration=3_600_000,
                                        remaining=float(rem[i] + frac[i]),
                                        updated_at=int(stamp[i]))
            else:
                v = mod.TokenBucketItem(limit=1000, duration=3_600_000, remaining=int(rem[i]),
                                        created_at=int(stamp[i]), status=int(rem[i] == 0))
            out.append(mod.CacheItem(algorithm=int(algo[i]), key=f"ld_{i}", value=v,
                                     expire_at=int(expire[i])))
        return out

    loaders, lsvcs = {}, {}
    for d in devs:
        loaders[d] = spi.MockLoader()
        loaders[d].cache_items = items(spi)
        lsvcs[d] = service(devs[d], S * C_FULL, loader=loaders[d])
    same_stores(torch, "loader boot", lsvcs["card"].store, lsvcs["cpu"].store)
    brng = np.random.RandomState(13)
    for i in range(2):
        ids = zipf_ids(brng, n_items, BATCH)
        batch = ingress("ld", ids, algorithm=algo[ids].astype(np.int32), limit=1000)
        got = [lsvcs[d].get_rate_limits_columns(batch, max_lanes=BATCH) for d in devs]
        if result_bytes(got[0]) != result_bytes(got[1]):
            raise AssertionError(f"persistence path: loader batch {i} differs")
    for d in devs:
        lsvcs[d].close()
    saved = [loaders[d].cache_items[n_items:] for d in devs]
    if saved[0] != saved[1] or len(saved[0]) < n_items * 0.9:
        raise AssertionError("persistence path: the loaders saved different items")
    log(f"[persist] loader: {n_items} items loaded, 2 batches, {len(saved[0])} items saved; "
        f"card == CPU")
    # (g) Store SPI: a dict-backed store over a 50,000-key cache
    srng = np.random.default_rng(17)
    n_pre, n_keys, cache, lanes = 25_000, 40_000, 50_000, 2_048
    pre_algo = srng.integers(0, 2, n_pre)
    stores, ssvcs = {}, {}
    for d in devs:
        stores[d] = preloaded_store(pre_algo)
        ssvcs[d] = service(devs[d], cache, persist_store=stores[d])
    spi_launches = dict.fromkeys(counts(), 0)
    spi_s = {d: 0.0 for d in devs}
    for i in range(8):
        ids = srng.integers(0, n_keys, lanes)
        algos = np.where(ids < n_pre, pre_algo[np.minimum(ids, n_pre - 1)], ids % 2)
        switch = srng.random(lanes) < 0.05
        batch = ingress("st", ids, algorithm=np.where(switch, 1 - algos, algos).astype(np.int32),
                        behavior=np.where(srng.random(lanes) < 0.02, 8, 0).astype(np.int32),
                        limit=100)
        got = []
        for d in devs:
            before = counts()
            t1 = time.perf_counter()
            got.append(ssvcs[d].get_rate_limits_columns(batch, max_lanes=lanes))
            spi_s[d] += time.perf_counter() - t1
            if d == "card":
                for k, v in delta(before).items():
                    spi_launches[k] += v
        if result_bytes(got[0]) != result_bytes(got[1]):
            raise AssertionError(f"persistence path: Store SPI batch {i} differs")
        for d in devs:
            ssvcs[d].clock.advance(10)

    if stores["card"].called != stores["cpu"].called or \
            item_tuples(stores["card"]) != item_tuples(stores["cpu"]):
        raise AssertionError("persistence path: the Store SPI's calls or items differ")
    same_stores(torch, "Store SPI", ssvcs["card"].store, ssvcs["cpu"].store)
    log(f"[persist] Store SPI: 8 batches of {lanes} lanes, calls {stores['card'].called}, "
        f"{len(stores['card'].cache_items)} items; card == CPU; launches {spi_launches} "
        f"(write_rows = single-lane injects); batch seconds card {spi_s['card'] / 8:.3f}, "
        f"CPU {spi_s['cpu'] / 8:.3f}")
    for st in (ssvcs["card"], ssvcs["cpu"], cpu, card):
        st.close()
    launches = counts()
    log(f"[persist] launches on the persistence path: {launches}")
    for kname, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {kname} was not launched on the persistence path")
    log(f"[persist] lanes {len(cols)}, file bytes {file_bytes}, write {write_s:.3f} s, "
        f"restore {card.snapshots.last_restore_seconds:.3f} s, save "
        f"{card.snapshots.last_save_seconds:.3f} s, K8 single-lane launches "
        f"{spi_launches['write_rows']}; phase took {time.perf_counter() - t_phase:.1f} s")
    tmp.cleanup()
    return rows, {"gather_rows": launches["gather_rows"], "write_rows": launches["write_rows"]}


# ---------------------------------------------------------------------
# phase 9: the two-tier path at full size
# ---------------------------------------------------------------------
def two_tier_traffic():
    """bench_full.py config 3b: one Zipf batch of the 10M keyspace (seed
    3) replayed over TT_WINDOWS key windows offset by 2,500,000 ids,
    mixed token and leaky buckets (key_id % 2) with daily and monthly
    Gregorian durations; TT_WARM + TT_TIMED batches rotating over the
    windows.  Returns the items for drive()."""
    from gubernator_tpu_torch import native
    from gubernator_tpu_torch.models.shard import GregResolver
    from gubernator_tpu_torch.utils import gregorian

    rng = np.random.RandomState(3)
    key_ids = zipf_ids(rng, TT_KEYS, BATCH)
    greg = GregResolver(TT_NOW)
    ge_d, gd_d = greg.resolve(gregorian.GREGORIAN_DAYS)
    ge_m, gd_m = greg.resolve(gregorian.GREGORIAN_MONTHS)
    assert ge_m - TT_NOW > (1 << 31) - 1, ge_m - TT_NOW  # the wide output
    monthly = (key_ids % 2).astype(bool)
    cols = dict(
        algorithm=(key_ids % 2).astype(np.int32),
        behavior=np.full(BATCH, 4, np.int32),  # DURATION_IS_GREGORIAN
        hits=np.ones(BATCH, np.int64),
        limit=np.full(BATCH, 1_000_000, np.int64),
        duration=np.where(monthly, gregorian.GREGORIAN_MONTHS,
                          gregorian.GREGORIAN_DAYS).astype(np.int64),
        greg_expire=np.where(monthly, ge_m, ge_d).astype(np.int64),
        greg_duration=np.where(monthly, gd_m, gd_d).astype(np.int64),
    )
    windows = []
    for w in range(TT_WINDOWS):
        ids = (key_ids + w * (TT_KEYS // TT_WINDOWS)) % TT_KEYS
        windows.append(native.PackedKeys(*native.pack_keys([f"c3:{k}" for k in ids])))
    return [("warm" if i < TT_WARM else "timed", windows[i % TT_WINDOWS], cols, TT_NOW + i)
            for i in range(TT_WARM + TT_TIMED)], len(np.unique(key_ids))


def two_tier_requests(lo, hi, home):
    """A 2,048-lane dataclass batch: GLOBAL token buckets over keys
    lo..hi (each twice) and plain leaky lanes over their own keys."""
    from gubernator_tpu_torch.types import Algorithm, Behavior, RateLimitRequest

    reqs = [RateLimitRequest(name="c3g", unique_key=f"g{lo + i // 2}", hits=1 + i % 2,
                             limit=1_000, duration=60_000, algorithm=Algorithm.TOKEN_BUCKET,
                             behavior=Behavior.GLOBAL) for i in range(2 * (hi - lo))]
    reqs += [RateLimitRequest(name="c3p", unique_key=f"p{(home * 7919 + i) % 5000}", hits=1,
                              limit=1_000, duration=60_000, algorithm=Algorithm.LEAKY_BUCKET)
             for i in range(GLOBAL_BATCH - len(reqs))]
    return reqs


class MoveCalls:
    """Keeps the records of the largest tier-move window and the lanes of
    the last back-tier gather a card store makes (the numbers phase
    times K9 and K7 on them)."""

    def __init__(self):
        from gubernator_tpu_torch.ops import buckets

        self.buckets, self.real = buckets, (buckets.apply_moves, buckets.read_back_rows)
        self.records = self.back_lanes = None

    def __enter__(self):
        real_m, real_b = self.real

        def moves(state, back, records):
            if state.hot.device.type == "cuda" and (
                    self.records is None or records.shape[1] > self.records.shape[1]):
                self.records = records
            return real_m(state, back, records)

        def back_rows(back, lanes):
            if back.hot.device.type == "cuda":
                self.back_lanes = lanes
            return real_b(back, lanes)

        self.buckets.apply_moves, self.buckets.read_back_rows = moves, back_rows
        return self

    def __exit__(self, *exc):
        self.buckets.apply_moves, self.buckets.read_back_rows = self.real
        return False


def two_tier_phase(torch, dev="cuda"):
    """bench_full.py config 3b on the card store and on a store on the
    plain versions (CPU), side by side: 2,048 dataclass lanes with
    GLOBAL keys, TT_WARM + TT_TIMED columnar batches two in flight that
    demote the window before last and promote their own, a dataclass
    batch and a GLOBAL sync that promote the demoted GLOBAL keys, and
    snapshot_items with the back rows."""
    from gubernator_tpu_torch.ops import _kernels
    from gubernator_tpu_torch.parallel.mesh import MeshBucketStore, shard_of_key

    t_phase = time.perf_counter()
    items, uniq = two_tier_traffic()
    log(f"[two-tier] traffic made in {time.perf_counter() - t_phase:.1f} s: "
        f"{len(items)} batches of {BATCH} lanes, {uniq} distinct keys a window, "
        f"{TT_WINDOWS} windows of a {TT_KEYS}-key space")
    base = 0
    if dev == "cuda":
        gc.collect()  # free what the earlier phases left unreachable
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()  # the earlier phases' stores
    card, ref = (MeshBucketStore(capacity_per_shard=TT_FRONT, n_shards=S, device=d,
                                 back_capacity_per_shard=TT_BACK) for d in (dev, "cpu"))

    def fields(resps):
        return [(r.status, r.limit, r.remaining, r.reset_time, r.error) for r in resps]

    def sync_fields(res):
        out = [res.did_work]
        for cols in (res.broadcast_cols, res.remote_hit_cols):
            out.append(None if cols is None else
                       [np.asarray(getattr(cols, f)).tobytes() for f in vars(cols)])
        return out

    def check(what, a, b):
        if a != b:
            bad = [i for i, (x, y) in enumerate(zip(a, b)) if x != y][:5]
            raise AssertionError(f"two-tier path, {what}: card store != plain store "
                                 f"(first lanes {[(i, a[i], b[i]) for i in bad]})")

    def item_fields(its):
        return [(i.key, int(i.algorithm), i.expire_at, tuple(vars(i.value).values()))
                for i in its]

    _kernels.reset_launch_counts()
    with MoveCalls() as calls:
        # GLOBAL owners apply first, so their rows are the oldest in the fronts
        first = card.apply(two_tier_requests(0, 256, 0), TT_NOW - 10)
        warm = [b for b in items if b[0] == "warm"]
        timed = [b for b in items if b[0] == "timed"]
        answers, _ = drive(card, warm)
        t0 = time.perf_counter()
        got, lat = drive(card, timed)
        timed_s = time.perf_counter() - t0
        answers += got
        stats_churn = [t.tier_stats for t in card.tables]
        demoted_g = sum(card.tables[shard_of_key(k, S)].get_slot(k) is None
                        for k in (f"c3g_g{i}" for i in range(256)))
        # the same GLOBAL keys again, at shard 0, then a sync: the owners'
        # demoted rows come back through the planner and the sync
        reqs = two_tier_requests(128, 384, 1)
        t0 = time.perf_counter()
        resp = card.apply(reqs, TT_NOW + 1000, home_shard=0)
        apply_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        res = card.sync_globals(TT_NOW + 1001)
        sync_ms = (time.perf_counter() - t0) * 1e3
        card_items = card.snapshot_items()
    launches = {k: _kernels.LAUNCHES[k] for k in (
        "bucket_rounds_dict", "apply_moves", "gather_back_rows", "gather_rows",
        "global_answer_rounds", "global_sync")}
    peak = torch.cuda.max_memory_allocated() - base if dev == "cuda" else 0
    stats = [t.tier_stats for t in card.tables]
    starved = sum(t.starved_evictions for t in card.tables)
    lats = np.array(lat) * 1e3
    log(f"[two-tier] launches: {launches}; tier-move launches {card.move_dispatches}")
    log(f"[two-tier] {len(timed)} timed batches in {timed_s:.3f} s: "
        f"{len(timed) * BATCH / timed_s:.0f} checks/s, batch latency "
        f"p50 {np.percentile(lats, 50):.2f} ms, max {lats.max():.2f} ms of {lats.size}; "
        f"peak device memory {peak / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB "
        f"the earlier phases hold")
    log(f"[two-tier] after the churn: demotions {sum(s[2] for s in stats_churn)}, "
        f"promotions {sum(s[3] for s in stats_churn)}; at the end: keys "
        f"{sum(s[0] for s in stats)} ({sum(s[1] for s in stats)} in the back tiers), "
        f"demotions {sum(s[2] for s in stats)}, promotions {sum(s[3] for s in stats)}, "
        f"back evictions {sum(s[4] for s in stats)}, starved evictions {starved}; "
        f"GLOBAL keys out of their owners' fronts before the second GLOBAL batch "
        f"{demoted_g} of 256")
    log(f"[two-tier] GLOBAL batch {apply_ms:.2f} ms, sync {sync_ms:.2f} ms "
        f"({res.broadcast_count} broadcasts); snapshot_items {len(card_items)} items")
    for kname in ("bucket_rounds_dict", "apply_moves", "gather_back_rows"):
        if launches[kname] <= 0:
            raise AssertionError(f"kernel {kname} was not launched on the two-tier path")
    # at least a whole window demoted and promoted (125,505 keys at full size)
    if min(sum(s[2] for s in stats_churn), sum(s[3] for s in stats_churn)) < uniq:
        raise AssertionError(f"two-tier path: too little churn {stats_churn}")

    # the same calls on the store on the plain versions
    t0 = time.perf_counter()
    check("first dataclass batch", fields(first),
          fields(ref.apply(two_tier_requests(0, 256, 0), TT_NOW - 10)))
    want, _ = drive(ref, warm)
    want += drive(ref, timed)[0]
    for (name, _, _, now), a, b in zip(items, answers, want):
        for f in ("status", "limit", "remaining", "reset_time"):
            if not np.array_equal(np.asarray(a[f]), np.asarray(b[f])):
                raise AssertionError(f"two-tier batch at {now}: {f} differs from the plain store")
    reqs = two_tier_requests(128, 384, 1)
    check("second dataclass batch", fields(resp),
          fields(ref.apply(reqs, TT_NOW + 1000, home_shard=0)))
    check("sync", sync_fields(res), sync_fields(ref.sync_globals(TT_NOW + 1001)))
    check("snapshot_items", item_fields(card_items), item_fields(ref.snapshot_items()))
    for x, y in ((card.state.hot, ref.state.hot), (card.state.cold, ref.state.cold),
                 (card.back.hot, ref.back.hot), (card.back.cold, ref.back.cold)):
        if not torch.equal(x.cpu(), y):
            raise AssertionError("two-tier path: front or back state differs from the plain store")
    for ct, rt in zip(card.tables, ref.tables):
        (ck, cs), (rk, rs) = ct.entries(), rt.entries()
        cb, rb = ct.back_entries(), rt.back_entries()
        if (ct.tier_stats != rt.tier_stats or ck != rk or cs.tobytes() != rs.tobytes()
                or cb[0] != rb[0] or any(a.tobytes() != b.tobytes()
                                         for a, b in zip(cb[1:], rb[1:]))
                or ct.starved_evictions != rt.starved_evictions):
            raise AssertionError("two-tier path: slot tables differ from the plain store")
    card.check_consistency()
    log(f"[two-tier] answers, front and back state, tier stats, tables, back tables, "
        f"sync and {len(card_items)} items == plain store (CPU), checked in "
        f"{time.perf_counter() - t0:.1f} s; phase took {time.perf_counter() - t_phase:.1f} s")
    return card, items, launches, calls


def two_tier_breakdown(torch, card, items):
    """One more two-tier batch on the card store, step by step on the
    host clock (plan, tier moves, pack+upload, K1, readback, commit),
    and the same batch's K1 on a single-tier store of 262,144 slots a
    shard that took the same windows: the K1 inputs of both for the
    numbers phase."""
    from gubernator_tpu_torch.models.shard import make_columns
    from gubernator_tpu_torch.parallel.mesh import MeshBucketStore

    _, keys, cols, now = items[TT_WARM]
    c = make_columns(cols["algorithm"], cols["behavior"], cols["hits"], cols["limit"],
                     cols["duration"], len(keys), cols["greg_expire"], cols["greg_duration"])
    now += 10_000
    out = {}
    single = MeshBucketStore(capacity_per_shard=TT_FRONT * S, n_shards=S, device=card.device)
    drive(single, items[:TT_WINDOWS + 1])
    for label, store in (("two-tier", card), ("single-tier", single)):
        store._drain_then_lock()
        try:
            torch.cuda.synchronize()
            t = [time.perf_counter()]
            prep = store._prepare_columns(keys, c, now)
            t.append(time.perf_counter())
            store._drain_moves()
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            staged = store._stage_columns(prep)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            hot, cold = store.state.hot.clone(), store.state.cold.clone()
            res = staged.kernel(store.state.hot, store.state.cold, *staged.args)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            res_np = res.cpu().numpy()
            t.append(time.perf_counter())
            prep.commit(res_np)
            t.append(time.perf_counter())
        finally:
            store._unlock_drained()
        steps = np.diff(t) * 1e3
        log(f"[breakdown] {label} batch, host clock: plan {steps[0]:.1f} ms, tier moves "
            f"{steps[1]:.2f} ms, pack+upload {steps[2]:.1f} ms, kernel+sync {steps[3]:.2f} ms, "
            f"readback {steps[4]:.2f} ms, decode+commit {steps[5]:.1f} ms "
            f"({'wide' if staged.wide else 'narrow'}, rounds {staged.args[-3]})")
        out[label] = (hot, cold, staged)
    return out


# ---------------------------------------------------------------------
# phase 10: the one-shard store at full size (bench.py's headline)
# ---------------------------------------------------------------------
def shard_traffic():
    """bench.py main()'s headline batch (seed 42): 131,072 lanes over
    100,000 keys, 80% of the traffic on 10% of them, `key_id % 2`
    algorithms (token and leaky), hits 1, limit 1,000,000, duration
    3,600,000; every dispatch resends it at now + i.  Returns (key_ids,
    packed keys, columns)."""
    from gubernator_tpu_torch import native

    rng = np.random.RandomState(42)
    hot = rng.randint(0, SHARD_KEYS // 10, size=BATCH)
    cold = rng.randint(0, SHARD_KEYS, size=BATCH)
    key_ids = np.where(rng.random(BATCH) < 0.8, hot, cold)
    keys = native.PackedKeys(*native.pack_keys([f"bench_account:{k}" for k in key_ids]))
    cols = dict(algorithm=(key_ids % 2).astype(np.int32), behavior=np.zeros(BATCH, np.int32),
                hits=np.ones(BATCH, np.int64), limit=np.full(BATCH, 1_000_000, np.int64),
                duration=np.full(BATCH, 3_600_000, np.int64))
    return key_ids, keys, cols


def shard_requests(key_ids, salt):
    """bench.py's dataclass-leg batch `make_batch(salt)`."""
    from gubernator_tpu_torch.types import Algorithm, RateLimitRequest

    return [RateLimitRequest(
        name="bench", unique_key=f"account:{(k + salt) % SHARD_KEYS}", hits=1,
        limit=1_000_000, duration=3_600_000,
        algorithm=Algorithm.TOKEN_BUCKET if (k + salt) % 2 == 0 else Algorithm.LEAKY_BUCKET)
        for k in key_ids.tolist()]


def shard_headline(store, keys, cols):
    """2 warm batches, then SHARD_THREADS dispatcher threads of
    SHARD_ITERS batches each, two in flight per thread.  Returns the
    answers by ticket {ticket: (now, result)}, the threaded batches'
    dispatch-to-answer latencies and the threaded leg's seconds."""
    from collections import deque

    results, lats, errors = {}, [], []
    lock = threading.Lock()

    def dispatch(i):
        return store.apply_columns_async(keys, now_ms=NOW + i, **cols), NOW + i

    for i in range(2):
        h, now = dispatch(i)
        results[h.ticket] = (now, h.result())

    def finish(p):
        h, now, t = p
        r = h.result()
        with lock:
            lats.append(time.perf_counter() - t)
            results[h.ticket] = (now, r)

    def worker(base):
        try:
            pending = deque()
            for i in range(SHARD_ITERS):
                t = time.perf_counter()
                pending.append((*dispatch(base + i), t))
                if len(pending) >= 2:
                    finish(pending.popleft())
            while pending:
                finish(pending.popleft())
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(2 + k * SHARD_ITERS,))
               for k in range(SHARD_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    timed_s = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return results, lats, timed_s


def same_answers(what, got, want, path="one-shard path"):
    for f in ("status", "limit", "remaining", "reset_time"):
        if not np.array_equal(np.asarray(got[f]), np.asarray(want[f])):
            raise AssertionError(f"{path}, {what}: {f} differs from the plain store")


def shard_phase(torch, dev="cuda"):
    """bench.py's headline deployment through the port's ShardStore on
    the card, every leg held against a ShardStore on the plain versions
    (CPU) replayed in ticket order.  Returns (card store, the K1/K2
    batches for the numbers phase, launches)."""
    from gubernator_tpu_torch.models.shard import GregResolver, ShardStore
    from gubernator_tpu_torch.ops import _kernels, buckets
    from gubernator_tpu_torch.types import RateLimitRequest
    from gubernator_tpu_torch.utils import gregorian

    t_phase = time.perf_counter()
    key_ids, keys, cols = shard_traffic()
    if dev == "cuda":
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()  # the earlier phases' stores
        torch.cuda.reset_peak_memory_stats()
    # the K2 calls' widths (the launch counts name the kernel only)
    k2 = {"narrow": 0, "wide": 0}
    real_k2 = buckets.bucket_rounds_cols

    def counted_k2(*a, **kw):
        if a[0].device.type == torch.device(dev).type:  # the card store's calls
            k2["wide" if a[6] else "narrow"] += 1
        return real_k2(*a, **kw)

    buckets.bucket_rounds_cols = counted_k2
    _kernels.reset_launch_counts()
    # (a) the headline: two dispatcher threads on the columnar pipeline
    card = ShardStore(capacity=SHARD_C, device=dev)
    groups = []
    real_launch = card._launch_group

    def launch_group(group):
        groups.append(len(group))
        return real_launch(group)

    card._launch_group = launch_group
    results, lats, timed_s = shard_headline(card, keys, cols)
    n_timed = SHARD_THREADS * SHARD_ITERS
    lat = np.array(lats) * 1e3
    log(f"[shard] headline: {n_timed} batches of {BATCH} lanes from {SHARD_THREADS} threads "
        f"(2 in flight each) in {timed_s:.3f} s: {n_timed * BATCH / timed_s:.0f} checks/s, "
        f"batch latency p50 {np.percentile(lat, 50):.2f} ms, max {lat.max():.2f} ms of {lat.size}; "
        f"{len(groups)} launch groups of sizes {groups}")
    # (b) the 400-config batch, narrow and wide (K2), and a monthly-
    # Gregorian batch (the dict wire's wide output)
    rng = np.random.RandomState(43)
    ids = zipf_ids(rng, SHARD_KEYS, BATCH)
    configs = (native_keys([f"bench_account:{k}" for k in ids]), dict(
        algorithm=(ids % 2).astype(np.int32), behavior=np.zeros(BATCH, np.int32),
        hits=np.ones(BATCH, np.int64), limit=(1_000_000 + ids % 400).astype(np.int64),
        duration=np.full(BATCH, 3_600_000, np.int64)), NOW + 100)
    ge, gd = GregResolver(TT_NOW).resolve(gregorian.GREGORIAN_MONTHS)
    ids = zipf_ids(rng, SHARD_KEYS, BATCH)
    monthly = (native_keys([f"bench_month:{k}" for k in ids]), dict(
        algorithm=(ids % 2).astype(np.int32), behavior=np.full(BATCH, 4, np.int32),
        hits=np.ones(BATCH, np.int64), limit=np.full(BATCH, 1_000_000, np.int64),
        duration=np.full(BATCH, gregorian.GREGORIAN_MONTHS, np.int64),
        greg_expire=np.full(BATCH, ge, np.int64), greg_duration=np.full(BATCH, gd, np.int64)),
        TT_NOW)
    batches = {"headline": (keys, cols, None), "400 configs narrow": (*configs[:2], None),
               "400 configs wide": (*configs[:2], "wide"), "monthly": (*monthly[:2], None)}
    results = {t: ("headline", now, r) for t, (now, r) in results.items()}
    for name in ("400 configs narrow", "400 configs wide", "monthly"):
        k, c, fw = batches[name]
        now = monthly[2] if name == "monthly" else configs[2]
        h = card.apply_columns_async(k, now_ms=now, force_wire=fw, **c)
        results[h.ticket] = (name, now, h.result())
    # the same traffic through a store on the plain versions, in ticket order
    t0 = time.perf_counter()
    ref = ShardStore(capacity=SHARD_C, device="cpu")
    for ticket in sorted(results):
        name, now, got = results[ticket]
        k, c, fw = batches[name]
        same_answers(f"{name} batch at {now}", got,
                     ref.apply_columns(k, now_ms=now, force_wire=fw, **c))
    same_stores(torch, "columnar", card, ref, "one-shard path")
    over = sum(int((r["status"] == 1).sum()) for _, _, r in results.values())
    log(f"[shard] {len(results)} columnar batches (2 warm, {n_timed} threaded, 400 configs "
        f"narrow and wide, monthly Gregorian) == plain store (CPU) replayed in ticket order: "
        f"answers, state, algo_mirror, table ({over} OVER_LIMIT lanes; checked in "
        f"{time.perf_counter() - t0:.1f} s)")
    if k2["narrow"] < 1 or k2["wide"] < 1:
        raise AssertionError(f"one-shard path: K2 narrow and wide not both launched: {k2}")
    # (c) the dataclass leg
    sides = {"card": dev, "cpu": "cpu"}  # side -> device
    dc = {k: ShardStore(capacity=SHARD_DC_C, device=d) for k, d in sides.items()}
    dc_s = 0.0
    for i in range(SHARD_DC_WARM + SHARD_DC_TIMED):
        reqs = shard_requests(key_ids, i)
        t0 = time.perf_counter()
        got = dc["card"].apply(reqs, NOW + i)
        if i >= SHARD_DC_WARM:
            dc_s += time.perf_counter() - t0
        if got != dc["cpu"].apply(reqs, NOW + i):
            raise AssertionError(f"one-shard path: dataclass batch {i} differs from the plain store")
    same_stores(torch, "dataclass", dc["card"], dc["cpu"], "one-shard path")
    log(f"[shard] dataclass leg: {SHARD_DC_TIMED} batches of {BATCH} requests in "
        f"{dc_s:.3f} s (apply only): {SHARD_DC_TIMED * BATCH / dc_s:.0f} checks/s; "
        f"== plain store")
    del dc
    # (d) a Store SPI over a 50,000-slot store: 8 batches of 2,048
    # lanes with algorithm switches and RESET_REMAINING
    srng = np.random.default_rng(17)
    n_pre, n_keys, cache, lanes = 25_000, 40_000, 50_000, 2_048
    pre_algo = srng.integers(0, 2, n_pre)
    stores, sstores = {}, {}
    for side, d in sides.items():
        stores[side] = preloaded_store(pre_algo)
        sstores[side] = ShardStore(capacity=cache, device=d, store=stores[side])
    spi_s = 0.0
    for i in range(8):
        ids = srng.integers(0, n_keys, lanes)
        algos = np.where(ids < n_pre, pre_algo[np.minimum(ids, n_pre - 1)], ids % 2)
        algos = np.where(srng.random(lanes) < 0.05, 1 - algos, algos)
        beh = np.where(srng.random(lanes) < 0.02, 8, 0)
        reqs = [RateLimitRequest(name="st", unique_key=str(k), hits=1, limit=100,
                                 duration=3_600_000, algorithm=int(a), behavior=int(b))
                for k, a, b in zip(ids.tolist(), algos.tolist(), beh.tolist())]
        t0 = time.perf_counter()
        got = sstores["card"].apply(reqs, NOW + 10 * i)
        spi_s += time.perf_counter() - t0
        if got != sstores["cpu"].apply(reqs, NOW + 10 * i):
            raise AssertionError(f"one-shard path: Store SPI batch {i} differs")

    if stores["card"].called != stores["cpu"].called or \
            item_tuples(stores["card"]) != item_tuples(stores["cpu"]):
        raise AssertionError("one-shard path: the Store SPI's calls or items differ")
    same_stores(torch, "Store SPI", sstores["card"], sstores["cpu"], "one-shard path")
    log(f"[shard] Store SPI: 8 batches of {lanes} lanes, calls {stores['card'].called}; "
        f"card == CPU; {spi_s / 8:.3f} s a batch on the card")
    # (e) the express slot: 1-lane batches with scalar_fast_path on take
    # K1 on the card and the host slot on the CPU
    ex = {k: ShardStore(capacity=4096, device=d) for k, d in sides.items()}
    erng = np.random.default_rng(5)
    before = _kernels.LAUNCHES["bucket_rounds_dict"]
    for st in ex.values():
        st.scalar_fast_path = True
    for i in range(40):
        k = [f"ex{int(erng.integers(0, 6))}"]
        c = dict(algorithm=np.array([i % 2], np.int32),
                 behavior=np.array([8 if erng.random() < 0.1 else 0], np.int32),
                 hits=np.array([int(erng.integers(0, 3))], np.int64),
                 limit=np.array([5], np.int64), duration=np.array([1000], np.int64))
        now = NOW + 40 * i
        same_answers(f"express batch {i}", ex["card"].apply_columns(k, now_ms=now, **c),
                     ex["cpu"].apply_columns(k, now_ms=now, **c))
    express_k1 = _kernels.LAUNCHES["bucket_rounds_dict"] - before
    on_card = (0, 40) if dev == "cuda" else (40, 0)  # (slot applies, K1 launches)
    if (ex["card"].scalar_applies, express_k1) != on_card or ex["cpu"].scalar_applies != 40:
        raise AssertionError(f"one-shard path: express slot on the card {ex['card'].scalar_applies}, "
                             f"on the CPU {ex['cpu'].scalar_applies}, K1 {express_k1}")
    same_stores(torch, "express", ex["card"], ex["cpu"], "one-shard path")
    log(f"[shard] express store: 40 one-lane batches, card (K1, scalar_applies "
        f"{ex['card'].scalar_applies}) == CPU (scalar_applies {ex['cpu'].scalar_applies})")
    # (f) launch fusion: a stalled stage step queues batches at the gate
    fused_backlog(torch, lambda d: ShardStore(capacity=SHARD_C, device=d),
                  fuse_items("bench_account", SHARD_KEYS, 44, lambda ids: ids % 2), dev,
                  "one-shard path")
    buckets.bucket_rounds_cols = real_k2
    launches = {k: _kernels.LAUNCHES[k] for k in (
        "bucket_rounds_dict", "bucket_rounds_cols", "gather_rows", "write_rows",
        "bucket_compact")}
    peak = torch.cuda.max_memory_allocated() - base if dev == "cuda" else 0
    log(f"[shard] launches on the one-shard path: {launches} (K2 narrow {k2['narrow']}, "
        f"wide {k2['wide']}); peak device memory of the phase {peak / 2**20:.1f} MiB; "
        f"phase took {time.perf_counter() - t_phase:.1f} s")
    for kname in ("bucket_rounds_dict", "bucket_rounds_cols", "gather_rows", "write_rows"):
        if launches[kname] <= 0:
            raise AssertionError(f"kernel {kname} was not launched on the one-shard path")
    launches["k2"] = k2
    card._launch_group = real_launch
    return card, {"headline": (keys, cols, NOW + 200), "configs": configs}, launches


def shard_numbers_phase(torch, card, batches, launches, k10_err, sass):
    """K1 and K2 (narrow and wide) at S = 1 on the one-shard store's
    batches, and K10 on the headline's single-round batch beside K1 on
    the same batch: one more batch of each planned and staged step by
    step, then each kernel, its plain version, its device time and its
    byte bound over the live lanes, against copies of the store's
    state."""
    from gubernator_tpu_torch.models.shard import make_columns
    from gubernator_tpu_torch.ops import buckets

    rows = []
    plans = [("bucket_rounds_dict", "headline", None, "gubernator_tpu/ops/buckets.py:1066"),
             ("bucket_rounds_cols", "configs", None, "gubernator_tpu/ops/buckets.py:844"),
             ("bucket_rounds_cols", "configs", "wide", "gubernator_tpu/ops/buckets.py:728")]
    for kname, which, fw, replaces in plans:
        keys, cols, now = batches[which]
        c = make_columns(cols["algorithm"], cols["behavior"], cols["hits"], cols["limit"],
                         cols["duration"], len(keys))
        hot0, cold0 = card.state.hot.clone(), card.state.cold.clone()
        hot, cold = hot0.clone(), cold0.clone()
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        prep = card._prepare_columns(keys, c, now, fw)
        t.append(time.perf_counter())
        staged = card._stage_columns(prep)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out = staged.kernel(hot, cold, *staged.args)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out_np = out.cpu().numpy()
        t.append(time.perf_counter())
        prep.commit(out_np)
        t.append(time.perf_counter())
        steps = np.diff(t) * 1e3
        width = "wide" if staged.wide else "narrow"
        log(f"[breakdown] one-shard {which} batch ({kname}, {width}), host clock: plan "
            f"{steps[0]:.1f} ms, pack+upload {steps[1]:.1f} ms, kernel+sync {steps[2]:.2f} ms, "
            f"readback {steps[3]:.2f} ms, decode+commit {steps[4]:.1f} ms")
        assert staged.kernel.__name__ == kname, (staged.kernel.__name__, kname)
        changed_cold = int((cold != cold0).any(dim=2).sum())
        args = staged.args
        if kname == "bucket_rounds_dict":
            wire = args[0]
            P = (wire.shape[1] - buckets.DICT_WIRE_TABLE_WORDS) // 3
            slot, write = wire[:, :P], ((wire[:, P:2 * P] >> 17) & 1) == 1
            lane_bytes, table_bytes = 3 * 4, buckets.DICT_WIRE_TABLE_WORDS * 4
            plain = buckets.bucket_rounds_dict_plain
        else:
            slot, write = args[0][:, 0], ((args[0][:, 1] >> 1) & 1) == 1
            lane_bytes, table_bytes = 6 * 4 + 5 * args[1].element_size(), 0
            plain = buckets.bucket_rounds_cols_plain
        valid = slot >= 0
        n_valid = int(valid.sum())
        # per valid lane its inputs and output; per distinct row its hot
        # and cold words read once, per distinct written row its hot
        # words, per changed config its cold words
        n_rows, n_write = distinct_rows(slot, valid), distinct_rows(slot, valid & write)
        nbytes = (n_valid * (lane_bytes + 4 * out.element_size()) + table_bytes
                  + 64 * n_rows + 32 * n_write + 32 * changed_cold)
        bound_ms, bound_by, bounds = rounds_bound(
            torch, sass, "dict" if kname == "bucket_rounds_dict" else "cols", hot0, cold0,
            args, nbytes)

        hp, cp = hot0.clone(), cold0.clone()
        want = plain(hp, cp, *args)
        err = max_abs_err([t.cpu().numpy() for t in (out, hot, cold)],
                          [t.cpu().numpy() for t in (want, hp, cp)])
        if err != 0:
            raise AssertionError(f"{kname} at S=1 != its plain version (max abs err {err})")

        def run(h=hot, cd=cold, a=args, k=staged.kernel):
            return k(h, cd, *a)

        ms = time_launches(torch, run, 20)
        dev_ms = device_ms(torch, kname, run)
        dev_cold = device_ms(torch, kname, run, cold=True)
        plain_ms = time_launches(torch, lambda: plain(hot, cold, *args), 3)
        rows.append({
            "name": f"{kname}/shard{'_wide' if staged.wide else ''}", "route": "cuda",
            "source": "gubernator_tpu_torch/csrc/bucket_rounds.cu", "replaces": replaces,
            "launches": (launches["k2"]["wide" if staged.wide else "narrow"]
                         if kname == "bucket_rounds_cols" else launches[kname]),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
        log(f"[numbers] {kname} at S=1 ({which} batch, C={hot.shape[1]} P={slot.shape[1]}, "
            f"{width}, rounds {args[-3]}): {ms:.4f} ms/launch, device {dev_ms} ms warm / "
            f"{dev_cold} ms L2 flushed, plain {plain_ms:.2f} ms; {bounds} ({n_valid} lanes, "
            f"{n_rows} rows, {n_write} written, {changed_cold} cold rows)")
        if kname != "bucket_rounds_dict":
            continue
        # K10 on the same single-round batch, the plan's write lanes listed
        if args[1] != 1:
            raise AssertionError(f"the headline batch planned {args[1]} rounds, not 1")
        wl = np.nonzero(prep.wr_col)[0]
        wlane = torch.tensor(_pad_wlane(wl), device=hot.device)
        h10, c10 = hot0.clone(), cold0.clone()
        h1, c1 = hot0.clone(), cold0.clone()
        out10 = buckets.compact_dict(h10, c10, wire, wlane, now)
        out1 = staged.kernel(h1, c1, *args)
        if not (torch.equal(out10, out1) and torch.equal(h10, h1) and torch.equal(c10, c1)):
            raise AssertionError("K10 != K1 on the headline's single-round batch")
        pout = buckets.apply_compact_packed_plain(hot0.clone(), cold0.clone(), wire, wlane, now)
        if not torch.equal(pout, out10):
            raise AssertionError("K10 != its plain version on the headline's batch")

        def k10(h=h10, cd=c10):
            return buckets.compact_dict(h, cd, wire, wlane, now)

        ms10 = time_launches(torch, k10, 20)
        dev10 = device_ms(torch, "bucket_compact", k10)
        dev10c = device_ms(torch, "bucket_compact", k10, cold=True)
        queued10, queued1 = queued_ms(torch, k10), queued_ms(torch, run)
        plain10 = time_launches(
            torch, lambda: buckets.apply_compact_packed_plain(h10, c10, wire, wlane, now), 3)
        nbytes10 = (n_valid * (lane_bytes + 16) + table_bytes + 4 * wl.size
                    + 64 * n_rows + 32 * n_write + 32 * changed_cold)
        bound10 = nbytes10 / HBM_BYTES_PER_S * 1e3
        kname10, replaces10 = COMPACT_KERNEL
        rows.append({
            "name": kname10, "route": "cuda", "source": "gubernator_tpu_torch/csrc/compact.cu",
            "replaces": replaces10, "launches": launches[kname10], "max_abs_err": k10_err,
            "ms": ms10, "plain_ms": plain10, "bound_ms": bound10, "bound_by": "bytes",
            "library_ms": None,
        })
        log(f"[numbers] {kname10} (K10, headline batch, S=1, P={P}, {wl.size} write lanes): "
            f"{ms10:.4f} ms/launch, device {dev10} ms warm / {dev10c} ms L2 flushed / "
            f"{queued10:.4f} ms queued, plain {plain10:.2f} ms, bound {bound10:.6g} ms "
            f"({nbytes10} bytes); K1 on the same batch {ms:.4f} ms/launch, device {dev_ms} ms "
            f"warm / {dev_cold} ms L2 flushed / {queued1:.4f} ms queued; launches on the "
            f"one-shard path {launches[kname10]} (no store calls it)")
    return rows


def native_keys(keys):
    from gubernator_tpu_torch import native

    return native.PackedKeys(*native.pack_keys(keys))


# ---------------------------------------------------------------------
# phase 8: kernel numbers at the paths' shapes
# ---------------------------------------------------------------------
def time_launches(torch, fn, iters):
    fn()  # warm
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# device kernels (csrc/*.cu) behind each wrapper, for the profiler
DEVICE_KERNELS = {
    "bucket_rounds_dict": ("bucket_rounds_kernel",),
    "bucket_rounds_cols": ("bucket_rounds_kernel",),
    "global_answer_rounds": ("bucket_rounds_kernel",),  # rounds.cuh, the AnswerOut sink
    "global_sync": ("sync_kernel",),
    "set_replica": ("set_replica_kernel",),
    "clear_gslots": ("clear_kernel",),
    "gather_rows": ("gather_rows_kernel",),
    "write_rows": ("write_rows_kernel",),
    "gather_back_rows": ("gather_rows_kernel",),
    "apply_moves": ("moves_kernel",),
    "bucket_compact": ("bucket_rounds_kernel",),  # rounds.cuh, the CompactOut sink
    "launch_floor": ("empty_kernel", "empty_barrier_kernel"),
}
# device ms a call from phase 8's numbers, by wrapper (phase 16 reads K4's)
NUMBERS_DEVICE_MS = {}
# wrappers whose every call is one device kernel (device_ms asserts it)
ONE_LAUNCH = ("bucket_rounds_dict", "bucket_rounds_cols", "global_answer_rounds",
              "clear_gslots", "apply_moves", "bucket_compact")


def device_profile(torch, fn, iters=20, cold=False, kernels=()):
    """(ms, span_ms, per_call) of `iters` calls of `fn` from
    torch.profiler: the summed duration of the device kernels whose names
    hold one of `kernels`, per call; the time from a call's first such
    kernel's start to its last one's end (the gaps between a call's
    launches included), per call; and the kernels a call ran.  With
    `cold`, a 64 MiB buffer is zeroed before each call so the call finds
    the 50 MB L2 cache holding none of its rows (the zeroing's own kernel
    is not summed).  (None, None, 0) when the trace holds no such
    kernel; (None, None, kernels seen a call) when every one of its ten
    traces lost some of their records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(16 << 20, dtype=torch.int32, device="cuda") if cold else None
    fn()
    torch.cuda.synchronize()
    for attempt in range(10):  # a trace that lost kernels' records is taken again
        if attempt:
            time.sleep(0.2)  # let the tracer drain what it still holds
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if flush is not None:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        evs = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                     if e.device_type == DeviceType.CUDA and any(k in e.name for k in kernels))
        if evs and len(evs) % iters == 0 and sum(b - a for a, b in evs):
            break
        log(f"[profile] trace {attempt + 1} held {len(evs)} of its kernels for {iters} calls")
    if not evs or not sum(b - a for a, b in evs):
        return None, None, 0
    if len(evs) % iters:  # every trace lost records: no time from them
        return None, None, len(evs) / iters
    ms = sum(b - a for a, b in evs) / iters / 1e3
    k = len(evs) // iters
    span = sum(evs[i + k - 1][1] - evs[i][0] for i in range(0, len(evs), k)) / iters / 1e3
    return ms, span, len(evs) / iters


def queued_ms(torch, fn, iters=20):
    """Time per call on the card with the calls queued behind a 50 ms
    spin kernel, so that the host's enqueue never leaves the card
    waiting: CUDA events around `iters` calls, which include the gaps
    between a call's launches as the card runs them (the profiler's sums
    leave them out, and its own launch overhead widens them)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's 1,980 MHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, kname, fn, iters=20, cold=False, kernels=None):
    """Device time per wrapper call (device_profile's summed kernel
    time) of the wrapper's kernels (DEVICE_KERNELS, or the names in
    `kernels`), which leaves out the host's launch gaps that the event
    timing of back-to-back calls includes; logs it with the call's span.
    None when no trace holds all of its kernels.  A wrapper of
    ONE_LAUNCH must run one device kernel a call."""
    ms, span, per_call = device_profile(torch, fn, iters, cold,
                                        kernels or DEVICE_KERNELS[kname])
    if kernels is None and kname in ONE_LAUNCH and per_call and per_call != 1:
        raise AssertionError(f"{kname}: {per_call * iters:g} device kernels in {iters} calls, "
                             f"not one a call")
    if ms is None:
        log(f"[profile] {kname}: no complete trace of its kernels (not measured)")
        return None
    span_s = "not measured" if span is None else f"{span:.4f} ms"
    log(f"[profile] {kname}: device {ms:.4f} ms per call{' (L2 flushed)' if cold else ''}, "
        f"{per_call:g} kernels a call, first start to last end {span_s}")
    return ms


def numbers_phase(torch, store, batches, launches, errs, sass):
    """Plan and stage one more main-path batch of each kind on the
    store, one step at a time (the host breakdown of a batch), then
    time the kernel and its plain version on those inputs against a
    copy of the store's state."""
    from gubernator_tpu_torch.models.shard import make_columns
    from gubernator_tpu_torch.ops import buckets

    rows = []
    picks = {"dict": batches[-3], "cols": batches[-1]}  # a timed batch; the K2 batch
    for kind, (kname, replaces) in KERNELS.items():
        name, keys, cols, now = picks[kind]
        c = make_columns(cols["algorithm"], cols["behavior"], cols["hits"],
                         cols["limit"], cols["duration"], len(keys))
        hot0, cold0 = store.state.hot.clone(), store.state.cold.clone()
        hot, cold = hot0.clone(), cold0.clone()
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        prep = store._prepare_columns(keys, c, now + 1000)
        t.append(time.perf_counter())
        staged = store._stage_columns(prep)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out = staged.kernel(hot, cold, *staged.args)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out_np = out.cpu().numpy()
        t.append(time.perf_counter())
        prep.commit(out_np)
        t.append(time.perf_counter())
        steps = np.diff(t) * 1e3
        log(f"[breakdown] {kname} one batch, host clock: plan {steps[0]:.1f} ms, "
            f"pack+upload {steps[1]:.1f} ms, kernel+sync {steps[2]:.2f} ms, "
            f"readback {steps[3]:.2f} ms, decode+commit {steps[4]:.1f} ms")
        assert staged.kernel.__name__ == kname, (staged.kernel.__name__, kname)
        changed_cold = int((cold != cold0).any(dim=2).sum())
        ms = time_launches(torch, lambda: staged.kernel(hot, cold, *staged.args), 20)
        dev_ms = device_ms(torch, kname, lambda: staged.kernel(hot, cold, *staged.args))
        dev_cold = device_ms(torch, kname, lambda: staged.kernel(hot, cold, *staged.args),
                             cold=True)
        plain = (buckets.bucket_rounds_dict_plain if kind == "dict"
                 else buckets.bucket_rounds_cols_plain)
        plain_ms = time_launches(torch, lambda: plain(hot, cold, *staged.args), 3)
        # bytes the function must move: the valid lanes' inputs once and
        # outputs once (the padding that fills each shard to P answers no
        # request and is not counted), each distinct row's hot+cold words
        # read once, each distinct written row's hot words, a cold row per
        # changed config
        args = staged.args
        if kind == "dict":
            wire = args[0]
            P = (wire.shape[1] - buckets.DICT_WIRE_TABLE_WORDS) // 3
            slot = wire[:, :P]
            write = ((wire[:, P:2 * P] >> 17) & 1) == 1
            lane_bytes, table_bytes = 3 * 4, wire.shape[0] * buckets.DICT_WIRE_TABLE_WORDS * 4
        else:
            lanes, values = args[0], args[1]
            slot = lanes[:, 0]
            write = ((lanes[:, 1] >> 1) & 1) == 1
            lane_bytes, table_bytes = 6 * 4 + 5 * values.element_size(), 0
        valid = slot >= 0
        n_valid = int(valid.sum())
        n_rows, n_write = distinct_rows(slot, valid), distinct_rows(slot, valid & write)
        nbytes = (n_valid * (lane_bytes + 4 * out.element_size()) + table_bytes
                  + 64 * n_rows + 32 * n_write + 32 * changed_cold)
        bound_ms, bound_by, bounds = rounds_bound(torch, sass, kind, hot0, cold0, args, nbytes)
        rows.append({
            "name": kname, "route": "cuda",
            "source": "gubernator_tpu_torch/csrc/bucket_rounds.cu",
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": errs[kind], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
        log(f"[numbers] {kname} ({name} batch, S={slot.shape[0]} P={slot.shape[1]}, "
            f"{'wide' if staged.wide else 'narrow'}, rounds {args[-3]}): "
            f"{ms:.4f} ms/launch, device {dev_ms} ms warm / {dev_cold} ms L2 flushed, plain "
            f"{plain_ms:.2f} ms; {bounds} ({n_valid} lanes, {n_rows} rows, {n_write} written, "
            f"{changed_cold} cold rows)")
    return rows


def global_numbers_phase(torch, card, launches, errs, inputs, now):
    """Time K3-K6 and their plain versions on the GLOBAL path's inputs
    (the step-by-step batch and sync, the replica commit) against copies
    of the card store's state; K5 and K6 also against the PyTorch calls
    that compute the same function."""
    from gubernator_tpu_torch.ops import _kernels, global_ops

    (prep, staged, answer_np), (sync_staged, sync_np), (upd_np, idx_np) = inputs
    S_, G = card.gcols.ghits.shape
    rows = []

    def copies():
        return (card.state.hot.clone(), card.state.cold.clone(),
                global_ops.GlobalColumns(*[c.clone() for c in card.gcols]))

    def row(kind, ms, plain_ms, nbytes, library_ms=None, note=""):
        kname, replaces = GLOBAL_KERNELS[kind]
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({
            "name": kname, "route": "cuda",
            "source": "gubernator_tpu_torch/csrc/global_ops.cu",
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": errs[kind], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms,
        })
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        log(f"[numbers] {kname}: {ms:.4f} ms/launch, plain {plain_ms:.3f} ms{lib}, "
            f"bound {bound_ms:.6g} ms ({nbytes} bytes{note})")

    # K3 on the step-by-step skew batch
    lanes, values, gslot = staged
    nr = prep.n_rounds
    hot, cold, g = copies()
    cold0 = cold.clone()
    global_ops.answer_rounds(hot, cold, g, lanes, values, gslot, nr, now)
    changed_cold = int((cold != cold0).any(dim=2).sum())
    ms = time_launches(torch, lambda: global_ops.answer_rounds(
        hot, cold, g, lanes, values, gslot, nr, now), 20)
    device_ms(torch, "global_answer_rounds", lambda: global_ops.answer_rounds(
        hot, cold, g, lanes, values, gslot, nr, now))
    device_ms(torch, "global_answer_rounds", lambda: global_ops.answer_rounds(
        hot, cold, g, lanes, values, gslot, nr, now), cold=True)
    queued = queued_ms(torch, lambda: global_ops.answer_rounds(
        hot, cold, g, lanes, values, gslot, nr, now))
    plain_ms = time_launches(torch, lambda: global_ops.answer_rounds_plain(
        hot, cold, g, lanes, values, gslot, nr, now), 3)
    cached = ((answer_np[:, 0] >> 2) & 1) == 1
    slot, write, gs = prep.lanes[:, 0], (prep.lanes[:, 1] & 2) != 0, prep.gslot
    evaluated = (slot >= 0) & ~cached
    live = (slot >= 0) | (gs >= 0)  # lanes that answer a request; the rest pads shards to P
    P = slot.shape[1]
    # once per distinct gslot its rep_expire and the ghits add, per
    # distinct gslot answered from the replica its rep_* words, per
    # distinct bucket row its rows, per distinct written row its new rows
    traffic = (24 * distinct_rows(gs, gs >= 0) + 28 * distinct_rows(gs, cached & (gs >= 0))
               + 64 * distinct_rows(slot, evaluated)
               + 32 * distinct_rows(slot, evaluated & write) + 32 * changed_cold)
    # the bound counts the live lanes' 6 lane, 5 value and gslot words
    # in and 5 output words out; the padded arrays the kernel reads are
    # given beside it
    nbytes = int(live.sum()) * (6 * 4 + 5 * 8 + 4 + 5 * 8) + traffic
    padded = (prep.lanes.nbytes + prep.values.nbytes + prep.gslot.nbytes + S_ * 5 * P * 8
              + traffic)
    row("answer", ms, plain_ms, nbytes,
        note=f": {int(live.sum())} live lanes of S*P={S_ * P}, {nr} rounds, "
             f"{int(cached.sum())} replica answers, {int(evaluated.sum())} bucket lanes; "
             f"with the padded arrays {padded} bytes, "
             f"{padded / HBM_BYTES_PER_S * 1e3:.6g} ms; queued behind a spin kernel "
             f"{queued:.4f} ms a call")
    k3_more(torch, card, (lanes, values, gslot), live, nr, now)

    # K4 on the step-by-step sync
    cfg, dirty = sync_staged
    hot, cold, g = copies()
    ms = time_launches(torch, lambda: global_ops.global_sync(hot, cold, g, cfg, dirty, now), 20)
    NUMBERS_DEVICE_MS["global_sync"] = device_ms(
        torch, "global_sync", lambda: global_ops.global_sync(hot, cold, g, cfg, dirty, now))
    plain_ms = time_launches(torch, lambda: global_ops.global_sync_plain(
        hot, cold, g, cfg, dirty, now), 3)
    applied = int(((sync_np[0, 0] >> 1) & 1).sum())
    nbytes = (2 * S_ * G * 8 + S_ * G * 36 + applied * S_ * 36 + 8 * G * 8 + G
              + S_ * 8 * G * 8 + applied * (64 + 32))
    row("sync", ms, plain_ms, nbytes, note=f": G={G}, {applied} gslots applied")

    # K5 and K6 on the replica commit's inputs
    hot, cold, g = copies()
    upd = torch.tensor(upd_np, device=card.device)
    valid = (upd_np[0] >= 0) & (upd_np[0] < G)
    gi = torch.tensor(upd_np[0][valid], device=card.device)
    vals = [torch.tensor(v[valid], device=card.device) for v in upd_np[1:]]
    vals[0] = vals[0].to(torch.int32)
    sidx = torch.arange(S_, device=card.device)[:, None]

    def library_replica():
        for col, v in zip(g[:5], (*vals, vals[3])):
            col.index_put_((sidx, gi[None, :]), v[None, :].expand(S_, -1))

    ms = time_launches(torch, lambda: _kernels.set_replica(g, upd), 20)
    device_ms(torch, "set_replica", lambda: _kernels.set_replica(g, upd))
    plain_ms = time_launches(torch, lambda: global_ops.set_replica_plain(g, upd), 3)
    lib_ms = time_launches(torch, library_replica, 20)
    row("replica", ms, plain_ms, upd_np.nbytes + int(valid.sum()) * S_ * 36, lib_ms,
        note=f": M={upd_np.shape[1]}")
    idx = torch.tensor(idx_np, device=card.device)
    ivalid = torch.tensor(idx_np[idx_np < G], device=card.device)

    def library_clear():
        for col in g:
            col.index_fill_(1, ivalid, 0)

    ms = time_launches(torch, lambda: _kernels.clear_gslots(g, idx), 20)
    device_ms(torch, "clear_gslots", lambda: _kernels.clear_gslots(g, idx))
    device_ms(torch, "clear_gslots", lambda: _kernels.clear_gslots(g, idx), cold=True)
    queued = queued_ms(torch, lambda: _kernels.clear_gslots(g, idx))
    plain_ms = time_launches(torch, lambda: global_ops.clear_gslots_plain(g, idx), 3)
    lib_ms = time_launches(torch, library_clear, 20)
    row("clear", ms, plain_ms, idx_np.nbytes + int((idx_np < G).sum()) * S_ * 44, lib_ms,
        note=f": K={idx_np.size}, {int((idx_np < G).sum())} gslots; queued behind a spin "
             f"kernel {queued:.4f} ms a call")
    return rows


def _ms(v):
    return "not measured" if v is None else f"{v:.4f} ms"


def deal_live_lanes(lanes, values, gslot, live):
    """The live lanes of a padded [S, *, P] answer batch dealt round robin
    over the S shards, each keeping its words (the same lanes' work, with
    the padding that fills every shard to the fullest cut to the
    fullest's share of the live lanes)."""
    S_ = lanes.shape[0]
    sh, p = np.nonzero(live)
    Pn = max(1, -(-len(sh) // S_))
    out_l = np.zeros((S_, 6, Pn), np.int32)
    out_l[:, 0] = -1
    out_v = np.zeros((S_, 5, Pn), np.int64)
    out_g = np.full((S_, Pn), -1, np.int32)
    k = np.arange(len(sh))
    out_l[k % S_, :, k // S_] = lanes[sh, :, p]
    out_v[k % S_, :, k // S_] = values[sh, :, p]
    out_g[k % S_, k // S_] = gslot[sh, p]
    return out_l, out_v, out_g


def k3_more(torch, card, staged, live, nr, now):
    """K3's device time on the GLOBAL path's batch beside the same live
    lanes without the host's padding, on a seeded 5-round batch of the
    path's shape, and the launch floor (empty kernels) at K3's grid."""
    from gubernator_tpu_torch.ops import _kernels, global_ops

    S_, _, P = staged[0].shape
    dev = card.device

    def copies():
        return (card.state.hot.clone(), card.state.cold.clone(),
                global_ops.GlobalColumns(*[c.clone() for c in card.gcols]))

    def k3(args, rounds, now_ms):
        h, c, g = copies()
        return device_profile(torch, lambda: global_ops.answer_rounds(h, c, g, *args, rounds,
                                                                      now_ms),
                              kernels=DEVICE_KERNELS["global_answer_rounds"])

    padded = k3(staged, nr, now)
    dealt = [torch.tensor(a, device=dev) for a in deal_live_lanes(
        *[t.cpu().numpy() for t in staged], live)]
    flat = k3(dealt, nr, now)
    cost = ("not measured" if padded[0] is None or flat[0] is None
            else f"{(padded[0] / flat[0] - 1) * 100:.1f}%")
    log(f"[numbers] K3 padding: the path's batch, S*P={S_ * P} lanes ({int(live.sum())} live), "
        f"device {_ms(padded[0])} (span {_ms(padded[1])}); its live lanes dealt over "
        f"{S_} x {dealt[0].shape[2]}, device {_ms(flat[0])} (span {_ms(flat[1])}): the "
        f"padding costs {cost} of the dealt batch's time")
    _, _, gc, (lanes5, values5, gslot5, n5) = global_case("answer", 105, card.state.hot.shape[1],
                                                          card.gcols.ghits.shape[1], P, 5)
    five = [torch.tensor(a, device=dev) for a in (lanes5, values5, gslot5)]
    t5 = k3(five, n5, now)
    log(f"[numbers] K3 seeded 5-round batch (S={S_} P={P}, slots of each round distinct, "
        f"gslots repeated across rounds): device {_ms(t5[0])}, {t5[2]:g} kernels a call, "
        f"span {_ms(t5[1])}")
    blocks = _kernels.answer_launch_shape(S_ * P)[0]
    floor = [device_profile(torch, lambda c=coop: _kernels.launch_floor(c, blocks, dev),
                            kernels=(DEVICE_KERNELS["launch_floor"][coop],))[0]
             for coop in (False, True)]
    log(f"[numbers] launch floor (device, profiler): an empty kernel {_ms(floor[0])}; an "
        f"empty cooperative kernel with one grid barrier at K3's grid ({blocks} blocks of "
        f"256) {_ms(floor[1])}")


def rows_numbers_phase(torch, rows, launches, errs):
    """Time K7 and K8, their plain versions and the PyTorch calls that
    move the same rows, on the inputs of the card's boot restore
    (1,000,000 lanes on S=8 x 262,144 slots): K7 on the card store's
    state, K8 on a copy of it."""
    from gubernator_tpu_torch.ops import _kernels, buckets

    out = []

    def row(kind, ms, plain_ms, lib_ms, n_live, M):
        kname, replaces = ROW_KERNELS[kind]
        # per live lane: 8 bytes of lane words, a 32-byte hot and a
        # 32-byte cold row, 48 bytes of columns (2 x 4 + 5 x 8)
        nbytes = n_live * (8 + 64 + 48)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out.append({
            "name": kname, "route": "cuda", "source": "gubernator_tpu_torch/csrc/rows.cu",
            "replaces": replaces, "launches": launches[kname], "max_abs_err": errs[kind],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": lib_ms,
        })
        log(f"[numbers] {kname}: {ms:.4f} ms/launch, plain {plain_ms:.3f} ms, library "
            f"{lib_ms:.4f} ms, bound {bound_ms:.6g} ms ({nbytes} bytes: {n_live} live lanes "
            f"of M={M})")

    hot, cold, lanes = rows.gather
    C = hot.shape[1]
    live = (lanes[1] >= 0) & (lanes[1] < C)
    sh, sl = lanes[0][live].long(), lanes[1][live].long()
    ms = time_launches(torch, lambda: _kernels.gather_rows(hot, cold, lanes), 20)
    device_ms(torch, "gather_rows", lambda: _kernels.gather_rows(hot, cold, lanes))
    plain_ms = time_launches(torch, lambda: buckets.read_rows_plain(hot, cold, lanes), 3)
    lib_ms = time_launches(torch, lambda: (hot[sh, sl], cold[sh, sl]), 20)
    row("gather", ms, plain_ms, lib_ms, int(live.sum()), lanes.shape[1])

    whot, wcold, wl, c32, c64 = rows.write
    h, c = whot.clone(), wcold.clone()
    live = (wl[1] >= 0) & (wl[1] < C)
    wsh, wsl = wl[0][live].long(), wl[1][live].long()
    split = buckets.rows_to_split(buckets.cols_to_rows(c32, c64))
    sh_hot, sh_cold = split.hot[live], split.cold[live]

    def library_write():
        h.index_put_((wsh, wsl), sh_hot)
        c.index_put_((wsh, wsl), sh_cold)

    ms = time_launches(torch, lambda: _kernels.write_rows(h, c, wl, c32, c64), 20)
    device_ms(torch, "write_rows", lambda: _kernels.write_rows(h, c, wl, c32, c64))
    plain_ms = time_launches(torch, lambda: buckets.write_rows_plain(h, c, wl, c32, c64), 3)
    lib_ms = time_launches(torch, library_write, 20)
    row("write", ms, plain_ms, lib_ms, int(live.sum()), wl.shape[1])
    return out


def two_tier_numbers_phase(torch, card, launches, calls, k1_inputs, err):
    """Time K9 on the largest tier-move window of the two-tier run and
    K7 on its back-tier gather, their plain versions and the PyTorch
    calls that move the same rows, against copies of the card store's
    tables; and K1's device time on the step-by-step batch against a
    32,768-slot front and against a 262,144-slot single tier."""
    from gubernator_tpu_torch.ops import _kernels, buckets

    out = []
    # K9: the window's records, their live subset for the bound and the
    # library's index lists (built once, outside the timing)
    records = calls.records
    hot, cold = card.state.hot.clone(), card.state.cold.clone()
    bhot, bcold = card.back.hot.clone(), card.back.cold.clone()
    live, sh, kind, src, dst = buckets._move_index(hot, bhot, records)
    n_live = int(live.sum())
    C, Cb = hot.shape[1], bhot.shape[1]
    demote, k0 = kind == buckets.MOVE_DEMOTE, kind == buckets.MOVE_PROMOTE_BACK
    k1 = ~demote & ~k0
    front_src = torch.cat([sh[demote] * C + src[demote], sh[k1] * C + src[k1]])
    back_src = sh[k0] * Cb + src[k0]
    demo_dst, k1_dst, k0_dst = (sh[demote] * Cb + dst[demote], sh[k1] * C + dst[k1],
                                sh[k0] * C + dst[k0])
    nd = int(demote.sum())
    fh, fc, bh, bc = (t.view(-1, 8) for t in (hot, cold, bhot, bcold))

    def library_moves():
        a_h, a_c = fh.index_select(0, front_src), fc.index_select(0, front_src)
        b_h, b_c = bh.index_select(0, back_src), bc.index_select(0, back_src)
        bh.index_copy_(0, demo_dst, a_h[:nd])
        bc.index_copy_(0, demo_dst, a_c[:nd])
        fh.index_copy_(0, k1_dst, a_h[nd:])
        fc.index_copy_(0, k1_dst, a_c[nd:])
        fh.index_copy_(0, k0_dst, b_h)
        fc.index_copy_(0, k0_dst, b_c)

    def k9():
        _kernels.apply_moves(hot, cold, bhot, bcold, records)

    ms = time_launches(torch, k9, 20)
    device_ms(torch, "apply_moves", k9)
    device_ms(torch, "apply_moves", k9, cold=True)
    queued = queued_ms(torch, k9)
    n_spill = _kernels.moves_spill(records.shape[1])
    plain_ms = time_launches(
        torch, lambda: buckets.apply_moves_plain(hot, cold, bhot, bcold, records), 3)
    lib_ms = time_launches(torch, library_moves, 20)
    # per live record: 12 bytes of record words, a 64-byte row pair read
    # and written
    nbytes = n_live * (12 + 64 + 64)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    kname, replaces = MOVE_KERNEL
    out.append({
        "name": kname, "route": "cuda", "source": "gubernator_tpu_torch/csrc/moves.cu",
        "replaces": replaces, "launches": launches[kname], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": lib_ms,
    })
    log(f"[numbers] {kname}: {ms:.4f} ms/launch, plain {plain_ms:.3f} ms, library "
        f"(index_select + index_copy_) {lib_ms:.4f} ms, bound {bound_ms:.6g} ms ({nbytes} "
        f"bytes: {n_live} live records of {records.shape[1]}: {nd} demotions, "
        f"{int(k0.sum())} promotions from the back, {int(k1.sum())} from the front); "
        f"queued behind a spin kernel {queued:.4f} ms a call; {n_spill} quarters past "
        f"what the launch holds")

    # K7 on the back tier: the lanes of snapshot_items' back gather
    lanes = calls.back_lanes
    bh3, bc3 = card.back.hot, card.back.cold
    ok = (lanes[1] >= 0) & (lanes[1] < Cb)
    lsh, lsl = lanes[0][ok].long(), lanes[1][ok].long()

    def k7():
        _kernels.gather_rows(bh3, bc3, lanes, count="gather_back_rows")

    got = _kernels.gather_rows(bh3, bc3, lanes, count="gather_back_rows")
    want = buckets.read_rows_plain(bh3, bc3, lanes)
    k7_err = max_abs_err([t.cpu().numpy() for t in got], [t.cpu().numpy() for t in want])
    if k7_err != 0:
        raise AssertionError(f"K7 on the back tier != plain (max abs err {k7_err})")
    ms = time_launches(torch, k7, 20)
    device_ms(torch, "gather_back_rows", k7)
    device_ms(torch, "gather_back_rows", k7, cold=True)
    plain_ms = time_launches(torch, lambda: buckets.read_rows_plain(bh3, bc3, lanes), 3)
    lib_ms = time_launches(torch, lambda: (bh3[lsh, lsl], bc3[lsh, lsl]), 20)
    n_ok = int(ok.sum())
    nbytes = n_ok * (8 + 64 + 48)  # lane words, two rows, the columns
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    kname, replaces = BACK_ROWS_KERNEL
    out.append({
        "name": kname, "route": "cuda", "source": "gubernator_tpu_torch/csrc/rows.cu",
        "replaces": replaces, "launches": launches[kname], "max_abs_err": k7_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": lib_ms,
    })
    log(f"[numbers] {kname} (K7 on the back tier): {ms:.4f} ms/launch, plain "
        f"{plain_ms:.3f} ms, library {lib_ms:.4f} ms, bound {bound_ms:.6g} ms "
        f"({nbytes} bytes: {n_ok} lanes)")

    # The JAX package's reason for the split, on this card: K1 on the
    # two-tier batch against its 32,768-slot front, the same wire with
    # every slot s moved to s * 8 of a 262,144-slot table holding the
    # same rows there (same work, an 8x larger table), and the single-
    # tier store's own plan of the batch.
    h0, c0, staged = k1_inputs["two-tier"]
    wire, *rest = staged.args
    P = (wire.shape[1] - buckets.DICT_WIRE_TABLE_WORDS) // 3
    spread = wire.clone()
    spread[:, :P] = torch.where(wire[:, :P] >= 0, wire[:, :P] * S, wire[:, :P])
    big = [torch.zeros((h0.shape[0], h0.shape[1] * S, 8), dtype=torch.int32, device=h0.device)
           for _ in range(2)]
    big[0][:, ::S], big[1][:, ::S] = h0, c0
    runs = {"front": (h0, c0, wire), "spread": (*big, spread)}
    outs = {k: staged.kernel(h.clone(), c.clone(), w, *rest) for k, (h, c, w) in runs.items()}
    if not torch.equal(outs["front"], outs["spread"]):
        raise AssertionError("K1 on the spread wire answers otherwise than on the front")
    sh0, sc0, sstaged = k1_inputs["single-tier"]
    runs["single-tier plan"] = (sh0, sc0, *sstaged.args)
    for label, (h, c, *args) in runs.items():
        if label != "single-tier plan":
            args = [args[0], *rest]
        h, c = h.clone(), c.clone()
        dev = device_ms(torch, "bucket_rounds_dict", lambda: staged.kernel(h, c, *args),
                        cold=True)
        log(f"[split] K1, {label} ({h.shape[1]} slots a shard, rounds {args[-3]}): "
            f"device {dev} ms per call, L2 flushed")
    return out


# ---------------------------------------------------------------------
# phase 11: the one-node serving tier at full width
# ---------------------------------------------------------------------
SERVE_ENV = {
    "GUBER_CACHE_SIZE": "2097152",  # 8 x 262,144 slots: the main path's table
    "GUBER_BATCH_WAIT": "500us",  # BASELINE.json config 2's BATCHING window
    # The GLOBAL sync runs where the phase calls run_once, on the card and
    # on the CPU alike (its answers must be the same on both).
    "GUBER_GLOBAL_SYNC_WAIT": "1h",
}
SERVE_CALLERS = 32  # bench.py's service-ingress n_threads
SERVE_REQS = 16  # requests of each caller
SERVE_LANES = 1_000
EXPRESS_CALLERS = 8
EXPRESS_REQS = 200
EXPRESS_KEYS = 1_000  # BASELINE.json config 1


def serve_traffic():
    """Phase 11's requests, by leg: {leg: [caller's [IngressColumns]]}.
    Callers of a leg own disjoint keys."""
    from gubernator_tpu_torch.service import IngressColumns
    from gubernator_tpu_torch.types import Behavior
    from gubernator_tpu_torch.utils import gregorian

    GL, NB = int(Behavior.GLOBAL), int(Behavior.NO_BATCHING)
    rng = np.random.RandomState(11)
    legs = {}
    # (a) BASELINE config 2: leaky, BATCHING, 1,000,000 keys Zipf 80/10,
    # limit 1,000,000, an hour; caller c owns the ids = c mod 32.
    per = N_KEYS // SERVE_CALLERS
    legs["a"] = [[ingress("cfg2", zipf_ids(rng, per, SERVE_LANES) * SERVE_CALLERS + c)
                  for _ in range(SERVE_REQS)] for c in range(SERVE_CALLERS)]

    # (b) BASELINE config 1: token, NO_BATCHING, 1,000 keys, limit
    # 100,000, a minute; requests of 1 and 4 lanes.
    def small(name, c, n, beh):
        ids = rng.randint(0, EXPRESS_KEYS // EXPRESS_CALLERS, n) * EXPRESS_CALLERS + c
        return IngressColumns(
            names=[name] * n, unique_keys=[str(k) for k in ids],
            algorithm=np.zeros(n, np.int32), behavior=np.full(n, beh, np.int32),
            hits=np.ones(n, np.int64), limit=np.full(n, 100_000, np.int64),
            duration=np.full(n, 60_000, np.int64))

    legs["b"] = [[small("cfg1", c, 1 + 3 * (k % 2), NB) for k in range(EXPRESS_REQS)]
                 for c in range(EXPRESS_CALLERS)]
    # The express bypass proper: BATCHING requests of 1 and 4 lanes to a
    # shallow queue, from one caller.
    legs["b_express"] = [[small("cfg1x", 0, 1 + 3 * (k % 2), 0) for k in range(100)]]

    # (c) GLOBAL lanes beside more than four batched lanes, one key in
    # both groups.
    def mixed(k):
        keys = ["shared"] + [f"b{(k * 7 + j) % 13}" for j in range(7)] + [
            "shared", "gk0", "gk1"]
        beh = np.array([0] * 8 + [GL, GL, GL | NB], np.int32)
        n = len(keys)
        return IngressColumns(
            names=["cfgg"] * n, unique_keys=keys, algorithm=np.zeros(n, np.int32),
            behavior=beh, hits=np.full(n, 1 + k % 3, np.int64),
            limit=np.full(n, 1_000, np.int64), duration=np.full(n, 3_600_000, np.int64))

    legs["c"] = [[mixed(k) for k in range(6)]]
    # (d) traced requests: 3 of 100 lanes.
    legs["d"] = [[ingress("cfgtr", rng.randint(0, 10_000, 100)) for _ in range(3)]]
    # (e) more than 256 configs in one batch, monthly Gregorian: the
    # per-lane column wire (K2).
    n = SERVE_LANES
    legs["e"] = [[IngressColumns(
        names=["cfgm"] * n, unique_keys=[str(k) for k in rng.randint(0, 50_000, n)],
        algorithm=np.ones(n, np.int32),
        behavior=np.full(n, int(Behavior.DURATION_IS_GREGORIAN), np.int32),
        hits=np.ones(n, np.int64),
        limit=(1_000_000 + np.arange(n) % 300).astype(np.int64),
        duration=np.full(n, gregorian.GREGORIAN_MONTHS, np.int64))]]
    return legs


def serve_callers(svc, scripts, async_callers=()):
    """Each caller's requests in order, the callers concurrent; a caller
    waits for each answer before its next request.  Returns (answers by
    caller, latencies in s, wall s)."""
    answers = [[None] * len(s) for s in scripts]
    lat, errors = [], []
    lat_lock = threading.Lock()

    def run(c):
        try:
            for k, cols in enumerate(scripts[c]):
                t0 = time.perf_counter()
                if c in async_callers:
                    box, done = [], threading.Event()
                    svc.get_rate_limits_columns_async(
                        cols, lambda r, e: (box.append((r, e)), done.set()))
                    if not done.wait(300):
                        raise TimeoutError(f"caller {c}: no callback in 300 s")
                    res, exc = box[0]
                    if exc is not None:
                        raise exc
                else:
                    res = svc.get_rate_limits_columns(cols)
                dt = time.perf_counter() - t0
                with lat_lock:
                    lat.append(dt)
                answers[c][k] = result_bytes(res)
        except BaseException as e:  # noqa: BLE001 — raised below, on the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(c,), name=f"caller-{c}")
               for c in range(len(scripts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("a phase 11 caller did not finish in 600 s")
    if errors:
        raise errors[0]
    return answers, np.asarray(lat), wall


def serve_phase(torch, dev="cuda"):
    """Phase 11: a V1Service built from setup_daemon_config at the main
    path's table size, driven through its coalescing windows, express
    lane, async entry, GLOBAL lanes and tracing, held lane by lane and
    key by key to a service on the plain versions fed each caller's
    requests serially."""
    from gubernator_tpu_torch import saturation, tracing
    from gubernator_tpu_torch.config import setup_daemon_config
    from gubernator_tpu_torch.ops import _kernels
    from gubernator_tpu_torch.service import ServiceConfig, V1Service
    from gubernator_tpu_torch.types import Behavior
    from gubernator_tpu_torch.utils.clock import Clock

    t_phase = time.perf_counter()
    conf = setup_daemon_config(env=SERVE_ENV)
    b = conf.behaviors
    assert (b.batch_wait_s, b.express, b.express_max_lanes, b.ingress_queue_lanes) == (
        0.0005, True, 4, 262_144), b

    def service(device):
        clock = Clock()
        clock.freeze(NOW)
        svc = V1Service(ServiceConfig(
            cache_size=conf.cache_size, back_cache_size=conf.back_cache_size,
            global_cache_size=conf.global_cache_size, behaviors=conf.behaviors,
            clock=clock, device=device))
        svc.store.warmup(NOW, conf.warmup_shapes)
        return svc

    legs = serve_traffic()
    card = service(None if dev == "cuda" else dev)  # None: the current CUDA device
    cpu = service("cpu")
    if card.store.device.type != (dev if dev != "cuda" else "cuda"):
        raise AssertionError(f"phase 11's service runs on {card.store.device}")
    try:
        got = {}
        _kernels.reset_launch_counts()
        saturation.reset()
        card.store.take_pipeline_stats()
        # (a) 32 callers, half sync, half async
        got["a"], lat_a, wall_a = serve_callers(
            card, legs["a"], async_callers=range(1, SERVE_CALLERS, 2))
        stats_a, _, hwm_a = card.store.take_pipeline_stats()
        phases_a = saturation.phase_snapshot()
        express_a = saturation.express_snapshot()
        launches_a = dict(_kernels.LAUNCHES)
        occupancy = card.store.occupancy_stats()
        # (b) 8 NO_BATCHING callers, then the express bypass
        got["b"], lat_b, wall_b = serve_callers(card, legs["b"],
                                                async_callers=range(1, EXPRESS_CALLERS, 2))
        k1_before = _kernels.LAUNCHES["bucket_rounds_dict"]
        got["b_express"], lat_x, _ = serve_callers(card, legs["b_express"])
        bypass = saturation.express_snapshot()["lanes"]
        k1_express = _kernels.LAUNCHES["bucket_rounds_dict"] - k1_before
        # (c) GLOBAL and batched lanes, then a sync; the GLOBAL counters
        got["c"], _, _ = serve_callers(card, legs["c"])
        sync_card = card.global_mgr.run_once()
        # (d) one sampled epoch
        tracing.reset()
        tracing.set_sample_rate(1.0)
        try:
            traced = []
            for cols in legs["d"][0]:
                root = tracing.ingress_span("grpc", "/pb.gubernator.V1/GetRateLimits")
                with root:
                    traced.append(result_bytes(card.get_rate_limits_columns(cols)))
                root.end()
                spans = tracing.spans_snapshot(root.ctx.trace_hex)
                windows = [s for s in spans if s["name"] == "batch.window"]
                if len(windows) != 1 or {"trace_id": root.ctx.trace_hex,
                                         "span_id": root.ctx.span_hex} not in windows[0]["links"]:
                    raise AssertionError(f"no batch.window span links the request: {spans}")
                stages = sorted(s["name"] for s in spans
                                if s["name"].startswith("dispatch.")
                                and s["parent_id"] == windows[0]["span_id"])
                want = sorted(f"dispatch.{s}" for s in
                              ("prepare", "stage", "launch", "fetch", "commit"))
                if stages != want:
                    raise AssertionError(f"stage spans {stages} != {want}")
            got["d"] = [traced]
        finally:
            tracing.set_sample_rate(0.0)
        # (e) more than 256 configs, monthly Gregorian
        got["e"], _, _ = serve_callers(card, legs["e"])
        launches = {k: _kernels.LAUNCHES[k] for k in
                    ("bucket_rounds_dict", "bucket_rounds_cols", "global_answer_rounds",
                     "global_sync", "set_replica", "clear_gslots")}
        if dev == "cuda":
            for k in ("bucket_rounds_dict", "bucket_rounds_cols", "global_answer_rounds",
                      "global_sync"):
                if launches[k] == 0:
                    raise AssertionError(f"phase 11 launched no {k}")
            if k1_express == 0:
                raise AssertionError("the express bypass launched no K1 on the card")
        if bypass["bypass"] == 0:
            raise AssertionError("no request took the express bypass")

        # The CPU service, each caller's requests serially, in leg order.
        want = {leg: [[result_bytes(cpu.get_rate_limits_columns(cols)) for cols in script]
                      for script in scripts] for leg, scripts in legs.items()}
        sync_cpu = cpu.global_mgr.run_once()
        for leg in legs:
            for c, (g, w) in enumerate(zip(got[leg], want[leg])):
                if g != w:
                    raise AssertionError(f"phase 11 ({leg}), caller {c}: card != CPU")
        if (sync_card, sync_cpu) != (True, True):
            raise AssertionError(f"GLOBAL sync broadcast nothing: {sync_card}, {sync_cpu}")
        for a, b_ in zip(card.store.gcols, cpu.store.gcols):
            if not torch.equal(a.cpu(), b_):
                raise AssertionError("phase 11: replica columns differ after the sync")
        # Exact GLOBAL counters: every hit of (c) counted once.
        totals = collections.Counter()
        for cols in legs["c"][0]:
            for k, h in zip(cols.unique_keys, cols.hits):
                totals[k] += int(h)
        for svc in (card, cpu):
            probe = ingress("cfgg", ["gk0", "gk1", "shared"],
                            algorithm=np.zeros(3, np.int32),
                            behavior=np.full(3, int(Behavior.GLOBAL), np.int32),
                            limit=1_000)
            probe.hits[:] = 0
            res = svc.get_rate_limits_columns(probe)
            for i, k in enumerate(("gk0", "gk1", "shared")):
                r = res.response_at(i)
                if r.error or r.remaining != 1_000 - totals[k]:
                    raise AssertionError(f"GLOBAL counter of {k}: {r}, hits {totals[k]}")
        # Final per-key state (slots depend on coalescing, rows must not).
        sc, sp = card.store.snapshot_columns(NOW), cpu.store.snapshot_columns(NOW)

        def per_key(cols):
            rows = np.stack([np.asarray(getattr(cols, f), np.int64) for f in
                             ("algorithm", "status", "limit", "remaining", "duration",
                              "stamp", "expire_at")], axis=1)
            return dict(zip(cols.keys, map(tuple, rows.tolist())))

        if per_key(sc) != per_key(sp):
            raise AssertionError("phase 11: per-key state on the card != the CPU replay")
        n_keys = len(sc.keys)
    finally:
        card.close()
        cpu.close()

    lanes_a = SERVE_CALLERS * SERVE_REQS * SERVE_LANES
    lat_a, lat_b, lat_x = lat_a * 1e3, lat_b * 1e3, lat_x * 1e3
    log(f"[serve] (a) BASELINE config 2 at the service: {SERVE_CALLERS} callers x "
        f"{SERVE_REQS} requests of {SERVE_LANES} lanes (half async): "
        f"{lanes_a / wall_a:.0f} checks/s, request latency p50 {np.percentile(lat_a, 50):.3f} "
        f"ms, max {lat_a.max():.3f} ms of {lat_a.size}")
    flushes, lanes_w = express_a["dispatches"].get("windowed", 0), \
        express_a["lanes"].get("windowed", 0)
    log(f"[serve] (a) window: {flushes} flushes, {lanes_w / max(flushes, 1):.1f} lanes a "
        f"flush; pipeline depth high-water {hwm_a}; launches {launches_a['bucket_rounds_dict']} "
        f"K1")
    for stage in ("prepare", "stage", "launch", "fetch", "commit"):
        cnt, tot, mx = stats_a.get(stage, (0, 0.0, 0.0))
        log(f"[serve] (a) stage {stage}: {cnt} x, total {tot * 1e3:.3f} ms, max "
            f"{mx * 1e3:.3f} ms")
    for ph in ("batch.window", "queue.wait", "dispatch.prepare", "dispatch.stage",
               "dispatch.launch", "dispatch.fetch", "dispatch.commit"):
        s = phases_a.get(ph)
        if s:
            log(f"[serve] (a) saturation {ph}: p50 {s['p50_ms']} ms, p99 {s['p99_ms']} ms "
                f"of {s['n_samples']}, max {s['max_ms']} ms")
    used = sum(r["used"] for r in occupancy)
    cap = sum(r["capacity"] for r in occupancy)
    log(f"[serve] (a) occupancy {used} / {cap} slots, evictions "
        f"{sum(r['evictions'] for r in occupancy)}")
    log(f"[serve] (b) BASELINE config 1, NO_BATCHING: {EXPRESS_CALLERS} callers x "
        f"{EXPRESS_REQS} requests of 1 and 4 lanes: latency p50 "
        f"{np.percentile(lat_b, 50):.3f} ms, max {lat_b.max():.3f} ms of {lat_b.size}, "
        f"{wall_b:.2f} s; express bypass (100 BATCHING requests, one caller): p50 "
        f"{np.percentile(lat_x, 50):.3f} ms, max {lat_x.max():.3f} ms, {bypass['bypass']} "
        f"lanes bypassed, {k1_express} K1 launches")
    log(f"[serve] phase 11 launches: K1 {launches['bucket_rounds_dict']}, K2 "
        f"{launches['bucket_rounds_cols']}, K3 {launches['global_answer_rounds']}, K4 "
        f"{launches['global_sync']}, K5 {launches['set_replica']}, K6 "
        f"{launches['clear_gslots']}")
    log(f"[serve] card == CPU serial replay: every answer of (a)-(e), {n_keys} keys' rows, "
        f"replica columns, exact GLOBAL counters; trace spans batch.window + 5 dispatch.* "
        f"on {len(legs['d'][0])} requests ({time.perf_counter() - t_phase:.1f} s)")
    return launches


# ---------------------------------------------------------------------
# phase 12: the HTTP edge of one node
# ---------------------------------------------------------------------
EDGE_ADDR = "127.0.0.1:9981"  # the node's id in its ring of itself
EDGE_CONNS = 32  # phase 11's callers, now client connections
EDGE_REQS = 16
EDGE_B_REQS = 4  # (b) repeats (a)'s shape as JSON: fewer bodies, same widths
EDGE_LANES = 1_000
EDGE_NB_CONNS = 8
EDGE_NB_REQS = 100
EDGE_PEER_LANES = 5_000
EDGE_GLOBALS = 2_000
EDGE_TRANSFER_KEYS = 10_000
EDGE_TIMEOUT_S = 300.0


def edge_read(s):
    """One HTTP/1.1 response off socket `s`: (status, content type, body)."""
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = s.recv(1 << 20)
        if not chunk:
            raise ConnectionError(f"EOF mid-headers: {data[:200]!r}")
        data += chunk
    head, _, rest = data.partition(b"\r\n\r\n")
    status = int(head.split(b" ", 2)[1])
    headers = {}
    for line in head.split(b"\r\n")[1:]:
        k, _, v = line.partition(b":")
        headers[k.strip().lower()] = v.strip()
    n = int(headers.get(b"content-length", b"0"))
    while len(rest) < n:
        chunk = s.recv(1 << 20)
        if not chunk:
            raise ConnectionError("EOF mid-body")
        rest += chunk
    return status, headers.get(b"content-type", b"").decode(), rest[:n]


def edge_request(s, method, path, body=b""):
    s.sendall(f"{method} {path} HTTP/1.1\r\nHost: x\r\nContent-Length: {len(body)}\r\n\r\n"
              .encode() + body)
    return edge_read(s)


def edge_connect(address):
    import socket

    host, _, port = address.partition(":")
    s = socket.create_connection((host, int(port)), timeout=EDGE_TIMEOUT_S)
    s.settimeout(EDGE_TIMEOUT_S)
    return s


def edge_traffic():
    """Phase 12's bodies by leg: {leg: (path, [connection's [body]])}.
    Legs and connections own disjoint keys."""
    from gubernator_tpu_torch import wire
    from gubernator_tpu_torch.utils import gregorian

    rng = np.random.RandomState(12)
    per = N_KEYS // EDGE_CONNS

    def cols(name, keys, algorithm=1, behavior=0, limit=1_000_000, duration=3_600_000):
        n = len(keys)
        return ([name] * n, [str(k) for k in keys], np.full(n, algorithm, np.int32),
                np.full(n, behavior, np.int32) if np.isscalar(behavior)
                else np.asarray(behavior, np.int32),
                np.ones(n, np.int64),
                np.full(n, limit, np.int64) if np.isscalar(limit) else np.asarray(limit, np.int64),
                np.full(n, duration, np.int64))

    def as_json(c):
        return json.dumps(wire.peer_columns_to_classic_json(c)).encode()

    legs = {}
    # (a) BASELINE config 2 through the native pump: kind-5 frames of
    # 1,000 leaky lanes, connection c owning the ids = c mod 32 of a
    # 1,000,000-key Zipf 80/10 space.
    legs["a"] = ("/v1/GetRateLimits", [
        [wire.encode_ingress_frame(cols("edge2", zipf_ids(rng, per, EDGE_LANES) * EDGE_CONNS + c))
         for _ in range(EDGE_REQS)] for c in range(EDGE_CONNS)])
    # (b) the same traffic as JSON on the stdlib gateway, fewer bodies
    # a connection (the CPU node replays every one serially).
    legs["b"] = ("/v1/GetRateLimits", [
        [as_json(cols("edge2j", zipf_ids(rng, per, EDGE_LANES) * EDGE_CONNS + c))
         for _ in range(EDGE_B_REQS)] for c in range(EDGE_CONNS)])
    # (c) BASELINE config 1: NO_BATCHING token requests of 1 and 4 lanes.
    legs["c"] = ("/v1/GetRateLimits", [
        [as_json(cols("edge1", rng.randint(0, EXPRESS_KEYS // EDGE_NB_CONNS, 1 + 3 * (k % 2))
                      * EDGE_NB_CONNS + c, algorithm=0, behavior=1, limit=100_000,
                      duration=60_000))
         for k in range(EDGE_NB_REQS)] for c in range(EDGE_NB_CONNS)])
    # More than 256 configs, monthly Gregorian: the per-lane column wire (K2).
    legs["k2"] = ("/v1/GetRateLimits", [[as_json(cols(
        "edgem", rng.randint(0, 50_000, EDGE_LANES), behavior=4,
        limit=1_000_000 + np.arange(EDGE_LANES) % 300, duration=gregorian.GREGORIAN_MONTHS))]])
    # GLOBAL lanes beside batched ones (their keys apart): K3, then a sync (K4).
    glob = []
    for k in range(6):
        glob.append(as_json(cols(
            "edgeg", [f"b{(k * 7 + j) % 13}" for j in range(8)] + ["gk0", "gk1", "gk2"],
            algorithm=0, behavior=[0] * 8 + [2, 2, 2], limit=1_000)))
    legs["g"] = ("/v1/GetRateLimits", [glob])
    # The peer API's receiving half: a kind-1 frame of owned lanes.
    legs["peer"] = ("/v1/peer.GetPeerRateLimits", [[wire.encode_columns_frame(
        cols("edgep", rng.randint(0, 1_000_000, EDGE_PEER_LANES)))]])
    return legs


def edge_globals_frame():
    """A GLOBAL broadcast of EDGE_GLOBALS remote keys (kind 3)."""
    from gubernator_tpu_torch import wire
    from gubernator_tpu_torch.parallel.global_mgr import GlobalsColumns

    rng = np.random.RandomState(13)
    n = EDGE_GLOBALS
    return wire.encode_globals_frame(GlobalsColumns(
        keys=[f"edger_{i}" for i in range(n)], algorithm=rng.randint(0, 2, n).astype(np.int32),
        status=rng.randint(0, 2, n).astype(np.int32), limit=np.full(n, 5_000, np.int64),
        remaining=rng.randint(0, 5_000, n).astype(np.int64),
        reset_time=np.full(n, NOW + 3_600_000, np.int64)))


def edge_transfer_frame(ring_hash, n=None, seed=14):
    """A transfer of n (EDGE_TRANSFER_KEYS) keys' rows fenced on
    `ring_hash` (kind 4)."""
    from gubernator_tpu_torch import wire
    from gubernator_tpu_torch.reshard import TransferColumns

    n = EDGE_TRANSFER_KEYS if n is None else n
    rng = np.random.RandomState(seed)
    return wire.encode_transfer_frame(TransferColumns(
        keys=[f"edget_{seed}_{i}" for i in range(n)], algorithm=rng.randint(0, 2, n).astype(np.int32),
        status=np.zeros(n, np.int32), limit=np.full(n, 1_000, np.int64),
        remaining=rng.randint(0, 1_000, n).astype(np.int64),
        duration=np.full(n, 3_600_000, np.int64), stamp=np.full(n, NOW - 1_000, np.int64),
        expire_at=np.full(n, NOW + 3_599_000, np.int64), ring_hash=ring_hash))


def edge_clients(address, path, scripts):
    """Each connection sends its bodies in order on one keep-alive
    socket, the connections concurrent.  Returns (answers by
    connection, latencies in s, wall s)."""
    answers = [[None] * len(s) for s in scripts]
    lat, errors = [], []
    lat_lock = threading.Lock()

    def run(c):
        try:
            with edge_connect(address) as s:
                for k, body in enumerate(scripts[c]):
                    t0 = time.perf_counter()
                    answers[c][k] = edge_request(s, "POST", path, body)
                    with lat_lock:
                        lat.append(time.perf_counter() - t0)
        except BaseException as e:  # noqa: BLE001 — raised below, on the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(c,), name=f"conn-{c}")
               for c in range(len(scripts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=EDGE_TIMEOUT_S * 2)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("a phase 12 connection did not finish")
    if errors:
        raise errors[0]
    return answers, np.asarray(lat), wall


EDGE_KERNELS = ("bucket_rounds_dict", "bucket_rounds_cols", "global_answer_rounds",
                "global_sync", "set_replica", "clear_gslots", "gather_rows", "write_rows")


def edge_phase(torch, dev="cuda"):
    """Phase 12: the HTTP edge of one node over real sockets — the
    native epoll edge with its ingress pump and the stdlib gateway over
    one service at the main path's table size — held body by body to a
    node on the plain versions (CPU) fed each connection's bodies
    serially through the same gateway handler."""
    from gubernator_tpu_torch import gateway
    from gubernator_tpu_torch.config import setup_daemon_config
    from gubernator_tpu_torch.ops import _kernels
    from gubernator_tpu_torch.service import ServiceConfig, V1Service
    from gubernator_tpu_torch.types import PeerInfo
    from gubernator_tpu_torch.utils.clock import Clock

    t_phase = time.perf_counter()
    conf = setup_daemon_config(env=SERVE_ENV)

    def node(device):
        clock = Clock()
        clock.freeze(NOW)
        svc = V1Service(ServiceConfig(
            cache_size=conf.cache_size, back_cache_size=conf.back_cache_size,
            global_cache_size=conf.global_cache_size, behaviors=conf.behaviors,
            clock=clock, device=device, advertise_address=EDGE_ADDR))
        svc.set_peers([PeerInfo(grpc_address=EDGE_ADDR, is_owner=True)])
        svc.store.warmup(NOW, conf.warmup_shapes)
        return svc

    legs = edge_traffic()
    card = node(None if dev == "cuda" else dev)  # None: the current CUDA device
    cpu = node("cpu")
    native = gateway.NativeGatewayServer(card, "127.0.0.1:0")
    pump = gateway.NativeIngressPump(card).start()
    pump.update_ring()
    native.pump = pump
    native.start()
    stdlib = gateway.GatewayServer(card, "127.0.0.1:0")
    stdlib.start()
    launches, got, numbers = {}, {}, {}

    def counted(leg, fn):
        _kernels.reset_launch_counts()
        out = fn()
        launches[leg] = {k: _kernels.LAUNCHES[k] for k in EDGE_KERNELS}
        return out

    try:
        if card.store.device.type != (dev if dev != "cuda" else "cuda"):
            raise AssertionError(f"phase 12's service runs on {card.store.device}")
        st0 = pump.stats()
        card.store.take_pipeline_stats()  # drain the warmup's
        got["a"], lat_a, wall_a = counted("a", lambda: edge_clients(
            native.address, *legs["a"]))
        st_a = pump.stats()
        stages_a, _, hwm_a = card.store.take_pipeline_stats()
        got["b"], lat_b, wall_b = counted("b", lambda: edge_clients(
            stdlib.address, *legs["b"]))
        got["c"], lat_c, wall_c = counted("c", lambda: edge_clients(
            native.address, *legs["c"]))
        got["k2"], _, _ = counted("k2", lambda: edge_clients(native.address, *legs["k2"]))
        got["g"], _, _ = counted("g", lambda: edge_clients(native.address, *legs["g"]))
        sync_card = counted("sync", card.global_mgr.run_once)
        got["peer"], lat_p, _ = counted("peer", lambda: edge_clients(
            native.address, *legs["peer"]))
        gframe = edge_globals_frame()
        tframe = edge_transfer_frame(card.ring_hash)
        fenced = edge_transfer_frame(card.ring_hash ^ 1, n=100, seed=15)
        with edge_connect(native.address) as s:
            t0 = time.perf_counter()
            got_globals = counted("globals", lambda: edge_request(
                s, "POST", "/v1/peer.UpdatePeerGlobals", gframe))
            numbers["globals_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            got_transfer = counted("transfer", lambda: edge_request(
                s, "POST", "/v1/peer.TransferOwnership", tframe))
            numbers["transfer_ms"] = (time.perf_counter() - t0) * 1e3
            got_fenced = counted("fenced", lambda: edge_request(
                s, "POST", "/v1/peer.TransferOwnership", fenced))
            debug = {}
            for path in ("/v1/HealthCheck", "/debug/status", "/debug/latency",
                         "/debug/device", "/debug/audit", "/debug/tenants"):
                t0 = time.perf_counter()
                debug[path] = edge_request(s, "GET", path) + (
                    (time.perf_counter() - t0) * 1e3,)
        st_end = pump.stats()
        if dev == "cuda":
            need = {"a": ("bucket_rounds_dict",), "k2": ("bucket_rounds_cols",),
                    "g": ("global_answer_rounds",), "sync": ("global_sync",),
                    "peer": ("bucket_rounds_dict",), "globals": ("set_replica",)}
            for leg, kernels in need.items():
                for k in kernels:
                    if launches[leg][k] == 0:
                        raise AssertionError(f"phase 12 ({leg}) launched no {k}")
            if (launches["transfer"]["gather_rows"], launches["transfer"]["write_rows"]) != (1, 1):
                raise AssertionError(f"a transfer took {launches['transfer']} launches, "
                                     "not one K7 and one K8")
        if st_a["frames"] - st0["frames"] != EDGE_CONNS * EDGE_REQS or st_a["fallbacks"]:
            raise AssertionError(f"the native pump did not take every frame of (a): {st_a}")
        if got_transfer[:2] != (200, "application/json") or json.loads(got_transfer[2]) != {
                "committed": EDGE_TRANSFER_KEYS, "rejected": 0}:
            raise AssertionError(f"transfer answered {got_transfer}")
        if got_fenced[0] != 409 or any(launches["fenced"].values()):
            raise AssertionError(f"a fenced transfer answered {got_fenced[:2]}, "
                                 f"launches {launches['fenced']}")
        for path, (status, ctype, body, _ms) in debug.items():
            keys = set(json.loads(body))
            want = {"/v1/HealthCheck": {"status", "peerCount"},
                    "/debug/status": {"health", "occupancy", "ring", "audit", "xla"},
                    "/debug/latency": {"phases", "express", "slo"},
                    "/debug/device": {"compiles", "devices", "programRuns"},
                    "/debug/audit": {"ledger", "violations", "invariants"},
                    "/debug/tenants": {"topk", "other", "totals"}}[path]
            if status != 200 or not want <= keys:
                raise AssertionError(f"{path}: {status}, keys {sorted(keys)}")
        devices = json.loads(debug["/debug/device"][2])["devices"]
        if dev == "cuda" and not (devices and devices[0]["bytes_in_use"] > 0):
            raise AssertionError(f"/debug/device shows no CUDA memory: {devices}")
        audit_doc = json.loads(debug["/debug/audit"][2])

        # The CPU node, each connection's bodies serially, in leg order,
        # through the same gateway handler.
        def replay(path, body, method="POST"):
            return gateway.handle_request(cpu, method, path, body)

        for leg, (path, scripts) in legs.items():
            for c, script in enumerate(scripts):
                want = [replay(path, body) for body in script]
                if got[leg][c] != want:
                    k = next(i for i, (g, w) in enumerate(zip(got[leg][c], want)) if g != w)
                    raise AssertionError(f"phase 12 ({leg}) connection {c} body {k}: card "
                                         f"{got[leg][c][k][:2]} != CPU {want[k][:2]}")
            if leg == "g":
                sync_cpu = cpu.global_mgr.run_once()
        if (sync_card, sync_cpu) != (True, True):
            raise AssertionError(f"GLOBAL sync broadcast nothing: {sync_card}, {sync_cpu}")
        for got_, body, path in ((got_globals, gframe, "/v1/peer.UpdatePeerGlobals"),
                                 (got_transfer, tframe, "/v1/peer.TransferOwnership"),
                                 (got_fenced, fenced, "/v1/peer.TransferOwnership")):
            if got_ != replay(path, body):
                raise AssertionError(f"phase 12 {path}: card {got_[:2]} != CPU")
        for a, b_ in zip(card.store.gcols, cpu.store.gcols):
            if not torch.equal(a.cpu(), b_):
                raise AssertionError("phase 12: replica columns differ")
        sc, sp = card.store.snapshot_columns(NOW), cpu.store.snapshot_columns(NOW)

        def per_key(cols):
            rows = np.stack([np.asarray(getattr(cols, f), np.int64) for f in
                             ("algorithm", "status", "limit", "remaining", "duration",
                              "stamp", "expire_at")], axis=1)
            return dict(zip(cols.keys, map(tuple, rows.tolist())))

        if per_key(sc) != per_key(sp):
            raise AssertionError("phase 12: per-key state on the card != the CPU replay")
        n_keys = len(sc.keys)
    finally:
        native.close()
        stdlib.close()
        card.close()
        cpu.close()

    def lat_line(lat):
        lat = lat * 1e3
        return (f"request latency p50 {np.percentile(lat, 50):.3f} ms, max {lat.max():.3f} ms "
                f"of {lat.size}")

    lanes = EDGE_CONNS * EDGE_REQS * EDGE_LANES
    takes = st_a["batches"] - st0["batches"]
    log(f"[edge] (a) BASELINE config 2 at the native edge: {EDGE_CONNS} connections x "
        f"{EDGE_REQS} kind-5 frames of {EDGE_LANES} leaky lanes: {lanes / wall_a:.0f} checks/s, "
        f"{lat_line(lat_a)}; {takes} takes, {(st_a['lanes'] - st0['lanes']) / max(takes, 1):.1f} "
        f"lanes a take; K1 {launches['a']['bucket_rounds_dict']}")
    log(f"[edge] (a) pump stats after (a): {json.dumps(st_a)}; pipeline depth high-water "
        f"{hwm_a}")
    for stage in ("prepare", "stage", "launch", "fetch", "commit"):
        cnt, tot, mx = stages_a.get(stage, (0, 0.0, 0.0))
        log(f"[edge] (a) take stage {stage}: {cnt} x, mean {tot / max(cnt, 1) * 1e3:.3f} ms, "
            f"max {mx * 1e3:.3f} ms")
    log(f"[edge] (b) the same traffic as JSON on the stdlib gateway ({EDGE_B_REQS} bodies a "
        f"connection): {EDGE_CONNS * EDGE_B_REQS * EDGE_LANES / wall_b:.0f} checks/s, "
        f"{lat_line(lat_b)}; K1 {launches['b']['bucket_rounds_dict']}")
    log(f"[edge] (c) BASELINE config 1, NO_BATCHING JSON of 1 and 4 lanes at the native edge: "
        f"{EDGE_NB_CONNS} connections x {EDGE_NB_REQS}: {lat_line(lat_c)}, {wall_c:.2f} s; "
        f"K1 {launches['c']['bucket_rounds_dict']}")
    log(f"[edge] (d) peer routes: a kind-1 frame of {EDGE_PEER_LANES} owned lanes "
        f"{lat_p.max() * 1e3:.3f} ms (K1 {launches['peer']['bucket_rounds_dict']}); a globals "
        f"frame of {EDGE_GLOBALS} keys {numbers['globals_ms']:.3f} ms (K5 "
        f"{launches['globals']['set_replica']}, K6 {launches['globals']['clear_gslots']}); a "
        f"transfer of {EDGE_TRANSFER_KEYS} keys {numbers['transfer_ms']:.3f} ms (K7 "
        f"{launches['transfer']['gather_rows']}, K8 {launches['transfer']['write_rows']}); a "
        f"fenced transfer answered {got_fenced[0]}")
    log("[edge] (e) " + ", ".join(f"{p} {v[0]} in {v[3]:.3f} ms" for p, v in debug.items()))
    log(f"[edge] pump stats at the end: {json.dumps(st_end)}; audit violations "
        f"{audit_doc['violationTotal']}")
    total = collections.Counter()
    for leg in launches.values():
        total.update(leg)
    log(f"[edge] phase 12 launches: K1 {total['bucket_rounds_dict']}, K2 "
        f"{total['bucket_rounds_cols']}, K3 {total['global_answer_rounds']}, K4 "
        f"{total['global_sync']}, K5 {total['set_replica']}, K6 {total['clear_gslots']}, K7 "
        f"{total['gather_rows']}, K8 {total['write_rows']}")
    log(f"[edge] card == CPU serial replay: every body of (a)-(d), the globals commit, the "
        f"transfers, {n_keys} keys' rows, replica columns ({time.perf_counter() - t_phase:.1f} s)")
    return dict(total)


# ---------------------------------------------------------------------
# phase 13: the daemon, as its own process
# ---------------------------------------------------------------------
DAEMON_ADDR = "127.0.0.1:9983"  # the daemon's advertised id, its ring of itself
DAEMON_ENV = {
    "GUBER_CACHE_SIZE": "2097152",  # the main path's 8 x 262,144 slots
    "GUBER_BATCH_WAIT": "500us",
    "GUBER_GLOBAL_SYNC_WAIT": "100ms",  # the daemon's own sync timer
    "GUBER_PEER_DISCOVERY_TYPE": "static",
    "GUBER_ADVERTISE_ADDRESS": DAEMON_ADDR,
    "GUBER_STATIC_PEERS": DAEMON_ADDR,  # static discovery of itself
}
DAEMON_CONNS = 32  # (a): phase 12's connections, through ColumnsV1Client
DAEMON_REQS = 16
DAEMON_LANES = 1_000
DAEMON_CHANNELS = 8  # (b): gRPC channels
DAEMON_CALLS = 8
DAEMON_NB_CONNS = 8  # (c): NO_BATCHING JSON
DAEMON_NB_REQS = 50
DAEMON_SYNC_GAP_S = 1.0  # (c): ten sync periods between the GLOBAL requests
DAEMON_START_S = 600.0
DAEMON_TIMEOUT_S = 300.0


def parity_families():
    """REFERENCE_PARITY | EXTENSIONS of scripts/check_metrics_parity.py,
    read from its source (the script imports the JAX package)."""
    import ast

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "check_metrics_parity.py")
    sets = {}
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) and \
                node.targets[0].id in ("REFERENCE_PARITY", "EXTENSIONS"):
            sets[node.targets[0].id] = set(ast.literal_eval(node.value.args[0]))
    if set(sets) != {"REFERENCE_PARITY", "EXTENSIONS"}:
        raise AssertionError(f"metric sets not found in {path}")
    return sets["REFERENCE_PARITY"] | sets["EXTENSIONS"]


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_env(path, env):
    with open(path, "w") as f:
        f.write("".join(f"{k}={v}\n" for k, v in env.items()))


class DaemonProcess:
    """The port's server binary as a subprocess: stdout read line by
    line on a thread, stderr to a file."""

    def __init__(self, env_file, err_path, device):
        import queue

        env = {k: v for k, v in os.environ.items() if not k.startswith("GUBER_")}
        root = os.path.dirname(os.path.abspath(__file__))
        env["PYTHONPATH"] = root
        if device == "cpu":
            env["GUBER_TORCH_DEVICE"] = "cpu"
        self.err_path = err_path
        self._err = open(err_path, "w")
        self.lines = queue.Queue()
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "gubernator_tpu_torch.cmd.server", "-config", env_file,
             "-frozen-clock-ms", str(NOW)],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=self._err, text=True)
        threading.Thread(target=self._read, daemon=True).start()
        line = self.wait_line("listening on http://", DAEMON_START_S)
        self.startup_s = time.perf_counter() - t0
        self.http = line.split("http://")[1].split()[0]
        self.grpc = line.split("grpc ")[1].split(",")[0]

    def _read(self):
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def wait_line(self, needle, timeout_s):
        import queue

        deadline = time.monotonic() + timeout_s
        while True:
            try:
                line = self.lines.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                line = None
            if line is not None and needle in line:
                return line
            if line is None or time.monotonic() > deadline:
                self.kill()
                with open(self.err_path) as f:
                    tail = f.read()[-4000:]
                raise AssertionError(f"the daemon never printed {needle!r} "
                                     f"(exit {self.proc.poll()}):\n{tail}")

    def stop(self):
        """SIGTERM; returns (the stop line, seconds to it)."""
        import signal

        t0 = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        line = self.wait_line("stopped", DAEMON_TIMEOUT_S)
        if self.proc.wait(timeout=DAEMON_TIMEOUT_S) != 0:
            raise AssertionError(f"the daemon exited {self.proc.returncode}")
        self._err.close()
        return line, time.perf_counter() - t0

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
        self._err.close()


def daemon_traffic():
    """Phase 13's requests by leg, disjoint keys per leg and connection."""
    from gubernator_tpu_torch.types import GetRateLimitsRequest, RateLimitRequest
    from gubernator_tpu_torch.utils import gregorian

    rng = np.random.RandomState(13)
    per = N_KEYS // DAEMON_CONNS

    def cols(name, keys, algorithm=1, behavior=0, limit=1_000_000, duration=3_600_000):
        n = len(keys)
        return ([name] * n, [str(k) for k in keys], np.full(n, algorithm, np.int32),
                np.full(n, behavior, np.int32) if np.isscalar(behavior)
                else np.asarray(behavior, np.int32),
                np.ones(n, np.int64),
                np.full(n, limit, np.int64) if np.isscalar(limit) else np.asarray(limit, np.int64),
                np.full(n, duration, np.int64))

    def request(c):
        return GetRateLimitsRequest(requests=[
            RateLimitRequest(name=c[0][i], unique_key=c[1][i], algorithm=int(c[2][i]),
                             behavior=int(c[3][i]), hits=int(c[4][i]), limit=int(c[5][i]),
                             duration=int(c[6][i])) for i in range(len(c[0]))])

    legs = {}
    # (a) BASELINE config 2: 1,000 leaky lanes a frame, connection c on
    # the ids = c mod 32 of a 1,000,000-key Zipf 80/10 space.
    legs["a"] = [[cols("dmn2", zipf_ids(rng, per, DAEMON_LANES) * DAEMON_CONNS + c)
                  for _ in range(DAEMON_REQS)] for c in range(DAEMON_CONNS)]
    # (b) the same shape over gRPC GetRateLimitsColumns.
    legs["b"] = [[cols("dmn2g", zipf_ids(rng, per, DAEMON_LANES) * DAEMON_CHANNELS + c)
                  for _ in range(DAEMON_CALLS)] for c in range(DAEMON_CHANNELS)]
    # (c) BASELINE config 1: NO_BATCHING token requests of 1 and 4 lanes.
    legs["c"] = [[request(cols("dmn1", rng.randint(0, EXPRESS_KEYS // DAEMON_NB_CONNS,
                                                     1 + 3 * (k % 2)) * DAEMON_NB_CONNS + c,
                               algorithm=0, behavior=1, limit=100_000, duration=60_000))
                  for k in range(DAEMON_NB_REQS)] for c in range(DAEMON_NB_CONNS)]
    # GLOBAL lanes beside batched ones, twice, a sync between them.
    legs["g"] = [request(cols("dmng", [f"b{j}" for j in range(8)] + ["gk0", "gk1", "gk2"],
                              algorithm=0, behavior=[0] * 8 + [2, 2, 2], limit=1_000))
                 for _ in range(2)]
    # More than 256 configs, monthly Gregorian: the per-lane column wire (K2).
    legs["k2"] = request(cols("dmnm", rng.randint(0, 50_000, DAEMON_LANES), behavior=4,
                              limit=1_000_000 + np.arange(DAEMON_LANES) % 300,
                              duration=gregorian.GREGORIAN_MONTHS))
    return legs


def result_rows(rc, lo=0, hi=None):
    """A ColumnarResult's lanes [lo, hi) as comparable bytes."""
    hi = rc.n if hi is None else hi
    arrays = b"".join(np.ascontiguousarray(np.asarray(getattr(rc, f))[lo:hi], np.int64).tobytes()
                      for f in ("status", "limit", "remaining", "reset_time"))
    over = sorted((i - lo, r.to_json()) for i, r in rc.overrides.items() if lo <= i < hi)
    return arrays + json.dumps(over).encode()


def daemon_legs(http, grpc_addr, legs, concurrent, sleep=time.sleep):
    """Phase 13 (a)-(c) against the daemon at `http` / `grpc_addr`:
    concurrent connections (the card) or each connection's requests
    serially (the replay).  Returns (answers by leg, latencies, walls)."""
    from gubernator_tpu_torch.client import ColumnsV1Client, GrpcV1Client, V1Client

    answers, lat, wall = {}, collections.defaultdict(list), {}
    lat_lock = threading.Lock()

    def run(leg, conns, open_client, call):
        out = [[None] * len(s) for s in conns]
        errors = []

        def one(c):
            client = open_client()
            try:
                for k, item in enumerate(conns[c]):
                    t0 = time.perf_counter()
                    out[c][k] = call(client, item)
                    with lat_lock:
                        lat[leg].append(time.perf_counter() - t0)
            except BaseException as e:  # noqa: BLE001 — raised below, on this thread
                errors.append(e)
            finally:
                client.close()

        t0 = time.perf_counter()
        if concurrent:
            threads = [threading.Thread(target=one, args=(c,)) for c in range(len(conns))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=DAEMON_TIMEOUT_S * 2)
            if any(t.is_alive() for t in threads):
                raise AssertionError(f"a phase 13 ({leg}) connection did not finish")
        else:
            for c in range(len(conns)):
                one(c)
        wall[leg] = time.perf_counter() - t0
        if errors:
            raise errors[0]
        answers[leg] = out

    def frame(client, cols):
        rc, lo, hi = client.submit_columns(cols).result(timeout=DAEMON_TIMEOUT_S)
        return result_rows(rc, lo, hi)

    def json_req(client, req):
        return json.dumps([r.to_json() for r in client.get_rate_limits(req).responses])

    run("a", legs["a"], lambda: ColumnsV1Client(http, timeout_s=DAEMON_TIMEOUT_S,
                                                connections=1), frame)
    run("b", legs["b"], lambda: GrpcV1Client(grpc_addr, timeout_s=DAEMON_TIMEOUT_S),
        lambda client, cols: result_rows(client.get_rate_limits_columns(cols)))
    run("c", legs["c"], lambda: V1Client(http, timeout_s=DAEMON_TIMEOUT_S), json_req)
    client = V1Client(http, timeout_s=DAEMON_TIMEOUT_S)
    try:
        answers["g"] = [json_req(client, legs["g"][0])]
        sleep(DAEMON_SYNC_GAP_S)  # the daemon's sync timer runs in the gap
        answers["g"].append(json_req(client, legs["g"][1]))
        answers["k2"] = json_req(client, legs["k2"])
    finally:
        client.close()
    with edge_connect(http) as s:
        answers["globals"] = edge_request(s, "POST", "/v1/peer.UpdatePeerGlobals",
                                          edge_globals_frame())
        answers["health"] = edge_request(s, "GET", "/v1/HealthCheck")
    return answers, lat, wall


def daemon_more(http, grpc_addr, legs):
    """One more request of each kind, after the restart."""
    from gubernator_tpu_torch.client import ColumnsV1Client, GrpcV1Client, V1Client

    out = []
    c = ColumnsV1Client(http, timeout_s=DAEMON_TIMEOUT_S, connections=1)
    try:
        rc, lo, hi = c.submit_columns(legs["a"][0][0]).result(timeout=DAEMON_TIMEOUT_S)
        out.append(result_rows(rc, lo, hi))
    finally:
        c.close()
    g = GrpcV1Client(grpc_addr, timeout_s=DAEMON_TIMEOUT_S)
    try:
        out.append(result_rows(g.get_rate_limits_columns(legs["b"][0][0])))
        out.append(g.health_check().to_json())
    finally:
        g.close()
    v = V1Client(http, timeout_s=DAEMON_TIMEOUT_S)
    try:
        out.append([r.to_json() for r in v.get_rate_limits(legs["c"][0][1]).responses])
        out.append([r.to_json() for r in v.get_rate_limits(legs["g"][1]).responses])
    finally:
        v.close()
    return out


def same_snapshot(a, b):
    """Two snapshot files hold the same header and the same row for
    every key.  Their lane order is the slot tables' key order, which
    the concurrent connections' arrival order fixes on the card and
    the serial replay fixes on the CPU, so equal bytes are reported, not
    required.  Returns whether the bytes are equal."""
    from gubernator_tpu_torch import snapshot

    if len(a) < 64 or len(a) != len(b):
        raise AssertionError(f"phase 13: the snapshot file ({len(a)} B) != the CPU "
                             f"replay's ({len(b)} B)")
    docs = []
    for raw in (a, b):
        with tempfile.NamedTemporaryFile(suffix=".snap") as f:
            f.write(raw)
            f.flush()
            cols, meta = snapshot.read_snapshot(f.name)
        rows = np.stack([np.asarray(getattr(cols, k), np.int64) for k in
                         ("algorithm", "status", "limit", "remaining", "duration",
                          "stamp", "expire_at")], axis=1)
        docs.append((meta, dict(zip(cols.keys, map(tuple, rows.tolist())))))
    if docs[0] != docs[1]:
        raise AssertionError("phase 13: the snapshot's header or a key's row != the CPU "
                             "replay's")
    return a == b


def metric_values(page, families):
    """{(sample, labels): value} of `families` on an exposition page."""
    from prometheus_client.parser import text_string_to_metric_families

    out = {}
    for fam in text_string_to_metric_families(page):
        if fam.name in families:
            for s in fam.samples:
                if not s.name.endswith("_created"):
                    out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


def http_json(address, method, path, body=b""):
    with edge_connect(address) as s:
        status, _, raw = edge_request(s, method, path, body)
    if status != 200:
        raise AssertionError(f"{method} {path}: {status} {raw[:200]!r}")
    return json.loads(raw)


def tls_legs(http, grpc_addr, ca_file):
    """(f): JSON over HTTPS and gRPC over TLS, trusting `ca_file` (None:
    the plain replay)."""
    import grpc

    from gubernator_tpu_torch.client import GrpcV1Client, V1Client
    from gubernator_tpu_torch.tls import client_context
    from gubernator_tpu_torch.types import GetRateLimitsRequest, RateLimitRequest

    ctx = client_context(ca_file=ca_file) if ca_file else None
    creds = None
    if ca_file:
        with open(ca_file, "rb") as f:
            creds = grpc.ssl_channel_credentials(root_certificates=f.read())
    out = []
    v = V1Client(http, timeout_s=DAEMON_TIMEOUT_S, tls_context=ctx)
    g = GrpcV1Client(grpc_addr, timeout_s=DAEMON_TIMEOUT_S, credentials=creds)
    try:
        for k in range(4):
            req = GetRateLimitsRequest(requests=[RateLimitRequest(
                name="dmnt", unique_key=f"t{(k * 3 + j) % 5}", hits=1, limit=6,
                duration=60_000, algorithm=k % 2) for j in range(4)])
            out.append([r.to_json() for r in v.get_rate_limits(req).responses])
            out.append([r.to_json() for r in g.get_rate_limits(req).responses])
        out.append(v.health_check().to_json())
        out.append(g.health_check().to_json())
    finally:
        v.close()
        g.close()
    return out


DAEMON_KERNELS = ("bucket_rounds_dict", "bucket_rounds_cols", "global_answer_rounds",
                  "global_sync", "set_replica", "clear_gslots", "gather_rows", "write_rows")


def daemon_phase(torch, dev="cuda"):
    """Phase 13: the port's server binary as its own process on the card
    (BASELINE config 2 frames through ColumnsV1Client, the same shape
    over gRPC, config 1 NO_BATCHING JSON, GLOBAL lanes and a sync, a K2
    batch, a globals frame, a /metrics scrape, SIGTERM with its snapshot,
    a restart that restores it, and a TLS daemon), held answer by answer
    to a port daemon on the plain versions (CPU) in this process fed each
    connection's requests serially, both on a frozen clock."""
    from gubernator_tpu_torch import tls
    from gubernator_tpu_torch.config import setup_daemon_config
    from gubernator_tpu_torch.daemon import Daemon
    from gubernator_tpu_torch.utils.clock import Clock

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-daemon-")
    legs = daemon_traffic()
    snap = os.path.join(tmp, "card.snap")
    env = dict(DAEMON_ENV, GUBER_HTTP_ADDRESS=f"127.0.0.1:{free_port()}",
               GUBER_GRPC_ADDRESS=f"127.0.0.1:{free_port()}", GUBER_NATIVE_HTTP="1",
               GUBER_SNAPSHOT=snap)
    env_file = os.path.join(tmp, "daemon.env")
    write_env(env_file, env)
    numbers = {}
    d = DaemonProcess(env_file, os.path.join(tmp, "daemon.err"), dev)
    try:
        numbers["startup_s"] = d.startup_s
        boot = http_json(d.http, "POST", "/debug/launches")["launches"]  # counts now 0
        got, lat, wall = daemon_legs(d.http, d.grpc, legs, concurrent=True)
        t0 = time.perf_counter()
        with edge_connect(d.http) as s:
            status, ctype, page = edge_request(s, "GET", "/metrics")
        numbers["scrape_ms"] = (time.perf_counter() - t0) * 1e3
        run = http_json(d.http, "POST", "/debug/launches")["launches"]
        stop_line, numbers["stop_s"] = d.stop()
    except BaseException:
        d.kill()
        raise
    with open(snap, "rb") as f:
        card_snap = f.read()
    save = json.loads(stop_line.split("kernel launches ", 1)[1].rsplit(")", 1)[0])
    numbers["save_s"] = float(stop_line.split("snapshot save ")[1].split(" s")[0])
    if status != 200 or not ctype.startswith("text/plain"):
        raise AssertionError(f"GET /metrics answered {status} {ctype}")
    page = page.decode()
    from prometheus_client.parser import text_string_to_metric_families

    families = {f.name for f in text_string_to_metric_families(page)}
    families = {f for f in families if not f.endswith("_created")}
    if families != parity_families():
        raise AssertionError(f"/metrics families != scripts/check_metrics_parity.py: "
                             f"missing {sorted(parity_families() - families)}, "
                             f"unexpected {sorted(families - parity_families())}")
    # The restart restores the snapshot (K7 + K8 at boot) and answers.
    d = DaemonProcess(env_file, os.path.join(tmp, "daemon2.err"), dev)
    try:
        numbers["restart_s"] = d.startup_s
        restore = http_json(d.http, "POST", "/debug/launches")["launches"]
        status_doc = http_json(d.http, "GET", "/debug/status")
        more = daemon_more(d.http, d.grpc, legs)
        d.stop()
    except BaseException:
        d.kill()
        raise
    snap_doc = status_doc["snapshot"]
    numbers["restore_s"] = snap_doc["lastRestoreSeconds"]
    # (f) a second daemon, TLS on its own certificates from a CA made
    # here, the stdlib gateway.
    ca_crt, ca_key = tls.self_ca(tmp)
    tls_env = dict(DAEMON_ENV, GUBER_HTTP_ADDRESS=f"127.0.0.1:{free_port()}",
                   GUBER_GRPC_ADDRESS=f"127.0.0.1:{free_port()}", GUBER_TLS_AUTO="1",
                   GUBER_TLS_CA=ca_crt, GUBER_TLS_CA_KEY=ca_key)
    tls_file = os.path.join(tmp, "tls.env")
    write_env(tls_file, tls_env)
    d = DaemonProcess(tls_file, os.path.join(tmp, "tls.err"), dev)
    try:
        numbers["tls_startup_s"] = d.startup_s
        got_tls = tls_legs(d.http, d.grpc, ca_crt)
        d.stop()
    except BaseException:
        d.kill()
        raise

    # The replay: a port daemon on the plain versions in this process,
    # each connection's requests serially, the same frozen clock.
    t_replay = time.perf_counter()

    def cpu_daemon(extra):
        conf = setup_daemon_config(env=dict(DAEMON_ENV, GUBER_HTTP_ADDRESS="127.0.0.1:0",
                                            GUBER_GRPC_ADDRESS="127.0.0.1:0",
                                            GUBER_TORCH_DEVICE="cpu", **extra))
        clock = Clock()
        clock.freeze(NOW)
        return Daemon(conf, clock=clock).start()

    cpu_snap = os.path.join(tmp, "cpu.snap")
    ref = cpu_daemon({"GUBER_NATIVE_HTTP": "1", "GUBER_SNAPSHOT": cpu_snap})
    try:
        want, _, _ = daemon_legs(ref.gateway.address, ref.grpc.address, legs, concurrent=False)
        with edge_connect(ref.gateway.address) as s:
            want_page = edge_request(s, "GET", "/metrics")[2].decode()
    finally:
        ref.close()
    with open(cpu_snap, "rb") as f:
        cpu_snap_bytes = f.read()
    ref = cpu_daemon({"GUBER_NATIVE_HTTP": "1", "GUBER_SNAPSHOT": cpu_snap})
    try:
        want_more = daemon_more(ref.gateway.address, ref.grpc.address, legs)
    finally:
        ref.close()
    ref = cpu_daemon({})
    try:
        want_tls = tls_legs(ref.gateway.address, ref.grpc.address, None)
    finally:
        ref.close()
    numbers["replay_s"] = time.perf_counter() - t_replay
    shutil.rmtree(tmp, ignore_errors=True)

    for leg in ("a", "b", "c"):
        for c, (g, w) in enumerate(zip(got[leg], want[leg])):
            if g != w:
                k = next(i for i, (x, y) in enumerate(zip(g, w)) if x != y)
                raise AssertionError(f"phase 13 ({leg}) connection {c} request {k}: "
                                     "card != CPU replay")
    for leg in ("g", "k2", "globals", "health"):
        if got[leg] != want[leg]:
            raise AssertionError(f"phase 13 ({leg}): card != CPU replay")
    if more != want_more:
        raise AssertionError("phase 13 (e): the restarted daemon's answers != CPU replay")
    if got_tls != want_tls:
        raise AssertionError("phase 13 (f): the TLS daemon's answers != CPU replay")
    snap_same = same_snapshot(card_snap, cpu_snap_bytes)
    if snap_doc["restore"] != "ok" or snap_doc["restoredLanes"] <= 0:
        raise AssertionError(f"phase 13 (e): the restart restored {snap_doc}")
    fams = ("gubernator_cache_access_count", "gubernator_cache_size",
            "gubernator_grpc_request_counts", "gubernator_snapshot_restores",
            "gubernator_ingress_columns_batches")
    mine, theirs = metric_values(page, fams), metric_values(want_page, fams)
    if mine != theirs:
        raise AssertionError(f"phase 13 (d): /metrics {mine} != the CPU replay's {theirs}")
    sent = {"/pb.gubernator.V1/GetRateLimits": DAEMON_CONNS * DAEMON_REQS
            + DAEMON_NB_CONNS * DAEMON_NB_REQS + 3,
            "/pb.gubernator.V1/GetRateLimitsColumns": DAEMON_CHANNELS * DAEMON_CALLS,
            "/pb.gubernator.PeersV1/UpdatePeerGlobals": 1,
            "/pb.gubernator.V1/HealthCheck": 1}
    counted = {dict(lab)["method"]: v for (name, lab), v in mine.items()
               if name == "gubernator_grpc_request_counts_total"}
    if counted != sent:
        raise AssertionError(f"phase 13 (d): request counts {counted} != sent {sent}")
    hits = mine[("gubernator_cache_access_count_total", (("type", "hit"),))]
    misses = mine[("gubernator_cache_access_count_total", (("type", "miss"),))]
    if dev == "cuda":
        for k in ("bucket_rounds_dict", "bucket_rounds_cols", "global_answer_rounds",
                  "global_sync", "set_replica"):
            if run[k] == 0:
                raise AssertionError(f"phase 13's run launched no {k}: {run}")
        if save["gather_rows"] < 1:
            raise AssertionError(f"the snapshot save launched no K7: {save}")
        if (restore["gather_rows"], restore["write_rows"]) != (1, 1):
            raise AssertionError(f"the restore took {restore}, not one K7 and one K8")

    def lat_line(leg):
        v = np.asarray(lat[leg]) * 1e3
        return f"request p50 {np.percentile(v, 50):.3f} ms, max {v.max():.3f} ms of {v.size}"

    def k(c):
        return ", ".join(f"K{i} {c[n]}" for i, n in zip((1, 2, 3, 4, 5, 6, 7, 8), DAEMON_KERNELS))

    log(f"[daemon] startup {numbers['startup_s']:.2f} s (process start to listening: "
        f"imports, kernel load, warmup; {k(boot)}); restart {numbers['restart_s']:.2f} s; "
        f"TLS daemon {numbers['tls_startup_s']:.2f} s")
    log(f"[daemon] (a) BASELINE config 2 through ColumnsV1Client: {DAEMON_CONNS} connections x "
        f"{DAEMON_REQS} kind-5 frames of {DAEMON_LANES} lanes: "
        f"{DAEMON_CONNS * DAEMON_REQS * DAEMON_LANES / wall['a']:.0f} checks/s, {lat_line('a')}")
    log(f"[daemon] (b) the same shape over gRPC GetRateLimitsColumns: {DAEMON_CHANNELS} channels "
        f"x {DAEMON_CALLS} calls: "
        f"{DAEMON_CHANNELS * DAEMON_CALLS * DAEMON_LANES / wall['b']:.0f} checks/s, "
        f"{lat_line('b')}")
    log(f"[daemon] (c) BASELINE config 1, NO_BATCHING JSON of 1 and 4 lanes, {DAEMON_NB_CONNS} "
        f"connections x {DAEMON_NB_REQS}: {lat_line('c')}; GLOBAL lanes with a sync between, "
        f"a 300-config monthly batch, a globals frame")
    log(f"[daemon] (d) GET /metrics {numbers['scrape_ms']:.3f} ms: {len(families)} families == "
        f"scripts/check_metrics_parity.py; cache hits {hits:.0f}, misses {misses:.0f}, request "
        f"counts {json.dumps(counted)} == sent == CPU replay")
    log(f"[daemon] (e) SIGTERM: snapshot save {numbers['save_s']:.3f} s ({len(card_snap)} B, "
        f"stop {numbers['stop_s']:.2f} s; {k(save)}); restart restored "
        f"{snap_doc['restoredLanes']} lanes in {numbers['restore_s']:.3f} s ({k(restore)})")
    log(f"[daemon] (a)-(d) launches: {k(run)}")
    log(f"[daemon] card == CPU serial replay: every answer of (a)-(f), the snapshot file's "
        f"header and every key's row (bytes {'equal' if snap_same else 'equal but for lane order'}"
        f"), hits/misses and request counts (replay {numbers['replay_s']:.1f} s, phase "
        f"{time.perf_counter() - t_phase:.1f} s)")
    return run


# ---------------------------------------------------------------------
# phase 14: a cluster of four server binaries on the one card
# ---------------------------------------------------------------------
# The reference's own cluster (docker-compose.yaml, gubernator-1 to
# gubernator-4), with file discovery in place of its member list.  Each
# node at phase 13's size.
CLUSTER_NODES = 4
CLUSTER_ENV = {
    "GUBER_CACHE_SIZE": "2097152",  # 8 x 262,144 slots a node
    "GUBER_BATCH_WAIT": "500us",
    "GUBER_GLOBAL_SYNC_WAIT": "100ms",  # each daemon's own sync timer
    "GUBER_PEER_DISCOVERY_TYPE": "file",
    "GUBER_NATIVE_HTTP": "1",
    # Four daemons and this script share the host's cores: a forward
    # waits longer than the 500 ms default without being lost.
    "GUBER_BATCH_TIMEOUT": "20s",
    "GUBER_GLOBAL_TIMEOUT": "20s",
}
CLUSTER_CONNS = 32  # (a): BASELINE config 2, phase 13's clients
CLUSTER_REQS = 16
CLUSTER_LANES = 1_000
CLUSTER_MORE = 4  # (c): frames a connection after the scale-up
CLUSTER_GLOBAL_REQS = 8  # (b): requests of the 64 hot keys at each of nodes 1-3
CLUSTER_GLOBAL_LIMIT = 1_000_000_000
CLUSTER_K2_CONFIGS = 300
CLUSTER_SETTLE_S = 120.0  # convergence and handoff deadlines
CLUSTER_KERNELS = DAEMON_KERNELS


def cluster_ring(addrs):
    from gubernator_tpu_torch.parallel.hash_ring import ReplicatedConsistentHash

    ring = ReplicatedConsistentHash()
    for a in addrs:
        ring.add(a, a)
    return ring


def ring_owners(ring, keys):
    """The owner address of each hash key."""
    codes, ids = ring.get_batch_codes(list(keys))
    return np.asarray(ids, dtype=object)[codes]


def write_peers(path, nodes):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump([{"grpcAddress": g, "httpAddress": h} for h, g in nodes], f)
    os.replace(tmp, path)


def cluster_traffic(ring3):
    """Phase 14's requests: (a) and (c) frames by connection, the K2
    batch (keys node 1 owns under the three-node ring) and (b)'s hot
    GLOBAL keys."""
    from gubernator_tpu_torch.types import GetRateLimitsRequest, RateLimitRequest
    from gubernator_tpu_torch.utils import gregorian

    rng = np.random.RandomState(14)
    per = N_KEYS // CLUSTER_CONNS

    def cols(keys):
        n = len(keys)
        return (["cl2"] * n, [str(k) for k in keys], np.ones(n, np.int32),
                np.zeros(n, np.int32), np.ones(n, np.int64),
                np.full(n, 1_000_000, np.int64), np.full(n, 3_600_000, np.int64))

    frames = [[cols(zipf_ids(rng, per, CLUSTER_LANES) * CLUSTER_CONNS + c)
               for _ in range(CLUSTER_REQS + CLUSTER_MORE)] for c in range(CLUSTER_CONNS)]
    pool = [f"m{i}" for i in range(20 * CLUSTER_LANES)]
    own = ring_owners(ring3, [f"clm_{k}" for k in pool])
    mine = [k for k, o in zip(pool, own) if o == ring3.peer_ids()[0]][:CLUSTER_LANES]
    k2 = GetRateLimitsRequest(requests=[
        RateLimitRequest(name="clm", unique_key=k, algorithm=1, behavior=4, hits=1,
                         limit=1_000_000 + i % CLUSTER_K2_CONFIGS,
                         duration=gregorian.GREGORIAN_MONTHS)
        for i, k in enumerate(mine)])

    def hot(hits):
        return GetRateLimitsRequest(requests=[
            RateLimitRequest(name="clg", unique_key=f"h{j}", algorithm=0, behavior=2,
                             hits=hits, limit=CLUSTER_GLOBAL_LIMIT, duration=3_600_000)
            for j in range(HOT_KEYS)])

    return frames, k2, hot(1), hot(0)


def cluster_frames(nodes, conns, which, node_of, timeout_s=DAEMON_TIMEOUT_S):
    """Each connection's frames `which` (a slice) to node node_of(c), the
    connections concurrently.  Returns (answers[c][k] = (rows, owners),
    latencies, wall)."""
    from gubernator_tpu_torch.client import ColumnsV1Client

    out = [[None] * len(range(*which.indices(len(s)))) for s in conns]
    lat, errors = [], []
    lock = threading.Lock()

    def one(c):
        client = ColumnsV1Client(nodes[node_of(c)][0], timeout_s=timeout_s, connections=1)
        try:
            for k, item in enumerate(conns[c][which]):
                t0 = time.perf_counter()
                rc, lo, hi = client.submit_columns(item).result(timeout=timeout_s)
                dt = time.perf_counter() - t0
                out[c][k] = (result_rows(rc, lo, hi), [rc.owner_at(i) for i in range(lo, hi)])
                with lock:
                    lat.append(dt)
        except BaseException as e:  # noqa: BLE001 — raised below, on this thread
            errors.append(e)
        finally:
            client.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(c,)) for c in range(len(conns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout_s * 2)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a phase 14 connection did not finish")
    if errors:
        raise errors[0]
    return out, lat, time.perf_counter() - t0


def cluster_phase(torch, smi, dev="cuda"):
    """Phase 14: four of the port's server binaries as one cluster on the
    card (file discovery, phase 13's size each): (a) BASELINE config 2
    frames through 32 ColumnsV1Clients over nodes 1-3, about two thirds
    of each frame forwarded to its owners, and a 300-config monthly batch
    (K2); (b) config 4's 64 hot keys as GLOBAL lanes at every node, the
    daemons' own syncs to exact convergence; (c) node 4 joins: nodes
    1-3's peers file is rewritten, the old owners drain the keys they no
    longer own (K7) and transfer them to node 4 (K8), then more frames to
    all four; (d) /metrics, each node's launches, SIGTERM with its
    snapshot.  Every answer of (a) and (c) and every key's row (each in
    exactly one node's snapshot, its owner's) equal a port node on the
    plain versions (CPU) in this process fed each connection's requests
    serially; each answer's owner is the ring's."""
    from gubernator_tpu_torch import snapshot
    from gubernator_tpu_torch.client import V1Client
    from gubernator_tpu_torch.config import setup_daemon_config
    from gubernator_tpu_torch.daemon import Daemon
    from gubernator_tpu_torch.reshard import TRANSFER_MAX_LANES, TransferColumns
    from gubernator_tpu_torch.utils.clock import Clock
    from gubernator_tpu_torch.wire import encode_transfer_frame

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-cluster-")
    nodes = [(f"127.0.0.1:{free_port()}", f"127.0.0.1:{free_port()}")
             for _ in range(CLUSTER_NODES)]  # (http, grpc)
    addrs = [g for _, g in nodes]
    ring3, ring4 = cluster_ring(addrs[:3]), cluster_ring(addrs)
    frames, k2_req, hot_req, hot_read = cluster_traffic(ring3)
    files = [os.path.join(tmp, "peers-123.json"), os.path.join(tmp, "peers-4.json")]
    write_peers(files[0], nodes[:3])
    write_peers(files[1], nodes)
    snaps = [os.path.join(tmp, f"node{i + 1}.snap") for i in range(CLUSTER_NODES)]
    procs = [None] * CLUSTER_NODES
    numbers = {}

    def start(i):
        env = dict(CLUSTER_ENV, GUBER_HTTP_ADDRESS=nodes[i][0], GUBER_GRPC_ADDRESS=nodes[i][1],
                   GUBER_ADVERTISE_ADDRESS=nodes[i][1], GUBER_SNAPSHOT=snaps[i],
                   GUBER_PEERS_FILE=files[0] if i < 3 else files[1])
        env_file = os.path.join(tmp, f"node{i + 1}.env")
        write_env(env_file, env)
        procs[i] = DaemonProcess(env_file, os.path.join(tmp, f"node{i + 1}.err"), dev)

    def launches(i):
        return http_json(procs[i].http, "POST", "/debug/launches")["launches"]

    def status(i):
        return http_json(procs[i].http, "GET", "/debug/status")

    def all_launches():
        return [launches(i) for i in range(CLUSTER_NODES)]

    try:
        errors = []

        def start_safe(i):
            try:
                start(i)
            except BaseException as e:  # noqa: BLE001 — raised below
                errors.append(e)

        threads = [threading.Thread(target=start_safe, args=(i,)) for i in range(CLUSTER_NODES)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=DAEMON_START_S + 60)
        if errors or any(p is None for p in procs):
            raise errors[0] if errors else AssertionError("a phase 14 node did not start")
        numbers["startup_s"] = [p.startup_s for p in procs]
        for i in range(CLUSTER_NODES):
            doc = status(i)
            want = 3 if i < 3 else 4
            if doc["health"]["peerCount"] != want or doc["ring"]["generation"] != 1:
                raise AssertionError(f"phase 14: node {i + 1}'s ring is {doc['ring']} "
                                     f"with {doc['health']['peerCount']} peers, not {want}")
        all_launches()  # every count 0 from here

        # (a) forwarding, and the K2 batch at node 1.
        got_a, lat_a, wall_a = cluster_frames(nodes, frames, slice(0, CLUSTER_REQS),
                                              lambda c: c % 3)
        client = V1Client(nodes[0][0], timeout_s=DAEMON_TIMEOUT_S)
        try:
            got_k2 = json.dumps([r.to_json() for r in client.get_rate_limits(k2_req).responses])
        finally:
            client.close()
        run_a = all_launches()

        # (b) GLOBAL: the hot keys from nodes 1-3 at once, then the
        # daemons' own syncs until every node reads the exact count.
        lat_b, errs_b = [], []

        def hot_client(i):
            v = V1Client(nodes[i][0], timeout_s=DAEMON_TIMEOUT_S)
            try:
                for _ in range(CLUSTER_GLOBAL_REQS):
                    t0 = time.perf_counter()
                    resp = v.get_rate_limits(hot_req)
                    lat_b.append(time.perf_counter() - t0)
                    if any(r.error for r in resp.responses):
                        raise AssertionError(f"phase 14 (b): {resp.responses[0].error}")
            except BaseException as e:  # noqa: BLE001 — raised below
                errs_b.append(e)
            finally:
                v.close()

        threads = [threading.Thread(target=hot_client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=DAEMON_TIMEOUT_S)
        if errs_b or any(t.is_alive() for t in threads):
            raise errs_b[0] if errs_b else AssertionError("phase 14 (b) did not finish")
        t_sent = time.perf_counter()
        want_rem = CLUSTER_GLOBAL_LIMIT - 3 * CLUSTER_GLOBAL_REQS
        readers = [V1Client(nodes[i][0], timeout_s=DAEMON_TIMEOUT_S) for i in range(3)]
        try:
            while True:
                reads = [[r.remaining for r in v.get_rate_limits(hot_read).responses]
                         for v in readers]
                if all(rem == [want_rem] * HOT_KEYS for rem in reads):
                    break
                if time.perf_counter() - t_sent > CLUSTER_SETTLE_S:
                    raise AssertionError(f"phase 14 (b): GLOBAL counters never converged: "
                                         f"{[sorted(set(r)) for r in reads]} != {want_rem}")
                time.sleep(0.02)
        finally:
            for v in readers:
                v.close()
        numbers["converge_s"] = time.perf_counter() - t_sent
        run_b = all_launches()

        # (c) scale-up: nodes 1-3 read a file that lists all four.
        t_rewrite = time.perf_counter()
        write_peers(files[0], nodes)
        while True:
            docs = [status(i) for i in range(CLUSTER_NODES)]
            rings = [d["ring"] for d in docs]
            idle = all(r["generation"] == (2 if i < 3 else 1) and not r["handoffActive"]
                       and r["reshard"]["transfersStarted"] == r["reshard"]["transfersCommitted"]
                       + r["reshard"]["transfersAborted"]
                       and (i == 3 or r["reshard"]["lastHandoffSeconds"] > 0)
                       for i, r in enumerate(rings))
            if idle:
                break
            if time.perf_counter() - t_rewrite > CLUSTER_SETTLE_S:
                raise AssertionError(f"phase 14 (c): the handoff never went idle: {rings}")
            time.sleep(0.05)
        numbers["handoff_s"] = time.perf_counter() - t_rewrite
        reshard = [r["reshard"] for r in rings]
        if any(r["transfersAborted"] for r in reshard):
            raise AssertionError(f"phase 14 (c): a transfer aborted: {reshard}")
        run_h = all_launches()
        got_c, lat_c, wall_c = cluster_frames(nodes, frames, slice(CLUSTER_REQS, None),
                                              lambda c: c % CLUSTER_NODES)
        run_c = all_launches()

        # (d) scrape, then SIGTERM.
        pages = []
        for i in range(CLUSTER_NODES):
            with edge_connect(nodes[i][0]) as s:
                st, ctype, page = edge_request(s, "GET", "/metrics")
            if st != 200:
                raise AssertionError(f"phase 14 (d): node {i + 1}'s /metrics answered {st}")
            pages.append(page.decode())
        stops = []
        for i in range(CLUSTER_NODES):
            line, _ = procs[i].stop()
            stops.append(json.loads(line.split("kernel launches ", 1)[1].rsplit(")", 1)[0]))
    except BaseException:
        for p in procs:
            if p is not None:
                p.kill()
        raise

    # The replay: one port node on the plain versions in this process,
    # each connection's frames serially, the same frozen clock.
    from gubernator_tpu_torch.client import ColumnsV1Client

    t_replay = time.perf_counter()
    conf = setup_daemon_config(env=dict(DAEMON_ENV, GUBER_HTTP_ADDRESS="127.0.0.1:0",
                                        GUBER_GRPC_ADDRESS="127.0.0.1:0",
                                        GUBER_NATIVE_HTTP="1", GUBER_TORCH_DEVICE="cpu"))
    clock = Clock()
    clock.freeze(NOW)
    ref = Daemon(conf, clock=clock).start()
    try:
        want = []
        for c in range(CLUSTER_CONNS):
            client = ColumnsV1Client(ref.gateway.address, timeout_s=DAEMON_TIMEOUT_S,
                                     connections=1)
            try:
                row = []
                for item in frames[c]:
                    rc, lo, hi = client.submit_columns(item).result(timeout=DAEMON_TIMEOUT_S)
                    row.append(result_rows(rc, lo, hi))
                want.append(row)
            finally:
                client.close()
        client = V1Client(ref.gateway.address, timeout_s=DAEMON_TIMEOUT_S)
        try:
            want_k2 = json.dumps([r.to_json() for r in client.get_rate_limits(k2_req).responses])
        finally:
            client.close()
        ref_cols = ref.service.store.snapshot_columns(NOW)
    finally:
        ref.close()
    numbers["replay_s"] = time.perf_counter() - t_replay

    # Every answer == the replay's; every owner the ring's.
    forwarded = [0] * CLUSTER_NODES
    lanes_at = [0] * CLUSTER_NODES
    for leg, got, ring, n_nodes, off in (("a", got_a, ring3, 3, 0),
                                         ("c", got_c, ring4, CLUSTER_NODES, CLUSTER_REQS)):
        for c in range(CLUSTER_CONNS):
            node = c % n_nodes
            for k, (rows, owners) in enumerate(got[c]):
                if rows != want[c][off + k]:
                    raise AssertionError(f"phase 14 ({leg}) connection {c} frame {k}: "
                                         "cluster != CPU replay")
                item = frames[c][off + k]
                ring_own = ring_owners(ring, [f"{n}_{u}" for n, u in zip(item[0], item[1])])
                expect = [None if o == addrs[node] else o for o in ring_own]
                if owners != expect:
                    raise AssertionError(f"phase 14 ({leg}) connection {c} frame {k}: owner "
                                         "metadata != the ring's")
                forwarded[node] += sum(o is not None for o in owners)
                lanes_at[node] += len(owners)
    if got_k2 != want_k2:
        raise AssertionError("phase 14: the 300-config batch != CPU replay")

    # Each key's row in exactly one snapshot, its owner's under the
    # four-node ring, == the replay's row.
    fields = ("algorithm", "status", "limit", "remaining", "duration", "stamp", "expire_at")

    def rows_of(cols):
        m = np.stack([np.asarray(getattr(cols, f), np.int64) for f in fields], axis=1)
        return dict(zip(cols.keys, map(tuple, m.tolist())))

    want_rows = {k: v for k, v in rows_of(ref_cols).items() if not k.startswith("clg_")}
    held, snap_bytes = {}, []
    for i in range(CLUSTER_NODES):
        with open(snaps[i], "rb") as f:
            snap_bytes.append(len(f.read()))
        cols, _meta = snapshot.read_snapshot(snaps[i])
        for k, row in rows_of(cols).items():
            if k.startswith("clg_"):
                continue
            if k in held:
                raise AssertionError(f"phase 14: key {k} in the snapshots of nodes "
                                     f"{held[k][0] + 1} and {i + 1}")
            held[k] = (i, row)
    if set(held) != set(want_rows):
        raise AssertionError(f"phase 14: the snapshots hold {len(held)} keys, the replay "
                             f"{len(want_rows)}")
    keys = sorted(held)
    own4 = ring_owners(ring4, keys)
    for k, o in zip(keys, own4):
        i, row = held[k]
        if addrs[i] != o:
            raise AssertionError(f"phase 14: key {k} lives on node {i + 1}, not its owner {o}")
        if row != want_rows[k]:
            raise AssertionError(f"phase 14: key {k}'s row on node {i + 1} != CPU replay")
    # What the handoff moved: the keys of (a) and the K2 batch whose
    # owner changed, by old owner; their transfer frames' bytes.
    sent_keys = sorted({f"{n}_{u}" for conn in frames for item in conn[:CLUSTER_REQS]
                        for n, u in zip(item[0], item[1])}
                       | {r.hash_key() for r in k2_req.requests})
    own3, own4s = ring_owners(ring3, sent_keys), ring_owners(ring4, sent_keys)
    moved_keys = [[k for k, a, b in zip(sent_keys, own3, own4s) if a == addrs[i] and b != a]
                  for i in range(3)]
    moved_bytes = []
    for i in range(3):
        total = 0
        for lo in range(0, len(moved_keys[i]), TRANSFER_MAX_LANES):
            part = moved_keys[i][lo:lo + TRANSFER_MAX_LANES]
            z32, z64 = np.zeros(len(part), np.int32), np.zeros(len(part), np.int64)
            total += len(encode_transfer_frame(TransferColumns(
                keys=part, algorithm=z32, status=z32, limit=z64, remaining=z64,
                duration=z64, stamp=z64, expire_at=z64)))
        moved_bytes.append(total)
    moved = [r["lanesMoved"] for r in reshard]
    if moved[:3] != [len(m) for m in moved_keys] or moved[3] != 0:
        raise AssertionError(f"phase 14 (c): lanes moved {moved} != the keys whose owner "
                             f"changed {[len(m) for m in moved_keys]}")
    if reshard[3]["lanesReceived"] != sum(moved):
        raise AssertionError(f"phase 14 (c): node 4 received {reshard[3]['lanesReceived']} "
                             f"of {sum(moved)} lanes")

    # (d) the peer families: every breaker closed, the forwarded frames.
    fams = ("gubernator_circuit_breaker_state", "gubernator_peer_columns_batches")
    fwd_frames = []
    for i, page in enumerate(pages):
        vals = metric_values(page, fams)
        states = {dict(lab)["peer"]: v for (n, lab), v in vals.items()
                  if n == "gubernator_circuit_breaker_state"}
        if sorted(states) != sorted(addrs) or any(v != 0 for v in states.values()):
            raise AssertionError(f"phase 14 (d): node {i + 1}'s breakers {states}")
        fwd_frames.append(int(sum(v for (n, lab), v in vals.items()
                                  if n == "gubernator_peer_columns_batches_total")))
    if min(fwd_frames) <= 0:
        raise AssertionError(f"phase 14 (d): forwarded frames a node {fwd_frames}")

    def k(c):
        return ", ".join(f"K{j} {c[n]}" for j, n in zip((1, 2, 3, 4, 5, 6, 7, 8), CLUSTER_KERNELS))

    if dev == "cuda":
        for i in range(CLUSTER_NODES):
            if (run_a[i] if i < 3 else run_c[i])["bucket_rounds_dict"] == 0:
                raise AssertionError(f"phase 14: node {i + 1} launched no K1")
        need = {"bucket_rounds_cols": [run_a[0]],
                "global_answer_rounds": run_b[:3], "global_sync": run_b[:3],
                "gather_rows": run_h[:3], "write_rows": [run_h[3]]}
        for name, runs in need.items():
            for c in runs:
                if c[name] == 0:
                    raise AssertionError(f"phase 14: no {name} launch where the path makes "
                                         f"one: {runs}")
        if sum(c["set_replica"] for c in run_b[:3]) == 0:
            raise AssertionError(f"phase 14 (b): no replica commit (K5): {run_b}")
        for i in range(CLUSTER_NODES):
            if stops[i]["gather_rows"] < 1:
                raise AssertionError(f"phase 14: node {i + 1}'s snapshot save launched no K7")

    def lat_line(v):
        v = np.asarray(v) * 1e3
        return f"request p50 {np.percentile(v, 50):.3f} ms, max {v.max():.3f} ms of {v.size}"

    tag = f"[cluster] ({smi})"
    log(f"{tag} startup to listening, nodes 1-4: "
        + ", ".join(f"{s:.2f} s" for s in numbers["startup_s"]))
    log(f"{tag} (a) BASELINE config 2 over nodes 1-3: {CLUSTER_CONNS} ColumnsV1Clients x "
        f"{CLUSTER_REQS} kind-5 frames of {CLUSTER_LANES} lanes: "
        f"{CLUSTER_CONNS * CLUSTER_REQS * CLUSTER_LANES / wall_a:.0f} checks/s, {lat_line(lat_a)}")
    log(f"{tag} (a)+(c) lanes forwarded by receiving node: "
        + ", ".join(f"node {i + 1} {forwarded[i]} of {lanes_at[i]}" for i in range(CLUSTER_NODES))
        + "; forwarded frames (gubernator_peer_columns_batches) by node: "
        + ", ".join(str(f) for f in fwd_frames))
    log(f"{tag} (b) {HOT_KEYS} hot GLOBAL keys x {CLUSTER_GLOBAL_REQS} requests at each of nodes "
        f"1-3: GLOBAL apply {lat_line(lat_b)}; every node reads the owner's exact count "
        f"{numbers['converge_s']:.3f} s after the last hit's answer")
    log(f"{tag} (c) handoff: rewrite to idle {numbers['handoff_s']:.3f} s; keys moved by nodes "
        f"1-3 " + ", ".join(str(m) for m in moved[:3]) + " (transfer frames "
        + ", ".join(f"{b} B" for b in moved_bytes) + f"), node 4 received "
        f"{reshard[3]['lanesReceived']}; handoff pass "
        + ", ".join(f"{r['lastHandoffSeconds']} s" for r in reshard[:3]))
    log(f"{tag} (c) {CLUSTER_CONNS} x {CLUSTER_MORE} frames over all four nodes: "
        f"{CLUSTER_CONNS * CLUSTER_MORE * CLUSTER_LANES / wall_c:.0f} checks/s, {lat_line(lat_c)}")
    for i in range(CLUSTER_NODES):
        log(f"{tag} node {i + 1} launches: (a) {k(run_a[i])}; (b) {k(run_b[i])}; handoff "
            f"{k(run_h[i])}; (c) {k(run_c[i])}; SIGTERM save {k(stops[i])} "
            f"({snap_bytes[i]} B snapshot)")
    log(f"{tag} cluster == CPU serial replay: every answer of (a) and (c), the K2 batch, every "
        f"key's row in exactly its owner's snapshot; owners == the ring's; GLOBAL exact "
        f"(replay {numbers['replay_s']:.1f} s, phase {time.perf_counter() - t_phase:.1f} s)")
    shutil.rmtree(tmp, ignore_errors=True)
    return run_a, run_b, run_h, run_c


# ---------------------------------------------------------------------
# phase 15: two regions of two server binaries each, by gossip
# ---------------------------------------------------------------------
# BASELINE config 5 ("Multi-region picker: 2 logical regions";
# bench_full.py config5: Cluster().start_with(["", "", "dc-east",
# "dc-east"]) and its 100-caller MULTI_REGION storm).  The first region
# is named: a node with no data centre takes every peer without one as
# local and names no region, so config 5's dc-east nodes would see one
# four-node ring and never send back.  Each node at phase 13's size.
FED_DCS = ("dc-west", "dc-west", "dc-east", "dc-east")
FED_ENV = {
    "GUBER_CACHE_SIZE": "2097152",
    "GUBER_BATCH_WAIT": "500us",
    "GUBER_GLOBAL_SYNC_WAIT": "100ms",
    "GUBER_PEER_DISCOVERY_TYPE": "member-list",
    "GUBER_NATIVE_HTTP": "1",
    "GUBER_MULTI_REGION_SYNC_WAIT": "100ms",  # the flush window
    # Four daemons and this script share the host's cores (phase 14).
    "GUBER_BATCH_TIMEOUT": "20s",
    "GUBER_GLOBAL_TIMEOUT": "20s",
    "GUBER_MULTI_REGION_TIMEOUT": "20s",
}
FED_CONNS = 16  # (b): ColumnsV1Clients, connection c at node c mod 4
FED_REQS = 4
FED_LANES = 1_000
FED_STORM_CALLERS = 100  # (c): benchmark_test.go's ThunderingHeard fan-out
FED_STORM_LANES = 512
FED_STORM_BATCHES = 8
FED_STORM_KEYS = 16
FED_SETTLE_S = 120.0


def fed_traffic():
    """(b)'s frames by connection (MULTI_REGION token and leaky lanes,
    disjoint keys a connection, each key one algorithm, limits no lane
    reaches: what a region applies is then the same however the flush
    windows split a key's hits) and (c)'s storm
    batches (bench_full.py config5: 16 hot keys, hits 5, limit 10)."""
    from gubernator_tpu_torch.types import Behavior, GetRateLimitsRequest, RateLimitRequest

    mr = int(Behavior.MULTI_REGION)
    rng = np.random.RandomState(15)
    per = N_KEYS // FED_CONNS

    def cols(keys):
        n = len(keys)
        return (["fedb"] * n, [str(k) for k in keys], (keys % 2).astype(np.int32),
                np.full(n, mr, np.int32), np.ones(n, np.int64),
                np.full(n, 1_000_000, np.int64), np.full(n, 3_600_000, np.int64))

    frames = [[cols(zipf_ids(rng, per, FED_LANES) * FED_CONNS + c) for _ in range(FED_REQS)]
              for c in range(FED_CONNS)]
    rng = np.random.RandomState(5)
    storm = [GetRateLimitsRequest(requests=[
        RateLimitRequest(name="c5", unique_key=f"storm{rng.randint(FED_STORM_KEYS)}", hits=5,
                         limit=10, duration=60_000, algorithm=0, behavior=mr)
        for _ in range(FED_STORM_LANES)]) for _ in range(FED_STORM_BATCHES)]
    return frames, storm


def fed_expected_hits(addrs, frames, storm, epochs):
    """(total hits, hits sent in the columnar encoding): each key's hits
    leave its owner in the region that took them for its owner in the
    other region, classic when either end is node 4
    (GUBER_REGION_COLUMNS=0)."""
    rings = {dc: cluster_ring([a for a, d in zip(addrs, FED_DCS) if d == dc])
             for dc in set(FED_DCS)}
    per = collections.Counter()  # (region, hash key) -> hits
    for c, conn in enumerate(frames):
        for item in conn:
            for n, u, h in zip(item[0], item[1], item[4]):
                per[(FED_DCS[c % 4], f"{n}_{u}")] += int(h)
    for e in range(epochs):
        for i in range(FED_STORM_CALLERS):
            for r in storm[i % FED_STORM_BATCHES].requests:
                per[(FED_DCS[i % 4], r.hash_key())] += r.hits
    total = columnar = 0
    for dc in set(FED_DCS):
        other = next(d for d in set(FED_DCS) if d != dc)
        keys = [k for d, k in per if d == dc]
        src, dst = ring_owners(rings[dc], keys), ring_owners(rings[other], keys)
        for k, a, b in zip(keys, src, dst):
            total += per[(dc, k)]
            if addrs[3] not in (a, b):
                columnar += per[(dc, k)]
    return total, columnar


def federation_phase(torch, smi, dev="cuda"):
    """Phase 15: two regions of two of the port's server binaries each
    on the card, found by member-list gossip (node 1's gossip address
    the known node); node 4 runs GUBER_REGION_COLUMNS=0, so the sends to
    and from it take the classic per-item encoding.  (a) every node lists
    the four peers, two a region, and names the other region; (b)
    MULTI_REGION token and leaky frames through ColumnsV1Client into both
    regions, then the flushes: every answer and every key's row in both
    regions equal two port nodes on the plain versions (CPU) in this
    process fed each connection's frames serially, flushed by hand; (c)
    config 5's storm, 100 callers x 512 lanes over the four gateways:
    zero error lanes, the region ledger balanced over the four nodes,
    no audit violation, both encodings used; (d) each node's launches,
    SIGTERM with its snapshot."""
    from gubernator_tpu_torch import snapshot
    from gubernator_tpu_torch.client import ColumnsV1Client, V1Client
    from gubernator_tpu_torch.config import setup_daemon_config
    from gubernator_tpu_torch.daemon import Daemon
    from gubernator_tpu_torch.utils.clock import Clock

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-federation-")
    nodes = [(f"127.0.0.1:{free_port()}", f"127.0.0.1:{free_port()}",
              f"127.0.0.1:{free_port()}") for _ in range(4)]  # (http, grpc, gossip)
    addrs = [g for _, g, _ in nodes]
    frames, storm = fed_traffic()
    snaps = [os.path.join(tmp, f"node{i + 1}.snap") for i in range(4)]
    procs = [None] * 4
    numbers = {}

    def start(i):
        env = dict(FED_ENV, GUBER_HTTP_ADDRESS=nodes[i][0], GUBER_GRPC_ADDRESS=nodes[i][1],
                   GUBER_ADVERTISE_ADDRESS=nodes[i][1], GUBER_DATA_CENTER=FED_DCS[i],
                   GUBER_MEMBERLIST_ADDRESS=nodes[i][2],
                   GUBER_MEMBERLIST_KNOWN_NODES=nodes[0][2],
                   GUBER_MEMBERLIST_NODE_NAME=f"node{i + 1}", GUBER_SNAPSHOT=snaps[i])
        if i == 3:
            env["GUBER_REGION_COLUMNS"] = "0"
        env_file = os.path.join(tmp, f"node{i + 1}.env")
        write_env(env_file, env)
        procs[i] = DaemonProcess(env_file, os.path.join(tmp, f"node{i + 1}.err"), dev)

    def launches(i):
        return http_json(procs[i].http, "POST", "/debug/launches")["launches"]

    def status(i):
        return http_json(procs[i].http, "GET", "/debug/status")

    def all_launches():
        return [launches(i) for i in range(4)]

    def settle(what, done):
        t0 = time.perf_counter()
        while True:
            docs = [status(i) for i in range(4)]
            if done(docs):
                return docs, time.perf_counter() - t0
            if time.perf_counter() - t0 > FED_SETTLE_S:
                raise AssertionError(f"phase 15: {what} never happened: "
                                     f"{[d['region'] for d in docs]}")
            time.sleep(0.02)

    def flushed(hits):
        """Every hit queued so far delivered or dropped: a flush in
        flight has emptied the queue before its sends count."""
        def done(docs):
            r = [d["region"] for d in docs]
            return (all(x["pendingKeys"] == 0 and x["carryKeyTotal"] == 0 for x in r)
                    and sum(x["sentHits"] + x["droppedHits"] for x in r) == hits)
        return done

    hits_b, _ = fed_expected_hits(addrs, frames, storm, epochs=0)
    total, columnar = fed_expected_hits(addrs, frames, storm, epochs=2)

    try:
        # Node 1 first: the others join through its gossip address.
        start(0)
        errors = []

        def start_safe(i):
            try:
                start(i)
            except BaseException as e:  # noqa: BLE001 — raised below
                errors.append(e)

        threads = [threading.Thread(target=start_safe, args=(i,)) for i in range(1, 4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=DAEMON_START_S + 60)
        if errors or any(p is None for p in procs):
            raise errors[0] if errors else AssertionError("a phase 15 node did not start")
        numbers["startup_s"] = [p.startup_s for p in procs]

        # (a) gossip convergence: two local peers, the other region's two.
        def converged(docs):
            for i, d in enumerate(docs):
                other = "dc-east" if FED_DCS[i] == "dc-west" else "dc-west"
                if (d["health"]["peerCount"] != 2 or len(d["peers"]) != 4
                        or d["region"]["regions"] != {other: {"peers": 2, "breakerOpen": 0}}
                        or d["region"]["dataCenter"] != FED_DCS[i]):
                    return False
            return True

        docs, numbers["converge_s"] = settle("gossip convergence", converged)
        generations = [d["ring"]["generation"] for d in docs]
        all_launches()  # every count 0 from here

        # (b) the serial leg: each connection's frames into its node's
        # region, the connections concurrently; then the flush windows.
        got_b, lat_b, wall_b = cluster_frames([(h, g) for h, g, _ in nodes], frames,
                                              slice(0, None), lambda c: c % 4)
        _, numbers["flush_b_s"] = settle("the flushes of (b)", flushed(hits_b))
        run_b = all_launches()

        # (c) config 5's storm: an untimed warm epoch, then the timed one.
        lat_c, totals = [], [0, 0, 0]  # lanes, over limit, error lanes
        lock = threading.Lock()

        def storm_one(i, timed):
            v = V1Client(nodes[i % 4][0], timeout_s=DAEMON_TIMEOUT_S)
            try:
                t0 = time.perf_counter()
                resp = v.get_rate_limits(storm[i % FED_STORM_BATCHES])
                dt = time.perf_counter() - t0
            finally:
                v.close()
            with lock:
                if timed:
                    lat_c.append(dt)
                totals[0] += len(resp.responses)
                totals[1] += sum(r.status == 1 and not r.error for r in resp.responses)
                totals[2] += sum(bool(r.error) for r in resp.responses)

        wall_c = 0.0
        for timed in (False, True):
            errs = []

            def safe(i, timed=timed):
                try:
                    storm_one(i, timed)
                except BaseException as e:  # noqa: BLE001 — raised below
                    errs.append(e)

            threads = [threading.Thread(target=safe, args=(i,)) for i in range(FED_STORM_CALLERS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=DAEMON_TIMEOUT_S)
            if errs or any(t.is_alive() for t in threads):
                raise errs[0] if errs else AssertionError("phase 15 (c) did not finish")
            wall_c = time.perf_counter() - t0
        docs, numbers["flush_c_s"] = settle("the flushes of (c)", flushed(total))
        run_c = all_launches()
        if [d["ring"]["generation"] for d in docs] != generations:
            raise AssertionError(f"phase 15: a ring changed during the run (gossip flapped): "
                                 f"{generations} -> {[d['ring']['generation'] for d in docs]}")

        # (d) the ledgers, /metrics, SIGTERM.
        audits = [http_json(procs[i].http, "GET", "/debug/audit") for i in range(4)]
        pages = []
        for i in range(4):
            with edge_connect(nodes[i][0]) as s:
                st, _, page = edge_request(s, "GET", "/metrics")
            if st != 200:
                raise AssertionError(f"phase 15 (d): node {i + 1}'s /metrics answered {st}")
            pages.append(page.decode())
        stops = []
        for i in range(4):
            line, _ = procs[i].stop()
            stops.append(json.loads(line.split("kernel launches ", 1)[1].rsplit(")", 1)[0]))
    except BaseException:
        for p in procs:
            if p is not None:
                p.kill()
        raise

    # The replay: one port node a region on the plain versions in this
    # process, each connection's frames serially, the flushes by hand.
    t_replay = time.perf_counter()
    clock = Clock()
    clock.freeze(NOW)
    ref = {}
    try:
        for dc in ("dc-west", "dc-east"):
            conf = setup_daemon_config(env=dict(
                DAEMON_ENV, GUBER_HTTP_ADDRESS="127.0.0.1:0", GUBER_GRPC_ADDRESS="127.0.0.1:0",
                GUBER_ADVERTISE_ADDRESS="", GUBER_STATIC_PEERS="", GUBER_NATIVE_HTTP="1",
                GUBER_TORCH_DEVICE="cpu", GUBER_DATA_CENTER=dc,
                GUBER_MULTI_REGION_SYNC_WAIT="3600s"))
            ref[dc] = Daemon(conf, clock=clock).start()
        infos = [d.peer_info for d in ref.values()]
        for d in ref.values():
            d.set_peers(infos)
        want_b = []
        for c in range(FED_CONNS):
            client = ColumnsV1Client(ref[FED_DCS[c % 4]].gateway.address,
                                     timeout_s=DAEMON_TIMEOUT_S, connections=1)
            try:
                row = []
                for item in frames[c]:
                    rc, lo, hi = client.submit_columns(item).result(timeout=DAEMON_TIMEOUT_S)
                    row.append(result_rows(rc, lo, hi))
                want_b.append(row)
            finally:
                client.close()
        for d in ref.values():
            d.service.multi_region_mgr.run_once()
        ref_cols = {dc: d.service.store.snapshot_columns(NOW) for dc, d in ref.items()}
    finally:
        for d in ref.values():
            d.close()
    numbers["replay_s"] = time.perf_counter() - t_replay

    for c in range(FED_CONNS):
        for k, (rows, _owners) in enumerate(got_b[c]):
            if rows != want_b[c][k]:
                raise AssertionError(f"phase 15 (b) connection {c} frame {k}: card != CPU "
                                     "replay")
    fields = ("algorithm", "status", "limit", "remaining", "duration", "stamp", "expire_at")

    def rows_of(cols):
        m = np.stack([np.asarray(getattr(cols, f), np.int64) for f in fields], axis=1)
        return {k: v for k, v in zip(cols.keys, map(tuple, m.tolist())) if k.startswith("fedb_")}

    n_rows = {}
    for dc in ("dc-west", "dc-east"):
        held = {}
        for i in (j for j in range(4) if FED_DCS[j] == dc):
            cols, _meta = snapshot.read_snapshot(snaps[i])
            for k, row in rows_of(cols).items():
                if k in held:
                    raise AssertionError(f"phase 15: key {k} on both nodes of {dc}")
                held[k] = row
        want = rows_of(ref_cols[dc])
        if held != want:
            bad = sorted(k for k in set(held) | set(want) if held.get(k) != want.get(k))
            raise AssertionError(f"phase 15 (b): {len(bad)} of {len(want)} keys' rows in {dc} "
                                 f"!= CPU replay (first {bad[:3]}: "
                                 f"{[(held.get(k), want.get(k)) for k in bad[:3]]})")
        n_rows[dc] = len(held)

    # (c) zero error lanes; the region ledger over the four nodes.
    if totals[2]:
        raise AssertionError(f"phase 15 (c): {totals[2]} error lanes of {totals[0]}")
    led = collections.Counter()
    for i, a in enumerate(audits):
        node = {k: int(a["ledger"].get(k, 0)) for k in
                ("region_agg_hits", "region_sent_hits", "region_dropped_hits",
                 "region_admitted_hits", "region_wire_hits", "region_recv_hits",
                 "region_applied_hits")}
        bad = {k: v for k, v in a["violations"].items() if k.startswith("region") and v}
        slack = a["gauges"].get("region_carry_keys", 0)
        if (bad or node["region_wire_hits"] > node["region_admitted_hits"]
                or node["region_sent_hits"] + node["region_dropped_hits"]
                > node["region_agg_hits"]
                or node["region_applied_hits"] > node["region_recv_hits"] or slack):
            raise AssertionError(f"phase 15: node {i + 1}'s region invariants: {node}, "
                                 f"violations {bad}, carry {slack}")
        led.update(node)
    if not (led["region_agg_hits"] == led["region_sent_hits"] == total
            and led["region_dropped_hits"] == 0
            and led["region_recv_hits"] == led["region_applied_hits"] == columnar):
        raise AssertionError(f"phase 15: region ledger {dict(led)} != {total} hits sent, "
                             f"{columnar} of them columnar")
    batches = collections.Counter()
    flushes = [d["region"]["flushes"] for d in docs]
    for page in pages:
        for (n, lab), v in metric_values(page, ("gubernator_region_batches",)).items():
            if n == "gubernator_region_batches_total":
                batches[dict(lab)["encoding"]] += int(v)
    if not (batches["columns"] > 0 and batches["classic"] > 0):
        raise AssertionError(f"phase 15: region batches by encoding {dict(batches)}")

    def k(c):
        return ", ".join(f"K{j} {c[n]}" for j, n in zip((1, 2, 3, 4, 5, 6, 7, 8), DAEMON_KERNELS))

    # The storm's keys each node owns in its region (FNV clusters keys
    # that differ only at the end, so a node may own none of the 16).
    storm_keys = sorted({r.hash_key() for b in storm for r in b.requests})
    owned = [0] * 4
    for dc in set(FED_DCS):
        ring = cluster_ring([a for a, d in zip(addrs, FED_DCS) if d == dc])
        for o in ring_owners(ring, storm_keys):
            owned[addrs.index(o)] += 1
    if dev == "cuda":
        for i in range(4):
            if run_b[i]["bucket_rounds_dict"] == 0 or (
                    owned[i] and run_c[i]["bucket_rounds_dict"] == 0):
                raise AssertionError(f"phase 15: node {i + 1} (owner of {owned[i]} storm keys) "
                                     f"launched no K1: {run_b[i]}, {run_c[i]}")
            if stops[i]["gather_rows"] < 1:
                raise AssertionError(f"phase 15: node {i + 1}'s snapshot save launched no K7")

    # What one flush of each region's keys costs on the wire, in each
    # encoding (the bytes actually sent are not counted by the nodes).
    from gubernator_tpu_torch.federation import RegionBatch, RegionColumns
    from gubernator_tpu_torch.types import RateLimitRequest

    one_flush = {}
    for dc in ("dc-west", "dc-east"):
        agg = {}
        for c in (c for c in range(FED_CONNS) if FED_DCS[c % 4] == dc):
            for item in frames[c]:
                for j in range(len(item[0])):
                    key = (item[0][j], item[1][j])
                    if key in agg:
                        agg[key].hits += 1
                    else:
                        agg[key] = RateLimitRequest(
                            name=item[0][j], unique_key=item[1][j], hits=1,
                            limit=int(item[5][j]), duration=int(item[6][j]),
                            algorithm=int(item[2][j]), behavior=int(item[3][j]))
        b = RegionBatch(RegionColumns.from_requests(dc, list(agg.values())))
        one_flush[dc] = (len(agg), len(b.frame()), sum(len(x) for x in b.classic_json_chunks(1000)))

    def lat_line(v):
        v = np.asarray(v) * 1e3
        return f"request p50 {np.percentile(v, 50):.3f} ms, max {v.max():.3f} ms of {v.size}"

    tag = f"[federation] ({smi})"
    log(f"{tag} startup to listening, nodes 1-4: "
        + ", ".join(f"{s:.2f} s" for s in numbers["startup_s"])
        + f"; gossip convergence (four peers, the other region named) "
        f"{numbers['converge_s']:.3f} s after the last node listened")
    log(f"{tag} (b) {FED_CONNS} ColumnsV1Clients x {FED_REQS} MULTI_REGION frames of "
        f"{FED_LANES} lanes over both regions: {FED_CONNS * FED_REQS * FED_LANES / wall_b:.0f} "
        f"checks/s, {lat_line(lat_b)}; flushed {numbers['flush_b_s']:.3f} s after the last "
        f"answer; rows in dc-west {n_rows['dc-west']}, dc-east {n_rows['dc-east']} keys")
    log(f"{tag} (c) config 5 storm, {FED_STORM_CALLERS} callers x {FED_STORM_LANES} lanes over "
        f"the four gateways: {FED_STORM_CALLERS * FED_STORM_LANES / wall_c:.0f} checks/s, "
        f"{lat_line(lat_c)}; over limit {totals[1]} of {totals[0]} lanes (both epochs), "
        f"error lanes {totals[2]}; flushed {numbers['flush_c_s']:.3f} s after the last answer; "
        f"storm keys owned by nodes 1-4: {owned}")
    log(f"{tag} region plane: flushes by node {flushes}; batches by encoding "
        f"{dict(sorted(batches.items()))}; ledger over the four nodes {dict(sorted(led.items()))}"
        f" ({columnar} of {total} hits columnar, the rest to or from node 4)")
    log(f"{tag} one flush of each region's (b) keys: "
        + "; ".join(f"{dc} {n} keys, region frame {f} B, classic JSON {j} B"
                    for dc, (n, f, j) in one_flush.items()))
    for i in range(4):
        log(f"{tag} node {i + 1} ({FED_DCS[i]}) launches: (b) {k(run_b[i])}; (c) {k(run_c[i])}; "
            f"SIGTERM save {k(stops[i])}")
    log(f"{tag} cluster == CPU serial replay: every answer of (b), every (b) key's row in both "
        f"regions (replay {numbers['replay_s']:.1f} s, phase {time.perf_counter() - t_phase:.1f} s)")
    shutil.rmtree(tmp, ignore_errors=True)
    return run_b, run_c


# ---------------------------------------------------------------------
# Phase 16: the incident black box and its replay, two in-process port
# nodes at phase 13's size each.
BB_NODES = 2
BB_CACHE = 2_097_152  # 8 x 262,144 slots a node
BB_CONNS = 16  # (a): BASELINE config 2 through the native pump
BB_REQS = 4
BB_LANES = 1_000
BB_QUADS = 3  # ABBA quads of the tap's cost
BB_PEER_FRAMES = 8  # (b): kind-1 frames of owned lanes POSTed to node 2
BB_WRITE_MB = 16  # (a): one write_bundle at full rings of this budget
BB_KERNELS = ("bucket_rounds_dict", "bucket_rounds_cols", "global_answer_rounds",
              "global_sync", "gather_rows", "write_rows")


def bb_frames():
    """(a)'s frames by connection: leaky BATCHING lanes of a 1,000,000-key
    Zipf space, each connection its own keys (ids = c mod BB_CONNS)."""
    rng = np.random.RandomState(16)
    per = N_KEYS // BB_CONNS

    def cols(keys):
        n = len(keys)
        return (["bb2"] * n, [str(k) for k in keys], np.ones(n, np.int32),
                np.zeros(n, np.int32), np.ones(n, np.int64),
                np.full(n, 1_000_000, np.int64), np.full(n, 3_600_000, np.int64))

    return [[cols(zipf_ids(rng, per, BB_LANES) * BB_CONNS + c) for _ in range(BB_REQS)]
            for c in range(BB_CONNS)]


def bb_write_ms(blackbox, wire, tmp):
    """One write_bundle of a service-less box whose five rings are filled
    to their share of BB_WRITE_MB with 64-lane frames (bench.py's
    measure_blackbox_bundle_write): (ms, ring bytes, bundle bytes)."""
    d = os.path.join(tmp, "write")
    bb = blackbox.BlackBox(None, path=d, budget_mb=BB_WRITE_MB)
    lanes = 64
    cols = (["bench"] * lanes, [f"key-{i:06d}" for i in range(lanes)], [1] * lanes,
            [0] * lanes, [2] * lanes, [1000] * lanes, [60_000] * lanes)
    try:
        for kind in (1, 3, 4, 5, 7):
            frame = wire.encode_columns_frame(cols, kind=kind)
            ring = bb.rings[blackbox._KIND_WIRE[kind]]
            for _ in range(ring.budget // (len(frame) + 32) + 1):
                bb.tap("in", "10.0.0.9:1051", frame)
        ring_bytes = sum(bb.rings[w].stats()[1] for w in blackbox.WIRES)
        t0 = time.perf_counter()
        path = bb.write_bundle([{"kind": "bench", "wallNs": 0, "monoNs": 0, "fields": {}}])
        ms = (time.perf_counter() - t0) * 1e3
        size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        return ms, ring_bytes, size
    finally:
        bb.close()


def bb_wait_bundles(blackbox, box, path, n, timeout_s=30.0):
    """The bundles under `path` once `box` has written n."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        found = blackbox.list_bundles(path)
        if len(found) >= n and box.bundles_written >= n:
            return [os.path.join(path, e) for e in found]
        time.sleep(0.02)
    raise AssertionError(f"phase 16: no {n} bundles under {path} in {timeout_s} s")


def bb_violation_bundle(blackbox, path, timeout_s=30.0):
    """The first bundle under `path` whose triggers list audit-violation."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        for e in blackbox.list_bundles(path):
            try:
                with open(os.path.join(path, e, blackbox.MANIFEST_NAME), "rb") as f:
                    kinds = [t["kind"] for t in json.loads(f.read())["triggers"]]
            except OSError:
                continue
            if "audit-violation" in kinds:
                return os.path.join(path, e)
        time.sleep(0.02)
    raise AssertionError(f"phase 16: no audit-violation bundle under {path}")


def bb_script(name):
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def blackbox_phase(torch, smi, rows, dev="cuda"):
    """Phase 16: the incident black box on two in-process port nodes on
    the card (phase 13's size each, their own bundle directories):
    (a) the tap's cost at node 1's native pump (BASELINE config 2, about
    half of each frame forwarded to node 2) in ABBA quads of
    blackbox.force_disable, the rings' frame counts against the frames
    sent and forwarded, one bundle write; (b) the seeded incident of
    tests/test_blackbox.py (a FaultPlan DUPLICATE on the forward, the
    armed auditor): forward_conservation's auto-dump writes a bundle
    that scripts/torch_blackbox_fsck.py passes, with the duplicated
    frame pair; node 2 takes kind-1 frames over HTTP and answers POST
    /debug/incident 202 with a second bundle, 403 force-disabled, 409
    without a directory; (c) scripts/torch_replay.py replays each bundle
    twice on the card and once on the plain versions (CPU): the three
    reports byte-identical, the violation reproduced; (d)
    measure_sync_cost_s on a fresh phase 6 store, K4 launched iters + 1
    times, refused on a store with a live GLOBAL key."""
    from gubernator_tpu_torch import blackbox, faults, tracing, wire
    from gubernator_tpu_torch.client import ColumnsV1Client
    from gubernator_tpu_torch.cluster import Cluster, fast_test_behaviors
    from gubernator_tpu_torch.ops import _kernels
    from gubernator_tpu_torch.parallel.mesh import MeshBucketStore
    from gubernator_tpu_torch.types import (
        Behavior, GetRateLimitsRequest, RateLimitRequest)

    from gubernator_tpu_torch import snapshot

    t_phase = time.perf_counter()
    tag = f"[blackbox] ({smi})"
    tmp = tempfile.mkdtemp(prefix="chip-smoke-blackbox-")
    _kernels.reset_launch_counts()  # the phase's path starts here
    beh = fast_test_behaviors()
    beh.batch_timeout_s = 20.0  # two nodes and this script share the host's cores
    beh.global_timeout_s = 20.0
    blackbox.set_enabled(True)
    blackbox.force_disable(False)
    t0 = time.perf_counter()
    cl = Cluster().start_with([""] * BB_NODES, cache_size=BB_CACHE, behaviors=beh,
                              native_http=True, device=None if dev == "cuda" else dev)
    start_s = time.perf_counter() - t0
    n1, n2 = (d.service for d in cl.daemons)
    try:
        for i, svc in enumerate((n1, n2)):
            if svc.store.device.type != dev:
                raise AssertionError(f"phase 16's node {i + 1} runs on {svc.store.device}")
            if svc.native_ingress is None or svc.blackbox.budget_bytes != 64 << 20:
                raise AssertionError("phase 16 needs the native pump and the 64 MiB box")
        n1.blackbox.path = os.path.join(tmp, "node1")
        n2.blackbox.path = ""  # set at (b)'s POST: the nodes share the default recorder
        log(f"{tag} two nodes up in {start_s:.3f} s (8 x {BB_CACHE // 8} slots each, "
            f"the native pump at node 1)")

        # (a) the tap's cost
        frames = bb_frames()
        addr1 = cl.daemons[0].gateway.address
        cols_ctr = n1.metrics.peer_columns_batches.labels(encoding="columns")

        def run():
            def one(c, out):
                client = ColumnsV1Client(addr1, timeout_s=DAEMON_TIMEOUT_S, connections=1)
                try:
                    for item in frames[c]:
                        rc, lo, hi = client.submit_columns(item).result(timeout=DAEMON_TIMEOUT_S)
                        errs = [r.error for i, r in rc.overrides.items() if lo <= i < hi and r.error]
                        if errs:
                            out.append(AssertionError(f"phase 16 (a): {errs[:2]}"))
                except BaseException as e:  # noqa: BLE001 — raised below
                    out.append(e)
                finally:
                    client.close()

            errors = []
            ts = [threading.Thread(target=one, args=(c, errors)) for c in range(BB_CONNS)]
            t = time.perf_counter()
            for th in ts:
                th.start()
            for th in ts:
                th.join(timeout=DAEMON_TIMEOUT_S * 2)
            wall = time.perf_counter() - t
            if any(th.is_alive() for th in ts):
                raise AssertionError("a phase 16 connection did not finish")
            if errors:
                raise errors[0]
            return BB_CONNS * BB_REQS * BB_LANES / wall

        def totals():
            return {w: n1.blackbox.rings[w].stats()[2] for w in blackbox.WIRES}

        run()  # warm: every key's first touch
        cps = {True: [], False: []}
        ratios = []
        first_on = None
        for q in range(BB_QUADS):
            quad = {}
            for on in (True, False, False, True):
                blackbox.force_disable(not on)
                before, fwd0 = totals(), cols_ctr._value.get()
                v = run()
                after, fwd = totals(), cols_ctr._value.get() - fwd0
                d = {w: after[w] - before[w] for w in blackbox.WIRES}
                sent = BB_CONNS * BB_REQS
                want = ({"public": 2 * sent, "peer": int(fwd), "global": 0, "transfer": 0,
                         "region": 0} if on else dict.fromkeys(blackbox.WIRES, 0))
                if d != want or (on and fwd == 0):
                    raise AssertionError(f"phase 16 (a): ring frames {d}, want {want}")
                if on and first_on is None:
                    # The budget holds one run's frames whole.
                    first_on = {w: n1.blackbox.rings[w].stats()[0] for w in ("public", "peer")}
                    if first_on["public"] < d["public"] or first_on["peer"] < d["peer"]:
                        raise AssertionError(f"phase 16 (a): the rings hold {first_on}, "
                                             f"the run tapped {d}")
                    first_on = d
                cps[on].append(v)
                quad.setdefault(on, []).append(v)
            ratios.append(sum(quad[True]) / sum(quad[False]))
        blackbox.force_disable(False)
        ratio = float(np.median(ratios))
        ring_mb = sum(n1.blackbox.rings[w].stats()[1] for w in blackbox.WIRES) / 2**20
        log(f"{tag} (a) tap cost at the pump, {BB_QUADS} ABBA quads of {BB_CONNS} x {BB_REQS} "
            f"frames of {BB_LANES} lanes: on {np.median(cps[True]):.0f} checks/s "
            f"(runs {', '.join(f'{v:.0f}' for v in cps[True])}), off "
            f"{np.median(cps[False]):.0f} (runs {', '.join(f'{v:.0f}' for v in cps[False])}), "
            f"median quad ratio on/off {ratio:.4f}; a run taps {2 * BB_CONNS * BB_REQS} public "
            f"and {first_on['peer']} peer frames, the rings hold {ring_mb:.1f} MiB")
        w_ms, w_ring, w_size = bb_write_ms(blackbox, wire, tmp)
        log(f"{tag} (a) write_bundle at {BB_WRITE_MB} MiB rings: {w_ms:.1f} ms, "
            f"{w_ring} ring bytes, {w_size} bundle bytes")

        # (b) the seeded incident.  Node 1's state is on disk first (one
        # K7), so its bundles carry it and the replay restores it.
        snap1 = os.path.join(tmp, "node1.snap")
        now1 = n1.clock.now_ms()
        snapshot.write_snapshot(snap1, n1.store.snapshot_columns(now1), now1)
        n1.conf.snapshot_path = snap1
        # No rate limit: the DUPLICATE's "fault" trigger may write a
        # bundle before the audit runs; the violation writes its own.
        n1.blackbox.coalesce_s = 0.05
        n1.blackbox.min_interval_s = 0.0
        plan = faults.FaultPlan(seed=11)
        plan.duplicate(op="GetPeerRateLimits")
        tracing.bind_recorder(n1.recorder)  # check as node 1's audit thread does
        try:
            auditor = n1.auditor
            auditor.arm()
            auditor.check_now()  # the seed pass
            faults.install(plan)
            me = n1.advertise_address
            import hashlib

            cand = [hashlib.md5(str(i).encode()).hexdigest() for i in range(64)]
            probe = [RateLimitRequest(name="bb", unique_key=uk, hits=3, limit=1000,
                                      duration=60_000)
                     for uk in cand if n1.get_peer(f"bb_{uk}").info.grpc_address != me]
            if not probe:
                raise AssertionError("phase 16 (b): no key of node 2 in the probe range")
            n1.get_rate_limits(GetRateLimitsRequest(requests=probe))
            found = [v["invariant"] for v in auditor.check_now()]
            faults.uninstall()
        finally:
            faults.uninstall()
            tracing.bind_recorder(None)
        if "forward_conservation" not in found:
            raise AssertionError(f"phase 16 (b): the audit found {found}")
        b1 = bb_violation_bundle(blackbox, n1.blackbox.path)
        if bb_script("torch_blackbox_fsck").main([b1]) != 0:
            raise AssertionError(f"phase 16 (b): fsck rejected {b1}")
        bundle1 = blackbox.load_bundle(b1)
        kinds = [t["kind"] for t in bundle1.manifest["triggers"]]
        if "audit-violation" not in kinds or "state.snap" not in bundle1.manifest["files"]:
            raise AssertionError(f"phase 16 (b): the manifest lists {kinds}, "
                                 f"{sorted(bundle1.manifest['files'])}")
        peer_out = [r[5] for r in bundle1.frames["peer"] if r[2] == "out"]
        if not any(a == b for a, b in zip(peer_out, peer_out[1:])):
            raise AssertionError("phase 16 (b): no duplicated forward frame in the capture")
        # node 2: kind-1 frames of lanes it owns over HTTP, then the
        # operator's bundle and the endpoint's refusals
        addr2 = cl.daemons[1].gateway.address
        g2 = cl.daemons[1].peer_info.grpc_address
        # index-first keys: FNV-1 clusters suffix-varying ones on the ring
        pool = [f"{i}p" for i in range(8 * BB_PEER_FRAMES * BB_LANES)]
        owned = [k for k in pool if n1.get_peer(f"bbp_{k}").info.grpc_address == g2]
        need = BB_PEER_FRAMES * BB_LANES
        if len(owned) < need:
            raise AssertionError("phase 16 (b): too few keys of node 2")
        with edge_connect(addr2) as s:
            for k in range(BB_PEER_FRAMES):
                keys = owned[k * BB_LANES:(k + 1) * BB_LANES]
                n = len(keys)
                f = wire.encode_columns_frame((
                    ["bbp"] * n, keys, np.ones(n, np.int32), np.zeros(n, np.int32),
                    np.full(n, 2, np.int64), np.full(n, 1_000, np.int64),
                    np.full(n, 3_600_000, np.int64)))
                st, _, _ = edge_request(s, "POST", "/v1/peer.GetPeerRateLimits", f)
                if st != 200:
                    raise AssertionError(f"phase 16 (b): peer frame answered {st}")
            st_409, _, _ = edge_request(s, "POST", "/debug/incident", b"")
            n2.blackbox.path = os.path.join(tmp, "node2")
            n2.blackbox.coalesce_s = 0.05
            st_202, _, body = edge_request(s, "POST", "/debug/incident", b'{"reason": "phase 16"}')
            b2 = bb_wait_bundles(blackbox, n2.blackbox, n2.blackbox.path, 1)[-1]
            blackbox.force_disable(True)
            try:
                st_403, _, _ = edge_request(s, "POST", "/debug/incident", b"")
            finally:
                blackbox.force_disable(False)
        if (st_409, st_202, st_403) != (409, 202, 403):
            raise AssertionError(f"phase 16 (b): /debug/incident answered "
                                 f"{st_409}, {st_202}, {st_403}")
        if bb_script("torch_blackbox_fsck").main([b2]) != 0:
            raise AssertionError(f"phase 16 (b): fsck rejected {b2}")
        bundle2 = blackbox.load_bundle(b2)
        in2 = sum(1 for r in bundle2.frames["peer"] if r[2] == "in")
        if in2 != BB_PEER_FRAMES:
            raise AssertionError(f"phase 16 (b): node 2's bundle holds {in2} peer frames")
        log(f"{tag} (b) forward_conservation bundle {os.path.basename(b1)}: triggers {kinds}, "
            f"{sum(len(v) for v in bundle1.frames.values())} frames "
            f"({len(peer_out)} peer out, a duplicated pair); node 2's POST /debug/incident "
            f"202 ({json.loads(body)['accepted']}), {sum(len(v) for v in bundle2.frames.values())} "
            f"frames; 403 force-disabled, 409 without a directory; fsck 0 on both")
    finally:
        blackbox.force_disable(False)
        cl.stop()

    # (c) the replays
    replay = bb_script("torch_replay")
    for label, b in (("node 1", b1), ("node 2", b2)):
        reports, secs, k1, rows_k = [], [], [], []
        for device in (dev, dev, "cpu"):
            before = dict(_kernels.LAUNCHES)
            t0 = time.perf_counter()
            reports.append(json.dumps(replay.replay_bundle(b, device=device), sort_keys=True))
            secs.append(time.perf_counter() - t0)
            d = {k: _kernels.LAUNCHES[k] - before[k] for k in before}
            k1.append(d["bucket_rounds_dict"] + d["bucket_rounds_cols"])
            rows_k.append((d["gather_rows"], d["write_rows"]))
        if len(set(reports)) != 1:
            raise AssertionError(f"phase 16 (c): {label}'s replays differ:\n" + "\n".join(reports))
        rep = json.loads(reports[0])
        # Node 2's audit may report node 1's violation too (the nodes
        # share the process's ledger); only node 1's frames replay it.
        if label == "node 1" and not (rep["reproducesBundleViolations"]
                                      and rep["violations"].get("forward_conservation")):
            raise AssertionError(f"phase 16 (c): node 1's violation not reproduced: {rep}")
        if label == "node 2" and dev == "cuda" and (k1[0] < 1 or k1[0] != k1[1] or k1[2] != 0):
            raise AssertionError(f"phase 16 (c): node 2's replays launched K1/K2 {k1}")
        if label == "node 1" and dev == "cuda" and min(rows_k[0]) < 1:
            raise AssertionError(f"phase 16 (c): node 1's restore launched K7/K8 {rows_k[0]}")
        log(f"{tag} (c) replay of {label}'s bundle: {secs[0]:.3f} / {secs[1]:.3f} s on the card, "
            f"{secs[2]:.3f} s on the CPU, {sum(rep['driven'].values())} frames driven "
            f"{rep['driven']}, {sum(rep['framesCaptured'].values())} captured, statuses "
            f"{rep['responseStatuses']}, violations {rep['violations']}, K1+K2 launches "
            f"{k1[0]} / {k1[1]} and K7/K8 (the state restore) {rows_k[0]} on the card; "
            f"the three reports byte-identical")

    # (d) measure_sync_cost_s
    store = MeshBucketStore(capacity_per_shard=C_GLOBAL, g_capacity=G_FULL,
                            device=None if dev == "cuda" else dev)
    iters = 6
    k4_0 = _kernels.LAUNCHES["global_sync"]
    cost_s = store.measure_sync_cost_s(NOW, iters=iters)
    k4 = _kernels.LAUNCHES["global_sync"] - k4_0
    if dev == "cuda" and k4 != iters + 1:
        raise AssertionError(f"phase 16 (d): {k4} K4 launches, want {iters} + the warm one")
    launches = {k: _kernels.LAUNCHES[k] for k in BB_KERNELS}  # the path ends here
    if dev == "cuda" and not all(launches[k] for k in ("bucket_rounds_dict", "global_sync",
                                                       "gather_rows")):
        raise AssertionError(f"phase 16: a kernel of the path never launched: {launches}")
    live = MeshBucketStore(capacity_per_shard=C_GLOBAL, g_capacity=G_FULL,
                           device=None if dev == "cuda" else dev)
    live.apply([RateLimitRequest(name="bb", unique_key="live", hits=1, limit=10, duration=5000,
                                 behavior=Behavior.GLOBAL)], NOW)
    try:
        live.measure_sync_cost_s(NOW + 1, iters=1)
    except RuntimeError as e:
        refused = str(e)
    else:
        raise AssertionError("phase 16 (d): measure_sync_cost_s ran on a live GLOBAL key")
    k4_row = next(r for r in rows if r["name"] == "global_sync")
    log(f"{tag} (d) measure_sync_cost_s (8 x {C_GLOBAL} slots, {G_FULL} gslots, iters "
        f"{iters}): {cost_s * 1e3:.4f} ms a sync, {k4} K4 launches; [numbers] K4 (the same "
        f"shapes) device {_ms(NUMBERS_DEVICE_MS.get('global_sync'))} a call, "
        f"{k4_row['ms']:.4f} ms a call back to back; a live GLOBAL "
        f"key refused ({refused[:60]}...)")
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"{tag} launches of the phase's path: K1 {launches['bucket_rounds_dict']}, K2 "
        f"{launches['bucket_rounds_cols']}, K3 {launches['global_answer_rounds']}, K4 "
        f"{launches['global_sync']}, K7 {launches['gather_rows']}, K8 {launches['write_rows']}")
    log(f"{tag} phase {time.perf_counter() - t_phase:.1f} s")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi, name = device_phase(torch)
    sass = build_phase()
    errs = kernel_phase(torch)
    gerrs = global_kernel_phase(torch)
    rerrs = rows_kernel_phase(torch)
    merr = moves_kernel_phase(torch)
    cerr = compact_kernel_phase(torch)
    service_phase()
    store, batches, launches = main_phase(torch)
    gstore, glaunches, ginputs, gsum = global_phase(torch)
    row_calls, plaunches = persist_phase(torch)
    tstore, titems, tlaunches, move_calls = two_tier_phase(torch)
    k1_inputs = two_tier_breakdown(torch, tstore, titems)
    sstore, sbatches, slaunches = shard_phase(torch)
    rows = numbers_phase(torch, store, batches, launches, errs, sass)
    rows += global_numbers_phase(torch, gstore, glaunches, gerrs, ginputs, gsum["now"])
    rows += rows_numbers_phase(torch, row_calls, plaunches, rerrs)
    rows += two_tier_numbers_phase(torch, tstore, tlaunches, move_calls, k1_inputs, merr)
    rows += shard_numbers_phase(torch, sstore, sbatches, slaunches, cerr, sass)
    del store, gstore, tstore, sstore, k1_inputs
    gc.collect()
    serve_phase(torch)
    gc.collect()
    edge_phase(torch)
    gc.collect()
    daemon_phase(torch)
    gc.collect()
    cluster_phase(torch, smi)
    gc.collect()
    federation_phase(torch, smi)
    gc.collect()
    blackbox_phase(torch, smi, rows)
    log(smi)  # again, so the tail of a long log names the card and limit
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
