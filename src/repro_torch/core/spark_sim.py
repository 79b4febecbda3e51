"""Analytical Spark-on-GCP performance model -> regenerated trace dataset.

The paper's trace (github.com/dos-group/flora, 180 executions) is not
reachable offline, so we regenerate an equivalent dataset: the exact job
list (Table I) x the exact configuration list (Table II), with runtimes
from a calibrated analytical model of Spark execution on GCP n2 VMs.

The model captures the effects the paper's evaluation hinges on:

* **Object-store I/O** — GCS bandwidth per node grows with vCPUs (GCP caps
  network egress per vCPU) up to a per-node cap, and sub-linearly with node
  count (shared-tenancy contention, stragglers):
  ``bw_total = bw_node(k) * n^0.85``.  At fixed total cores, more smaller
  nodes therefore read faster — the paper's #9-over-#2 observation.
* **Shuffle / local disk** — NIC and pd throughput have per-node floors, so
  scale-out buys aggregate shuffle bandwidth.
* **CPU scaling** — parallel work over total cores, mild per-core
  efficiency bonus on narrow nodes (less memory-bandwidth contention).
* **Memory (the paper's main axis)** — class A jobs cache a working set
  ``kappa * dataset``; usable cache is ``0.58 * (node_mem - 2 GiB)`` per
  node (Spark memory fraction + runtime overhead).  Misses trigger
  per-iteration reloads (re-read + re-parse for MEMORY_ONLY; spill/merge
  traffic for MEMORY_AND_DISK) with *superlinear* GC/eviction thrash in the
  miss fraction: a small shortfall is benign (LRU keeps the hot set), a
  large one is catastrophic — which is exactly why the paper's class-A jobs
  prefer 256 GiB clusters over both 64 GiB (thrash) and 512 GiB (price).
* **JVM heap penalty** — oversized heaps pay superlinear GC cost on
  cache-heavy jobs (many small executors beat few big ones at equal totals).

A deterministic log-normal noise term models shared-tenancy variance; the
paper ran each cell once, so noise stays in the trace (cf. §III-A "may make
this measured test job data somewhat vulnerable to outliers").

**Calibration status vs paper Table III** (seed=0; pinned by
``tests/test_flora_core.py::test_spark_sim_calibration_pinned``):

    ==============  ========  ===========
    statistic       paper     regenerated
    ==============  ========  ===========
    cost mean $     1.409     1.861
    cost min $      0.177     0.115
    runtime mean s  1834.8    2845.1
    runtime min s   141.7     125.9
    runtime max s   21714.7   24985.1
    ==============  ========  ===========

The drift is a heavy-tail artifact: the model's cache-thrash blowup
(``THRASH_CPU_FACTOR * miss_frac**4``) inflates the worst class-A cells
more than the paper's measured cluster did, dragging the means up while
the mins sit *below* paper (our startup/IO floors are slightly
optimistic).  A uniform runtime rescale cannot close it — matching the
cost mean (x0.757) pushes runtime min to 95 s, far under Table III's
141.7 s, and any *non*-uniform re-fit moves the per-job normalized
ranking the paper-claim tests pin (uniform scaling is
ranking-invariant; per-cell changes are not).  Every qualitative claim
the evaluation depends on (class A -> #9, class B -> #1, Table IV/V
orderings, Fig. 2/3 shapes) reproduces despite the gap, so the
constants stay as calibrated and the pinned test makes any further
drift a deliberate, reviewed change instead of a silent one.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, Iterable, Mapping, Optional, Sequence

from repro_torch.core.trace import (CloudConfig, ExecutionRecord, GCP_CONFIGS,
                                    JobSpec, PAPER_JOBS, Trace)

# --- machine model constants (calibrated against paper Tables III-V) ---------

GCS_BW_PER_CORE = 0.030    # GiB/s object-store bandwidth per vCPU...
GCS_BW_CORE_CAP = 8        # ...capped per node (practical GCS throughput)
GCS_BW_NODE_BASE = 0.050
GCS_BW_CLUSTER_CAP = 2.2   # GiB/s regional object-store contention cap
DISK_BW_PER_CORE = 0.015   # GiB/s local pd throughput per vCPU
DISK_BW_NODE_BASE = 0.090  # pd throughput floor per node
NET_BW_PER_CORE = 0.020    # GiB/s shuffle network bandwidth per vCPU
NET_BW_NODE_BASE = 0.110   # NIC floor per node
CLUSTER_SCALING = 0.85     # bw_total ~ n^CLUSTER_SCALING
CACHE_FRACTION = 0.58      # usable cache fraction of (node_mem - overhead)
NODE_MEM_OVERHEAD_GIB = 2.0
GC_HEAP_KNEE_GIB = 16.0    # heaps beyond this pay GC penalty on cache-heavy jobs
GC_PENALTY_PER_GIB = 0.002
CORE_EFF_EXPONENT = 0.06   # cpu_eff = (8 / cores_per_node) ** exponent
STARTUP_BASE_S = 70.0
STARTUP_PER_NODE_S = 0.5
THRASH_CPU_FACTOR = 6.0    # cpu *= 1 + f * miss_frac**4 (MEMORY_ONLY)
SPILL_CPU_FACTOR = 1.0     # cpu *= 1 + f * miss_frac**2 (MEMORY_AND_DISK)
SPILL_IO_PASSES = 4.0      # write + read-back + merge traffic per spilled GiB
REPARSE_FACTOR = 1.5       # recompute costs 1.5x the initial parse
NOISE_SIGMA = 0.08


@dataclasses.dataclass(frozen=True)
class AlgoParams:
    """Per-algorithm workload parameters."""

    w: float            # CPU core-seconds per GiB per pass
    parse_w: float      # one-time parse/deserialise core-seconds per GiB
    iters: int          # passes over the cached working set
    kappa: float        # cached working set / input size
    shuffle: float      # shuffle volume / input size
    out: float          # output volume / input size
    storage: str        # "mem" (MEMORY_ONLY), "disk" (MEMORY_AND_DISK), "none"
    kappa_peak: float   # peak memory / input (what Crispy-style tools measure)


ALGO_PARAMS: Mapping[str, AlgoParams] = {
    "Grep":               AlgoParams(8, 6, 1, 0.00, 0.002, 0.010, "none", 0.08),
    "Sort":               AlgoParams(22, 8, 1, 1.05, 2.000, 1.000, "disk", 1.20),
    "WordCount":          AlgoParams(100, 10, 1, 0.00, 0.050, 0.020, "none", 0.25),
    "KMeans":             AlgoParams(32, 16, 10, 1.10, 0.010, 0.001, "mem", 1.15),
    "LinearRegression":   AlgoParams(20, 16, 8, 0.55, 0.010, 0.001, "mem", 0.60),
    "LogisticRegression": AlgoParams(22, 16, 9, 0.65, 0.010, 0.001, "mem", 0.70),
    "Join":               AlgoParams(24, 8, 1, 0.75, 2.200, 0.300, "disk", 0.90),
    "GroupByCount":       AlgoParams(30, 8, 1, 0.00, 0.020, 0.001, "none", 0.20),
    "SelectWhereOrderBy": AlgoParams(18, 8, 1, 0.04, 0.040, 0.030, "disk", 0.12),
}


def _noise(job: JobSpec, config: CloudConfig, seed: int, sigma: float) -> float:
    """Deterministic log-normal multiplier per (job, config, seed)."""
    key = f"{job.algorithm}|{job.dataset_gib}|{config.index}|{seed}".encode()
    h = hashlib.md5(key).digest()
    u1 = (int.from_bytes(h[:8], "big") + 1) / (2 ** 64 + 2)
    u2 = (int.from_bytes(h[8:16], "big") + 1) / (2 ** 64 + 2)
    z = math.sqrt(-2.0 * math.log(u1)) * math.cos(2 * math.pi * u2)
    return math.exp(sigma * z)


def _gcs_bw(config: CloudConfig) -> float:
    node = GCS_BW_PER_CORE * min(config.cores_per_node, GCS_BW_CORE_CAP) \
        + GCS_BW_NODE_BASE
    return min(node * config.scale_out ** CLUSTER_SCALING, GCS_BW_CLUSTER_CAP)


def _disk_bw(config: CloudConfig) -> float:
    node = DISK_BW_PER_CORE * config.cores_per_node + DISK_BW_NODE_BASE
    return node * config.scale_out ** CLUSTER_SCALING


def _net_bw(config: CloudConfig) -> float:
    node = NET_BW_PER_CORE * config.cores_per_node + NET_BW_NODE_BASE
    return node * config.scale_out ** CLUSTER_SCALING


def usable_cache_gib(config: CloudConfig) -> float:
    per_node = max(0.0, config.mem_per_node_gib - NODE_MEM_OVERHEAD_GIB)
    return CACHE_FRACTION * per_node * config.scale_out


def runtime_s(job: JobSpec, config: CloudConfig, *, seed: int = 0,
              noise_sigma: float = NOISE_SIGMA) -> float:
    """Modelled wall-clock runtime of ``job`` on ``config`` in seconds."""
    p = ALGO_PARAMS[job.algorithm]
    s = job.dataset_gib
    n, k = config.scale_out, config.cores_per_node

    gcs, disk, net = _gcs_bw(config), _disk_bw(config), _net_bw(config)
    cores_eff = config.total_cores * (8.0 / k) ** CORE_EFF_EXPONENT
    heap = max(1.0, config.mem_per_node_gib - NODE_MEM_OVERHEAD_GIB)
    gc = 1.0
    if p.kappa > 0:
        gc += GC_PENALTY_PER_GIB * max(0.0, heap - GC_HEAP_KNEE_GIB)

    t = STARTUP_BASE_S + STARTUP_PER_NODE_S * n
    t += s / gcs                                   # input read
    t += p.out * s / gcs                           # output write
    if p.shuffle > 0:                              # shuffle: net + write-back
        t += p.shuffle * s / net + 0.5 * p.shuffle * s / disk

    cpu = (p.parse_w * s + p.w * s * p.iters) / cores_eff

    # memory behaviour: cache miss -> reloads + thrash
    need = p.kappa * s
    if need > 0:
        avail = usable_cache_gib(config)
        miss = max(0.0, need - avail)
        mf = miss / need
        reload_passes = max(0, p.iters - 1)
        if p.storage == "mem" and miss > 0:
            # MEMORY_ONLY: evicted partitions are recomputed from source.
            # LRU keeps the hot set, so effective reload volume ~ miss * mf.
            vol = miss * mf * reload_passes
            t += vol / gcs
            cpu += vol * REPARSE_FACTOR * p.parse_w / cores_eff
            cpu *= 1.0 + THRASH_CPU_FACTOR * mf ** 4
        elif p.storage == "disk" and miss > 0:
            # MEMORY_AND_DISK: spill to local disk, read back, merge.
            vol = miss * mf * SPILL_IO_PASSES * max(1, reload_passes)
            t += vol / disk
            cpu *= 1.0 + SPILL_CPU_FACTOR * mf ** 2
    t += cpu * gc

    return t * _noise(job, config, seed, noise_sigma)


def generate_trace(*, seed: int = 0, noise_sigma: float = NOISE_SIGMA,
                   jobs: Sequence[JobSpec] = PAPER_JOBS,
                   configs: Sequence[CloudConfig] = GCP_CONFIGS) -> Trace:
    """Regenerate the 180-execution evaluation trace (Tables I x II)."""
    records = [
        ExecutionRecord(job=j, config_index=c.index,
                        runtime_s=runtime_s(j, c, seed=seed,
                                            noise_sigma=noise_sigma))
        for j in jobs for c in configs
    ]
    return Trace(configs, records)
