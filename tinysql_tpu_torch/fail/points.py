"""THE failpoint catalogue: every named inject site in the engine.

qlint FP502 statically checks that each ``failpoint.inject("...")`` /
``eval`` site names a point registered here, and the chaos suite
(tests/test_chaos.py) asserts it has a driver for EVERY name below — so
a new failpoint cannot be added without both a registration and a chaos
proof that arming it degrades cleanly.
"""
from __future__ import annotations

from . import register

# ---- kv / 2PC (store/tikv lineage) ----------------------------------------
RPC_SERVER_BUSY = register(
    "rpcServerBusy",
    "RPC region check raises RegionError(server_busy) — drives the "
    "BO_REGION_MISS retry ladder (kv/rpc.py)")
PREWRITE_ERROR = register(
    "prewriteError",
    "kv_prewrite raises before touching MVCC — 2PC must clean up, no "
    "locks left (kv/rpc.py)")
COMMIT_ERROR = register(
    "commitError",
    "kv_commit raises for every batch (kv/rpc.py)")
COMMIT_PRIMARY_ERROR = register(
    "commitPrimaryError",
    "commit RPC on the PRIMARY batch fails — outcome undetermined, "
    "UndeterminedError must surface (kv/txn.py)")
COMMIT_SECONDARY_ERROR = register(
    "commitSecondaryError",
    "commit RPC on a secondary batch fails — txn stays durable, later "
    "readers resolve the leftover locks (kv/txn.py)")
BEFORE_COMMIT = register(
    "beforeCommit",
    "between prewrite and commit_keys — a panic here models the classic "
    "Percolator crashed-committer window (kv/txn.py)")

# ---- durability: WAL + checkpoint (kv/wal.py) ------------------------------
WAL_APPEND_ERROR = register(
    "walAppendError",
    "WAL record append fails BEFORE any bytes are written — the "
    "journaled mutation is not applied, a typed WalError surfaces, the "
    "store never diverges ahead of its log (kv/wal.py append)")
WAL_FSYNC_ERROR = register(
    "walFsyncError",
    "the wal fsync syscall fails — under strict policy the ack-bearing "
    "commit surfaces a typed error (the bytes may still be in the page "
    "cache: outcome undetermined, exactly the primary-commit contract); "
    "counted as fsync_errors (kv/wal.py _fsync_locked)")
WAL_TORN_TAIL = register(
    "walTornTail",
    "the next record is deliberately half-written — the crash-boundary "
    "lever: recovery must truncate at the first bad checksum and the "
    "live log poisons itself (further appends raise WalError) "
    "(kv/wal.py append)")
CHECKPOINT_ERROR = register(
    "checkpointError",
    "a checkpoint attempt fails (or stalls, with sleep=) before the "
    "atomic rename — counted, never fatal: the previous checkpoint + "
    "unrotated log remain the recovery source; armed during recovery it "
    "is the crash-during-recovery lever (kv/wal.py checkpoint)")

# ---- distsql coprocessor ---------------------------------------------------
COP_TASK_ERROR = register(
    "copTaskError",
    "start of every region task attempt in the scatter-gather pool — "
    "RegionError retries through re-split, generic errors surface typed "
    "(distsql/client.py)")

# ---- device tier -----------------------------------------------------------
DEVPIPE_STAGE_ERROR = register(
    "devpipeStageError",
    "block-staging function of the async pipeline — the producer's "
    "error contract must deliver it to the consumer in order "
    "(executor/devpipe.py BlockPipeline)")
KERNEL_DISPATCH_ERROR = register(
    "kernelDispatchError",
    "every counted kernel launch (ops/kernels.py counted_launch) — "
    "the statement must fail with the error, never re-run on the CPU")
KERNEL_D2H_ERROR = register(
    "kernelD2HError",
    "every device->host materialization (ops/kernels.py d2h/d2h_many)")
BACKEND_PROBE_FAIL = register(
    "backendProbeFail",
    "backend liveness probe reports the device backend unreachable — "
    "engine must pin jax_platforms=cpu instead of hanging "
    "(ops/kernels.py ensure_live_backend)")

# ---- DDL -------------------------------------------------------------------
DDL_STEP_ERROR = register(
    "ddlStepError",
    "one DDL worker state-machine step fails — the job retries/rolls "
    "back, the queue never wedges (ddl/worker.py)")
REORG_BATCH_ERROR = register(
    "reorgBatchError",
    "one index-backfill batch fails — reorg resumes from the checkpoint "
    "handle (ddl/worker.py)")

# ---- auto-prewarm ----------------------------------------------------------
PREWARM_COMPILE_ERROR = register(
    "prewarmCompileError",
    "start of one family's warm attempt in the auto-prewarm worker — "
    "the worker must count the error, start the family's cooldown, and "
    "keep serving later candidates and cycles (session/prewarm.py)")

# ---- serving / admission ---------------------------------------------------
ADMISSION_QUEUE_FULL = register(
    "admissionQueueFull",
    "admission gate reports the statement queue full — every pooled "
    "statement sheds with typed MySQL 1041 + retry hint; control "
    "statements and KILL keep working (server/admission.py)")
ADMISSION_DELAY = register(
    "admissionDelay",
    "statement-pool worker stalls (sleep) or fails (error) with an "
    "entry claimed — the queue builds behind it, queued statements stay "
    "KILLable, the accept loop never hangs (server/pool.py)")

# ---- sharded operator tier (ops/shardops.py) -------------------------------
SHARD_EXCHANGE_STALL = register(
    "shardExchangeStall",
    "entry of a partitioned join/semijoin shard exchange (ops/shardops.py)"
    " — armed with sleep= it holds the statement mid-exchange so KILL "
    "must land at the next drain-block boundary with the session healthy "
    "after; armed with exc= the sharded attempt surfaces the error")

# ---- memory-adaptive spilling (ops/spill.py) -------------------------------
SPILL_PARTITION_ERROR = register(
    "spillPartitionError",
    "spill-store partition write fails — the statement surfaces a typed "
    "error, no partition files or resident bytes leak (ops/spill.py "
    "SpillStore.put)")
SPILL_RELOAD_ERROR = register(
    "spillReloadError",
    "spilled-partition reload fails mid-probe/merge — typed error, all "
    "remaining partitions dropped cleanly (ops/spill.py SpillStore.load)")
SPILL_FORCE_ALL = register(
    "spillForceAll",
    "armed with return(1): every spill-capable operator (hash join, "
    "hash agg, sort, topn) runs its partitioned spill path regardless "
    "of tidb_mem_quota_query — the spill==no-spill equivalence and CI "
    "smoke lever (ops/spill.py maybe_context)")

# ---- executor --------------------------------------------------------------
EXEC_SLOW_NEXT = register(
    "execSlowNext",
    "fires once per root drain block — a sleep action makes any "
    "statement controllably long-running (KILL / max_execution_time "
    "tests; executor/executors.py Executor.drain)")

# ---- continuous heap profiler (obs/memprof.py) -----------------------------
MEMPROF_SAMPLE_ERROR = register(
    "memprofSampleError",
    "one heap-profiler sampling tick fails at snapshot time "
    "(obs/memprof.py HeapProfiler.sample_once) — the background sampler "
    "counts the error and keeps ticking, the fold/attribution store "
    "stays consistent, no statement or surface is affected")
