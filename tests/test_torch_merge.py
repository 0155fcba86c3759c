"""HK14 shard_rank's merge-path rounds (tinysql_tpu_torch/csrc/shard_rank.cu)
on the CPU, where there is no card.

The numpy model in tinysql_tpu_torch/bench/rankcases.py follows the
kernel's steps: round j merges runs 2p and 2p + 1 of width run * 2^j; a
block's tile of TILE outputs is cut out of the two inputs by a merge-path
search on its diagonals (a tie takes the left input; half the block's
threads probe each diagonal's range at once, step by step), each of its
TILE / ITEMS threads finds its own split in the staged ranges and merges
ITEMS outputs in sequence, an odd run has an empty partner, round 0 reads
the keys through the ids, the last round keeps the ranks below k_out;
n * run <= SMALL runs every round in one block by binary searches in the
partner run.  It is held here to shard_rank_plain (the plain version the
kernel is held to on the card), at the kernel's constants and at small
tiles that cut the same inputs into many blocks, by the edge shapes and a
Hypothesis sweep; and, through the port's own K25 route (per-shard sorted
runs, then the model's merge), to the reference's K25 sort and top-k
(tinysql_tpu/ops/shardops.py sort_permutation_sharded / top_k_sharded,
JAX on the 8 virtual CPU devices tests/conftest.py forces).
"""
import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from tinysql_tpu.ops import progcache as ref_progcache
from tinysql_tpu.ops import shardops as ref_shardops
from tinysql_tpu.parallel import dist as ref_dist
from tinysql_tpu_torch.bench import rankcases as RC
from tinysql_tpu_torch.ops import kernels, shardops

SMALL_TILES = {"tile": 64, "items": 4, "small": 64}


@pytest.fixture(autouse=True)
def _cpu_device():
    with kernels.use_device("cpu"):
        yield


@pytest.fixture(autouse=True, scope="module")
def _reference_registry_unchanged():
    """The reference programs built here leave its process-global
    registry when the module ends (as in tests/test_torch_radix.py)."""
    before = set(ref_progcache.keys())
    yield
    with ref_progcache._mu:
        for k in [k for k in ref_progcache._REG if k not in before]:
            ref_progcache._REG.pop(k, None)
            ref_progcache._CATALOG.pop(k, None)


def _plain(keys, ids, stride, run, n, k_out):
    return kernels.shard_rank_plain(torch.as_tensor(keys),
                                    torch.as_tensor(ids), stride, run, n,
                                    k_out).numpy()


def test_model_constants_are_the_kernels():
    """The model's tile, items a thread and one-block limit are the
    constants csrc/shard_rank.cu compiles with."""
    src = open(os.path.join(os.path.dirname(kernels.__file__), os.pardir,
                            "csrc", "shard_rank.cu")).read()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
    assert const("kTile") == "kThreads * kItems"
    assert int(const("kThreads")) * int(const("kItems")) == RC.TILE
    assert int(const("kItems")) == RC.ITEMS
    assert const("kProbes") == "kThreads / 2"
    assert int(const("kSmall")) == RC.SMALL == kernels.RANK_SMALL


@settings(max_examples=80, deadline=None)
@given(la=st.integers(0, 5000), lb=st.integers(0, 5000),
       hi=st.sampled_from([2, 5, 1 << 40]),
       probes=st.sampled_from([1, 2, 8, 128]),
       at=st.tuples(st.floats(0.0, 1.0), st.floats(0.0, 1.0)),
       seed=st.integers(0, 1 << 16))
def test_tile_cuts_probe_search(la, lb, hi, probes, at, seed):
    """The block-wide probe search of a tile's two cuts: one writer of
    each shared word a step, the cut the binary search finds (ties to
    the left), in ceil(log_probes(range)) + 1 steps at most."""
    rng = np.random.default_rng(seed)
    ka = sorted(int(x) for x in rng.integers(0, hi, la))
    kb = sorted(int(x) for x in rng.integers(0, hi, lb))
    d0, d1 = sorted(int(round(f * (la + lb))) for f in at)
    (c0, c1), steps = RC.tile_cuts(ka, kb, d0, d1, probes)
    assert (c0, c1) == (RC._split(ka, kb, d0), RC._split(ka, kb, d1))
    widest = max(1, min(la, lb, max(d0, d1)))
    if probes > 1:
        need, reach = 1, probes
        while reach < widest:
            need, reach = need + 1, reach * probes
        assert steps <= need + 1


@pytest.mark.parametrize("tiles", ["kernel", "small"])
@pytest.mark.parametrize("case", sorted(RC.CASES))
def test_merge_model_edge_shapes(case, tiles):
    """Ties in 0..3, all keys equal, n = 1, 2 and 3 runs, a run length
    that is not a multiple of the tile, k_out < n * run, stride > run and
    the top-k's layout: the model's rows equal the plain version's and
    the wrapper's (which runs the plain version for CPU tensors)."""
    keys, ids, stride, run, n, k_out = RC.case(case, 11)
    kw = SMALL_TILES if tiles == "small" else {}
    got = RC.merge_rounds(keys, ids, stride, run, n, k_out, **kw)
    want = _plain(keys, ids, stride, run, n, k_out)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        kernels.shard_rank(torch.as_tensor(keys), torch.as_tensor(ids),
                           stride, run, n, k_out).numpy(), want)


@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 9), run=st.integers(1, 300),
       extra=st.integers(0, 40), frac=st.floats(0.0, 1.0),
       span=st.sampled_from([(0, 2), (0, 4), (-50, 50),
                             (-(1 << 62), 1 << 62)]),
       tiles=st.sampled_from(["kernel", "small", "tiny"]),
       seed=st.integers(0, 1 << 16))
def test_merge_model_sweep(n, run, extra, frac, span, tiles, seed):
    """Any run count, run length, stride, k_out and key spread (tie-heavy
    or across the sign bit, which the unsigned compare orders last): the
    model equals the plain version."""
    stride = run + extra
    k_out = max(1, int(round(frac * n * run)))
    keys, ids = RC.runs(n, run, stride, span[0], span[1], seed)
    kw = {"kernel": {}, "small": SMALL_TILES,
          "tiny": {"tile": 8, "items": 2, "small": 4}}[tiles]
    got = RC.merge_rounds(keys, ids, stride, run, n, k_out, **kw)
    np.testing.assert_array_equal(got, _plain(keys, ids, stride, run, n,
                                              k_out))


def _score_runs(v, m, desc, n_shards):
    """The port's K25 inputs: the score's order lane over the row bucket
    and each shard's stable sorted run (HK4's order, plain here)."""
    n_rows = v.shape[0]
    nb = kernels.bucket(n_rows)
    ordl = shardops._score_order([(v, m)], [desc], n_rows, nb)
    runs = kernels.lex_order_plain(
        [kernels.shard_lane(n_shards, nb // n_shards), ordl], nb)
    return ordl.numpy(), runs.numpy(), nb


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("tiles", ["kernel", "small"])
def test_model_is_the_reference_sort(n_shards, desc, tiles):
    """K25 sort: the model's merge of the port's per-shard runs is the
    reference's sharded ORDER BY permutation, ties by row."""
    rng = np.random.default_rng(2100 + n_shards + 2 * desc)
    n = 3000
    v = rng.integers(-40, 40, n).astype(np.int64)
    m = rng.random(n) < 0.05
    ordl, runs, nb = _score_runs(v, m, desc, n_shards)
    mm = nb // n_shards
    kw = SMALL_TILES if tiles == "small" else {}
    got = RC.merge_rounds(ordl, runs, mm, mm, n_shards, nb, **kw)[:n]
    want = ref_shardops.sort_permutation_sharded(
        ref_dist.sized_mesh(n_shards), [(v, m)], [desc], n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 10, 16, 50])
def test_model_is_the_reference_top_k(n_shards, k):
    """K25 top-k: the model's merge of each shard's top kb is the
    reference's distributed top-k, lowest row among ties."""
    rng = np.random.default_rng(2200 + n_shards + k)
    n = 3000
    v = rng.integers(-20, 20, n).astype(np.int64)
    m = rng.random(n) < 0.05
    ordl, _runs, nb = _score_runs(v, m, True, n_shards)
    mm = nb // n_shards
    kb = min(kernels.bucket(k), mm)
    t = torch.as_tensor(ordl)
    cand = np.concatenate([
        kernels.lex_order_plain([t[s * mm:(s + 1) * mm]], mm).numpy()[:kb]
        + s * mm for s in range(n_shards)])
    got = RC.merge_rounds(ordl, cand, kb, kb, n_shards, kb)[:k]
    got = got[got < n]
    want = ref_shardops.top_k_sharded(ref_dist.sized_mesh(n_shards),
                                      [(v, m)], [True], n, k)
    np.testing.assert_array_equal(got, want)
