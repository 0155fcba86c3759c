"""The port's K26 (tinysql_tpu_torch/parallel/dist.py) and the plain
versions of its kernels: HK13 shard_exchange, HK14 shard_rank, HK12's
member and count modes and HK8's shard mode, against the reference's
shard_map programs (tinysql_tpu/parallel/dist.py, ops/shardops.py) on the
8 virtual CPU devices tests/conftest.py forces, and against numpy.

Exchanged lanes must equal the reference's received lanes slot for slot
(the local join's build rows and the row order above the join depend on
it); counts and ranks exactly; the step's bucket sums within 1e-9
relative (another addition order), as __graft_entry__'s oracle bounds
them.  On the card the kernels are held to these plain versions
(tests/test_torch_cuda.py, chip_smoke.py's mesh phase)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinysql_tpu.ops import progcache as ref_progcache
from tinysql_tpu.ops import shardops as ref_shardops
from tinysql_tpu.parallel import dist as ref_dist
from tinysql_tpu_torch.ops import kernels, shardops
from tinysql_tpu_torch.parallel import dist

t = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def _fresh_reference_programs():
    """Leave the reference's program cache as a fresh worker process has
    it: its own mesh tests assert that they compile these shapes."""
    yield
    ref_progcache.clear()


@pytest.fixture(autouse=True)
def _cpu():
    with kernels.use_device("cpu"):
        yield


def _ref_exchange(n, keys, n_rows, lanes, cap):
    """The reference's hash_dest_traced + exchange_lanes (all_to_all)
    under shard_map: the lanes every shard receives, concatenated."""
    mesh = ref_dist.make_mesh(n)
    shard_map, P = ref_dist.shard_map_fn()
    nb = len(keys)
    fills = [f for _, f in lanes]

    def body(k, *arrs):
        si = jax.lax.axis_index("shard").astype(jnp.int64)
        m = nb // n
        d = ref_dist.hash_dest_traced(jnp, k, n, si * m + jnp.arange(m),
                                      n_rows)
        return tuple(ref_dist.exchange_lanes(
            jnp, list(zip(arrs, fills)), d, cap, n))
    fn = jax.jit(shard_map(body, mesh=mesh,
                           in_specs=(P("shard"),) * (1 + len(lanes)),
                           out_specs=(P("shard"),) * len(lanes)))
    return [np.asarray(x) for x in fn(keys, *[a for a, _ in lanes])]


def _lanes(rng, nb):
    v = rng.normal(size=nb) * 100
    v[:3] = [-0.0, np.inf, np.nan]
    iv = rng.integers(-(1 << 40), 1 << 40, nb).astype(np.int64)
    nul = rng.random(nb) < 0.25
    return [(v, 0.0), (iv, 0), (nul, True)]


# =========================================================================
# HK13: the exchange
# =========================================================================

@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("pad", [0, 37])
def test_exchange_equals_reference_slot_for_slot(n, pad):
    rng = np.random.default_rng(5 * n + pad)
    nb = n * 128
    n_rows = nb - pad
    keys = rng.integers(-60, 60, nb).astype(np.int64)
    keys[:4] = [kernels.I64_MIN, kernels.I64_MAX, 0, -1]
    valid = rng.random(nb) < 0.8
    valid[n_rows:] = False
    lanes = _lanes(rng, nb) + [(valid, False)]
    cap = ref_dist.shuffle_cap(keys, n, n_rows)
    assert cap == dist.shuffle_cap(keys, n, n_rows)
    want = _ref_exchange(n, keys, n_rows, lanes, cap)
    got = dist.exchange_lanes(t(keys), n_rows, [(t(a), f) for a, f in lanes],
                              cap, n)
    for g, w in zip(got, want):
        assert g.shape == (n * n * cap,)
        np.testing.assert_array_equal(g.numpy().view(np.uint8),
                                      w.view(np.uint8))


@pytest.mark.parametrize("n", [2, 8])
def test_exchange_two_chunks_and_narrow_lanes_equal_reference(n):
    """More lanes than one launch takes (19: two chunks of HK13's
    kMaxLanes) with 1-, 2-, 4- and 8-byte lanes and fills that are not
    byte-uniform: slot for slot the reference's received lanes."""
    rng = np.random.default_rng(71 * n)
    nb = n * 96
    n_rows = nb - 11
    keys = rng.integers(-40, 40, nb).astype(np.int64)
    lanes = []
    for j in range(19):
        kind = j % 4
        if kind == 0:
            lanes.append((rng.integers(-99, 99, nb).astype(np.int8), -7))
        elif kind == 1:
            lanes.append((rng.integers(-999, 999, nb).astype(np.int16), 300))
        elif kind == 2:
            lanes.append((rng.integers(-9, 9, nb).astype(np.int32), -2))
        else:
            lanes.append((rng.normal(size=nb), -1.5))
    cap = ref_dist.shuffle_cap(keys, n, n_rows)
    want = _ref_exchange(n, keys, n_rows, lanes, cap)
    got = dist.exchange_lanes(t(keys), n_rows, [(t(a), f) for a, f in lanes],
                              cap, n)
    assert len(got) == 19
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype and g.shape == (n * n * cap,)
        np.testing.assert_array_equal(g.numpy().view(np.uint8),
                                      w.view(np.uint8))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_hash_dest_is_the_host_twin_and_the_exchange_destination(n):
    """dist.hash_dest equals dist.hash_dest_np, and every row lands in
    the received block of that destination, at its stable rank."""
    rng = np.random.default_rng(17 * n)
    nb, n_rows = n * 64, n * 64 - 5
    keys = rng.integers(-(1 << 50), 1 << 50, nb).astype(np.int64)
    d = dist.hash_dest(t(keys), n, n_rows).numpy()
    np.testing.assert_array_equal(d, dist.hash_dest_np(keys, n, n_rows))
    np.testing.assert_array_equal(d, ref_dist.hash_dest_np(keys, n, n_rows))
    cap = dist.shuffle_cap(keys, n, n_rows)
    ids = np.arange(nb, dtype=np.int64)
    got = dist.exchange_lanes(t(keys), n_rows, [(t(ids), -1)], cap, n)[0]
    got = got.numpy().reshape(n, n, cap)
    m = nb // n
    for dd in range(n):
        for s in range(n):
            rows = got[dd, s][got[dd, s] >= 0]
            want = [g for g in range(s * m, (s + 1) * m) if d[g] == dd]
            np.testing.assert_array_equal(rows, want)


def test_exchange_overflow_raises_instead_of_dropping():
    keys = np.zeros(64, dtype=np.int64)  # every row to one shard
    with pytest.raises(RuntimeError, match="capacity"):
        dist.exchange_lanes(t(keys), 64, [(t(keys), 0)], 4, 4)


def test_exchange_rejects_bad_arguments():
    k = torch.zeros(64, dtype=torch.int64)
    for n, cap in ((3, 16), (1, 16), (4, 0), (2048, 16)):
        with pytest.raises(ValueError):
            kernels.shard_exchange(k, 64, [(k, 0)], cap, n)
    with pytest.raises(ValueError):
        kernels.shard_exchange(k.to(torch.float64), 64, [(k, 0)], 16, 4)
    with pytest.raises(ValueError):
        kernels.shard_exchange(k, 64, [], 16, 4)


# =========================================================================
# HK4 + HK12: the local join of the received partitions
# =========================================================================

@pytest.mark.parametrize("n", [2, 8])
def test_local_unique_join_equals_reference(n):
    """Per shard: hit equals the reference's; brow names the same
    received build slot (the reference's is local to the shard)."""
    rng = np.random.default_rng(61 * n)
    bn = 32  # received build slots per shard
    bk = rng.integers(0, 40, n * bn).astype(np.int64)
    bk[:2] = kernels.I64_MAX
    blive = rng.random(n * bn) < 0.7
    pk = rng.integers(0, 45, n * 48).astype(np.int64)
    pk[:2] = kernels.I64_MAX
    mesh = ref_dist.make_mesh(n)
    shard_map, P = ref_dist.shard_map_fn()
    fn = jax.jit(shard_map(
        lambda b, l, p: ref_dist.local_unique_join(jnp, b, l, p, bn),
        mesh=mesh, in_specs=(P("shard"),) * 3,
        out_specs=(P("shard"), P("shard"))))
    whit, wbrow = (np.asarray(x) for x in fn(bk, blive, pk))
    hit, brow = dist.local_unique_join(t(bk), t(blive), t(pk), n)
    np.testing.assert_array_equal(hit.numpy(), whit)
    shard = np.arange(n * 48) // 48
    np.testing.assert_array_equal(brow.numpy()[whit],
                                  (shard * bn + wbrow)[whit])
    assert (brow.numpy()[~whit] == -1).all() and whit.any()


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_member_mode_equals_reference(dtype):
    """HK12's member mode over the partition blocks equals the
    reference's _local_member_kernel, and the hit of the unique mode."""
    rng = np.random.default_rng(73)
    n, cap_p, cap_b = 8, 32, 16
    pk = rng.integers(-20, 20, n * cap_p).astype(dtype)
    bk = rng.integers(-20, 20, n * cap_b).astype(dtype)
    if dtype == np.float64:
        pk[:3] = [np.nan, -0.0, np.inf]
        bk[:2] = [0.0, np.inf]
    pid = np.where(rng.random(n * cap_p) < 0.8, np.arange(n * cap_p),
                   -1).astype(np.int64)
    bid = np.where(rng.random(n * cap_b) < 0.7,
                   np.arange(n * cap_b), -1).astype(np.int64)
    want = np.asarray(ref_shardops._local_member_kernel(
        ref_dist.make_mesh(n), cap_p, cap_b, str(pk.dtype))(
        pk.reshape(n, cap_p), pid.reshape(n, cap_p),
        bk.reshape(n, cap_b), bid.reshape(n, cap_b))).reshape(-1)
    got = shardops._local_member(n, t(pk), t(pid), t(bk), t(bid))
    np.testing.assert_array_equal(got.numpy(), want)
    hit, _ = shardops._local_unique_join(n, t(pk), t(pid), t(bk), t(bid))
    np.testing.assert_array_equal(hit.numpy(), want)
    assert want.any() and not want.all()


# =========================================================================
# K26: the sharded group sum, the broadcast join counts, the step
# =========================================================================

def _graft_inputs(n, seed=1, n_buckets=32):
    """__graft_entry__.dryrun_multichip's inputs (8 x 68 rows, 32 buckets,
    37 sorted build keys)."""
    rng = np.random.default_rng(seed)
    rows_total = 4 * n * 17
    buckets = rng.integers(0, n_buckets, rows_total).astype(np.int32)
    vals = rng.uniform(-5, 5, rows_total)
    lkeys = rng.integers(0, 50, rows_total).astype(np.int64)
    rkeys = np.sort(rng.integers(0, 50, 37).astype(np.int64))
    ones = np.ones(rows_total, dtype=bool)
    sh = ref_dist.shard_rows
    return (buckets, vals, lkeys, rkeys,
            (sh(buckets, n), sh(vals, n), sh(ones, n, fill=False),
             sh(lkeys, n), sh(ones, n, fill=False), rkeys))


@pytest.mark.parametrize("n", [2, 8])
def test_distributed_query_step_equals_reference_and_oracle(n):
    n_buckets = 32
    buckets, vals, lkeys, rkeys, ins = _graft_inputs(n)
    step = ref_dist.distributed_query_step(ref_dist.make_mesh(n), n_buckets)
    wsums, wcnts, wcounts, wtotal = (np.asarray(x) for x in step(
        *[jnp.asarray(a) for a in ins]))
    kernels.reset_kernel_counts()
    got = dist.distributed_query_step(dist.Mesh(n, torch.device("cpu")),
                                      n_buckets)(*[t(a) for a in ins])
    sums, cnts, counts, total = (x.numpy() for x in got)
    np.testing.assert_allclose(sums, wsums, rtol=1e-9)
    np.testing.assert_array_equal(cnts, wcnts)
    np.testing.assert_array_equal(counts, wcounts)
    assert int(total) == int(wtotal)
    # __graft_entry__'s numpy oracle
    want_sums = np.zeros(n_buckets)
    want_cnts = np.zeros(n_buckets, dtype=np.int64)
    for b, v in zip(buckets, vals):
        want_sums[b] += v
        want_cnts[b] += 1
    np.testing.assert_allclose(sums, want_sums, rtol=1e-9)
    np.testing.assert_array_equal(cnts, want_cnts)
    assert int(total) == sum(int(np.sum(rkeys == k)) for k in lkeys)
    plain = kernels.kernel_counts()["plain_calls"]
    assert plain["segment_reduce"] == n and plain["shard_count"] == 1
    assert plain["shard_merge"] == 2


def test_broadcast_join_counts_skip_invalid_rows_and_empty_builds():
    n = 4
    lk = np.arange(64, dtype=np.int64) % 7
    lv = np.arange(64) % 3 != 0
    rk = np.array([1, 1, 2, 6, 6, 6], dtype=np.int64)
    mesh = dist.Mesh(n, torch.device("cpu"))
    counts, total = dist.broadcast_join_counts(
        mesh, t(lk).reshape(n, -1), t(lv).reshape(n, -1), t(rk))
    want = np.where(lv, [int(np.sum(rk == k)) for k in lk], 0)
    np.testing.assert_array_equal(counts.numpy().reshape(-1), want)
    assert int(total) == want.sum()
    counts, total = dist.broadcast_join_counts(
        mesh, t(lk).reshape(n, -1), t(lv).reshape(n, -1),
        torch.zeros(0, dtype=torch.int64))
    assert int(total) == 0 and not counts.numpy().any()


# =========================================================================
# HK14: the merge of sorted runs
# =========================================================================

@pytest.mark.parametrize("n,run,k_out", [(2, 16, 32), (8, 64, 512),
                                         (8, 16, 10), (4, 1, 4)])
def test_shard_rank_is_the_stable_merge(n, run, k_out):
    """Runs of heavy ties: the merged order is the stable sort of all
    elements by (key, shard, place) — the global row order."""
    rng = np.random.default_rng(n * run + k_out)
    stride = run + 3
    nb = n * stride
    ordl = rng.integers(-4, 4, nb).astype(np.int64)
    ordl[:2] = [kernels.I64_MIN, kernels.I64_MAX]
    ids = np.arange(nb, dtype=np.int64)
    for s in range(n):  # sort each run by (unsigned key, row)
        blk = slice(s * stride, s * stride + run)
        key = ordl[ids[blk]] ^ kernels.I64_MIN
        ids[blk] = ids[blk][np.argsort(key, kind="stable")]
    got = kernels.shard_rank(t(ordl), t(ids), stride, run, n, k_out).numpy()
    elems = np.concatenate([ids[s * stride:s * stride + run]
                            for s in range(n)])
    order = np.argsort(ordl[elems] ^ kernels.I64_MIN, kind="stable")
    np.testing.assert_array_equal(got, elems[order][:k_out])


def test_shard_rank_rejects_bad_arguments():
    z = torch.zeros(32, dtype=torch.int64)
    for stride, run, n, k in ((4, 8, 2, 4), (8, 8, 2, 17), (8, 8, 8, 4)):
        with pytest.raises(ValueError):
            kernels.shard_rank(z, z, stride, run, n, k)


# =========================================================================
# HK8's shard mode
# =========================================================================

def _csr_inputs(rng, nbb=64, nb=128):
    keys = rng.integers(0, 12, nbb).astype(np.int64)
    order = np.argsort(keys, kind="stable").astype(np.int64)
    sk = keys[order]
    ends = np.nonzero(np.r_[sk[1:] != sk[:-1], True])[0].astype(np.int64)
    gkeys = sk[ends]
    lo, hi = int(gkeys.min()), int(gkeys.max())
    tbl = np.full(hi - lo + 1, -1, dtype=np.int32)
    tbl[gkeys - lo] = np.arange(len(gkeys), dtype=np.int32)
    pk = rng.integers(-1, 15, nb).astype(np.int64)
    pn = rng.random(nb) < 0.1
    pvalid = rng.random(nb) < 0.85
    bvalid = rng.random(nbb) < 0.8
    return keys, order, ends, lo, hi, tbl, pk, pn, pvalid, bvalid


@pytest.mark.parametrize("outer", [False, True])
@pytest.mark.parametrize("n", [2, 8])
def test_csr_expand_shard_mode_is_per_shard_expansion(outer, n):
    """Shard s's bucket holds exactly its own probe rows' expansion, probe
    rows ascending and each one's valid build rows in group order (the
    reference's per-shard joinm output), its offsets restarting at the
    shard; past its total, invalid slots."""
    rng = np.random.default_rng(9 * n + outer)
    keys, order, ends, lo, hi, tbl, pk, pn, pvalid, bvalid = \
        _csr_inputs(rng)
    nb, nbb = len(pk), len(keys)
    prow = np.arange(nb, dtype=np.int64)
    brow_lane = np.arange(nbb, dtype=np.int64) * 10
    per = []
    for i in range(nb):
        if not pvalid[i]:
            per.append([])
            continue
        hits = [] if pn[i] else [r for r in order if keys[r] == pk[i]
                                 and bvalid[r]]
        per.append([(i, r) for r in hits] or ([(i, None)] if outer else []))
    blk = nb // n
    ob = kernels.bucket(max(sum(len(p) for p in per[s * blk:(s + 1) * blk])
                            for s in range(n)))
    valid, pcols, bcols = kernels.csr_expand(
        t(order), t(ends), len(ends), nbb, t(bvalid), t(tbl), lo, hi,
        [(t(pk), t(pn))], None, t(pvalid), outer, ob,
        [(t(prow), None)], [(t(brow_lane), None)], shards=n)
    assert valid.shape == (n * ob,)
    for s in range(n):
        want = [x for p in per[s * blk:(s + 1) * blk] for x in p]
        sl = slice(s * ob, (s + 1) * ob)
        v = valid[sl].numpy()
        assert v.sum() == len(want) and v[:len(want)].all()
        got_p = pcols[0][0][sl].numpy()[:len(want)]
        got_b = np.where(bcols[0][1][sl].numpy(), -1,
                         bcols[0][0][sl].numpy() // 10)[:len(want)]
        np.testing.assert_array_equal(got_p, [i for i, _ in want])
        np.testing.assert_array_equal(
            got_b, [-1 if r is None else r for _, r in want])
    one = kernels.csr_expand(
        t(order), t(ends), len(ends), nbb, t(bvalid), t(tbl), lo, hi,
        [(t(pk[:blk]), t(pn[:blk]))], None, t(pvalid[:blk]), outer, ob,
        [(t(prow[:blk]), None)], [(t(brow_lane), None)])
    np.testing.assert_array_equal(one[0].numpy(), valid[:ob].numpy())
    np.testing.assert_array_equal(one[2][0][0].numpy(),
                                  bcols[0][0][:ob].numpy())
