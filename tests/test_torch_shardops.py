"""The port's mesh-sharded operator tier (tinysql_tpu_torch/ops/shardops.py,
parallel/dist.py) and its kernels' plain versions, HK11 shard_merge, HK12
shard_probe (and its member and count modes), HK13 shard_exchange and
HK14 shard_rank, against the reference's (tinysql_tpu/ops/shardops.py,
parallel/dist.py).

The reference runs on the 8 virtual CPU devices tests/conftest.py forces;
the port's mesh is N virtual shards on the CPU device, with
TINYSQL_MESH_SHARDS at the same count.  Join outputs must equal the
reference's bit for bit; the plain kernels must equal a numpy left fold
over the shards in order (HK11) and numpy's searchsorted per shard
(HK12).  On the card the kernels are held to these plain versions
(chip_smoke.py's mesh phase, tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from tinysql_tpu.ops import progcache as ref_progcache
from tinysql_tpu.ops import shardops as ref_shardops
from tinysql_tpu.ops import spill as ref_spill
from tinysql_tpu.parallel import dist as ref_dist
from tinysql_tpu_torch.ops import kernels, shardops
from tinysql_tpu_torch.parallel import dist

NDEV = 8
MESH_SIZES = [1, 2, 4, 8]
I64_MIN, I64_MAX = kernels.I64_MIN, kernels.I64_MAX


@pytest.fixture(scope="module", autouse=True)
def _fresh_reference_programs():
    """Leave the reference's program cache as a fresh worker process has
    it: its own mesh tests assert that they compile these shapes."""
    yield
    ref_progcache.clear()


@pytest.fixture(autouse=True)
def _mesh_env(monkeypatch):
    """The port's shard count and device for every test here."""
    monkeypatch.setenv("TINYSQL_MESH_SHARDS", str(NDEV))
    with kernels.use_device("cpu"):
        yield


def _rng(seed):
    return np.random.default_rng(seed)


def _keys(rng, n, lo, hi, null_frac=0.1, dtype=np.int64):
    v = rng.integers(lo, hi, n).astype(np.int64)
    if dtype == np.float64:
        v = v.astype(np.float64) * 0.5
    return v, rng.random(n) < null_frac


# =========================================================================
# policy (parallel/dist.py)
# =========================================================================

@pytest.mark.parametrize("est,n", [(0, 8), (255, 8), (512, 8), (1024, 8),
                                   (2048, 8), (1e9, 8), (1e9, 4), (600, 2)])
def test_shard_bucket_matches_reference(est, n):
    assert dist.shard_bucket(est, n) == ref_dist.shard_bucket(est, n)


def test_mesh_count_from_the_environment(monkeypatch):
    """TINYSQL_MESH_SHARDS is read each time a mesh forms; below 2 means
    no mesh; a count that is not a power of two raises."""
    on = {"tidb_mesh_parallel": 1}
    assert dist.session_mesh(on).n_shards == 8
    assert dist.session_mesh({"tidb_mesh_parallel": 0}) is None
    monkeypatch.setenv("TINYSQL_MESH_SHARDS", "4")
    m = dist.session_mesh(on)
    assert m.shards == 4 and m.device == torch.device("cpu")
    assert dist.sized_mesh(8).n_shards == 4
    assert dist.sized_mesh(1) is None
    monkeypatch.setenv("TINYSQL_MESH_SHARDS", "1")
    assert dist.session_mesh(on) is None
    monkeypatch.delenv("TINYSQL_MESH_SHARDS")
    assert dist.device_count() == 1  # the CPU device: one shard
    assert dist.session_mesh(on) is None
    monkeypatch.setenv("TINYSQL_MESH_SHARDS", "6")
    with pytest.raises(ValueError, match="power-of-two"):
        dist.session_mesh(on)


@pytest.mark.parametrize("nb", [16, 64, 128, 1 << 20, 96])
def test_shardable_matches_reference(nb):
    for n in (2, 4, 8):
        assert dist.shardable(nb, dist.sized_mesh(n)) \
            == ref_dist.shardable(nb, ref_dist.sized_mesh(n))


def test_hash_dest_and_shuffle_cap_match_reference():
    keys = _rng(5).integers(-(1 << 40), 1 << 40, 4096).astype(np.int64)
    for n in (2, 4, 8):
        np.testing.assert_array_equal(dist.hash_dest_np(keys, n, 4000),
                                      ref_dist.hash_dest_np(keys, n, 4000))
        assert dist.shuffle_cap(keys, n, 4000) \
            == ref_dist.shuffle_cap(keys, n, 4000)


# =========================================================================
# K25 unique join: byte-identity with the reference across mesh sizes
# =========================================================================

@pytest.mark.parametrize("n_shards", MESH_SIZES)
@pytest.mark.parametrize("outer", [False, True])
@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_unique_join_identity(n_shards, outer, dtype):
    rng = _rng(1117 + n_shards)
    n_left, n_right = 700, 400
    lk, ln = _keys(rng, n_left, 0, 500, dtype=dtype)
    rv0 = rng.permutation(500)[:n_right].astype(np.int64)  # unique build
    rk = rv0.astype(np.float64) * 0.5 if dtype == np.float64 else rv0
    rn = rng.random(n_right) < 0.05
    lvalid = rng.random(n_left) < 0.9
    rvalid = rng.random(n_right) < 0.9
    args = ((lk, ln), n_left, (rk, rn), n_right)
    kw = dict(outer=outer, lvalid=lvalid, rvalid=rvalid)
    want = ref_shardops.unique_join_match_sharded(
        ref_dist.sized_mesh(n_shards), *args, **kw)
    got = shardops.unique_join_match_sharded(
        dist.sized_mesh(n_shards), *args, **kw)
    if n_shards < 2:
        assert got is None and want is None
        return
    single = kernels.unique_join_match(*args, **kw)
    for g, w, s in zip(got, want, single):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, s)


def test_unique_join_duplicate_build_keys_take_the_lowest_row():
    """Equal live build keys: the lowest build row matches, as the
    reference's (key, liveness, slot) sort gives; -0.0 probes find 0.0."""
    lk = np.array([3.0, -0.0, 7.0, 3.0, np.nan])
    rk = np.array([3.0, 0.0, 3.0, 9.0, 3.0])
    ln, rn = np.zeros(5, dtype=bool), np.zeros(5, dtype=bool)
    rvalid = np.array([False, True, True, True, True])
    args = ((lk, ln), 5, (rk, rn), 5)
    for n in (2, 4, 8):
        got = shardops.unique_join_match_sharded(
            dist.sized_mesh(n), *args, rvalid=rvalid)
        want = ref_shardops.unique_join_match_sharded(
            ref_dist.sized_mesh(n), *args, rvalid=rvalid)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[0], [0, 1, 3])
        np.testing.assert_array_equal(got[1], [2, 1, 2])


def _partition(keys, live, n):
    """One side through HK13's partition mode (its plain version on the
    CPU): the counts, then the blocks at the reference's cap."""
    part = kernels.shard_partition(torch.from_numpy(keys),
                                   torch.from_numpy(live), n)
    counts = part.counts.numpy()
    cap = kernels.bucket(max(int(counts.max()), 1))
    ko, io = kernels.shard_partition_scatter(part, cap)
    return counts, cap, ko.numpy(), io.numpy()


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_shard_is_spill_partition(n_shards):
    """The shard of a row is the reference's spill partition at depth 0
    (on the device: kernels.partition_dest), and equal keys colocate."""
    rng = _rng(229 + n_shards)
    keys = rng.integers(-10_000, 10_000, 2000).astype(np.int64)
    live = rng.random(2000) < 0.85
    want = ref_spill.hash_partition(
        np.ascontiguousarray(keys[np.nonzero(live)[0]]), 0, n_shards)
    np.testing.assert_array_equal(
        kernels.partition_dest(torch.from_numpy(keys), n_shards).numpy()[
            live], want)
    fk = keys.astype(np.float64) * 0.25
    fk[:7] = -0.0
    np.testing.assert_array_equal(shardops.hash_partition(fk, 3, n_shards),
                                  ref_spill.hash_partition(fk, 3, n_shards))
    np.testing.assert_array_equal(
        kernels.partition_dest(torch.from_numpy(fk), n_shards).numpy(),
        ref_spill.hash_partition(fk, 0, n_shards))
    counts, cap, _, ids = _partition(keys, live, n_shards)
    np.testing.assert_array_equal(counts,
                                  np.bincount(want, minlength=n_shards))
    blocks = ids.reshape(n_shards, cap)
    for s in range(n_shards):
        rows = blocks[s][blocks[s] >= 0]
        np.testing.assert_array_equal(
            np.unique(shardops.hash_partition(
                np.ascontiguousarray(keys[rows]), 0, n_shards)),
            [s] if len(rows) else [])


def test_scatter_reassembles_in_input_order():
    keys = _rng(250).integers(0, 64, 500).astype(np.int64)
    live = np.ones(500, dtype=bool)
    _, cap, ko, ids = _partition(keys, live, 4)
    ref = ref_shardops._Partitioned(keys, live, 4)
    assert cap == ref.cap
    np.testing.assert_array_equal(ko, ref.scatter(keys, 0).reshape(-1))
    np.testing.assert_array_equal(ids, ref.scatter_ids().reshape(-1))
    sel = ids >= 0
    out = np.empty(500, dtype=np.int64)
    out[ids[sel]] = ko[sel]
    np.testing.assert_array_equal(out, keys)


def _edge_keys(rng, kind, n):
    """Key lanes with the partition's edge values: int64 extremes;
    float64 signed zeros, infinities and NaNs (two NaN bit patterns);
    an int64 side coerced to float64 against a float64 side."""
    if kind == "int64":
        k = rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64)
        k[:4] = [kernels.I64_MIN, kernels.I64_MAX, 0, -1]
        return k, k[::-1].copy()
    f = rng.normal(size=n) * 1e3
    f[:6] = [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan]
    if kind == "float64":
        return f, f[::-1].copy()
    i = rng.integers(-50, 50, n).astype(np.int64)
    i[:2] = [0, 5]
    f[6:8] = [5.0, -0.0]
    return shardops._common_key_dtype(i, f)


@pytest.mark.parametrize("n", [2, 4, 8, 1024])
@pytest.mark.parametrize("kind", ["int64", "float64", "mixed"])
def test_partition_equals_reference_slot_for_slot(n, kind):
    """HK13's partition mode (its plain version) against the reference's
    _Partitioned for each side: the counts and cap, every slot of the key
    and id lanes, and the destinations (5 and 5.0 colocate once the
    mixed pair is coerced; -0.0 lands with 0.0; a NaN by its bits)."""
    rng = _rng(31 * n + len(kind))
    for keys in _edge_keys(rng, kind, 3000):
        live = rng.random(len(keys)) < 0.8
        live[:8] = True
        counts, cap, ko, ids = _partition(keys, live, n)
        ref = ref_shardops._Partitioned(keys, live, n)
        assert cap == ref.cap, (cap, ref.cap)
        np.testing.assert_array_equal(
            counts, np.bincount(ref.dest, minlength=n))
        np.testing.assert_array_equal(
            ko.view(np.uint64),
            ref.scatter(keys, 0).reshape(-1).view(np.uint64))
        np.testing.assert_array_equal(ids, ref.scatter_ids().reshape(-1))
        np.testing.assert_array_equal(
            kernels.partition_dest(torch.from_numpy(keys), n).numpy()[live],
            ref.dest)
    if kind == "mixed":
        i, f = _edge_keys(rng, kind, 3000)
        d = [kernels.partition_dest(torch.from_numpy(x), n).numpy()
             for x in (i, f)]
        assert d[0][1] == d[1][6] and d[0][0] == d[1][7] == d[1][1]


@pytest.mark.parametrize("side", ["all_dead", "one_live", "skewed"])
def test_partition_edge_sides(side):
    """A side with no live row (every slot at its fill, cap 16), one live
    row, and a skewed side: the reference's skew gate, counted as a skew
    retry, returns None before any scatter."""
    n = 8
    keys = _rng(7).integers(-100, 100, 1024).astype(np.int64)
    live = np.zeros(1024, dtype=bool)
    if side == "one_live":
        live[517] = True
    elif side == "skewed":
        keys[:] = 42
        live[:] = True
    ref = ref_shardops._Partitioned(keys, live, n)
    if side == "skewed":
        assert ref.skewed(kernels.bucket(1024))
        st0 = shardops.stats_snapshot()
        kernels.reset_kernel_counts()
        got = shardops.partition_sides(
            n, ((keys, live, 1024), (keys[:64], live[:64], 64)))
        assert got is None
        st = shardops.stats_snapshot()
        assert st["shard_skew_retries"] == st0["shard_skew_retries"] + 1
        assert st["shard_rounds"] == st0["shard_rounds"]
        # the two count calls ran, no scatter
        assert kernels.kernel_counts()["plain_calls"]["shard_partition"] == 2
        return
    counts, cap, ko, ids = _partition(keys, live, n)
    assert cap == ref.cap == 16 and int(counts.sum()) == int(live.sum())
    np.testing.assert_array_equal(ko, ref.scatter(keys, 0).reshape(-1))
    np.testing.assert_array_equal(ids, ref.scatter_ids().reshape(-1))


K25_MODES = ["inner", "outer", "semi", "anti", "not_in_probe_nulls",
             "not_in_build_nulls"]


@pytest.mark.parametrize("mode", K25_MODES)
def test_k25_runs_the_partition_mode(mode):
    """K25's join (inner, outer) and member mode (semi, anti, NOT IN with
    NULL keys on the probe or the build side) through HK13's partition
    mode: the reference's answers and shard counters, two count and two
    scatter calls a partitioned round."""
    rng = _rng(500 + K25_MODES.index(mode))
    lk, ln = _keys(rng, 1500, 0, 700, null_frac=0.1)
    if mode in ("inner", "outer"):
        rk = rng.permutation(700)[:450].astype(np.int64)
        rn = np.zeros(450, dtype=bool)
    else:
        rk, rn = _keys(rng, 900, 100, 900,
                       null_frac=0.05 if mode == "not_in_build_nulls"
                       else 0.0)
    lvalid = rng.random(1500) < 0.9
    args = ((lk, ln), 1500, (rk, rn), len(rk))
    shardops.reset_stats()
    ref_shardops.reset_stats()
    kernels.reset_kernel_counts()
    if mode in ("inner", "outer"):
        kw = dict(outer=mode == "outer", lvalid=lvalid)
        got = shardops.unique_join_match_sharded(dist.sized_mesh(8), *args,
                                                 **kw)
        want = ref_shardops.unique_join_match_sharded(ref_dist.sized_mesh(8),
                                                      *args, **kw)
    else:
        kw = dict(anti=mode != "semi", null_aware=mode.startswith("not_in"),
                  lvalid=lvalid)
        got = [shardops.semi_join_match_sharded(dist.sized_mesh(8), *args,
                                                **kw)]
        want = [ref_shardops.semi_join_match_sharded(ref_dist.sized_mesh(8),
                                                     *args, **kw)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    st, rst = shardops.stats_snapshot(), ref_shardops.stats_snapshot()
    for k in ("shard_rounds", "shard_rows_hwm", "shard_exchange_bytes",
              "shard_skew_retries"):
        assert st[k] == rst[k], (k, st, rst)
    calls = kernels.kernel_counts()["plain_calls"]["shard_partition"]
    assert calls == (0 if mode == "not_in_build_nulls" else 4), calls


def test_skewed_keys_fall_back_single_device():
    n = 1024
    lk = np.zeros(n, dtype=np.int64)  # every key in ONE partition
    ln = np.zeros(n, dtype=bool)
    rk = np.arange(n, dtype=np.int64)
    rn = np.zeros(n, dtype=bool)
    st0 = shardops.stats_snapshot()
    got = shardops.unique_join_match_sharded(
        dist.sized_mesh(NDEV), (lk, ln), n, (rk, rn), n)
    assert got is None  # the caller runs the single-device kernel
    st = shardops.stats_snapshot()
    assert st["shard_skew_retries"] == st0["shard_skew_retries"] + 1


def test_unique_join_counts_a_round_and_its_exchange():
    rng = _rng(77)
    lk, ln = _keys(rng, 600, 0, 300)
    rk = rng.permutation(300).astype(np.int64)
    rn = np.zeros(300, dtype=bool)
    args = ((lk, ln), 600, (rk, rn), 300)
    shardops.reset_stats()
    ref_shardops.reset_stats()
    shardops.unique_join_match_sharded(dist.sized_mesh(4), *args)
    ref_shardops.unique_join_match_sharded(ref_dist.sized_mesh(4), *args)
    got, want = shardops.stats_snapshot(), ref_shardops.stats_snapshot()
    assert got["shard_rounds"] == want["shard_rounds"] == 1
    for k in ("shard_rows_hwm", "shard_exchange_bytes"):
        assert got[k] == want[k] > 0, k


# =========================================================================
# K25 member, sort and top-k: the reference's gates, then its answers
# =========================================================================

def test_semi_join_gates_then_raise():
    """The reference's gates and its answers without a device round stay;
    past them the partitioned membership (HK4 + HK12's member mode) runs
    and equals the reference's."""
    rng = _rng(414)
    lk, ln = _keys(rng, 900, 0, 400)
    rk, rn = _keys(rng, 300, 100, 500, null_frac=0.08)
    args = ((lk, ln), 900, (rk, rn), 300)
    assert shardops.semi_join_match_sharded(None, *args) is None
    # answers without a device round stay the reference's
    none = np.zeros(300, dtype=bool)
    for anti in (False, True):
        got = shardops.semi_join_match_sharded(
            dist.sized_mesh(4), *args, anti=anti, rvalid=none)
        want = ref_shardops.semi_join_match_sharded(
            ref_dist.sized_mesh(4), *args, anti=anti, rvalid=none)
        np.testing.assert_array_equal(got, want)
    got = shardops.semi_join_match_sharded(
        dist.sized_mesh(4), *args, anti=True, null_aware=True)
    assert len(got) == 0
    kernels.reset_kernel_counts()
    got = shardops.semi_join_match_sharded(dist.sized_mesh(4), *args)
    np.testing.assert_array_equal(got, ref_shardops.semi_join_match_sharded(
        ref_dist.sized_mesh(4), *args))
    assert len(got) and kernels.kernel_counts()["plain_calls"][
        "shard_member"] == 1


def test_sort_and_top_k_gates_then_raise():
    """None where the reference returns None; past the gates the sharded
    sort (HK4 per shard + HK14) and top-k (HK4's top-k per shard + HK14)
    equal the reference's and the single-device kernels."""
    rng = _rng(657)
    v, m = _keys(rng, 1000, -300, 300)
    mesh = dist.sized_mesh(8)
    # two keys, k past a shard's rows, an unsafe score: None, as the
    # reference returns
    assert shardops.sort_permutation_sharded(
        mesh, [(v, m), (v, m)], [False, True], 1000) is None
    assert shardops.top_k_sharded(mesh, [(v, m), (v, m)], [False, False],
                                  1000, 5) is None
    assert shardops.top_k_sharded(mesh, [(v, m)], [False], 1000, 200) is None
    assert ref_shardops.top_k_sharded(ref_dist.sized_mesh(8), [(v, m)],
                                      [False], 1000, 200) is None
    edge = v.copy()
    edge[3] = I64_MAX
    assert shardops.sort_permutation_sharded(mesh, [(edge, m)], [False],
                                             1000) is None
    assert shardops.top_k_sharded(mesh, [(v, m)], [True], 10, 3) is None
    rmesh = ref_dist.sized_mesh(8)
    np.testing.assert_array_equal(
        shardops.sort_permutation_sharded(mesh, [(v, m)], [True], 1000),
        ref_shardops.sort_permutation_sharded(rmesh, [(v, m)], [True], 1000))
    np.testing.assert_array_equal(
        shardops.top_k_sharded(mesh, [(v, m)], [False], 1000, 7),
        ref_shardops.top_k_sharded(rmesh, [(v, m)], [False], 1000, 7))


@pytest.mark.parametrize("n_shards", MESH_SIZES)
@pytest.mark.parametrize("anti,null_aware",
                         [(False, False), (True, False), (True, True)])
def test_semi_join_identity(n_shards, anti, null_aware):
    """tests/test_shardops.py's battery: the port's partitioned semi /
    anti / NOT IN equals the reference's and the single-device kernel."""
    rng = _rng(1117 + 3 * n_shards + 2 * anti + null_aware)
    n_left, n_right = 900, 300
    lk, ln = _keys(rng, n_left, 0, 400)
    rk, rn = _keys(rng, n_right, 100, 500,
                   null_frac=0.0 if null_aware else 0.08)
    lvalid = rng.random(n_left) < 0.9
    rvalid = rng.random(n_right) < 0.9
    args = ((lk, ln), n_left, (rk, rn), n_right)
    kw = dict(anti=anti, null_aware=null_aware, lvalid=lvalid, rvalid=rvalid)
    got = shardops.semi_join_match_sharded(dist.sized_mesh(n_shards), *args,
                                           **kw)
    want = ref_shardops.semi_join_match_sharded(
        ref_dist.sized_mesh(n_shards), *args, **kw)
    if n_shards < 2:
        assert got is None and want is None
        return
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, kernels.semi_join_match(*args, **kw))


@pytest.mark.parametrize("n_shards", MESH_SIZES)
@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_sort_permutation_identity(n_shards, desc, dtype):
    rng = _rng(1201 + n_shards + 2 * desc)
    n = 1000
    v, m = _keys(rng, n, -300, 300, dtype=dtype)
    if dtype == np.float64:
        v[:5] = -0.0  # folds into 0.0, as the reference's sort does
    got = shardops.sort_permutation_sharded(
        dist.sized_mesh(n_shards), [(v, m)], [desc], n)
    want = ref_shardops.sort_permutation_sharded(
        ref_dist.sized_mesh(n_shards), [(v, m)], [desc], n)
    if n_shards < 2:
        assert got is None and want is None
        return
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, kernels.sort_permutation([(v, m)], [desc], n))


@pytest.mark.parametrize("n_shards", MESH_SIZES)
@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("k", [1, 7, 50])
def test_top_k_identity(n_shards, desc, k):
    rng = _rng(1301 + n_shards + 2 * desc + k)
    n = 1200
    v, m = _keys(rng, n, -500, 500)
    got = shardops.top_k_sharded(dist.sized_mesh(n_shards), [(v, m)],
                                 [desc], n, k)
    want = ref_shardops.top_k_sharded(ref_dist.sized_mesh(n_shards),
                                      [(v, m)], [desc], n, k)
    if n_shards < 2:
        assert got is None and want is None
        return
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, kernels.top_k([(v, m)], [desc], n, k))


def test_sort_and_top_k_count_their_rounds():
    rng = _rng(88)
    v, m = _keys(rng, 700, -50, 50, dtype=np.float64)
    for fn, rfn, extra in ((shardops.sort_permutation_sharded,
                            ref_shardops.sort_permutation_sharded, ()),
                           (shardops.top_k_sharded,
                            ref_shardops.top_k_sharded, (9,))):
        shardops.reset_stats()
        ref_shardops.reset_stats()
        fn(dist.sized_mesh(4), [(v, m)], [True], 700, *extra)
        rfn(ref_dist.sized_mesh(4), [(v, m)], [True], 700, *extra)
        got, want = shardops.stats_snapshot(), ref_shardops.stats_snapshot()
        for k in ("shard_rounds", "shard_rows_hwm", "shard_exchange_bytes"):
            assert got[k] == want[k], (k, got, want)


# =========================================================================
# HK11 shard_merge's plain version against a numpy left fold
# =========================================================================

OPS = kernels.MERGE_OPS


def _fold_np(parts, ops, m, nb):
    """The reference's merges, written out: a left fold over the shards
    in ascending order per row."""
    n, rows, width = parts.shape
    out = np.empty((rows, width), dtype=np.int64)
    for r, op in enumerate(ops):
        if op == OPS["first_seg"]:
            g = [np.where(parts[s, r] >= m, nb - 1, parts[s, r] + s * m)
                 for s in range(n)]
            out[r] = np.minimum.reduce(g)
        elif op == OPS["first_scalar"]:
            g = [np.where(parts[s, 0] == 0, nb, parts[s, r] + s * m)
                 for s in range(n)]
            acc = np.minimum.reduce(g)
            out[r] = np.where(acc >= nb, 0, acc)
        elif op in (OPS["sum_f"], OPS["min_f"], OPS["max_f"]):
            acc = parts[0, r].view(np.float64).copy()
            for s in range(1, n):
                x = parts[s, r].view(np.float64)
                if op == OPS["sum_f"]:
                    acc = acc + x
                else:
                    # NaN if any partial is NaN (jnp.min / jnp.max over
                    # all rows)
                    better = x < acc if op == OPS["min_f"] else x > acc
                    take = ~np.isnan(acc) & (np.isnan(x) | better)
                    acc = np.where(take, x, acc)
            out[r] = acc.view(np.int64)
        else:
            acc = parts[0, r].copy()
            with np.errstate(over="ignore"):
                for s in range(1, n):
                    if op == OPS["sum_i"]:
                        acc = acc + parts[s, r]
                    elif op == OPS["min_i"]:
                        acc = np.minimum(acc, parts[s, r])
                    else:
                        acc = np.maximum(acc, parts[s, r])
            out[r] = acc
    return out


@pytest.mark.parametrize("n,width", [(2, 1), (8, 1), (8, 16), (4, 300)])
def test_shard_merge_plain_is_the_left_fold(n, width):
    rng = _rng(11 * n + width)
    m = 64
    nb = n * m
    ops = [OPS["sum_i"], OPS["first_seg"], OPS["sum_f"], OPS["sum_i"],
           OPS["min_f"], OPS["sum_i"], OPS["max_f"], OPS["sum_i"],
           OPS["min_i"], OPS["max_i"], OPS["sum_i"]]
    parts = rng.integers(-(1 << 40), 1 << 40, (n, len(ops), width))
    parts[:, 1] = rng.integers(0, m + 1, (n, width))  # m = "no row"
    for r in (2, 4, 6):
        f = rng.normal(size=(n, width)) * 1e6
        f[rng.random((n, width)) < 0.1] = np.nan
        f[rng.random((n, width)) < 0.05] = np.inf
        parts[:, r] = f.view(np.int64)
    parts[:, 8] = rng.choice([I64_MIN, I64_MAX, -1, 0, 5], (n, width))
    parts[:, 9] = rng.choice([I64_MIN, I64_MAX, -1, 0, 5], (n, width))
    parts[:, 10] = rng.choice([I64_MAX, I64_MAX - 1], (n, width))  # wraps
    parts = parts.astype(np.int64)
    got = kernels.shard_merge(torch.from_numpy(parts), ops, m, nb)
    np.testing.assert_array_equal(got.numpy(), _fold_np(parts, ops, m, nb))


def test_shard_merge_scalar_sentinels():
    """K25's first valid row: an empty shard (n_valid 0) never wins, a
    merged nb becomes 0; K11's: HK2's sentinel maps to nb - 1."""
    m, n = 16, 4
    nb = n * m
    ops = [OPS["sum_i"], OPS["first_scalar"]]
    parts = np.array([[[0], [0]], [[0], [0]], [[3], [5]], [[1], [2]]],
                     dtype=np.int64)
    got = kernels.shard_merge(torch.from_numpy(parts), ops, m, nb)
    assert got[:, 0].tolist() == [4, 2 * m + 5]
    parts[:, 0] = 0
    got = kernels.shard_merge(torch.from_numpy(parts), ops, m, nb)
    assert got[:, 0].tolist() == [0, 0]
    seg = np.array([[[0], [m]], [[0], [m]], [[2], [m]], [[1], [3]]],
                   dtype=np.int64)
    got = kernels.shard_merge(torch.from_numpy(seg),
                              [OPS["sum_i"], OPS["first_seg"]], m, nb)
    assert got[:, 0].tolist() == [3, 3 * m + 3]
    seg[3, 1] = m
    got = kernels.shard_merge(torch.from_numpy(seg),
                              [OPS["sum_i"], OPS["first_seg"]], m, nb)
    assert got[:, 0].tolist() == [3, nb - 1]


def test_shard_merge_chunks_past_64_rows():
    rng = _rng(64)
    ops = [OPS["sum_i"], OPS["first_seg"]] + [OPS["sum_i"]] * 70
    parts = rng.integers(0, 1000, (8, len(ops), 5)).astype(np.int64)
    got = kernels.shard_merge(torch.from_numpy(parts), ops, 1000, 8000)
    np.testing.assert_array_equal(got.numpy(),
                                  _fold_np(parts, ops, 1000, 8000))


def test_shard_merge_rejects_bad_arguments():
    parts = torch.zeros((2, 3, 4), dtype=torch.int64)
    with pytest.raises(ValueError):
        kernels.shard_merge(parts, [0, 6], 4, 8)
    with pytest.raises(ValueError):
        kernels.shard_merge(parts.to(torch.float64), [0, 6, 0], 4, 8)
    with pytest.raises(ValueError):
        kernels.shard_merge(parts, [0, 6, 99], 4, 8)


def test_sharded_reductions_equal_single_device_ones():
    """HK1 / HK2 per shard, merged by HK11, give the single-device
    tables: integers, counts, presence and first rows exactly, float sums
    within 1e-12 relative (another addition order)."""
    rng = _rng(2024)
    nb, ns, n = 1024, 37, 8
    valid = torch.from_numpy(rng.random(nb) < 0.7)
    valid[:nb // n] = False  # an empty shard
    gid = torch.from_numpy(rng.integers(0, ns - 1, nb).astype(np.int64))
    gid[-5:] = ns - 1        # a segment only in the last shard
    f = torch.from_numpy(rng.normal(size=nb) * 100)
    i = torch.from_numpy(rng.choice([I64_MIN, I64_MAX, 3, -7], nb))
    nul = torch.from_numpy(rng.random(nb) < 0.2)
    lanes = [(f, nul, "sum"), (f, None, "min"), (f, nul, "max"),
             (i, None, "min"), (i, nul, "max"), (None, nul, "count"),
             (i, None, "sum")]
    one = kernels.segment_reduce(gid, valid, ns, lanes)
    got = kernels.sharded_segment_reduce(gid, valid, ns, lanes, n)
    exact = [0, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 15]
    np.testing.assert_array_equal(got[exact].numpy(), one[exact].numpy())
    np.testing.assert_array_equal(
        np.minimum(got[1].numpy(), nb - 1),
        np.minimum(one[1].numpy(), nb - 1))
    np.testing.assert_allclose(got[2].view(torch.float64).numpy(),
                               one[2].view(torch.float64).numpy(),
                               rtol=1e-12)
    one = kernels.masked_reduce(valid, lanes)
    got = kernels.sharded_masked_reduce(valid, lanes, n)
    np.testing.assert_array_equal(got[exact].numpy(), one[exact].numpy())
    np.testing.assert_allclose(got[2].view(torch.float64).numpy(),
                               one[2].view(torch.float64).numpy(),
                               rtol=1e-12)
    assert int(got[1]) == int(torch.nonzero(valid)[0])


def test_sharded_min_is_nan_when_any_shard_holds_nan():
    """R10: a NaN in a float min / max lane makes the merged value NaN
    (jnp.min over all rows, and the port's single-device HK1).  The
    reference's mesh merge (XLA:CPU pmin / pmax) drops NaN partials and
    gives +inf when every shard's partial is NaN."""
    nb, n = 256, 8
    valid = torch.ones(nb, dtype=torch.bool)
    x = torch.arange(nb, dtype=torch.float64)
    x[3] = float("nan")
    lanes = [(x, None, "min"), (x, None, "max"), (x, None, "sum")]
    got = kernels.sharded_masked_reduce(valid, lanes, n)
    one = kernels.masked_reduce(valid, lanes)
    for r in (2, 4, 6):
        assert np.isnan(got[r:r + 1].view(torch.float64).item())
        assert np.isnan(one[r:r + 1].view(torch.float64).item())
    # the reference's merge, as it runs on its CPU mesh
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    shard_map, _ = ref_dist.shard_map_fn()
    mesh = ref_dist.sized_mesh(n)
    fn = jax.jit(shard_map(
        lambda v: (jax.lax.pmin(jnp.min(v), "shard")[None],
                   jax.lax.pmax(jnp.max(v), "shard")[None]),
        mesh=mesh, in_specs=P("shard"), out_specs=(P(), P())))
    lo, hi = fn(x.numpy())
    # shard 0's NaN partial is dropped: its rows 0..31 do not count
    assert float(lo[0]) == nb // n and float(hi[0]) == nb - 1.0
    lo, hi = fn(np.full(nb, np.nan))
    assert float(lo[0]) == np.inf and float(hi[0]) == -np.inf


# =========================================================================
# HK12 shard_probe's plain version against numpy's searchsorted
# =========================================================================

def _probe_np(pk, pid, bk, bid, n):
    """The reference's per-shard body in numpy: sort the build block by
    (key with dead slots at the sentinel, liveness, slot), searchsorted
    each probe key."""
    cap_p, cap_b = len(pk) // n, len(bk) // n
    hit = np.zeros(len(pk), dtype=bool)
    brow = np.full(len(pk), -1, dtype=np.int64)
    sent = np.inf if bk.dtype == np.float64 else I64_MAX
    for s in range(n):
        b = slice(s * cap_b, (s + 1) * cap_b)
        live = bid[b] >= 0
        km = np.where(live, bk[b], sent)
        if km.dtype == np.float64:
            km = km + 0.0
        order = np.lexsort((np.arange(cap_b), ~live, km))
        sk, sl = km[order], live[order]
        for j in range(s * cap_p, (s + 1) * cap_p):
            key = pk[j] + 0.0 if pk.dtype == np.float64 else pk[j]
            lo = int(np.searchsorted(sk, key, side="left"))
            loc = min(lo, cap_b - 1)
            h = pid[j] >= 0 and lo < cap_b and sk[loc] == key and sl[loc]
            hit[j] = h
            brow[j] = bid[b][order[loc]] if h else -1
    return hit, brow


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_shard_probe_plain_is_searchsorted(n, dtype):
    rng = _rng(97 * n)
    cap_p, cap_b = 32, 16
    pk = rng.integers(-20, 20, n * cap_p).astype(dtype)
    bk = rng.integers(-20, 20, n * cap_b).astype(dtype)
    if dtype == np.int64:
        pk[:3] = [I64_MAX, I64_MIN, I64_MAX]
        bk[:2] = [I64_MAX, I64_MIN]
    else:
        pk[:4] = [np.inf, -0.0, np.nan, 0.0]
        bk[:3] = [np.inf, 0.0, -0.0]
    pid = np.where(rng.random(n * cap_p) < 0.8,
                   np.arange(n * cap_p), -1).astype(np.int64)
    bid = np.where(rng.random(n * cap_b) < 0.7,
                   np.arange(100, 100 + n * cap_b), -1).astype(np.int64)
    bid[0] = 5
    t = torch.from_numpy
    hit, brow = shardops._local_unique_join(n, t(pk), t(pid), t(bk),
                                            t(bid))
    want_hit, want_brow = _probe_np(pk, pid, bk, bid, n)
    np.testing.assert_array_equal(hit.numpy(), want_hit)
    np.testing.assert_array_equal(brow.numpy(), want_brow)
    assert want_hit.any()


def test_shard_probe_rejects_bad_arguments():
    z = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError):
        kernels.shard_probe(z, z, z[:6], z[:6], z[:6], 4)
    with pytest.raises(ValueError):
        kernels.shard_probe(z.to(torch.int32), z, z, z, z, 2)


# =========================================================================
# attribution and observability
# =========================================================================

def test_member_shard_shares_conserve_bxn():
    """The port's B x N cells reuse ops/batching.split_exact (R1): exact
    under math.fsum and under the nested left fold."""
    import math
    totals = {"dispatches": 1, "device_time_s": 0.777,
              "h2d_bytes": 123457.0}
    for b, n in ((2, 8), (3, 4), (5, 2), (7, 8)):
        cells = shardops.member_shard_shares(totals, b, n)
        assert len(cells) == b and all(len(row) == n for row in cells)
        for key, v in totals.items():
            assert math.fsum(c[key] for row in cells for c in row) == v
            acc = 0.0
            for row in cells:
                inner = 0.0
                for c in row:
                    inner += c[key]
                acc += inner
            assert acc == v, (b, n, key)


def test_shards_of_key():
    assert shardops.shards_of_key(("seg_sharded", 1, ("shards", 8))) == 8
    assert shardops.shards_of_key(("seg", 1)) == 0
    assert shardops._shards_tag(dist.sized_mesh(4)) == ("shards", 4)


def test_shard_metrics_registered_and_sampled():
    """The tinysql_shard_* surface: registered in obs/metrics.METRICS,
    mapped by SHARD_METRIC_NAMES, sampled by the tsring source and probed
    by the flight recorder."""
    from tinysql_tpu_torch.obs import metrics as om
    from tinysql_tpu_torch.obs import tsring
    for key, name in om.SHARD_METRIC_NAMES:
        assert name in om.METRICS, name
        assert key in shardops.STATS, key
    sample = tsring._src_shardops()
    assert set(sample) == {n for _, n in om.SHARD_METRIC_NAMES}
    assert "shardops" in tsring._SOURCES
