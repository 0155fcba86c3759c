"""TPC-H data generation + schema + queries (BASELINE.json configs).

Numpy-vectorized generator with TPC-H-shaped cardinalities (SF=1:
6M lineitem / 1.5M orders / 150k customer / 10k supplier / 25 nation /
5 region), loaded through the columnar bulk-ingest path
(columnar/store.py).  Dates are 'YYYY-MM-DD' strings (lexicographic
compare == date compare), matching the engine's 3-family type system
(SURVEY §0.2 — no DATE type in the reference either).

Two query sets:
- ``QUERIES``  — Q1/Q3/Q6, the long-standing perf benchmark trio; every
  historical bench section (param_reuse, spill squeeze, prewarm) keys on
  these, so their membership is stable.
- ``WORKLOAD`` — Q5/Q10/Q18, the workload-diversity trio (ROADMAP item
  5): multi-join chains, IN-subquery semijoins (decorrelation), and
  GROUP BY + ORDER BY + LIMIT compositions.  Q5 phrases the region
  restriction as an IN subquery so the planner's decorrelation ->
  device-semijoin path is exercised end-to-end; Q18 is the classic
  aggregate-subquery membership shape.

``Q13`` (the customer distribution: how many customers have 0, 1, 2, ...
orders) stands apart: a LEFT join with a non-unique build side and two
GROUP BYs above it, one device pipeline.  It is written without TPC-H's
``o_comment not like '%special%requests%'`` term, because ``orders`` here
has no ``o_comment`` column.  :func:`q13_rows` computes its answer from
the generated columns with numpy alone.
"""
from __future__ import annotations

import numpy as np

SCHEMAS = {
    "region": """create table region (
        r_regionkey bigint primary key,
        r_name varchar(12))""",
    "nation": """create table nation (
        n_nationkey bigint primary key,
        n_name varchar(25),
        n_regionkey bigint)""",
    "supplier": """create table supplier (
        s_suppkey bigint primary key,
        s_name varchar(25),
        s_nationkey bigint,
        s_acctbal double)""",
    "customer": """create table customer (
        c_custkey bigint primary key,
        c_name varchar(25),
        c_address varchar(40),
        c_phone varchar(15),
        c_mktsegment varchar(10),
        c_nationkey bigint,
        c_acctbal double,
        c_comment varchar(60))""",
    "orders": """create table orders (
        o_orderkey bigint primary key,
        o_custkey bigint,
        o_orderstatus varchar(1),
        o_totalprice double,
        o_orderdate varchar(10),
        o_shippriority bigint)""",
    "lineitem": """create table lineitem (
        l_id bigint primary key,
        l_orderkey bigint,
        l_suppkey bigint,
        l_quantity double,
        l_extendedprice double,
        l_discount double,
        l_tax double,
        l_returnflag varchar(1),
        l_linestatus varchar(1),
        l_shipdate varchar(10))""",
}

Q1 = """select l_returnflag, l_linestatus,
    sum(l_quantity) as sum_qty,
    sum(l_extendedprice) as sum_base_price,
    sum(l_extendedprice * (1 - l_discount)) as sum_disc_price,
    sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) as sum_charge,
    avg(l_quantity) as avg_qty,
    avg(l_extendedprice) as avg_price,
    avg(l_discount) as avg_disc,
    count(*) as count_order
from lineitem
where l_shipdate <= '1998-09-02'
group by l_returnflag, l_linestatus
order by l_returnflag, l_linestatus"""

Q3 = """select l_orderkey,
    sum(l_extendedprice * (1 - l_discount)) as revenue,
    o_orderdate, o_shippriority
from customer, orders, lineitem
where c_mktsegment = 'BUILDING'
  and c_custkey = o_custkey
  and l_orderkey = o_orderkey
  and o_orderdate < '1995-03-15'
  and l_shipdate > '1995-03-15'
group by l_orderkey, o_orderdate, o_shippriority
order by revenue desc, o_orderdate
limit 10"""

Q5 = """select n_name,
    sum(l_extendedprice * (1 - l_discount)) as revenue
from customer, orders, lineitem, supplier, nation
where c_custkey = o_custkey
  and l_orderkey = o_orderkey
  and l_suppkey = s_suppkey
  and c_nationkey = s_nationkey
  and s_nationkey = n_nationkey
  and n_regionkey in (select r_regionkey from region
                      where r_name = 'ASIA')
  and o_orderdate >= '1994-01-01'
  and o_orderdate < '1995-01-01'
group by n_name
order by revenue desc"""

Q6 = """select sum(l_extendedprice * l_discount) as revenue
from lineitem
where l_shipdate >= '1994-01-01'
  and l_shipdate < '1995-01-01'
  and l_discount between 0.05 and 0.07
  and l_quantity < 24"""

Q10 = """select c_custkey, c_name,
    sum(l_extendedprice * (1 - l_discount)) as revenue,
    c_acctbal, n_name, c_address, c_phone, c_comment
from customer, orders, lineitem, nation
where c_custkey = o_custkey
  and l_orderkey = o_orderkey
  and o_orderdate >= '1993-10-01'
  and o_orderdate < '1994-01-01'
  and l_returnflag = 'R'
  and c_nationkey = n_nationkey
group by c_custkey, c_name, c_acctbal, c_phone, n_name, c_address,
    c_comment
order by revenue desc
limit 20"""

Q18 = """select c_name, c_custkey, o_orderkey, o_orderdate,
    o_totalprice, sum(l_quantity) as sum_qty
from customer, orders, lineitem
where o_orderkey in (select l_orderkey from lineitem
                     group by l_orderkey
                     having sum(l_quantity) > 300)
  and c_custkey = o_custkey
  and o_orderkey = l_orderkey
group by c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
order by o_totalprice desc, o_orderdate
limit 100"""

Q13 = """select c_count, count(*) as custdist
from (select c_custkey, count(o_orderkey) as c_count
      from customer left outer join orders on c_custkey = o_custkey
      group by c_custkey) as c_orders
group by c_count
order by custdist desc, c_count desc"""

QUERIES = {"Q1": Q1, "Q3": Q3, "Q6": Q6}
WORKLOAD = {"Q5": Q5, "Q10": Q10, "Q18": Q18}
ALL_QUERIES = {**QUERIES, **WORKLOAD}

_SEGMENTS = np.array(["AUTOMOBILE", "BUILDING", "FURNITURE",
                      "MACHINERY", "HOUSEHOLD"])
_EPOCH = np.datetime64("1992-01-01")

# TPC-H specification nation/region fixed tables
_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
_NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]

_COMMENT_WORDS = np.array(["furiously", "carefully", "quickly", "slyly",
                           "blithely", "even", "final", "ironic",
                           "pending", "regular", "express", "bold"])


def _dates(rng, n, lo_days=0, hi_days=2405):
    days = rng.integers(lo_days, hi_days, n)
    return (_EPOCH + days.astype("timedelta64[D]")).astype("datetime64[D]").astype(str)


def _tagged_names(tag: str, ids: np.ndarray) -> np.ndarray:
    """'Customer#000000007'-style names, vectorized."""
    return np.char.add(tag + "#", np.char.zfill(ids.astype(str), 9))


def generate(sf: float = 1.0, seed: int = 7):
    """Returns {table: {col: ndarray}} at scale factor sf (column order
    per table matches the CREATE TABLE column order — the sqlite
    baseline inserts positionally)."""
    rng = np.random.default_rng(seed)
    n_cust = int(150_000 * sf)
    n_ord = int(1_500_000 * sf)
    n_supp = max(int(10_000 * sf), 10)
    n_li_avg = 4  # ~6M lineitems at SF=1

    region = {
        "r_regionkey": np.arange(len(_REGIONS), dtype=np.int64),
        "r_name": np.array(_REGIONS),
    }
    nation = {
        "n_nationkey": np.arange(len(_NATIONS), dtype=np.int64),
        "n_name": np.array([n for n, _ in _NATIONS]),
        "n_regionkey": np.array([r for _, r in _NATIONS], dtype=np.int64),
    }
    supp_ids = np.arange(1, n_supp + 1, dtype=np.int64)
    supplier = {
        "s_suppkey": supp_ids,
        "s_name": _tagged_names("Supplier", supp_ids),
        "s_nationkey": rng.integers(0, len(_NATIONS),
                                    n_supp).astype(np.int64),
        "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_supp), 2),
    }

    cust_ids = np.arange(1, n_cust + 1, dtype=np.int64)
    c_nationkey = rng.integers(0, len(_NATIONS), n_cust).astype(np.int64)
    customer = {
        "c_custkey": cust_ids,
        "c_name": _tagged_names("Customer", cust_ids),
        "c_address": np.char.add(
            "addr-", rng.integers(0, 10 ** 9, n_cust).astype(str)),
        "c_phone": np.char.add(
            np.char.add((c_nationkey + 10).astype(str), "-"),
            rng.integers(100_0000, 999_9999, n_cust).astype(str)),
        "c_mktsegment": _SEGMENTS[rng.integers(0, len(_SEGMENTS), n_cust)],
        "c_nationkey": c_nationkey,
        "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_cust), 2),
        "c_comment": np.char.add(
            np.char.add(
                _COMMENT_WORDS[rng.integers(0, len(_COMMENT_WORDS),
                                            n_cust)], " "),
            _COMMENT_WORDS[rng.integers(0, len(_COMMENT_WORDS), n_cust)]),
    }

    o_orderdate = _dates(rng, n_ord)
    orders = {
        "o_orderkey": np.arange(1, n_ord + 1, dtype=np.int64),
        "o_custkey": rng.integers(1, n_cust + 1, n_ord).astype(np.int64),
        "o_orderstatus": np.array(["O", "F", "P"])[rng.integers(0, 3, n_ord)],
        "o_totalprice": np.round(rng.uniform(800.0, 500_000.0, n_ord), 2),
        "o_orderdate": o_orderdate,
        "o_shippriority": np.zeros(n_ord, dtype=np.int64),
    }

    per_order = rng.integers(1, 2 * n_li_avg, n_ord)
    l_orderkey = np.repeat(orders["o_orderkey"], per_order)
    n_li = len(l_orderkey)
    ship_delay = rng.integers(1, 122, n_li).astype("timedelta64[D]")
    base_date = np.repeat(o_orderdate, per_order).astype("datetime64[D]")
    l_shipdate = (base_date + ship_delay).astype(str)
    lineitem = {
        "l_id": np.arange(1, n_li + 1, dtype=np.int64),
        "l_orderkey": l_orderkey,
        "l_suppkey": rng.integers(1, n_supp + 1, n_li).astype(np.int64),
        "l_quantity": rng.integers(1, 51, n_li).astype(np.float64),
        "l_extendedprice": np.round(rng.uniform(900.0, 105_000.0, n_li), 2),
        "l_discount": np.round(rng.integers(0, 11, n_li) * 0.01, 2),
        "l_tax": np.round(rng.integers(0, 9, n_li) * 0.01, 2),
        "l_returnflag": np.array(["A", "N", "R"])[rng.integers(0, 3, n_li)],
        "l_linestatus": np.array(["O", "F"])[rng.integers(0, 2, n_li)],
        "l_shipdate": l_shipdate,
    }
    return {"region": region, "nation": nation, "supplier": supplier,
            "customer": customer, "orders": orders, "lineitem": lineitem}


def q13_rows(data) -> list:
    """Q13's rows from the generated columns (numpy, independent of the
    engine): orders per customer, then customers per order count, in
    Q13's ORDER BY (custdist desc, c_count desc)."""
    cks = np.sort(data["customer"]["c_custkey"])
    ok = data["orders"]["o_custkey"]
    per = np.bincount(np.searchsorted(cks, ok[np.isin(ok, cks)]),
                      minlength=len(cks))
    dist = np.bincount(per)
    rows = [[int(c), int(k)] for c, k in enumerate(dist) if k]
    rows.sort(key=lambda r: (-r[1], -r[0]))
    return rows


def q5_rows(data) -> list:
    """Q5's rows from the generated columns (numpy, independent of the
    engine): each 1994 order's line items whose supplier shares the
    customer's nation, in an ASIA nation, summed per nation in revenue
    order.  Sums are float64 in another order than the engine's; compare
    through :func:`canon_rows`."""
    def index(keys, probe):
        order = np.argsort(keys, kind="stable")
        return order[np.searchsorted(keys, probe, sorter=order)]
    reg, nat = data["region"], data["nation"]
    cust, orde = data["customer"], data["orders"]
    supp, li = data["supplier"], data["lineitem"]
    asia = np.isin(nat["n_regionkey"],
                   reg["r_regionkey"][reg["r_name"] == "ASIA"])
    od = orde["o_orderdate"]
    o_in = (od >= "1994-01-01") & (od < "1995-01-01")
    o_nat = cust["c_nationkey"][index(cust["c_custkey"], orde["o_custkey"])]
    oi = index(orde["o_orderkey"], li["l_orderkey"])
    s_nat = supp["s_nationkey"][index(supp["s_suppkey"], li["l_suppkey"])]
    ni = index(nat["n_nationkey"], s_nat)
    keep = o_in[oi] & (o_nat[oi] == s_nat) & asia[ni]
    rev = li["l_extendedprice"][keep] * (1 - li["l_discount"][keep])
    n = len(nat["n_nationkey"])
    sums = np.bincount(ni[keep], weights=rev, minlength=n)
    hits = np.bincount(ni[keep], minlength=n)
    rows = [[str(nat["n_name"][i]), float(sums[i])]
            for i in range(n) if hits[i]]
    rows.sort(key=lambda r: -r[1])
    return rows


def sqlite_mirror(data):
    """In-memory sqlite3 oracle over the SAME generated data (bigint ->
    integer, double -> real, positional insert in CREATE column order).
    One definition shared by tests/test_workload.py and
    tools/workload_smoke.py so 'matches sqlite' means one thing."""
    import sqlite3
    db = sqlite3.connect(":memory:")
    for name, ddl in SCHEMAS.items():
        db.execute(ddl.replace("bigint", "integer")
                   .replace("double", "real"))
        cols = list(data[name].keys())
        ph = ", ".join("?" * len(cols))
        db.executemany(f"insert into {name} values ({ph})",
                       zip(*(data[name][c].tolist() for c in cols)))
    return db


def canon_rows(rows):
    """Engine-vs-sqlite comparable form: floats canonicalized to 9
    significant digits (covers float64 noise and -0.0), NULL tagged
    unambiguously, everything else stringified.  Row ORDER is kept —
    the workload queries all have deterministic ORDER BY.  This is the
    STRICT equality tests and the CI smoke share; bench.py deliberately
    keeps its looser `_rows_match` (sorted, 1e-6 relative) for ALL its
    sections because real-TPU reductions reorder float sums beyond 9
    significant digits at SF>=0.1."""
    out = []
    for r in rows:
        key = []
        for v in r:
            if v is None:
                key.append("\x00NULL")
            elif isinstance(v, (int, float)):
                f = float(v)
                key.append(f"{0.0 if f == 0 else f:.9g}")
            else:
                key.append(str(v))
        out.append(tuple(key))
    return out


def load(session, sf: float = 1.0, seed: int = 7, data=None) -> dict:
    """Create schemas + columnar bulk-load (returns row counts).  Pass a
    pre-generated `data` dict to avoid regenerating (bench shares one
    dataset between this engine and the sqlite baseline)."""
    from ..columnar.store import bulk_load
    if data is None:
        data = generate(sf, seed)
    session.execute("create database if not exists tpch")
    session.execute("use tpch")
    counts = {}
    for name, ddl in SCHEMAS.items():
        session.execute(f"drop table if exists {name}")
        session.execute(ddl)
        info = session.infoschema().table_by_name("tpch", name)
        counts[name] = bulk_load(session.storage, info, data[name])
    return counts
