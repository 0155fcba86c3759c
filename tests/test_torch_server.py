"""The port's MySQL wire server (tinysql_tpu_torch/server/): the wire
tests of tests/test_server.py against the port's Server(storage, port=0,
device="cpu") — handshake, native-password auth, text-protocol
roundtrips, error packets, two connections over one storage, prepared
statements over the binary protocol, COM_FIELD_LIST, the status
endpoint, KILL over the wire — plus the port's device seam: a server
runs on CUDA unless asked for the CPU, and raises without a card.

The client is tests/test_server.py's MiniClient (every socket times out
after 10 s); the module's server closes when the module ends.
"""
import json
import struct
import urllib.request

import pytest
import torch

from test_server import MiniClient
from tinysql_tpu_torch.kv import new_mock_storage
from tinysql_tpu_torch.server.http_status import StatusServer
from tinysql_tpu_torch.server.packetio import read_lenenc_int
from tinysql_tpu_torch.server.server import Server


@pytest.fixture(scope="module")
def server():
    storage = new_mock_storage()
    srv = Server(storage, port=0, device="cpu")  # ephemeral
    srv.start()
    c = MiniClient(srv.port)
    c.query("set global tidb_auto_prewarm = 0")
    c.close()
    yield srv
    srv.close()


def test_handshake_and_version(server):
    c = MiniClient(server.port)
    assert "tinysql-tpu" in c.server_version
    c.close()


def test_mysql_native_password_auth(server):
    # mysql_native_password scramble verification against mysql.user
    # (full-TiDB conn.go:418 behavior, stripped in tinysql, restored here)
    from tinysql_tpu_torch.server.auth import hash_password
    admin = MiniClient(server.port)
    admin.query("insert into mysql.user values "
                f"('alice', '{hash_password('sesame')}')")
    # correct password: session works
    c = MiniClient(server.port, user="alice", password="sesame")
    _, rows = c.query("select 1 + 1")
    assert rows == [["2"]]
    c.close()
    # wrong password -> ERR 1045, connection refused
    with pytest.raises(PermissionError) as ei:
        MiniClient(server.port, user="alice", password="wrong")
    assert "1045" in str(ei.value) and "Access denied" in str(ei.value)
    # password against a passwordless account -> denied
    with pytest.raises(PermissionError):
        MiniClient(server.port, user="root", password="something")
    # unknown user -> denied
    with pytest.raises(PermissionError):
        MiniClient(server.port, user="mallory", password="x")
    # root with no password still fine
    MiniClient(server.port).close()
    # SQL-injection usernames must not bypass auth or kill the conn thread
    for evil in ("\\' or 1=1 -- x", "x' or ''='", "trailing\\"):
        with pytest.raises(PermissionError):
            MiniClient(server.port, user=evil, password="")
    admin.query("delete from mysql.user where user = 'alice'")
    admin.close()


def test_query_roundtrip(server):
    c = MiniClient(server.port)
    c.query("create database if not exists wiretest")
    c.query("use wiretest")
    c.query("create table t (a int primary key, b double, c varchar(20))")
    affected = c.query("insert into t values (1, 1.5, 'x'), (2, null, null)")
    assert affected == 2
    cols, rows = c.query("select a, b, c from t order by a")
    assert cols == ["a", "b", "c"]
    assert rows == [["1", "1.5", "x"], ["2", None, None]]
    c.close()


def test_error_packet(server):
    c = MiniClient(server.port)
    with pytest.raises(RuntimeError, match="server error"):
        c.query("select * from wiretest.does_not_exist")
    c.close()


def test_two_connections_share_storage(server):
    c1 = MiniClient(server.port)
    c2 = MiniClient(server.port)
    c1.query("create database if not exists shared")
    c1.query("use shared")
    c1.query("create table s (a int primary key)")
    c1.query("insert into s values (42)")
    _, rows = c2.query("select a from shared.s")
    assert rows == [["42"]]
    c1.close()
    c2.close()


def test_txn_isolation_across_connections(server):
    c1 = MiniClient(server.port)
    c2 = MiniClient(server.port)
    c1.query("use shared")
    c2.query("use shared")
    c1.query("begin")
    c1.query("insert into s values (99)")
    _, rows = c2.query("select a from s order by a")
    assert ["99"] not in rows  # uncommitted: invisible
    c1.query("commit")
    _, rows = c2.query("select a from s order by a")
    assert ["99"] in rows
    c1.close()
    c2.close()


def test_connect_with_db(server):
    c = MiniClient(server.port, db="shared")
    _, rows = c.query("select count(*) from s")
    assert rows[0][0] == "2"
    c.close()


def test_multi_statement_query(server):
    c = MiniClient(server.port)
    c.query("create database if not exists multi")
    c.query("use multi")
    c.query("create table m (a int primary key)")
    # two resultsets + trailing DML in ONE COM_QUERY; each response chained
    # with SERVER_MORE_RESULTS_EXISTS, read back-to-back
    c.io.reset_sequence()
    c.io.write_packet(b"\x03" + b"select 1; select 2; insert into m values (7)")
    # resultset 1
    for want in ("1", "2"):
        first = c.io.read_packet()
        ncols, _ = read_lenenc_int(first, 0)
        for _ in range(ncols):
            c.io.read_packet()
        eof1 = c.io.read_packet()
        assert eof1[0] == 0xFE
        row = c.io.read_packet()
        assert want.encode() in row
        eof2 = c.io.read_packet()
        assert eof2[0] == 0xFE
        status = struct.unpack_from("<H", eof2, 3)[0]
        assert status & 0x0008, "SERVER_MORE_RESULTS_EXISTS missing"
    ok = c.io.read_packet()
    assert ok[0] == 0x00
    affected, _ = read_lenenc_int(ok, 1)
    assert affected == 1
    # connection still in sync
    _, rows = c.query("select a from m")
    assert rows == [["7"]]
    c.close()


def test_affected_rows_reset_after_ddl(server):
    c = MiniClient(server.port)
    c.query("create database if not exists ar")
    c.query("use ar")
    c.query("create table r (a int primary key)")
    assert c.query("insert into r values (1), (2)") == 2
    assert c.query("create table r2 (a int primary key)") == 0
    assert c.query("begin") == 0
    assert c.query("commit") == 0
    c.close()


def test_status_endpoint(server):
    st = StatusServer(server, port=0)
    st.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{st.port}/status", timeout=5) as r:
            data = json.loads(r.read())
        assert "tinysql-tpu" in data["version"]
        # /metrics carries the serving layer's counters, stacked batching
        # among them
        with urllib.request.urlopen(
                f"http://127.0.0.1:{st.port}/metrics", timeout=5) as r:
            text = r.read().decode()
        for name in ("tinysql_batch_stacked_rounds_total",
                     "tinysql_batch_stacked_occupancy_sum",
                     "tinysql_admission_admitted_total"):
            assert name in text, name
    finally:
        st.close()


def test_com_field_list(server):
    """COM_FIELD_LIST over the real socket (reference conn.go:846
    handleFieldList): one column-definition packet per table column, with
    the empty default-value field appended, then EOF."""
    c = MiniClient(server.port)
    c.query("create database if not exists fl")
    c.query("use fl")
    c.query("create table ft (id int primary key, name varchar(20), "
            "score double)")
    c.io.reset_sequence()
    c.io.write_packet(b"\x04" + b"ft\x00" + b"%")
    names, types = [], []
    while True:
        d = c.io.read_packet()
        if d[0] == 0xFE and len(d) < 9:
            break
        pos = 0
        vals = []
        for _ in range(6):
            ln, pos = read_lenenc_int(d, pos)
            vals.append(d[pos:pos + ln])
            pos += ln
        names.append(vals[4].decode())
        assert d[pos] == 0x0C
        tp = d[pos + 1 + 2 + 4]
        types.append(tp)
        # the trailing default-value field must be present (lenenc 0)
        assert d[-1] == 0x00
    assert names == ["id", "name", "score"]
    assert types == [0x08, 0xFD, 0x05]  # LONGLONG, VAR_STRING, DOUBLE
    # unknown table -> 1146
    c.io.reset_sequence()
    c.io.write_packet(b"\x04" + b"nope\x00")
    d = c.io.read_packet()
    assert d[0] == 0xFF and struct.unpack_from("<H", d, 1)[0] == 1146
    c.close()


def test_prepared_statement_binary_protocol(server):
    """COM_STMT_PREPARE/EXECUTE/CLOSE over the real socket: binary param
    decoding (longlong/double/string/NULL) and BINARY resultset rows
    (reference conn.go:879 writeResultset binary=true path)."""
    from tinysql_tpu_torch.server.packetio import lenenc_int
    c = MiniClient(server.port)
    c.query("create database if not exists ps")
    c.query("use ps")
    c.query("create table pt (id int primary key, nm varchar(20), "
            "sc double)")
    c.query("insert into pt values (1, 'ann', 1.5), (2, 'bob', 2.5), "
            "(3, null, 3.5)")
    # prepare
    c.io.reset_sequence()
    sql = b"select id, nm, sc from pt where id >= ? and sc < ? order by id"
    c.io.write_packet(b"\x16" + sql)
    d = c.io.read_packet()
    assert d[0] == 0x00
    stmt_id = struct.unpack_from("<I", d, 1)[0]
    ncols = struct.unpack_from("<H", d, 5)[0]
    nparams = struct.unpack_from("<H", d, 7)[0]
    # prepare-time result metadata: the SELECT's real columns
    assert nparams == 2 and ncols == 3
    for _ in range(nparams):
        c.io.read_packet()          # param definitions
    assert c.io.read_packet()[0] == 0xFE
    prep_cols = []
    for _ in range(ncols):
        d = c.io.read_packet()
        pos = 0
        vals = []
        for _ in range(6):
            ln, pos = read_lenenc_int(d, pos)
            vals.append(d[pos:pos + ln])
            pos += ln
        prep_cols.append(vals[4].decode())
    assert prep_cols == ["id", "nm", "sc"]
    assert c.io.read_packet()[0] == 0xFE
    # execute with id >= 1 (longlong), sc < 3.0 (double)
    c.io.reset_sequence()
    pl = struct.pack("<IBI", stmt_id, 0, 1)
    pl += b"\x00"                    # null bitmap (2 params)
    pl += b"\x01"                    # new params bound
    pl += bytes([0x08, 0x00, 0x05, 0x00])   # LONGLONG, DOUBLE
    pl += struct.pack("<q", 1) + struct.pack("<d", 3.0)
    c.io.write_packet(b"\x17" + pl)
    first = c.io.read_packet()
    nc, _ = read_lenenc_int(first, 0)
    assert nc == 3
    fts = []
    for _ in range(nc):
        d = c.io.read_packet()
        pos = 0
        for _ in range(6):
            ln, pos = read_lenenc_int(d, pos)
            pos += ln
        fts.append(d[pos + 1 + 2 + 4])   # column type byte
    assert c.io.read_packet()[0] == 0xFE
    rows = []
    while True:
        d = c.io.read_packet()
        if d[0] == 0xFE and len(d) < 9:
            break
        assert d[0] == 0x00          # binary row header
        nmap_len = (nc + 7 + 2) // 8
        nmap = d[1:1 + nmap_len]
        pos = 1 + nmap_len
        row = []
        for i, tp in enumerate(fts):
            if nmap[(i + 2) // 8] & (1 << ((i + 2) % 8)):
                row.append(None)
                continue
            if tp == 0x08:
                row.append(struct.unpack_from("<q", d, pos)[0])
                pos += 8
            elif tp == 0x05:
                row.append(struct.unpack_from("<d", d, pos)[0])
                pos += 8
            else:
                ln, pos = read_lenenc_int(d, pos)
                row.append(d[pos:pos + ln].decode())
                pos += ln
        rows.append(row)
    assert rows == [[1, "ann", 1.5], [2, "bob", 2.5]], rows
    # re-execute WITHOUT re-binding types (bound flag 0): types cached
    c.io.reset_sequence()
    pl = struct.pack("<IBI", stmt_id, 0, 1) + b"\x00" + b"\x00"
    pl += struct.pack("<q", 3) + struct.pack("<d", 99.0)
    c.io.write_packet(b"\x17" + pl)
    first = c.io.read_packet()
    nc2, _ = read_lenenc_int(first, 0)
    assert nc2 == 3
    for _ in range(nc2):
        c.io.read_packet()           # column definitions
    assert c.io.read_packet()[0] == 0xFE
    rows2 = 0
    null_seen = False
    while True:
        d = c.io.read_packet()
        if d[0] == 0xFE and len(d) < 9:
            break
        rows2 += 1
        nmap = d[1:1 + (nc2 + 7 + 2) // 8]
        # nm is column 1 -> bitmap bit 1+2 (row id=3 has nm NULL)
        null_seen = null_seen or bool(nmap[0] & (1 << 3))
    assert rows2 == 1 and null_seen  # only id=3 matches; its nm is NULL
    # close the statement (no response expected)
    c.io.reset_sequence()
    c.io.write_packet(b"\x19" + struct.pack("<I", stmt_id))
    # connection still alive after close
    cols, rows = c.query("select count(*) from pt")
    assert rows == [["3"]]
    c.close()


def test_plain_server_does_not_offer_ssl(server):
    c = MiniClient(server.port)
    assert not (c.server_caps & 0x0800)
    c.close()


def test_kill_query_over_wire(server):
    """KILL QUERY <id> from a second connection aborts the first
    connection's running statement with MySQL error 1317, and the victim
    connection stays usable (reference: server kill dispatch)."""
    import threading
    import time as _t

    from tinysql_tpu_torch import fail

    c1 = MiniClient(server.port)
    c1.query("create database if not exists killdb")
    c1.query("use killdb")
    c1.query("create table if not exists k (a int primary key, b int)")
    c1.query("insert into k values " + ", ".join(
        f"({i}, {i})" for i in range(1, 101)))
    c1.query("set @@tidb_use_tpu = 0")
    c1.query("set @@tidb_max_chunk_size = 8")
    victim_id = max(server.conns)  # c1 is the newest connection
    c2 = MiniClient(server.port)
    box = []

    def slow():
        try:
            box.append(c1.query("select * from k"))
        except RuntimeError as e:
            box.append(e)
    fail.arm("execSlowNext", sleep=0.02)
    try:
        t = threading.Thread(target=slow)
        t.start()
        _t.sleep(0.1)
        c2.query(f"kill query {victim_id}")
        t.join(10)
        assert not t.is_alive()
    finally:
        fail.disarm("execSlowNext")
    assert isinstance(box[0], RuntimeError) and "1317" in str(box[0]), \
        box[0]
    # the killed CONNECTION survives a KILL QUERY
    assert c1.query("select count(*) from k")[1] == [["100"]]
    c1.close()
    c2.close()


def test_plain_kill_drops_connection(server):
    import socket as _socket

    c1 = MiniClient(server.port)
    c1.query("select 1")
    victim_id = max(server.conns)
    c2 = MiniClient(server.port)
    c2.query(f"kill {victim_id}")
    # the victim's next command gets a closed socket (server dropped it
    # after the in-flight command window)
    deadline = __import__("time").time() + 5
    dead = False
    while __import__("time").time() < deadline and not dead:
        try:
            c1.query("select 1")
            __import__("time").sleep(0.05)
        except (RuntimeError, ConnectionError, OSError, _socket.error):
            dead = True
    assert dead, "plain KILL did not drop the victim connection"
    c2.close()



def test_r8_session_registry_survives_gc_under_its_lock(server):
    """R8 (ROADMAP queue 3): the reference's session registry gives each
    weakref a callback that takes the registry lock, so a collection run
    by a thread that holds the lock deadlocks it.  The port's weakrefs
    carry no callback: a session freed by the collector while the lock
    is held leaves the lock free, and KILL resolution no longer finds
    it."""
    import gc
    import threading
    from tinysql_tpu_torch.session.session import Session
    from tinysql_tpu_torch.utils import interrupt
    s = Session(server.storage)
    s.device = server.device
    s.self_ref = s  # only the cycle collector can free it
    cid = s.conn_id
    assert interrupt.lookup(cid) is s
    del s
    done = threading.Event()

    def collect_under_the_lock():
        with interrupt._reg_mu:
            gc.collect()
        done.set()
    threading.Thread(target=collect_under_the_lock, daemon=True).start()
    assert done.wait(10), "a weakref callback blocked on the registry lock"
    assert interrupt.lookup(cid) is None
    assert cid not in dict(interrupt.sessions())
    Session(server.storage)  # registering sweeps the dead entries
    assert cid not in interrupt._SESSIONS


def test_server_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    """Server() without a device means the current CUDA device: with no
    card it raises RuntimeError, naming device='cpu', before it binds or
    starts anything; device="cpu" serves on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(new_mock_storage(), port=0)
    srv = Server(new_mock_storage(), port=0, device="cpu")
    try:
        assert srv.device.type == "cpu"
    finally:
        srv.close()


def test_main_without_a_card_exits_with_the_reason(monkeypatch):
    """python -m tinysql_tpu_torch.main runs on the card: without one it
    raises before any storage, socket or thread exists."""
    from tinysql_tpu_torch import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main.main(["-P", "0"])


def test_connections_run_their_statements_on_the_server_device(server):
    """Every connection's session takes the server's device: a grouped
    aggregate over the wire runs the device tier's plain kernels here."""
    from tinysql_tpu_torch.ops import kernels
    c = MiniClient(server.port)
    c.query("create database if not exists devseam")
    c.query("use devseam")
    c.query("create table d (a int primary key, g int, x double)")
    c.query("insert into d values (1, 1, 1.5), (2, 1, 2.5), (3, 2, null)")
    c.query("set tidb_tpu_min_rows = 0")
    kernels.reset_kernel_counts()
    _, rows = c.query("select g, sum(x), count(*) from d group by g "
                      "order by g")
    assert rows == [["1", "4.0", "2"], ["2", None, "1"]]
    assert sum(kernels.kernel_counts()["plain_calls"].values()) > 0
    assert all(cc.session.device == server.device
               for cc in server.conns.values())
    c.close()


def test_aio_wire_mode_is_not_ported(server):
    """tidb_wire_mode = 'aio' (the reference's event-loop front end) is
    not ported: a connection accepted in that mode gets an error packet
    naming it, a new server refuses to start in it, and legacy
    connections keep working."""
    admin = MiniClient(server.port)
    admin.query("set global tidb_wire_mode = 'aio'")
    try:
        import socket
        from tinysql_tpu_torch.server.packetio import PacketIO
        sock = socket.create_connection(("127.0.0.1", server.port),
                                        timeout=10)
        try:
            d = PacketIO(sock).read_packet()
        finally:
            sock.close()
        assert d[0] == 0xFF and b"aio" in d and b"item 8" in d
        with pytest.raises(NotImplementedError, match="item 8"):
            Server(server.storage, port=0, device="cpu").start()
        assert admin.query("select 1 + 1")[1] == [["2"]]
    finally:
        admin.query("set global tidb_wire_mode = 'legacy'")
    MiniClient(server.port).close()
    admin.close()
