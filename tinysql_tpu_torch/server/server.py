"""TCP server speaking the MySQL protocol (reference: server/server.go
NewServer :121 / Run :155 accept loop / per-conn goroutine :225, and
server/conn.go clientConn.Run :541, dispatch :667, handleQuery :821,
writeResultset :931).

One thread per connection (the per-connection-goroutine analogue, SURVEY
§2.11 P1); each connection owns a Session over the shared storage.

The port's seam: a :class:`Server` runs its device tier on one torch
device (``device=None``: the current CUDA device, raising
``RuntimeError`` without one; ``device="cpu"`` for the tests), and every
connection's Session and the auto-prewarm worker's session run there.
The event-loop front end (``tidb_wire_mode = 'aio'``, the reference's
server/aio.py) is not ported yet (ROADMAP queue 1, item 8): a server
started in that mode raises ``NotImplementedError`` and a connection
accepted after a switch to it gets an error packet.
"""
from __future__ import annotations

import logging
import socket
import threading
import time
import weakref
from typing import Dict, Optional

from ..session.session import ResultSet, Session
from . import protocol as p
from .packetio import PacketIO

log = logging.getLogger("tinysql_tpu.server")

_AIO_NOT_PORTED = ("tidb_wire_mode = 'aio' (the event-loop front end, "
                   "server/aio.py) is not ported yet: ROADMAP queue 1, "
                   "item 8; use 'legacy'")

#: live servers (weak — registry dies with the server): the
#: ``tinysql_conn_*`` gauges aggregate open/idle/active connections
#: across every live server the same way pool gauges do for pools.
_SERVERS: "weakref.WeakSet" = weakref.WeakSet()
_SERVERS_MU = threading.Lock()


def conn_gauges() -> dict:
    """Aggregate connection gauges across every live server (the
    ``tinysql_conn_open/idle/active`` ring-metric feed).  A connection
    is *active* while its session has a statement executing or queued;
    everything else — parked aio file objects and legacy threads
    blocked in read alike — is *idle*."""
    out = {"open": 0, "idle": 0, "active": 0}
    with _SERVERS_MU:
        servers = list(_SERVERS)
    for srv in servers:
        with srv._mu:
            ccs = list(srv.conns.values())
        for cc in ccs:
            sess = cc.session
            out["open"] += 1
            if getattr(sess, "stmt_running", False) or \
                    getattr(sess, "stmt_state", "") == "queued":
                out["active"] += 1
            else:
                out["idle"] += 1
    return out


def _err_packet_for(e: Exception) -> bytes:
    """Map a statement error onto the wire: typed errors carry their own
    MySQL code/sqlstate (QueryKilled 1317, QueryTimeout 3024,
    MemQuotaExceeded 8175, coded SessionErrors); everything else is the
    generic 1105."""
    return p.err_packet(getattr(e, "mysql_code", 1105), str(e),
                        getattr(e, "sqlstate", "HY000"))


class ClientConn:
    def __init__(self, server: "Server", conn: socket.socket):
        self.server = server
        self.sock = conn
        self.io = PacketIO(conn)
        self.tls = False
        self.session = Session(server.storage, domain=server.domain)
        self.session.device = server.device
        # the wire thread-id IS the session's process-unique conn id, so
        # the id a client sees in the handshake is a valid KILL target
        self.conn_id = self.session.conn_id
        self.alive = True
        # prepared statements: id -> [sql_parts, types] (binary protocol)
        self._stmts: dict = {}
        self._next_stmt_id = 1

    # ---- handshake (reference: conn.go:117,418 — with the scramble
    # verification full TiDB does and tinysql stripped) -------------------
    def greeting_caps(self) -> int:
        caps = p.SERVER_CAPS
        if self.server.ssl_ctx is not None:
            caps |= p.CLIENT_SSL
        return caps

    def handshake(self) -> bool:
        salt = p.new_salt()
        self.io.write_packet(p.handshake_v10(self.conn_id, salt,
                                             self.greeting_caps()))
        try:
            payload = self.io.read_packet()
        except (ConnectionError, OSError):
            return False
        return self.finish_handshake(salt, payload)

    def finish_handshake(self, salt: bytes, payload: bytes) -> bool:
        """Everything after the greeting round-trip: optional TLS
        upgrade, response parse, scramble verification, initial USE.
        Split out so the aio front end (which frames the first response
        itself, nonblocking) shares one auth path with the legacy
        blocking read above."""
        import struct
        from . import auth
        try:
            # SSLRequest (reference: conn.go:448-455 readOptionalSSLRequest
            # + upgradeToTLS :1070): the protocol-41 SSLRequest is the
            # 32-byte response prefix (caps, max-packet, charset, filler)
            # with CLIENT_SSL set and NO username — the client then
            # renegotiates over TLS and sends the full response.
            if (self.server.ssl_ctx is not None and len(payload) <= 32
                    and struct.unpack_from("<I", payload, 0)[0]
                    & p.CLIENT_SSL):
                seq = self.io.sequence
                self.sock = self.server.ssl_ctx.wrap_socket(
                    self.sock, server_side=True)
                self.io = PacketIO(self.sock)
                self.io.sequence = seq
                self.tls = True
                payload = self.io.read_packet()
            resp = p.parse_handshake_response(payload)
        except (ConnectionError, IndexError, ValueError, struct.error,
                OSError):
            return False  # not a MySQL client (or bad TLS); close quietly
        try:
            stored = auth.lookup_auth_string(self.server.storage,
                                             resp["user"],
                                             self.server.device)
        except Exception as e:  # auth lookup failure != dead server thread
            log.warning("conn-%d auth lookup error: %s", self.conn_id, e)
            self.io.write_packet(p.err_packet(1105, "auth lookup failed"))
            return False
        if stored is None or not auth.check_scramble(resp["auth"], salt,
                                                     stored):
            using = "YES" if resp["auth"] else "NO"
            self.io.write_packet(p.err_packet(
                1045, f"Access denied for user '{resp['user']}'@'%' "
                      f"(using password: {using})", "28000"))
            return False
        if resp["db"]:
            try:
                self.session.execute(f"use `{resp['db']}`")
            except Exception as e:
                self.io.write_packet(p.err_packet(1049, str(e), "42000"))
                return False
        self.user = resp["user"]
        self.session.user = resp["user"]  # PROCESSLIST identity
        self.io.write_packet(p.ok_packet())
        return True

    # ---- command loop (reference: conn.go:541,667) ----------------------
    def dispatch_command(self, cmd: int, payload: bytes) -> None:
        """One non-QUIT command's dispatch + response, shared by the
        legacy thread loop below and the aio front end (which frames
        commands itself and intercepts COM_QUERY for async pool
        submission before ever calling here)."""
        if cmd == p.COM_PING:
            self.io.write_packet(p.ok_packet())
        elif cmd == p.COM_INIT_DB:
            db = payload.decode("utf-8", "replace")
            self._run_sql(f"use `{db}`")
        elif cmd == p.COM_QUERY:
            self._run_sql(payload.decode("utf-8", "replace"))
        elif cmd == p.COM_FIELD_LIST:
            self._handle_field_list(payload)
        elif cmd == p.COM_STMT_PREPARE:
            self._handle_stmt_prepare(payload)
        elif cmd == p.COM_STMT_EXECUTE:
            self._handle_stmt_execute(payload)
        elif cmd == p.COM_STMT_CLOSE:
            import struct
            self._stmts.pop(
                struct.unpack_from("<I", payload, 0)[0], None)
            # COM_STMT_CLOSE sends no response
        else:
            self.io.write_packet(
                p.err_packet(1047, f"unknown command {cmd}"))

    def run(self, pre=None) -> None:
        """The per-connection thread body.  ``pre=(salt, payload)``
        resumes a handshake whose greeting round-trip already happened
        on the event loop (the aio front end's TLS handoff)."""
        try:
            ok = self.finish_handshake(*pre) if pre is not None \
                else self.handshake()
            if not ok:
                return
            while self.alive:
                self.io.reset_sequence()
                try:
                    data = self.io.read_packet()
                except ConnectionError:
                    return
                if not data:
                    continue
                cmd, payload = data[0], data[1:]
                if cmd == p.COM_QUIT:
                    return
                try:
                    self.dispatch_command(cmd, payload)
                except ConnectionError:
                    return
                except Exception as e:  # one bad command != dead conn
                    log.warning("conn-%d command error: %s",
                                self.conn_id, e)
                    try:
                        self.io.write_packet(_err_packet_for(e))
                    except OSError:
                        return
                if self.session.killed:
                    # plain KILL <id>: the connection drops after the
                    # current command's response went out
                    return
        finally:
            try:
                self.session.rollback_txn()
            except Exception:
                pass
            self.sock.close()
            self.server.remove_conn(self.conn_id)

    def _handle_field_list(self, payload: bytes) -> None:
        """COM_FIELD_LIST (reference conn.go:846 handleFieldList): table
        name up to NUL, optional field wildcard after; respond with one
        column definition per table column (empty default value) + EOF."""
        from ..catalog.infoschema import DatabaseNotExist, TableNotExist
        name = payload.split(b"\x00", 1)[0].decode("utf-8", "replace")
        db = self.session.current_db
        if not db:
            self.io.write_packet(p.err_packet(1046, "No database selected",
                                              "3D000"))
            return
        try:
            # fresh domain schema, NOT the session's statement pin: a
            # COM_FIELD_LIST never runs a statement, so the pin would
            # otherwise serve a stale column list across others' DDL
            info = self.session.domain.info_schema().table_by_name(db,
                                                                   name)
        except DatabaseNotExist:
            self.io.write_packet(p.err_packet(
                1049, f"Unknown database '{db}'", "42000"))
            return
        except TableNotExist:
            self.io.write_packet(p.err_packet(
                1146, f"Table '{db}.{name}' doesn't exist", "42S02"))
            return
        self.io.begin_buffer()
        try:
            for col in info.columns:
                self.io.write_packet(p.column_def(col.name, col.ft,
                                                  with_default=True))
            self.io.write_packet(p.eof_packet())
        finally:
            self.io.flush()

    # ---- prepared statements (binary protocol) --------------------------
    # The client-visible surface of the reference's binary resultset path
    # (conn.go:879 writeResultset binary=true, util.go:171 dumpBinaryRow):
    # prepare splits on '?' placeholders, execute decodes binary params,
    # substitutes literals, and streams the resultset in BINARY rows.
    MAX_PREPARED_STMTS = 1024  # per connection (max_prepared_stmt_count)

    def _handle_stmt_prepare(self, payload: bytes) -> None:
        if len(self._stmts) >= self.MAX_PREPARED_STMTS:
            self.io.write_packet(p.err_packet(
                1461, "Can't create more than "
                f"{self.MAX_PREPARED_STMTS} prepared statements", "42000"))
            return
        sql = payload.decode("utf-8", "replace")
        parts = p.split_placeholders(sql)
        n_params = len(parts) - 1
        # result-column metadata WITHOUT executing: plan the statement
        # with NULL in the placeholders (param types are unknown at
        # prepare time — MySQL's own prepare metadata does the same)
        cols = fts = None
        try:
            from ..parser import parse
            probe = parse("NULL".join(parts))
            if len(probe) == 1:
                meta = self.session.select_metadata(probe[0])
                if meta is not None:
                    cols, fts = meta
        except Exception:
            cols = fts = None
        sid = self._next_stmt_id
        self._next_stmt_id += 1
        self._stmts[sid] = [parts, None]
        self.io.begin_buffer()
        try:
            self.io.write_packet(p.prepare_ok(sid, n_params,
                                              len(cols) if cols else 0))
            for _ in range(n_params):
                self.io.write_packet(p.column_def("?", None))
            if n_params:
                self.io.write_packet(p.eof_packet())
            if cols:
                for name, ft in zip(cols, fts):
                    self.io.write_packet(p.column_def(name, ft))
                self.io.write_packet(p.eof_packet())
        finally:
            self.io.flush()

    def _handle_stmt_execute(self, payload: bytes) -> None:
        import struct
        sid = struct.unpack_from("<I", payload, 0)[0]
        ent = self._stmts.get(sid)
        if ent is None:
            self.io.write_packet(p.err_packet(
                1243, f"Unknown prepared statement handler ({sid})",
                "HY000"))
            return
        parts, prev_types = ent
        _, vals, types = p.decode_execute_params(payload, len(parts) - 1,
                                                 prev_types)
        ent[1] = types
        try:
            sql = parts[0] + "".join(p.literal(v) + seg
                                     for v, seg in zip(vals, parts[1:]))
        except ValueError as e:
            self.io.write_packet(p.err_packet(1367, str(e), "22007"))
            return
        from ..parser import parse
        stmts = parse(sql)
        if len(stmts) != 1:
            self.io.write_packet(p.err_packet(
                1064, "prepared statement must be a single statement",
                "42000"))
            return
        rs = self.server.pool.run(self.session, stmts[0], sql)
        if isinstance(rs, ResultSet):
            self._write_resultset(rs, binary=True)
        else:
            self.io.write_packet(p.ok_packet(
                affected=self.session.last_affected))

    def _run_sql(self, sql: str) -> None:
        """Execute statement-by-statement so each gets its own response,
        chained with SERVER_MORE_RESULTS_EXISTS (reference: conn.go
        handleQuery's multi-statement loop)."""
        from ..parser import parse
        try:
            stmts = parse(sql)
        except Exception as e:
            self.io.write_packet(p.err_packet(1064, str(e), "42000"))
            return
        for i, stmt in enumerate(stmts):
            more = i + 1 < len(stmts)
            label = sql if len(stmts) == 1 else \
                f"{sql[:200]} [stmt {i + 1}/{len(stmts)}]"
            try:
                # the full-lifecycle entry, via the bounded statement
                # pool (admission control + same-digest coalescing;
                # control statements bypass it inside pool.run): wire
                # statements get QueryObs scopes, summary/slow-log
                # records, and processlist info
                rs = self.server.pool.run(self.session, stmt, label)
            except Exception as e:
                log.debug("query error: %s", e)
                self.io.write_packet(_err_packet_for(e))
                return  # error aborts the remaining statements
            if isinstance(rs, ResultSet):
                self._write_resultset(rs, more)
            else:
                self.io.write_packet(p.ok_packet(
                    affected=self.session.last_affected,
                    more_results=more))

    def _write_resultset(self, rs: ResultSet, more: bool = False,
                         binary: bool = False) -> None:
        """Text rows for COM_QUERY, binary rows for COM_STMT_EXECUTE
        (reference conn.go:931,977 writeChunks text/binary split)."""
        from .packetio import lenenc_int
        self.io.begin_buffer()  # whole resultset -> one sendall
        try:
            self.io.write_packet(lenenc_int(len(rs.columns)))
            fields = rs.fields or [None] * len(rs.columns)
            for name, ft in zip(rs.columns, fields):
                self.io.write_packet(p.column_def(name, ft))
            self.io.write_packet(p.eof_packet())
            for row in rs.rows:
                self.io.write_packet(p.binary_row(row, fields) if binary
                                     else p.text_row(row))
            self.io.write_packet(p.eof_packet(more_results=more))
        finally:
            self.io.flush()


class Server:
    def __init__(self, storage, host: str = "127.0.0.1", port: int = 4000,
                 lease_s: float = 0.05, ssl_cert: str = "",
                 ssl_key: str = "", device=None):
        from ..ops import kernels
        self.storage = storage
        # where every session of this server runs its device tier: None
        # = the current CUDA device, raising without one (never a silent
        # drop to the CPU), as new_session() does
        self.device = kernels.resolve_device(device)
        # mid-handshake TLS upgrade (reference: server/conn.go:448-455,
        # upgradeToTLS :1070) — advertised via CLIENT_SSL only when a
        # cert/key pair is configured
        self.ssl_ctx = None
        if ssl_cert and ssl_key:
            import ssl as _ssl
            ctx = _ssl.SSLContext(_ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(ssl_cert, ssl_key)
            self.ssl_ctx = ctx
        # one schema-cache domain PER SERVER (reference: domain singleton
        # per tidb-server process) with a background reload ticker so the
        # DDL syncer barrier sees this server catch up
        from ..domain import Domain
        self.domain = Domain(storage, lease_s=lease_s, background=True)
        # stats-driven auto-prewarm (session/prewarm.py): a background
        # worker that warms the hottest digest families from
        # statements_summary off the query path (their programs and
        # stacked variants, on this server's device).  Gated at runtime
        # by the GLOBAL tidb_auto_prewarm sysvar (re-read every cycle).
        from ..session.prewarm import PrewarmWorker
        self.prewarm = PrewarmWorker(storage, domain=self.domain,
                                     device=self.device)
        # bounded statement execution + admission control + same-digest
        # micro-batching (server/pool.py, server/admission.py) — the
        # high-throughput serving path (ROADMAP open item 2)
        from .pool import StatementPool
        self.pool = StatementPool(storage)
        # time-series metrics sampler (obs/tsring.py): snapshots every
        # registered counter/gauge source into the bounded ring behind
        # information_schema.metrics_history / metrics_summary and the
        # inspection engine, paced by the GLOBAL tidb_metrics_interval
        from ..obs.tsring import Sampler
        self.metrics_sampler = Sampler(storage)
        # continuous host profiler (obs/conprof.py): a background
        # stack sampler walking sys._current_frames() at the GLOBAL
        # tidb_conprof_rate (Hz, 0 = off), feeding
        # information_schema.continuous_profiling, /debug/conprof,
        # statements_summary CPU attribution, and the cpu-saturation /
        # profiler-overhead inspection rules
        from ..obs.conprof import ConprofSampler
        self.conprof_sampler = ConprofSampler(storage)
        # continuous heap profiler (obs/memprof.py): tracemalloc-based
        # allocation-site sampler paced by tidb_memprof_rate (Hz, 0 =
        # off + tracing stopped), feeding /debug/heap, the memory_state
        # reconciliation series, statements_summary heap attribution,
        # and the heap-growth / mem-untracked inspection rules
        from ..obs.memprof import MemprofSampler
        self.memprof_sampler = MemprofSampler(storage)
        # durable flight recorder (obs/flight.py): stamps this boot's
        # incarnation identity and — when the storage has a data dir —
        # appends crc-framed observability segments every
        # tidb_flight_interval, loads prior incarnations read-only, and
        # arms the atexit/faulthandler black-box flush.  Volatile
        # storage: identity only, zero flight movement.
        from ..obs.flight import FlightWriter
        self.flight_writer = FlightWriter(storage)
        self.host = host
        self.port = port
        self.sock: Optional[socket.socket] = None
        self.conns: Dict[int, ClientConn] = {}
        self._mu = threading.Lock()
        self._closed = threading.Event()
        with _SERVERS_MU:
            _SERVERS.add(self)

    def start(self) -> int:
        """Bind + accept loop in a background thread; returns bound port."""
        from .auth import ensure_user_table
        # idempotent system-table bootstrap
        ensure_user_table(self.storage, self.device)
        if self.wire_mode() == "aio":
            raise NotImplementedError(_AIO_NOT_PORTED)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((self.host, self.port))
        self.port = self.sock.getsockname()[1]
        self.sock.listen(128)
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="mysql-accept")
        t.start()
        self.prewarm.start()
        self.metrics_sampler.start()
        self.conprof_sampler.start()
        self.memprof_sampler.start()
        self.flight_writer.start()
        # device-time truth knobs are process-global module state applied
        # at SET time (session/session.py) — a fresh server re-applies
        # whatever GLOBAL scope the storage carries
        try:
            g = getattr(self.storage, "_global_vars", {})
            from ..ops import profiler
            profiler.set_rate(float(
                g.get("tidb_device_profile_rate", 0) or 0))
            from ..obs import inspect as obs_inspect
            obs_inspect.set_slo_p99_ms(float(
                g.get("tidb_slo_p99_ms", 0) or 0))
            wal = self.storage.mvcc.wal
            if wal is not None and g.get("tidb_wal_fsync"):
                wal.set_fsync_policy(str(g["tidb_wal_fsync"]))
        except Exception:
            log.warning("device-profile knob re-apply failed",
                        exc_info=True)
        log.info("listening on %s:%d", self.host, self.port)
        return self.port

    def _max_connections(self) -> int:
        from .pool import read_global_int
        return read_global_int(self.storage,
                               "tidb_max_server_connections", 0)

    def wire_mode(self) -> str:
        """The live GLOBAL ``tidb_wire_mode``: ``legacy`` =
        thread-per-connection, ``aio`` = event-loop front end.  Read
        per accepted connection, so a mid-server flip applies to every
        NEW connection while established ones keep their mode."""
        from .pool import read_global_str
        return read_global_str(self.storage, "tidb_wire_mode",
                               "legacy").strip().lower()

    def _accept_loop(self) -> None:
        from . import admission
        while not self._closed.is_set():
            try:
                conn, addr = self.sock.accept()
            except OSError:
                return
            cap = self._max_connections()
            with self._mu:
                n_open = len(self.conns)
            # the connection-admission gate (server/admission.py): the
            # 1040 verdict and its accept/shed accounting live with the
            # 1041 statement gate, and run AT ACCEPT — before any
            # handshake work — in both wire modes
            if not admission.check_connect(n_open, cap):
                # MySQL refuses over-cap connects with ERR 1040 as the
                # FIRST packet (no handshake) — the unbounded accept
                # loop was a trivial DoS before this gate
                try:
                    PacketIO(conn).write_packet(p.err_packet(
                        1040, "Too many connections", "08004"))
                except OSError:
                    pass
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            if self.wire_mode() == "aio":
                # the event-loop front end is not ported: refuse this
                # connection with the reason, keep serving legacy ones
                try:
                    PacketIO(conn).write_packet(p.err_packet(
                        1105, _AIO_NOT_PORTED))
                except OSError:
                    pass
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            cc = ClientConn(self, conn)
            with self._mu:
                self.conns[cc.conn_id] = cc
            threading.Thread(target=cc.run, daemon=True,
                             name=f"conn-{cc.conn_id}").start()

    def remove_conn(self, cid: int) -> None:
        with self._mu:
            self.conns.pop(cid, None)

    def close(self) -> None:
        """Graceful drain (reference: server.go:155-283)."""
        self._closed.set()
        # shutdown drain: give in-flight pooled statements a bounded
        # window to complete (and their responses to flush) BEFORE the
        # front ends are torn down — the WAL checkpoint below must cover
        # every statement the wire acked.  Wedged statements (armed
        # sleeps, kills in flight) fall through to today's cancel path.
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            try:
                snap = self.pool.snapshot()
                if not snap.get("running") and not snap.get("queued"):
                    break
            except Exception:
                break
            time.sleep(0.01)  # qlint: disable=CC701 -- bounded drain poll at shutdown, no lock held
        self.pool.close()
        self.prewarm.close()
        self.metrics_sampler.close()
        self.conprof_sampler.close()
        self.memprof_sampler.close()
        # flight black box: force-flush the final segment (last trace
        # ring + processlist) AFTER the samplers stop — their windows
        # are settled — and BEFORE the WAL checkpoint below, so a clean
        # shutdown marks this incarnation's record final.  Both wire
        # modes end here (the aio front end closed above).
        self.flight_writer.close()
        self.domain.close()
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
        with self._mu:
            for cc in list(self.conns.values()):
                cc.alive = False
                try:
                    cc.sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
        # graceful-close durability parity (BOTH wire modes end here):
        # fsync the WAL tail and fold it into a checkpoint, so a clean
        # shutdown leaves the data dir checkpoint-clean.  Best effort —
        # a failed checkpoint leaves the unrotated log authoritative,
        # and a shared storage may already be closed by another server.
        flush = getattr(self.storage, "flush_and_checkpoint", None)
        if flush is not None:
            try:
                flush()
            except Exception:
                log.warning("wal checkpoint on close failed",
                            exc_info=True)
