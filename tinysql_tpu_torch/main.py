"""Server binary (reference: tidb-server/main.go — flag parsing :44-81,
registerStores :120, createStoreAndDomain :127, bootstrap, signal handling
and graceful shutdown :265-291).

Run: python -m tinysql_tpu_torch.main [-P port] [--store mocktikv]
[--config f] [--device cpu|cuda]

The server runs its device tier on the current CUDA device unless
``--device cpu`` asks for the CPU; without a card it exits with the
reason (never a silent drop to the CPU).
"""
from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

from . import config as cfgmod
from .kv import new_mock_storage
from .server.http_status import StatusServer
from .server.server import Server
from .session.session import Session


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("tinysql-tpu-server")
    ap.add_argument("--config", default="", help="TOML config file")
    ap.add_argument("--host", default=None)
    ap.add_argument("-P", "--port", type=int, default=None)
    ap.add_argument("--store", default=None, choices=["mocktikv"])
    ap.add_argument("--path", default=None, help="store path/dsn")
    ap.add_argument("--data-dir", default=None,
                    help="durable MVCC data directory (WAL + checkpoints);"
                         " empty = volatile store")
    ap.add_argument("--status", type=int, default=None,
                    help="status HTTP port")
    ap.add_argument("--log-file", default=None)
    ap.add_argument("-L", "--log-level", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device of the device tier (default: the "
                         "current CUDA device)")
    return ap


def load_config(args) -> cfgmod.Config:
    """The config file named by the parsed ``args``, with the command
    line's overrides."""
    cfg = cfgmod.load(args.config)
    # CLI overrides (reference: overrideConfig main.go:176)
    if args.host is not None:
        cfg.host = args.host
    if args.port is not None:
        cfg.port = args.port
    if args.store is not None:
        cfg.store = args.store
    if args.path is not None:
        cfg.path = args.path
    if args.data_dir is not None:
        cfg.data_dir = args.data_dir
    if args.status is not None:
        cfg.status.status_port = args.status
    if args.log_file is not None:
        cfg.log.file = args.log_file
    if args.log_level is not None:
        cfg.log.level = args.log_level
    cfgmod.store_global_config(cfg)
    return cfg


def setup_logging(cfg: cfgmod.Config) -> None:
    handlers = None
    if cfg.log.file:
        handlers = [logging.FileHandler(cfg.log.file)]
    logging.basicConfig(
        level=getattr(logging, cfg.log.level.upper(), logging.INFO),
        format="[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
        handlers=handlers)


def bootstrap(storage) -> None:
    """Create system state on first run (reference: session/bootstrap.go)."""
    s = Session(storage)
    try:
        s.execute("create database if not exists test")
    except Exception:
        pass


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(
        argv if argv is not None else sys.argv[1:])
    cfg = load_config(args)
    setup_logging(cfg)
    log = logging.getLogger("tinysql_tpu")
    # the device first: a missing card ends the start-up before any
    # storage or thread exists (RuntimeError names the reason)
    from .ops.kernels import resolve_device
    device = resolve_device(args.device)
    # data_dir: CLI/config wins; "" falls through to TINYSQL_DATA_DIR env
    # (kv/txn.py resolve_data_dir); no dir at all = the volatile store
    storage = new_mock_storage(num_stores=cfg.num_stores,
                               data_dir=cfg.data_dir or None)
    if storage.data_dir:
        ri = storage.mvcc.recovery_info or {}
        log.info("durable store on %s (replayed %d wal records, "
                 "%d in-flight locks recovered)", storage.data_dir,
                 ri.get("replayed_records", 0),
                 ri.get("recovered_locks", 0))
    bootstrap(storage)
    server = Server(storage, cfg.host, cfg.port,
                    ssl_cert=cfg.security.ssl_cert,
                    ssl_key=cfg.security.ssl_key, device=device)
    port = server.start()
    status = None
    if cfg.status.report_status:
        status = StatusServer(server, cfg.status.status_host,
                              cfg.status.status_port)
        status.start()
        log.info("status server on :%d", status.port)
    log.info("server ready on :%d (store=%s, device=%s)", port, cfg.store,
             device)

    stop = threading.Event()

    def on_signal(sig, frame):
        log.info("signal %s: shutting down", sig)
        stop.set()
    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)
    stop.wait()
    server.close()
    storage.close()  # final WAL checkpoint + fd close (no-op volatile)
    if status is not None:
        status.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
