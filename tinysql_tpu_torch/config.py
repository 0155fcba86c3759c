"""Layered configuration (reference: config/config.go — defaults struct
:155, strict TOML Load :118-140 with unknown-key detection, CLI flag
overrides in tidb-server/main.go:176-234, atomic global :108)."""
from __future__ import annotations

import threading
from dataclasses import dataclass, field, fields, is_dataclass

try:
    import tomllib  # Python 3.11+
except ImportError:  # 3.10 runners: minimal strict-subset parser below
    tomllib = None


class ConfigError(Exception):
    pass


@dataclass
class Log:
    level: str = "info"
    file: str = ""          # empty = stderr
    slow_threshold_ms: int = 300


@dataclass
class Status:
    report_status: bool = True
    status_host: str = "127.0.0.1"
    status_port: int = 10080


@dataclass
class Security:
    # reference: config/config.go Security section (ssl-cert/ssl-key);
    # both set => the server advertises CLIENT_SSL and accepts the
    # mid-handshake upgrade (server/conn.go:448-455,1070)
    ssl_cert: str = ""
    ssl_key: str = ""


@dataclass
class Config:
    host: str = "127.0.0.1"
    port: int = 4000
    store: str = "mocktikv"          # mocktikv | tikv
    path: str = "/tmp/tinysql_tpu"
    lease: str = "45s"
    num_stores: int = 1
    use_tpu: bool = True
    # persistent XLA compile-cache directory; "" = <repo>/.jax_cache
    # (ops/kernels.py _cache_dir resolution: sysvar tidb_compile_cache_dir
    # > TINYSQL_JAX_CACHE env > this entry > default)
    compile_cache_dir: str = ""
    # durability arming (kv/wal.py): directory for the MVCC WAL +
    # checkpoints.  "" = volatile in-memory store, byte-identical to the
    # pre-WAL behavior.  Resolution: --data-dir CLI > this entry >
    # TINYSQL_DATA_DIR env (kv/txn.py resolve_data_dir)
    data_dir: str = ""
    log: Log = field(default_factory=Log)
    status: Status = field(default_factory=Status)
    security: Security = field(default_factory=Security)


def _apply(obj, data: dict, prefix: str = "") -> None:
    known = {f.name: f for f in fields(obj)}
    for k, v in data.items():
        key = k.replace("-", "_")
        if key not in known:
            raise ConfigError(
                f"unknown configuration option {prefix}{k!r}")
        cur = getattr(obj, key)
        if isinstance(v, dict):
            if not is_dataclass(cur):
                raise ConfigError(
                    f"{prefix}{k} is a scalar option, not a section")
            _apply(cur, v, prefix=f"{prefix}{k}.")
        else:
            if not isinstance(v, type(cur)) and not (
                    isinstance(cur, bool) is isinstance(v, bool)
                    and isinstance(v, int) and isinstance(cur, int)):
                raise ConfigError(
                    f"bad type for {prefix}{k}: {type(v).__name__}")
            setattr(obj, key, v)


def _parse_toml_minimal(text: str) -> dict:
    """Config-file TOML subset for pre-3.11 interpreters: `[section]`
    headers (dotted allowed) and `key = scalar` lines with string / int /
    float / bool scalars.  Enough for every config this server reads;
    anything fancier needs the stdlib tomllib."""
    root: dict = {}
    cur = root
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("[") and line.endswith("]"):
            cur = root
            for part in line[1:-1].strip().split("."):
                cur = cur.setdefault(part.strip(), {})
            continue
        if "=" not in line:
            raise ConfigError(f"bad TOML line {lineno}: {raw!r}")
        key, _, val = line.partition("=")
        key = key.strip().strip('"')
        val = val.strip()
        if val[:1] in ('"', "'"):
            # quoted string: close at the matching quote; anything after
            # it may only be an inline comment
            end = val.find(val[0], 1)
            rest = val[end + 1:].strip() if end > 0 else "!"
            if end < 0 or (rest and not rest.startswith("#")):
                raise ConfigError(
                    f"bad TOML string at line {lineno}: {raw!r}")
            cur[key] = val[1:end]
            continue
        val = val.split("#", 1)[0].strip()
        if val in ("true", "false"):
            cur[key] = val == "true"
        else:
            try:
                cur[key] = int(val)
            except ValueError:
                try:
                    cur[key] = float(val)
                except ValueError:
                    raise ConfigError(
                        f"bad TOML value at line {lineno}: {raw!r}")
    return root


def load(path: str = "") -> Config:
    """TOML file -> Config with strict unknown-key detection
    (reference: ErrConfigValidationFailed)."""
    cfg = Config()
    if path:
        if tomllib is not None:
            with open(path, "rb") as f:
                data = tomllib.load(f)
        else:
            with open(path, "r", encoding="utf-8") as f:
                data = _parse_toml_minimal(f.read())
        _apply(cfg, data)
    return cfg


_global = Config()
_mu = threading.Lock()


def get_global_config() -> Config:
    return _global


def store_global_config(cfg: Config) -> None:
    global _global
    with _mu:
        _global = cfg
