"""The port stands alone: no file of tinysql_tpu_torch/ (nor chip_smoke.py)
imports JAX or the reference package, and in a process where both are
blocked the port still starts — on the CPU when asked, never silently when
CUDA is missing."""
import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "tinysql_tpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "tinysql_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_no_port_file_imports_jax_or_the_reference():
    bad = []
    files = _port_files()
    assert len(files) > 100
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    bad.append(f"{os.path.relpath(path, ROOT)}: {name}")
    assert not bad, bad


_CHILD = r'''
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tinysql_tpu"):
            raise ImportError("blocked " + name)
        return None
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
import torch
torch.cuda.is_available = lambda: False  # the card is absent here
from tinysql_tpu_torch.session import new_session
try:
    new_session()
    print("no raise")
except RuntimeError as e:
    print("raised:", e)
s = new_session(device="cpu")
s.execute("create database d")
s.execute("use d")
s.execute("create table t (id bigint primary key, g bigint, x double)")
s.execute("insert into t values (1, 1, 1.5), (2, 1, 2.5), (3, 2, null)")
s.execute("set tidb_tpu_min_rows = 0")
print(s.query("select g, sum(x), count(*) from t group by g "
              "order by g").rows)
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tinysql_tpu")))
'''


def test_port_runs_with_jax_and_the_reference_blocked(tmp_path):
    r = subprocess.run([sys.executable, "-c", _CHILD, ROOT], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert lines[0].startswith("raised:") and "device='cpu'" in lines[0]
    assert lines[1] == "[[1, 4.0, 2], [2, None, 1]]"
    assert lines[2] == "[]"


_F1_CHILD = r'''
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tinysql_tpu"):
            raise ImportError("blocked " + name)
        return None
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
from tinysql_tpu_torch.session import new_session
s = new_session(device="cpu")
s.execute("create database d")
s.execute("use d")
s.execute("create table t (id bigint primary key, g bigint, key ig (g))")
s.execute("insert into t values (1, 1), (2, 1), (3, 2)")
s.execute("analyze table t")
print(s.query("admin check table t").rows)
s.execute("set tidb_enable_cascades_planner = 1")
print(s.query("select g, count(*) from t group by g order by g").rows)
s.execute("set tidb_enable_cascades_planner = 0")
s.execute("set tidb_qlint_verify = 1")
s.execute("set tidb_tpu_min_rows = 0")
print(s.query("select g, count(*) from t group by g order by g").rows)
mods = ("tinysql_tpu_torch.statistics.analyze",
        "tinysql_tpu_torch.executor.admin",
        "tinysql_tpu_torch.planner.cascades",
        "tinysql_tpu_torch.analysis.plan_device")
print(all(m in sys.modules for m in mods))
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tinysql_tpu")))
'''


def test_f1_modules_stand_alone(tmp_path):
    """ANALYZE TABLE, ADMIN CHECK TABLE, the cascades planner and the
    runtime plan verifier load the port's own statistics/analyze.py,
    executor/admin.py, planner/cascades/ and analysis/ with JAX and the
    reference blocked."""
    r = subprocess.run([sys.executable, "-c", _F1_CHILD, ROOT], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines() == [
        "[['OK']]", "[[1, 2], [2, 1]]", "[[1, 2], [2, 1]]", "True", "[]"]
