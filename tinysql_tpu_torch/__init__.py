"""tinysql_tpu_torch: the PyTorch / CUDA port of tinysql_tpu.

The same SQL engine — parser, planner with the device enforcer, volcano
executors over columnar replicas — with its device tier rewritten in
PyTorch and its kernels written by hand for Hopper (``csrc/*.cu``).  The
JAX package ``tinysql_tpu`` stays beside it as the reference; this
package imports neither JAX nor ``tinysql_tpu``.

Device-free modules are copies of the reference's with the import prefix
changed; the device modules are rewritten: ``ops/kernels.py``,
``ops/exprjit.py``, ``ops/_ext.py`` (kernel build), ``chunk/column.py``
(DeviceColumn on tensors), ``obs/memprof.py`` (device census) and
``executor/gpu_executors.py`` — the port of ``executor/tpu_executors.py``,
whose ``TPU*Exec`` classes are named ``GPU*Exec`` here.  SQL-visible
names (the ``tidb_use_tpu`` sysvar, ``(TPU)`` in EXPLAIN) stay as the
reference spells them.

Entry point: ``session.new_session(device=None)`` runs the device tier on
the current CUDA device and raises ``RuntimeError`` without one; pass
``device="cpu"`` to run it on the CPU (the kernels' plain torch versions
serve CPU tensors).
"""
