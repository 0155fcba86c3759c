"""Vectorized filter, constant folding, expression utilities.

Capability parity with reference expression/chunk_executor.go:196
(VectorizedFilter), expression.go:205 (VecEvalBool CNF short-circuit),
constant_fold.go, util.go (column substitution).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..chunk import Chunk
from ..mytypes import to_bool
from .builtins import _truthy, new_function
from .core import Column, Constant, Expression, ScalarFunction, Schema


def vectorized_filter(exprs: Sequence[Expression], chk: Chunk) -> np.ndarray:
    """Evaluate a CNF list over the chunk -> boolean keep-mask over physical
    rows (reference: VectorizedFilter; NULL counts as false)."""
    n = chk.full_rows()
    mask = np.ones(n, dtype=bool)
    for e in exprs:
        if not mask.any():
            break  # short-circuit: everything already filtered
        v, null = e.vec_eval(chk)
        t, tn = _truthy((v, null))
        mask &= t & ~tn & ~null
    return mask


def eval_bool_scalar(exprs: Sequence[Expression], row) -> bool:
    for e in exprs:
        v = to_bool(e.eval(row))
        if v is None or v == 0:
            return False
    return True


def fold_constants(e: Expression) -> Expression:
    """Bottom-up constant folding (reference: constant_fold.go)."""
    if isinstance(e, ScalarFunction):
        new_args = [fold_constants(a) for a in e.args]
        e = ScalarFunction(e.name, new_args, e.ret_type,
                           e._scalar_fn, e._vec_fn)
        if all(isinstance(a, Constant) for a in new_args):
            try:
                v = e.eval([])
            except Exception:
                return e
            return Constant(v, e.ret_type)
    return e


def split_cnf(e: Optional[Expression]) -> List[Expression]:
    """Flatten nested ANDs into a conjunct list (reference:
    expression.SplitCNFItems)."""
    if e is None:
        return []
    if isinstance(e, ScalarFunction) and e.name == "and":
        return split_cnf(e.args[0]) + split_cnf(e.args[1])
    return [e]


def compose_cnf(conds: Sequence[Expression]) -> Optional[Expression]:
    if not conds:
        return None
    out = conds[0]
    for c in conds[1:]:
        out = new_function("and", [out, c])
    return out


def split_dnf(e: Optional[Expression]) -> List[Expression]:
    if e is None:
        return []
    if isinstance(e, ScalarFunction) and e.name == "or":
        return split_dnf(e.args[0]) + split_dnf(e.args[1])
    return [e]


def substitute_column(e: Expression, schema: Schema,
                      replacements: Sequence[Expression]) -> Expression:
    """Replace each Column that resolves in `schema` with the corresponding
    expression (reference: expression.ColumnSubstitute — used by projection
    elimination and predicate pushdown through projections)."""
    if isinstance(e, Column):
        idx = schema.column_index(e)
        return replacements[idx] if idx >= 0 else e
    if isinstance(e, ScalarFunction):
        return ScalarFunction(
            e.name, [substitute_column(a, schema, replacements) for a in e.args],
            e.ret_type, e._scalar_fn, e._vec_fn)
    return e


def expr_referenced_indices(exprs: Sequence[Expression]) -> List[int]:
    out = set()
    for e in exprs:
        for c in e.collect_columns():
            if c.index >= 0:
                out.add(c.index)
    return sorted(out)


def propagate_constants(conds: List[Expression]) -> List[Expression]:
    """Constant propagation across equalities (reference:
    expression/constant_propagation.go:580 — reduced to the CNF list
    form): `col = const` conjuncts substitute the constant into SIBLING
    conjuncts, then fold; `col1 = col2` equalities propagate a constant
    bound to either side onto the other.  Runs to a bounded fixpoint.
    `a = 3 AND a < b` becomes `a = 3 AND 3 < b`, unlocking index paths
    and pushdowns the raw form hides."""
    conds = list(conds)
    for _ in range(3):  # bounded fixpoint
        bindings = {}
        for c in conds:
            if isinstance(c, ScalarFunction) and c.name == "=" \
                    and len(c.args) == 2:
                a, b = c.args
                if isinstance(a, Column) and isinstance(b, Constant) \
                        and b.value is not None:
                    bindings.setdefault(a.unique_id, b)
                elif isinstance(b, Column) and isinstance(a, Constant) \
                        and a.value is not None:
                    bindings.setdefault(b.unique_id, a)
        if not bindings:
            return conds
        # col=col transitivity: bind the unbound side
        grew = True
        while grew:
            grew = False
            for c in conds:
                if isinstance(c, ScalarFunction) and c.name == "=" \
                        and len(c.args) == 2:
                    a, b = c.args
                    if isinstance(a, Column) and isinstance(b, Column):
                        if (a.unique_id in bindings
                                and b.unique_id not in bindings):
                            bindings[b.unique_id] = bindings[a.unique_id]
                            grew = True
                        elif (b.unique_id in bindings
                                and a.unique_id not in bindings):
                            bindings[a.unique_id] = bindings[b.unique_id]
                            grew = True

        def subst(e: Expression) -> Expression:
            # (defining `col = const` conjuncts and col=col join keys are
            # excluded by the caller loop below, never rewritten here)
            if isinstance(e, Column):
                got = bindings.get(e.unique_id)
                return got if got is not None else e
            if isinstance(e, ScalarFunction):
                return ScalarFunction(
                    e.name, [subst(a) for a in e.args],
                    e.ret_type, e._scalar_fn, e._vec_fn)
            return e

        changed = False
        out: List[Expression] = []
        for c in conds:
            if isinstance(c, ScalarFunction) and c.name == "=" \
                    and len(c.args) == 2:
                a, b = c.args
                col_const = ((isinstance(a, Column)
                              and isinstance(b, Constant))
                             or (isinstance(b, Column)
                                 and isinstance(a, Constant)))
                col_col = isinstance(a, Column) and isinstance(b, Column)
                if col_const or col_col:
                    out.append(c)  # defining / join-key equality: keep
                    continue
            new_c = fold_constants(subst(c))
            changed = changed or new_c.key() != c.key()
            out.append(new_c)
        conds = out
        if not changed:
            break
    return conds
