"""Expression subsystem (reference: expression/)."""
from .core import Column, Constant, Expression, ScalarFunction, Schema
from .builtins import new_function, like_to_regex, KNOWN_SCALAR_FUNCS
from .util import (vectorized_filter, eval_bool_scalar, fold_constants,
                   propagate_constants, split_cnf, compose_cnf, split_dnf,
                   substitute_column)
from .aggregation import (AggFuncDesc, AggMode, infer_agg_ret_type,
                          AGG_COUNT, AGG_SUM, AGG_AVG, AGG_MAX, AGG_MIN,
                          AGG_FIRST_ROW)

__all__ = [
    "Column", "Constant", "Expression", "ScalarFunction", "Schema",
    "new_function", "like_to_regex", "KNOWN_SCALAR_FUNCS",
    "vectorized_filter", "eval_bool_scalar", "fold_constants",
    "propagate_constants",
    "split_cnf", "compose_cnf", "split_dnf", "substitute_column",
    "AggFuncDesc", "AggMode", "infer_agg_ret_type",
    "AGG_COUNT", "AGG_SUM", "AGG_AVG", "AGG_MAX", "AGG_MIN", "AGG_FIRST_ROW",
]
