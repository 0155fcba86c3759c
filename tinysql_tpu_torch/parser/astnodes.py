"""AST node types.

Capability parity with reference parser/ast/: dml.go (SelectStmt, Join,
TableSource, InsertStmt, DeleteStmt, ShowStmt…), ddl.go (Create/Drop/Alter),
expressions.go (BinaryOperationExpr, PatternInExpr, BetweenExpr,
PatternLikeExpr, IsNullExpr, CaseExpr, AggregateFuncExpr…), misc.go
(Set/Use/Begin/Commit/Rollback/Explain/Admin).  Dataclasses instead of the
Go visitor — tree walks are plain-Python recursion in the planner.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..mytypes import FieldType


class Node:
    pass


class ExprNode(Node):
    pass


class StmtNode(Node):
    #: this statement's own source slice within the parsed batch
    #: (Parser.parse fills it in) — the observability layer normalizes
    #: and samples THIS, never the display label a batch decorates
    src: str = ""


# ---------------- expressions ----------------------------------------------

@dataclass
class Literal(ExprNode):
    value: object  # None | int | float | str | bool


@dataclass
class DefaultExpr(ExprNode):
    """DEFAULT in a VALUES list."""


@dataclass
class ColumnRef(ExprNode):
    name: str
    table: str = ""
    db: str = ""

    def __str__(self) -> str:
        parts = [p for p in (self.db, self.table, self.name) if p]
        return ".".join(parts)


@dataclass
class UnaryOp(ExprNode):
    op: str          # '-', '+', 'not', '~'
    operand: ExprNode


@dataclass
class BinaryOp(ExprNode):
    op: str          # '+','-','*','/','div','%','and','or','xor',
                     # '=','<','>','<=','>=','!=','<=>'
    left: ExprNode
    right: ExprNode


@dataclass
class IsNullExpr(ExprNode):
    expr: ExprNode
    negated: bool = False


@dataclass
class IsTruthExpr(ExprNode):
    expr: ExprNode
    truth: bool      # IS TRUE / IS FALSE
    negated: bool = False


@dataclass
class LikeExpr(ExprNode):
    expr: ExprNode
    pattern: ExprNode
    negated: bool = False
    escape: str = "\\"


@dataclass
class InExpr(ExprNode):
    expr: ExprNode
    items: List[ExprNode] = field(default_factory=list)
    negated: bool = False


@dataclass
class BetweenExpr(ExprNode):
    expr: ExprNode
    lo: ExprNode
    hi: ExprNode
    negated: bool = False


@dataclass
class FuncCall(ExprNode):
    name: str                 # lowercase
    args: List[ExprNode] = field(default_factory=list)


@dataclass
class AggFunc(ExprNode):
    name: str                 # count/sum/avg/max/min/first_row (lowercase)
    args: List[ExprNode] = field(default_factory=list)
    distinct: bool = False


@dataclass
class CaseExpr(ExprNode):
    operand: Optional[ExprNode]
    when_clauses: List[Tuple[ExprNode, ExprNode]] = field(default_factory=list)
    else_clause: Optional[ExprNode] = None


@dataclass
class RowExpr(ExprNode):
    items: List[ExprNode] = field(default_factory=list)


@dataclass
class VariableExpr(ExprNode):
    name: str
    is_system: bool = False
    scope: str = ""           # '', 'global', 'session'


@dataclass
class ParenExpr(ExprNode):
    expr: ExprNode


@dataclass
class SubqueryExpr(ExprNode):
    """(SELECT ...) used as an expression: a scalar subquery in a
    comparison, or the list side of IN (reference: ast/expressions.go
    SubqueryExpr).  The inner statement is NOT walked by walk_expr —
    its aggregates/columns belong to the subquery's own scope."""
    select: "SelectStmt" = None


@dataclass
class ExistsExpr(ExprNode):
    """[NOT] EXISTS (SELECT ...) (reference: ast/expressions.go
    ExistsSubqueryExpr).  Decorrelates into a semi/anti join when it is
    a top-level WHERE conjunct; evaluates eagerly (uncorrelated only)
    elsewhere."""
    select: "SelectStmt" = None
    negated: bool = False


# ---------------- table refs -----------------------------------------------

@dataclass
class TableName(Node):
    name: str
    db: str = ""


@dataclass
class TableSource(Node):
    source: Node              # TableName | SelectStmt | Join
    as_name: str = ""


@dataclass
class Join(Node):
    """reference: ast/dml.go Join; the course's JoinTable production."""
    left: Node                # TableSource | Join
    right: Optional[Node]
    tp: str = "cross"         # cross | inner | left | right
    on: Optional[ExprNode] = None
    using: List[str] = field(default_factory=list)


# ---------------- DML -------------------------------------------------------

@dataclass
class SelectField(Node):
    expr: Optional[ExprNode]      # None for wildcard
    as_name: str = ""
    wildcard_table: str = ""      # for t.* ; '' means plain *
    is_wildcard: bool = False
    text: str = ""


@dataclass
class SelectStmt(StmtNode):
    fields: List[SelectField] = field(default_factory=list)
    from_: Optional[Join] = None
    where: Optional[ExprNode] = None
    group_by: List[ExprNode] = field(default_factory=list)
    having: Optional[ExprNode] = None
    order_by: List[Tuple[ExprNode, bool]] = field(default_factory=list)  # (expr, desc)
    limit: Optional[Tuple[int, int]] = None     # (offset, count)
    distinct: bool = False


@dataclass
class Assignment(Node):
    column: ColumnRef
    expr: ExprNode


@dataclass
class InsertStmt(StmtNode):
    table: TableName = None
    columns: List[str] = field(default_factory=list)
    lists: List[List[ExprNode]] = field(default_factory=list)
    select: Optional[SelectStmt] = None
    is_replace: bool = False


@dataclass
class DeleteStmt(StmtNode):
    table: TableSource = None
    where: Optional[ExprNode] = None


@dataclass
class UpdateStmt(StmtNode):
    """UPDATE t SET c = expr [, ...] [WHERE ...] (reference: ast/dml.go
    UpdateStmt, single-table form — a genuine extension past the
    reference's reduced surface, ROADMAP item 5)."""
    table: TableSource = None
    assignments: List[Assignment] = field(default_factory=list)
    where: Optional[ExprNode] = None


# ---------------- DDL -------------------------------------------------------

@dataclass
class ColumnOption(Node):
    tp: str                   # not_null/null/primary/unique/auto_increment/default
    value: object = None


@dataclass
class ColumnDef(Node):
    name: str
    ft: FieldType
    options: List[ColumnOption] = field(default_factory=list)


@dataclass
class Constraint(Node):
    tp: str                   # primary | unique | index
    name: str = ""
    columns: List[Tuple[str, int]] = field(default_factory=list)  # (col, prefix_len)


@dataclass
class CreateDatabaseStmt(StmtNode):
    name: str
    if_not_exists: bool = False


@dataclass
class DropDatabaseStmt(StmtNode):
    name: str
    if_exists: bool = False


@dataclass
class CreateTableStmt(StmtNode):
    table: TableName
    cols: List[ColumnDef] = field(default_factory=list)
    constraints: List[Constraint] = field(default_factory=list)
    if_not_exists: bool = False


@dataclass
class DropTableStmt(StmtNode):
    tables: List[TableName] = field(default_factory=list)
    if_exists: bool = False


@dataclass
class TruncateTableStmt(StmtNode):
    table: TableName = None


@dataclass
class CreateIndexStmt(StmtNode):
    index_name: str = ""
    table: TableName = None
    columns: List[Tuple[str, int]] = field(default_factory=list)
    unique: bool = False


@dataclass
class DropIndexStmt(StmtNode):
    index_name: str = ""
    table: TableName = None
    if_exists: bool = False


@dataclass
class AlterTableSpec(Node):
    tp: str                   # add_column | drop_column | add_index | drop_index | add_constraint
    column: Optional[ColumnDef] = None
    constraint: Optional[Constraint] = None
    name: str = ""


@dataclass
class AlterTableStmt(StmtNode):
    table: TableName = None
    specs: List[AlterTableSpec] = field(default_factory=list)


# ---------------- simple / admin -------------------------------------------

@dataclass
class ShowStmt(StmtNode):
    tp: str                   # databases|tables|columns|create_table|indexes|variables
    db: str = ""
    table: Optional[TableName] = None
    pattern: Optional[str] = None
    where: Optional[ExprNode] = None
    full: bool = False
    global_scope: bool = False


@dataclass
class SetStmt(StmtNode):
    # (scope, name, value) ; scope in '', 'global', 'session', 'user'
    assignments: List[Tuple[str, str, ExprNode]] = field(default_factory=list)


@dataclass
class UseStmt(StmtNode):
    db: str = ""


@dataclass
class BeginStmt(StmtNode):
    pass


@dataclass
class CommitStmt(StmtNode):
    pass


@dataclass
class RollbackStmt(StmtNode):
    pass


@dataclass
class ExplainStmt(StmtNode):
    stmt: StmtNode = None
    analyze: bool = False
    # EXPLAIN FOR CONNECTION <id>: render the target session's last
    # plan via the interrupt registry (stmt is None in that form)
    for_conn: Optional[int] = None


@dataclass
class TraceStmt(StmtNode):
    # TRACE [FORMAT = 'row'] <stmt>: execute the statement and return
    # its recorded span tree as rows (obs/trace.py trace_rows) — span,
    # parent, start offset, duration, thread role
    stmt: StmtNode = None
    format: str = "row"


@dataclass
class AnalyzeTableStmt(StmtNode):
    tables: List[TableName] = field(default_factory=list)


@dataclass
class AdminStmt(StmtNode):
    tp: str                   # show_ddl | show_ddl_jobs | check_table
    tables: List[TableName] = field(default_factory=list)


@dataclass
class KillStmt(StmtNode):
    # KILL [QUERY|CONNECTION] <conn_id>: QUERY aborts the target's
    # running statement; plain/CONNECTION also drops the connection
    conn_id: int = 0
    query_only: bool = False


@dataclass
class EmptyStmt(StmtNode):
    pass


# ---------------- tree walking ----------------------------------------------

def walk_expr(e: ExprNode):
    """Yield every expression node in the subtree (pre-order)."""
    if e is None:
        return
    yield e
    for child in expr_children(e):
        yield from walk_expr(child)


def expr_children(e: ExprNode) -> List[ExprNode]:
    if isinstance(e, UnaryOp):
        return [e.operand]
    if isinstance(e, BinaryOp):
        return [e.left, e.right]
    if isinstance(e, (IsNullExpr, IsTruthExpr)):
        return [e.expr]
    if isinstance(e, LikeExpr):
        return [e.expr, e.pattern]
    if isinstance(e, InExpr):
        return [e.expr] + e.items
    if isinstance(e, BetweenExpr):
        return [e.expr, e.lo, e.hi]
    if isinstance(e, (FuncCall, AggFunc)):
        return list(e.args)
    if isinstance(e, CaseExpr):
        out = [e.operand] if e.operand else []
        for c, r in e.when_clauses:
            out += [c, r]
        if e.else_clause:
            out.append(e.else_clause)
        return out
    if isinstance(e, RowExpr):
        return list(e.items)
    if isinstance(e, ParenExpr):
        return [e.expr]
    return []


def has_agg(e: ExprNode) -> bool:
    return any(isinstance(x, AggFunc) for x in walk_expr(e))
