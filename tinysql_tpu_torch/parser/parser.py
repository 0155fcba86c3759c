"""SQL parser: recursive descent with Pratt expression climbing.

Capability parity with reference parser/parser.y (5,299-line goyacc LALR
grammar, tinysql statement subset — parser.y:4521-4543) including the JOIN
productions the course has students add (courses/proj2).  Hand-rolled
instead of generated: the grammar subset is small enough that a Pratt parser
is clearer and plenty fast (the reference itself keeps the lexer hand-written,
lexer.go).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..mytypes import (FieldType, TYPE_DOUBLE, TYPE_FLOAT, TYPE_LONG,
                       TYPE_LONGLONG, TYPE_STRING, TYPE_VARCHAR,
                       FLAG_AUTO_INCREMENT, FLAG_NOT_NULL, FLAG_PRI_KEY,
                       FLAG_UNIQUE_KEY, FLAG_UNSIGNED)
from .astnodes import *  # noqa: F401,F403
from .lexer import (ParseError, T_EOF, T_FLOAT, T_IDENT, T_INT, T_OP,
                    T_QIDENT, T_STRING, T_SYSVAR, T_USERVAR, Token, tokenize)

AGG_FUNCS = {"count", "sum", "avg", "max", "min"}

_CMP_OPS = {"=", "<", ">", "<=", ">=", "!=", "<>", "<=>"}


class Parser:
    """reference: parser/yy_parser.go Parser (entry: Parse)."""

    def __init__(self):
        self.toks: List[Token] = []
        self.i = 0
        self.sql = ""

    # ==== token helpers =====================================================
    def _cur(self) -> Token:
        return self.toks[self.i]

    def _peek(self, k: int = 1) -> Token:
        j = min(self.i + k, len(self.toks) - 1)
        return self.toks[j]

    def _advance(self) -> Token:
        t = self.toks[self.i]
        if t.kind != T_EOF:
            self.i += 1
        return t

    def _at_kw(self, *kws: str) -> bool:
        t = self._cur()
        return t.kind == T_IDENT and t.value.lower() in kws

    def _accept_kw(self, *kws: str) -> Optional[str]:
        if self._at_kw(*kws):
            return self._advance().value.lower()
        return None

    def _expect_kw(self, kw: str) -> None:
        if not self._accept_kw(kw):
            raise ParseError(f"expected {kw.upper()}, got {self._cur().text!r}",
                             self._cur().pos)

    def _at_op(self, *ops: str) -> bool:
        t = self._cur()
        return t.kind == T_OP and t.value in ops

    def _accept_op(self, *ops: str) -> Optional[str]:
        if self._at_op(*ops):
            return self._advance().value
        return None

    def _expect_op(self, op: str) -> None:
        if not self._accept_op(op):
            raise ParseError(f"expected {op!r}, got {self._cur().text!r}",
                             self._cur().pos)

    def _ident(self) -> str:
        t = self._cur()
        if t.kind in (T_IDENT, T_QIDENT):
            self._advance()
            return t.value
        raise ParseError(f"expected identifier, got {t.text!r}", t.pos)

    # ==== entry =============================================================
    def parse(self, sql: str) -> List[StmtNode]:
        self.sql = sql
        self.toks = tokenize(sql)
        self.i = 0
        stmts: List[StmtNode] = []
        while self._cur().kind != T_EOF:
            if self._accept_op(";"):
                continue
            start = self._cur().pos
            stmt = self._statement()
            end = self._cur().pos if self._cur().kind != T_EOF \
                else len(sql)
            # the statement's OWN source slice: digest normalization and
            # sampling must see it, not a batch-decorated display label
            stmt.src = sql[start:end].strip().rstrip(";").rstrip()
            stmts.append(stmt)
            if self._cur().kind != T_EOF:
                self._expect_op(";")
        return stmts

    def parse_one(self, sql: str) -> StmtNode:
        stmts = self.parse(sql)
        if len(stmts) != 1:
            raise ParseError(f"expected exactly one statement, got {len(stmts)}")
        return stmts[0]

    # ==== statements ========================================================
    def _statement(self) -> StmtNode:
        t = self._cur()
        if t.kind != T_IDENT and not (t.kind == T_OP and t.value == "("):
            raise ParseError(f"unexpected {t.text!r}", t.pos)
        kw = t.value.lower() if t.kind == T_IDENT else "("
        if kw in ("select", "("):
            return self._select_stmt()
        if kw == "insert":
            return self._insert_stmt(replace=False)
        if kw == "replace":
            return self._insert_stmt(replace=True)
        if kw == "delete":
            return self._delete_stmt()
        if kw == "update":
            return self._update_stmt()
        if kw == "create":
            return self._create_stmt()
        if kw == "drop":
            return self._drop_stmt()
        if kw == "alter":
            return self._alter_stmt()
        if kw == "truncate":
            self._advance()
            self._accept_kw("table")
            return TruncateTableStmt(self._table_name())
        if kw == "show":
            return self._show_stmt()
        if kw == "set":
            return self._set_stmt()
        if kw == "use":
            self._advance()
            return UseStmt(self._ident())
        if kw in ("begin", "start"):
            self._advance()
            if kw == "start":
                self._expect_kw("transaction")
            return BeginStmt()
        if kw == "commit":
            self._advance()
            return CommitStmt()
        if kw == "rollback":
            self._advance()
            return RollbackStmt()
        if kw in ("explain", "desc", "describe"):
            return self._explain_stmt()
        if kw == "trace":
            return self._trace_stmt()
        if kw == "analyze":
            self._advance()
            self._expect_kw("table")
            tables = [self._table_name()]
            while self._accept_op(","):
                tables.append(self._table_name())
            return AnalyzeTableStmt(tables)
        if kw == "admin":
            return self._admin_stmt()
        if kw == "kill":
            return self._kill_stmt()
        raise ParseError(f"unsupported statement {t.text!r}", t.pos)

    def _kill_stmt(self) -> KillStmt:
        """KILL [TIDB] [QUERY | CONNECTION] <conn_id> (reference:
        executor/simple.go executeKill + server kill dispatch)."""
        self._advance()
        self._accept_kw("tidb")
        query_only = self._accept_kw("query") is not None
        if not query_only:
            self._accept_kw("connection")
        return KillStmt(conn_id=self._uint_literal(), query_only=query_only)

    # ---- SELECT ------------------------------------------------------------
    def _select_stmt(self) -> SelectStmt:
        if self._at_op("("):
            # parenthesized select at statement level
            self._expect_op("(")
            s = self._select_stmt()
            self._expect_op(")")
            return s
        self._expect_kw("select")
        stmt = SelectStmt()
        if self._accept_kw("distinct"):
            stmt.distinct = True
        else:
            self._accept_kw("all")
        stmt.fields = self._select_fields()
        if self._accept_kw("from"):
            stmt.from_ = self._table_refs()
        if self._accept_kw("where"):
            stmt.where = self._expr()
        if self._at_kw("group"):
            self._advance()
            self._expect_kw("by")
            stmt.group_by.append(self._expr())
            while self._accept_op(","):
                stmt.group_by.append(self._expr())
        if self._accept_kw("having"):
            stmt.having = self._expr()
        if self._at_kw("order"):
            self._advance()
            self._expect_kw("by")
            stmt.order_by = self._order_items()
        if self._accept_kw("limit"):
            stmt.limit = self._limit_clause()
        return stmt

    def _select_fields(self) -> List[SelectField]:
        fields = []
        while True:
            start = self._cur().pos
            if self._at_op("*"):
                self._advance()
                fields.append(SelectField(None, is_wildcard=True))
            elif (self._cur().kind in (T_IDENT, T_QIDENT)
                  and self._peek().kind == T_OP and self._peek().value == "."
                  and self._peek(2).kind == T_OP and self._peek(2).value == "*"):
                tbl = self._ident()
                self._advance()  # .
                self._advance()  # *
                fields.append(SelectField(None, is_wildcard=True,
                                          wildcard_table=tbl))
            else:
                e = self._expr()
                as_name = ""
                if self._accept_kw("as"):
                    as_name = self._ident_or_string()
                elif (self._cur().kind in (T_IDENT, T_QIDENT)
                      and not self._at_kw(*_CLAUSE_KWS)):
                    as_name = self._ident()
                end = self._cur().pos
                fields.append(SelectField(e, as_name=as_name,
                                          text=self.sql[start:end].strip()))
            if not self._accept_op(","):
                return fields

    def _ident_or_string(self) -> str:
        t = self._cur()
        if t.kind == T_STRING:
            self._advance()
            return t.value
        return self._ident()

    def _order_items(self) -> List[Tuple[ExprNode, bool]]:
        out = []
        while True:
            e = self._expr()
            desc = False
            if self._accept_kw("desc"):
                desc = True
            else:
                self._accept_kw("asc")
            out.append((e, desc))
            if not self._accept_op(","):
                return out

    def _limit_clause(self) -> Tuple[int, int]:
        a = self._uint_literal()
        if self._accept_op(","):
            return a, self._uint_literal()
        if self._accept_kw("offset"):
            return self._uint_literal(), a
        return 0, a

    def _uint_literal(self) -> int:
        t = self._cur()
        if t.kind != T_INT or t.value < 0:
            raise ParseError(f"expected unsigned integer, got {t.text!r}", t.pos)
        self._advance()
        return t.value

    # ---- table refs (the course's JoinTable production) --------------------
    def _table_refs(self) -> Join:
        left = self._join_side()
        while True:
            if self._accept_op(","):
                right = self._join_side()
                left = Join(left, right, tp="cross")
                continue
            tp = None
            if self._at_kw("join", "inner", "cross"):
                w = self._advance().value.lower()
                if w in ("inner", "cross"):
                    self._expect_kw("join")
                tp = "inner" if w != "cross" else "cross"
            elif self._at_kw("left", "right"):
                w = self._advance().value.lower()
                self._accept_kw("outer")
                self._expect_kw("join")
                tp = w
            else:
                return left if isinstance(left, Join) else Join(left, None)
            right = self._join_side()
            j = Join(left, right, tp=tp)
            if self._accept_kw("on"):
                j.on = self._expr()
            elif self._accept_kw("using"):
                self._expect_op("(")
                j.using.append(self._ident())
                while self._accept_op(","):
                    j.using.append(self._ident())
                self._expect_op(")")
            elif tp in ("left", "right"):
                raise ParseError("outer join requires ON or USING",
                                 self._cur().pos)
            left = j

    def _join_side(self):
        if self._at_op("("):
            if (self._peek().kind == T_IDENT
                    and self._peek().value.lower() == "select"):
                self._advance()
                sub = self._select_stmt()
                self._expect_op(")")
                self._accept_kw("as")
                name = self._ident()
                return TableSource(sub, as_name=name)
            self._advance()
            inner = self._table_refs()
            self._expect_op(")")
            return inner
        tn = self._table_name()
        as_name = ""
        if self._accept_kw("as"):
            as_name = self._ident()
        elif (self._cur().kind in (T_IDENT, T_QIDENT)
              and not self._at_kw(*_TABLE_CLAUSE_KWS)):
            as_name = self._ident()
        return TableSource(tn, as_name=as_name)

    def _table_name(self) -> TableName:
        a = self._ident()
        if self._accept_op("."):
            return TableName(self._ident(), db=a)
        return TableName(a)

    # ---- INSERT / DELETE ---------------------------------------------------
    def _insert_stmt(self, replace: bool) -> InsertStmt:
        self._advance()  # insert | replace
        self._accept_kw("into")
        stmt = InsertStmt(is_replace=replace)
        stmt.table = self._table_name()
        if self._at_op("(") :
            # could be column list or values-select paren; column list only
            # if followed by idents then ')'
            save = self.i
            self._advance()
            try:
                cols = [self._ident()]
                while self._accept_op(","):
                    cols.append(self._ident())
                self._expect_op(")")
                stmt.columns = cols
            except ParseError:
                self.i = save
        if self._accept_kw("values", "value"):
            while True:
                self._expect_op("(")
                row: List[ExprNode] = []
                if not self._at_op(")"):
                    row.append(self._insert_value())
                    while self._accept_op(","):
                        row.append(self._insert_value())
                self._expect_op(")")
                stmt.lists.append(row)
                if not self._accept_op(","):
                    break
        elif self._at_kw("select") or self._at_op("("):
            stmt.select = self._select_stmt()
        else:
            raise ParseError("expected VALUES or SELECT", self._cur().pos)
        return stmt

    def _insert_value(self) -> ExprNode:
        if self._accept_kw("default"):
            return DefaultExpr()
        return self._expr()

    def _update_stmt(self) -> UpdateStmt:
        """UPDATE t [AS a] SET col = expr [, ...] [WHERE ...]."""
        self._advance()  # update
        tn = self._table_name()
        as_name = ""
        if self._accept_kw("as"):
            as_name = self._ident()
        elif (self._cur().kind in (T_IDENT, T_QIDENT)
              and not self._at_kw("set")):
            as_name = self._ident()
        self._expect_kw("set")
        stmt = UpdateStmt(TableSource(tn, as_name))
        while True:
            col = self._column_ref_only()
            if not self._accept_op("="):
                self._expect_op(":=")
            stmt.assignments.append(Assignment(col, self._expr()))
            if not self._accept_op(","):
                break
        if self._accept_kw("where"):
            stmt.where = self._expr()
        return stmt

    def _column_ref_only(self) -> ColumnRef:
        a = self._ident()
        if self._accept_op("."):
            b = self._ident()
            if self._accept_op("."):
                return ColumnRef(self._ident(), table=b, db=a)
            return ColumnRef(b, table=a)
        return ColumnRef(a)

    def _delete_stmt(self) -> DeleteStmt:
        self._advance()
        self._expect_kw("from")
        tn = self._table_name()
        as_name = ""
        if self._accept_kw("as"):
            as_name = self._ident()
        elif self._cur().kind in (T_IDENT, T_QIDENT) and not self._at_kw("where"):
            as_name = self._ident()
        stmt = DeleteStmt(TableSource(tn, as_name))
        if self._accept_kw("where"):
            stmt.where = self._expr()
        return stmt

    # ---- DDL ---------------------------------------------------------------
    def _create_stmt(self) -> StmtNode:
        self._advance()  # create
        if self._accept_kw("database", "schema"):
            ine = self._if_not_exists()
            return CreateDatabaseStmt(self._ident(), ine)
        if self._accept_kw("table"):
            return self._create_table()
        unique = bool(self._accept_kw("unique"))
        if self._accept_kw("index"):
            name = self._ident()
            self._expect_kw("on")
            tn = self._table_name()
            cols = self._index_col_list()
            return CreateIndexStmt(name, tn, cols, unique)
        raise ParseError("unsupported CREATE", self._cur().pos)

    def _if_not_exists(self) -> bool:
        if self._accept_kw("if"):
            self._expect_kw("not")
            self._expect_kw("exists")
            return True
        return False

    def _if_exists(self) -> bool:
        if self._accept_kw("if"):
            self._expect_kw("exists")
            return True
        return False

    def _create_table(self) -> CreateTableStmt:
        ine = self._if_not_exists()
        tn = self._table_name()
        stmt = CreateTableStmt(tn, if_not_exists=ine)
        self._expect_op("(")
        while True:
            if self._at_kw("primary"):
                self._advance()
                self._expect_kw("key")
                stmt.constraints.append(
                    Constraint("primary", columns=self._index_col_list()))
            elif self._at_kw("unique"):
                self._advance()
                self._accept_kw("key", "index")
                name = ""
                if self._cur().kind in (T_IDENT, T_QIDENT) and not self._at_op("("):
                    name = self._ident()
                stmt.constraints.append(
                    Constraint("unique", name, self._index_col_list()))
            elif self._at_kw("index", "key"):
                self._advance()
                name = ""
                if self._cur().kind in (T_IDENT, T_QIDENT) and not self._at_op("("):
                    name = self._ident()
                stmt.constraints.append(
                    Constraint("index", name, self._index_col_list()))
            else:
                stmt.cols.append(self._column_def())
            if not self._accept_op(","):
                break
        self._expect_op(")")
        # swallow table options (ENGINE=, CHARSET=, ...) permissively
        while self._cur().kind == T_IDENT and not self._at_op(";"):
            self._advance()
            self._accept_op("=")
            if self._cur().kind in (T_IDENT, T_QIDENT, T_INT, T_STRING):
                self._advance()
        return stmt

    def _column_def(self) -> ColumnDef:
        name = self._ident()
        ft = self._field_type()
        col = ColumnDef(name, ft)
        while True:
            if self._accept_kw("not"):
                self._expect_kw("null")
                col.options.append(ColumnOption("not_null"))
            elif self._accept_kw("null"):
                col.options.append(ColumnOption("null"))
            elif self._at_kw("primary"):
                self._advance()
                self._expect_kw("key")
                col.options.append(ColumnOption("primary"))
            elif self._accept_kw("unique"):
                self._accept_kw("key")
                col.options.append(ColumnOption("unique"))
            elif self._accept_kw("auto_increment"):
                col.options.append(ColumnOption("auto_increment"))
            elif self._accept_kw("default"):
                v = self._signed_literal()
                col.options.append(ColumnOption("default", v))
            elif self._accept_kw("comment"):
                self._advance()  # string
            else:
                return col

    def _signed_literal(self):
        neg = False
        if self._accept_op("-"):
            neg = True
        t = self._cur()
        if t.kind in (T_INT, T_FLOAT, T_STRING):
            self._advance()
            return -t.value if neg and t.kind != T_STRING else t.value
        if self._accept_kw("null"):
            return None
        if self._accept_kw("true"):
            return 1
        if self._accept_kw("false"):
            return 0
        raise ParseError(f"expected literal, got {t.text!r}", t.pos)

    def _field_type(self) -> FieldType:
        w = self._ident().lower()
        flen = -1
        if self._accept_op("("):
            flen = self._uint_literal()
            self._accept_op(",") and self._uint_literal()  # ignore decimals
            self._expect_op(")")
        ft: FieldType
        if w in ("int", "integer", "mediumint"):
            ft = FieldType(TYPE_LONG, flen=11)
        elif w in ("bigint",):
            ft = FieldType(TYPE_LONGLONG, flen=20)
        elif w in ("smallint", "tinyint", "bool", "boolean"):
            ft = FieldType(TYPE_LONG, flen=6)
        elif w in ("float", "real"):
            ft = FieldType(TYPE_FLOAT, flen=12)
        elif w in ("double", "decimal", "numeric"):
            # no DECIMAL family in the engine (reference has none either,
            # SURVEY §2.9); map to double like tinysql's tests do
            if w == "double":
                self._accept_kw("precision")
            ft = FieldType(TYPE_DOUBLE, flen=22)
        elif w in ("varchar", "text", "longtext", "mediumtext"):
            ft = FieldType(TYPE_VARCHAR, flen=flen)
        elif w in ("char",):
            ft = FieldType(TYPE_STRING, flen=flen if flen >= 0 else 1)
        else:
            raise ParseError(f"unsupported column type {w!r}", self._cur().pos)
        if flen >= 0 and w not in ("varchar", "char", "text"):
            ft.flen = flen
        if self._accept_kw("unsigned"):
            ft.flag |= FLAG_UNSIGNED
        self._accept_kw("signed")
        if self._accept_kw("zerofill"):
            pass
        # charset/collate noise
        if self._accept_kw("character"):
            self._expect_kw("set")
            self._ident()
        if self._accept_kw("charset"):
            self._ident()
        if self._accept_kw("collate"):
            self._ident()
        return ft

    def _index_col_list(self) -> List[Tuple[str, int]]:
        self._expect_op("(")
        cols = [self._index_col()]
        while self._accept_op(","):
            cols.append(self._index_col())
        self._expect_op(")")
        return cols

    def _index_col(self) -> Tuple[str, int]:
        name = self._ident()
        ln = -1
        if self._accept_op("("):
            ln = self._uint_literal()
            self._expect_op(")")
        return name, ln

    def _drop_stmt(self) -> StmtNode:
        self._advance()  # drop
        if self._accept_kw("database", "schema"):
            ie = self._if_exists()
            return DropDatabaseStmt(self._ident(), ie)
        if self._accept_kw("table"):
            ie = self._if_exists()
            tables = [self._table_name()]
            while self._accept_op(","):
                tables.append(self._table_name())
            return DropTableStmt(tables, ie)
        if self._accept_kw("index"):
            name = self._ident()
            self._expect_kw("on")
            return DropIndexStmt(name, self._table_name())
        raise ParseError("unsupported DROP", self._cur().pos)

    def _alter_stmt(self) -> AlterTableStmt:
        self._advance()
        self._expect_kw("table")
        stmt = AlterTableStmt(self._table_name())
        while True:
            if self._accept_kw("add"):
                if self._accept_kw("index", "key"):
                    name = ""
                    if self._cur().kind in (T_IDENT, T_QIDENT) and not self._at_op("("):
                        name = self._ident()
                    stmt.specs.append(AlterTableSpec(
                        "add_index",
                        constraint=Constraint("index", name, self._index_col_list())))
                elif self._accept_kw("unique"):
                    self._accept_kw("key", "index")
                    name = ""
                    if self._cur().kind in (T_IDENT, T_QIDENT) and not self._at_op("("):
                        name = self._ident()
                    stmt.specs.append(AlterTableSpec(
                        "add_index",
                        constraint=Constraint("unique", name, self._index_col_list())))
                else:
                    self._accept_kw("column")
                    stmt.specs.append(AlterTableSpec(
                        "add_column", column=self._column_def()))
            elif self._accept_kw("drop"):
                if self._accept_kw("index", "key"):
                    stmt.specs.append(AlterTableSpec("drop_index",
                                                     name=self._ident()))
                else:
                    self._accept_kw("column")
                    stmt.specs.append(AlterTableSpec("drop_column",
                                                     name=self._ident()))
            else:
                raise ParseError("unsupported ALTER TABLE action",
                                 self._cur().pos)
            if not self._accept_op(","):
                return stmt

    # ---- SHOW / SET / EXPLAIN / ADMIN --------------------------------------
    def _show_stmt(self) -> ShowStmt:
        self._advance()
        full = bool(self._accept_kw("full"))
        glob = bool(self._accept_kw("global"))
        self._accept_kw("session")
        if self._accept_kw("databases", "schemas"):
            stmt = ShowStmt("databases")
        elif self._accept_kw("tables"):
            stmt = ShowStmt("tables")
            if self._accept_kw("from", "in"):
                stmt.db = self._ident()
        elif self._accept_kw("columns", "fields"):
            self._expect_kw("from")
            stmt = ShowStmt("columns", table=self._table_name())
            if self._accept_kw("from", "in"):
                stmt.db = self._ident()
        elif self._accept_kw("create"):
            if self._accept_kw("database", "schema"):
                stmt = ShowStmt("create_database")
                stmt.db = self._ident()
            else:
                self._expect_kw("table")
                stmt = ShowStmt("create_table", table=self._table_name())
        elif self._accept_kw("index", "indexes", "keys"):
            self._expect_kw("from")
            stmt = ShowStmt("indexes", table=self._table_name())
        elif self._accept_kw("variables"):
            stmt = ShowStmt("variables", global_scope=glob)
        elif self._accept_kw("processlist"):
            stmt = ShowStmt("processlist")
        elif self._accept_kw("warnings"):
            stmt = ShowStmt("warnings")
        elif self._accept_kw("errors"):
            stmt = ShowStmt("errors")
        else:
            raise ParseError("unsupported SHOW", self._cur().pos)
        stmt.full = full
        # LIKE/WHERE tails only on the list-producing kinds (MySQL
        # rejects e.g. SHOW WARNINGS LIKE ...)
        if stmt.tp in ("databases", "tables", "columns", "indexes",
                       "variables"):
            if self._accept_kw("like"):
                t = self._cur()
                if t.kind != T_STRING:
                    raise ParseError("expected pattern string", t.pos)
                self._advance()
                stmt.pattern = t.value
            elif self._accept_kw("where"):
                stmt.where = self._expr()
        return stmt

    def _set_stmt(self) -> SetStmt:
        self._advance()
        stmt = SetStmt()
        while True:
            scope = ""
            t = self._cur()
            if t.kind == T_SYSVAR:
                self._advance()
                name = t.value
                if name.startswith("global."):
                    scope, name = "global", name[7:]
                elif name.startswith("session."):
                    scope, name = "session", name[8:]
                else:
                    scope = "session"
            elif t.kind == T_USERVAR:
                self._advance()
                scope, name = "user", t.value
            elif self._accept_kw("global"):
                scope, name = "global", self._ident().lower()
            elif self._accept_kw("session"):
                scope, name = "session", self._ident().lower()
            elif self._accept_kw("names"):
                # SET NAMES utf8: accept & ignore (charset fixed)
                self._ident_or_string()
                if not self._accept_op(","):
                    return stmt
                continue
            else:
                scope, name = "session", self._ident().lower()
            if not self._accept_op("="):
                self._expect_op(":=")
            value = self._expr()
            stmt.assignments.append((scope, name, value))
            if not self._accept_op(","):
                return stmt

    def _explain_stmt(self) -> StmtNode:
        kw = self._advance().value.lower()
        if kw in ("desc", "describe") and self._cur().kind in (T_IDENT, T_QIDENT) \
                and not self._at_kw("select", "insert", "delete", "replace", "analyze"):
            # DESC t == SHOW COLUMNS FROM t
            return ShowStmt("columns", table=self._table_name())
        analyze = bool(self._accept_kw("analyze"))
        if not analyze and self._accept_kw("for"):
            # EXPLAIN FOR CONNECTION <id> (reference: common_plans.go
            # ExplainFor — the plan of whatever the target conn ran last)
            self._expect_kw("connection")
            return ExplainStmt(None, for_conn=self._uint_literal())
        return ExplainStmt(self._statement(), analyze=analyze)

    def _trace_stmt(self) -> TraceStmt:
        """TRACE [FORMAT = 'row'] <statement> (reference: TiDB's
        executor/trace.go — execute the statement and return its span
        tree as rows).  Only the 'row' format is supported."""
        self._advance()
        fmt = "row"
        if self._accept_kw("format"):
            self._expect_op("=")
            t = self._cur()
            if t.kind != T_STRING:
                raise ParseError("TRACE FORMAT expects a string literal",
                                 t.pos)
            fmt = str(t.value).lower()
            self._advance()
            if fmt != "row":
                raise ParseError(f"unsupported TRACE format {fmt!r}",
                                 t.pos)
        return TraceStmt(self._statement(), format=fmt)

    def _admin_stmt(self) -> AdminStmt:
        self._advance()
        if self._accept_kw("show"):
            self._expect_kw("ddl")
            if self._accept_kw("jobs"):
                return AdminStmt("show_ddl_jobs")
            return AdminStmt("show_ddl")
        if self._accept_kw("check"):
            self._expect_kw("table")
            tables = [self._table_name()]
            while self._accept_op(","):
                tables.append(self._table_name())
            return AdminStmt("check_table", tables)
        raise ParseError("unsupported ADMIN", self._cur().pos)

    # ==== expressions (Pratt) ==============================================
    def _expr(self) -> ExprNode:
        return self._or_expr()

    def _or_expr(self) -> ExprNode:
        left = self._xor_expr()
        while self._at_kw("or") or self._at_op("||"):
            self._advance()
            left = BinaryOp("or", left, self._xor_expr())
        return left

    def _xor_expr(self) -> ExprNode:
        left = self._and_expr()
        while self._at_kw("xor"):
            self._advance()
            left = BinaryOp("xor", left, self._and_expr())
        return left

    def _and_expr(self) -> ExprNode:
        left = self._not_expr()
        while self._at_kw("and") or self._at_op("&&"):
            self._advance()
            left = BinaryOp("and", left, self._not_expr())
        return left

    def _not_expr(self) -> ExprNode:
        if self._accept_kw("not"):
            return UnaryOp("not", self._not_expr())
        return self._predicate()

    def _predicate(self) -> ExprNode:
        left = self._additive()
        while True:
            if self._at_op(*_CMP_OPS):
                op = self._advance().value
                if op == "<>":
                    op = "!="
                left = BinaryOp(op, left, self._additive())
                continue
            if self._at_kw("is"):
                self._advance()
                neg = bool(self._accept_kw("not"))
                if self._accept_kw("null"):
                    left = IsNullExpr(left, neg)
                elif self._accept_kw("true"):
                    left = IsTruthExpr(left, True, neg)
                elif self._accept_kw("false"):
                    left = IsTruthExpr(left, False, neg)
                else:
                    raise ParseError("expected NULL/TRUE/FALSE after IS",
                                     self._cur().pos)
                continue
            neg = False
            save = self.i
            if self._accept_kw("not"):
                neg = True
            if self._accept_kw("like"):
                left = LikeExpr(left, self._additive(), neg)
                if self._accept_kw("escape"):
                    t = self._cur()
                    if t.kind != T_STRING:
                        raise ParseError("expected escape string", t.pos)
                    self._advance()
                    left.escape = t.value or "\\"
                continue
            if self._accept_kw("in"):
                self._expect_op("(")
                if self._at_kw("select"):
                    # IN (subquery): the single item is a SubqueryExpr —
                    # the planner decorrelates it into a semi/anti join
                    sub = self._select_stmt()
                    self._expect_op(")")
                    left = InExpr(left, [SubqueryExpr(sub)], neg)
                    continue
                items = [self._expr()]
                while self._accept_op(","):
                    items.append(self._expr())
                self._expect_op(")")
                left = InExpr(left, items, neg)
                continue
            if self._accept_kw("between"):
                lo = self._additive()
                self._expect_kw("and")
                hi = self._additive()
                left = BetweenExpr(left, lo, hi, neg)
                continue
            if neg:
                self.i = save
            return left

    def _additive(self) -> ExprNode:
        left = self._multiplicative()
        while self._at_op("+", "-"):
            op = self._advance().value
            left = BinaryOp(op, left, self._multiplicative())
        return left

    def _multiplicative(self) -> ExprNode:
        left = self._unary()
        while True:
            if self._at_op("*", "/", "%"):
                op = self._advance().value
                left = BinaryOp(op, left, self._unary())
            elif self._at_kw("div"):
                self._advance()
                left = BinaryOp("div", left, self._unary())
            elif self._at_kw("mod"):
                self._advance()
                left = BinaryOp("%", left, self._unary())
            else:
                return left

    def _unary(self) -> ExprNode:
        if self._at_op("-", "+", "!", "~"):
            op = self._advance().value
            operand = self._unary()
            if op == "+":
                return operand
            if op == "!":
                return UnaryOp("not", operand)
            # constant-fold negative literals so -9223372036854775808 parses
            if op == "-" and isinstance(operand, Literal) \
                    and isinstance(operand.value, (int, float)) \
                    and not isinstance(operand.value, bool):
                return Literal(-operand.value)
            return UnaryOp(op, operand)
        return self._primary()

    def _primary(self) -> ExprNode:
        t = self._cur()
        if t.kind == T_INT or t.kind == T_FLOAT or t.kind == T_STRING:
            self._advance()
            return Literal(t.value)
        if t.kind == T_SYSVAR:
            self._advance()
            name, scope = t.value, ""
            if name.startswith("global."):
                scope, name = "global", name[7:]
            elif name.startswith("session."):
                scope, name = "session", name[8:]
            return VariableExpr(name, is_system=True, scope=scope)
        if t.kind == T_USERVAR:
            self._advance()
            return VariableExpr(t.value, is_system=False)
        if self._at_op("("):
            if (self._peek().kind == T_IDENT
                    and self._peek().value.lower() == "select"):
                # scalar subquery: (SELECT ...) as an expression operand
                self._advance()
                sub = self._select_stmt()
                self._expect_op(")")
                return SubqueryExpr(sub)
            self._advance()
            e = self._expr()
            if self._at_op(","):
                items = [e]
                while self._accept_op(","):
                    items.append(self._expr())
                self._expect_op(")")
                return RowExpr(items)
            self._expect_op(")")
            return ParenExpr(e)
        if t.kind in (T_IDENT, T_QIDENT):
            word = t.value.lower() if t.kind == T_IDENT else None
            if word in RESERVED_NON_EXPR:
                # LEFT( / RIGHT( / REPLACE( are function CALLS despite the
                # words being reserved for joins/statements (MySQL allows
                # them when directly followed by a parenthesis)
                nxt = self._peek(1)
                if word == "exists" and nxt.kind == T_OP \
                        and nxt.value == "(":
                    # EXISTS (SELECT ...); NOT EXISTS arrives via the
                    # generic NOT operator and is normalized by the
                    # planner's decorrelation pass
                    self._advance()  # exists
                    self._expect_op("(")
                    if not self._at_kw("select"):
                        raise ParseError("expected SELECT after EXISTS (",
                                         self._cur().pos)
                    sub = self._select_stmt()
                    self._expect_op(")")
                    return ExistsExpr(sub)
                if word in ("left", "right", "replace") \
                        and nxt.kind == T_OP and nxt.value == "(":
                    return self._func_call()
                raise ParseError(f"unexpected keyword {t.text!r} in expression",
                                 t.pos)
            if word == "null":
                self._advance()
                return Literal(None)
            if word == "true":
                self._advance()
                return Literal(1)
            if word == "false":
                self._advance()
                return Literal(0)
            if word == "case":
                return self._case_expr()
            if word == "row" and self._peek().kind == T_OP and self._peek().value == "(":
                self._advance()
                self._expect_op("(")
                items = [self._expr()]
                while self._accept_op(","):
                    items.append(self._expr())
                self._expect_op(")")
                return RowExpr(items)
            # function call?
            if self._peek().kind == T_OP and self._peek().value == "(" \
                    and t.kind == T_IDENT:
                return self._func_call()
            # column ref: a | t.a | db.t.a
            a = self._ident()
            if self._accept_op("."):
                b = self._ident()
                if self._accept_op("."):
                    return ColumnRef(self._ident(), table=b, db=a)
                return ColumnRef(b, table=a)
            return ColumnRef(a)
        raise ParseError(f"unexpected token {t.text!r} in expression", t.pos)

    def _func_call(self) -> ExprNode:
        name = self._ident().lower()
        self._expect_op("(")
        if name in AGG_FUNCS:
            distinct = bool(self._accept_kw("distinct"))
            if name == "count" and self._at_op("*"):
                self._advance()
                self._expect_op(")")
                return AggFunc("count", [Literal(1)], distinct=False)
            args = [self._expr()]
            while self._accept_op(","):
                args.append(self._expr())
            self._expect_op(")")
            return AggFunc(name, args, distinct)
        args = []
        if not self._at_op(")"):
            args.append(self._expr())
            while self._accept_op(","):
                args.append(self._expr())
        self._expect_op(")")
        return FuncCall(name, args)

    def _case_expr(self) -> CaseExpr:
        self._advance()  # case
        operand = None
        if not self._at_kw("when"):
            operand = self._expr()
        cases = []
        while self._accept_kw("when"):
            cond = self._expr()
            self._expect_kw("then")
            cases.append((cond, self._expr()))
        els = None
        if self._accept_kw("else"):
            els = self._expr()
        self._expect_kw("end")
        if not cases:
            raise ParseError("CASE requires at least one WHEN", self._cur().pos)
        return CaseExpr(operand, cases, els)


# MySQL reserved words that can never appear bare as a column reference
# (reference: parser/misc.go tokenMap reserved section, trimmed to this
# grammar's keyword set)
RESERVED_NON_EXPR = frozenset("""
    select from where group having order limit insert update delete replace
    create drop alter table index join inner left right cross on using and
    or xor not like in between is when then else as by asc desc distinct
    values set into union for default primary unique references exists
    """.split())

_CLAUSE_KWS = ("from", "where", "group", "having", "order", "limit", "as",
               "union", "for", "into", "on", "using", "join", "inner", "left",
               "right", "cross", "when", "then", "else", "end", "and", "or",
               "xor", "not", "desc", "asc", "offset")
_TABLE_CLAUSE_KWS = _CLAUSE_KWS + ("set", "values")


def parse(sql: str) -> List[StmtNode]:
    return Parser().parse(sql)


def parse_one(sql: str) -> StmtNode:
    return Parser().parse_one(sql)
