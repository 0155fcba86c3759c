"""SQL front end (reference: parser/)."""
from .lexer import ParseError, tokenize
from .parser import Parser, parse, parse_one
from . import astnodes as ast

__all__ = ["ParseError", "tokenize", "Parser", "parse", "parse_one", "ast"]
