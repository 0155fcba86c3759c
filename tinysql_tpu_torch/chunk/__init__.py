"""Columnar memory (reference: util/chunk)."""
from .column import Column, DeviceColumn
from .chunk import Chunk, INIT_CHUNK_SIZE, MAX_CHUNK_SIZE, new_chunk_like, chunk_from_rows
from .codec import encode_chunk, decode_chunk, encode_column, decode_column

__all__ = [
    "Column", "DeviceColumn", "Chunk", "INIT_CHUNK_SIZE", "MAX_CHUNK_SIZE",
    "new_chunk_like", "chunk_from_rows",
    "encode_chunk", "decode_chunk", "encode_column", "decode_column",
]
