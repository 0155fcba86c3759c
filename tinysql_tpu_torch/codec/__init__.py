"""Key/row codecs (reference: util/codec, tablecodec, util/rowcodec)."""
from . import keycodec, tablecodec, rowcodec

__all__ = ["keycodec", "tablecodec", "rowcodec"]
