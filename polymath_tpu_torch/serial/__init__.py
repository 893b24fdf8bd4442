"""arkworks-compatible serialization codecs."""
from . import codec
