"""Native (C++) host pieces of the port, bound with ctypes: the capture
reader's prefetch ring buffer and the packed-wire quantizer."""
from .reader import CaptureReader, native_available  # noqa: F401
