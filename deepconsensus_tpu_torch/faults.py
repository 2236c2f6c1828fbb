"""Typed input faults raised by the port's decoders.

Only the exception classes that the copied host modules raise are
carried over from the reference package's fault taxonomy; the
quarantine, dead-letter and injection machinery is not part of the
port's serial runner.
"""
from __future__ import annotations

from typing import Optional


class CorruptInputError(IOError):
  """Untrusted input bytes failed decode-layer validation.

  Carries machine-readable context so callers can report file, byte
  offset and ZMW without parsing the message:

  * path:   the input file
  * offset: byte offset of the bad frame (decompressed-stream offset
            for BGZF-compressed inputs, raw file offset otherwise)
  * zmw:    per-molecule context when known (read name / ZMW)
  * recoverable: True when the stream is positioned past the damaged
            record so the caller may keep reading; False when the
            stream cannot be advanced.
  """

  def __init__(self, message: str, *, path: Optional[str] = None,
               offset: Optional[int] = None, zmw: Optional[str] = None,
               recoverable: bool = False):
    context = [
        f'file={path}' if path else None,
        f'offset={offset}' if offset is not None else None,
        f'zmw={zmw}' if zmw else None,
    ]
    context = [c for c in context if c]
    super().__init__(
        f'{message} [{" ".join(context)}]' if context else message)
    self.path = path
    self.offset = offset
    self.zmw = zmw
    self.recoverable = recoverable


class WindowBucketError(ValueError):
  """A window's width is not one the model was configured for."""
