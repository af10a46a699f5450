"""Fail-fast error handling (reference: src/utils/fatal.h, fatal.cc).

All error paths print to stderr and exit(1); there is no recovery, no
retries, matching the reference's fail-fast semantics.
"""

import sys

ERROR_PREFIX = "\nError: "


class FatalError(SystemExit):
    """Raised on any fatal condition; carries the full message text."""

    def __init__(self, message: str):
        self.message = message
        super().__init__(1)


UINT8_MAX_CHAR = "\xff"  # reference streams uint8_t through iostream as a char


def fatal(*args) -> "NoReturn":  # noqa: F821
    """Print all arguments to stderr followed by a newline and exit(1).

    Byte-transparent: non-ASCII header bytes and the reference's
    uint8_t-as-char quirk are written verbatim (latin-1)."""
    message = "".join(str(arg) for arg in args) + "\n"
    sys.stderr.flush()
    sys.stderr.buffer.write(message.encode("latin-1", errors="replace"))
    sys.stderr.buffer.flush()
    raise FatalError(message)
