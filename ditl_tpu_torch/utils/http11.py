"""HTTP/1.1 keep-alive for the stdlib request handler, cooperating with the
server's drain lifecycle (a copy of the JAX package's ``utils/http11.py``).

- While a connection is *parked* (the handler thread blocked reading the next
  request line), the mixin reports it to the server (``note_parked``) so a
  drain can sever exactly the idle connections.
- Once the server drains, every response closes its connection.
"""

from __future__ import annotations

__all__ = ["KeepAliveHandlerMixin"]


class KeepAliveHandlerMixin:
    """Mix into a ``BaseHTTPRequestHandler`` subclass (first in the MRO).
    Every response must send ``Content-Length`` or ``Connection: close``."""

    protocol_version = "HTTP/1.1"
    # Headers and body go out as separate small writes; without TCP_NODELAY
    # the second waits for the peer's delayed ACK on a kept-alive socket.
    disable_nagle_algorithm = True
    # Idle cap: a silent peer would otherwise pin a handler thread forever.
    timeout = 120.0

    def handle_one_request(self):
        note = getattr(self.server, "note_parked", None)
        if note is not None:
            note(self.connection, True)
        try:
            super().handle_one_request()
        finally:
            if note is not None:
                note(self.connection, False)
            if getattr(self.server, "draining", False):
                self.close_connection = True

    def parse_request(self):
        note = getattr(self.server, "note_parked", None)
        if note is not None:
            note(self.connection, False)
        return super().parse_request()
