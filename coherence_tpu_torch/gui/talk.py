"""TCP transport for the GUI wire protocol (parity: reference ``pytalk.ml``
and ``mltalk.py``).

The engine side binds localhost TCP starting at port 50000, retrying upward
on failure, then either spawns the display client or — when the display
starts first ("findport" mode) — writes the negotiated port to a `findport`
file the client reads (pytalk.ml:52-111, mltalk.py:119-140).  ``poll``
buffers bytes and unmarshalls complete frames into an event queue; ``send``
loops until the frame is fully written.

The port's copy of ``coherence_tpu.gui.talk``, unchanged (TCP_NODELAY and
the findport handshake included).
"""

from __future__ import annotations

import os
import socket
import subprocess
from collections import deque
from typing import Optional, Tuple

from . import wire

BASE_PORT = 50000


class Connection:
    def __init__(self, sock: socket.socket):
        self.sock = sock
        # The protocol is many small request/reply frames (events, synch
        # RPCs, paint rects); Nagle + delayed-ACK turns each into a ~40 ms
        # round trip even on loopback.  The reference never noticed (wx
        # events are human-rate); an interactive latency benchmark does.
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # non-TCP test doubles (socketpairs) lack the option
        self.buf = b""
        self.queue: deque = deque()

    def send(self, value) -> None:
        data = wire.marshall(value)
        self.sock.sendall(data)

    def poll(self, block: bool = True):
        """Next frame (blocking), buffering partial reads (pytalk.ml:19-38)."""
        while True:
            if self.queue:
                return self.queue.popleft()
            got = wire.unmarshall(self.buf)
            if got is not None:
                n, v = got
                self.buf = self.buf[n:]
                self.queue.append(v)
                continue
            if not block:
                self.sock.setblocking(False)
                try:
                    chunk = self.sock.recv(65536)
                except BlockingIOError:
                    return None
                finally:
                    self.sock.setblocking(True)
            else:
                chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("peer closed")
            self.buf += chunk

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def _bind_retrying(start_port: int = BASE_PORT, tries: int = 100):
    for port in range(start_port, start_port + tries):
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("127.0.0.1", port))
            s.listen(1)
            return s, port
        except OSError:
            s.close()
    raise OSError("no free port")


def establish_connection(
    command: Optional[str] = None,
    args: Tuple[str, ...] = (),
    findport_file: Optional[str] = None,
) -> Connection:
    """Listen, then spawn the display client (or write the findport file for
    a client started first), and accept (pytalk.ml:52-111)."""
    server, port = _bind_retrying()
    proc = None
    if command is not None:
        proc = subprocess.Popen([command, *args, str(port)])
    elif findport_file is not None:
        with open(findport_file, "w") as f:
            f.write(str(port))
    conn, _ = server.accept()
    server.close()
    c = Connection(conn)
    c.process = proc
    return c


def connect(port: int) -> Connection:
    """Client side: connect to the engine (mltalk.py:28-46)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.connect(("127.0.0.1", port))
    return Connection(s)


def connect_findport(findport_file: str = "findport", timeout_s: float = 30.0) -> Connection:
    """Client started first: wait for the engine to write the port file
    (mltalk.py:119-140)."""
    import time

    t0 = time.time()
    while time.time() - t0 < timeout_s:
        if os.path.exists(findport_file):
            with open(findport_file) as f:
                txt = f.read().strip()
            if txt:
                os.unlink(findport_file)
                return connect(int(txt))
        time.sleep(0.05)
    raise TimeoutError("findport file never appeared")
