"""Localhost TCP plumbing for tests of the serving surface.

A connected pair of sockets, a HeadlessClient driven from the test's own
thread, and a thread whose exception is kept.  Nothing here imports either
package: a *side* is any namespace with the ``talk`` and ``client`` modules
of one package, so the tests that run without JAX use it too.
``RecordingSocket`` wraps the server's end and keeps every byte the server
wrote, so that two packages' streams can be compared.
"""

import socket
import threading
import time
import zlib

import numpy as np

DEADLINE = 600.0  # seconds any wait in these tests may take (the JAX side compiles as it goes)


class RecordingSocket:
    """A socket that keeps what was written to it."""

    def __init__(self, sock):
        self._sock = sock
        self.sent = bytearray()

    def sendall(self, data):
        self.sent += data
        return self._sock.sendall(data)

    def __getattr__(self, name):
        return getattr(self._sock, name)


def socket_pair(server_side, client_side, record=False):
    """A connected (server Connection, client Connection) over localhost
    TCP, each made by its side's ``talk``; with record=True the server's
    socket is a RecordingSocket (``conn.sock.sent``)."""
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    port = listener.getsockname()[1]
    got = {}

    def accept():
        got["sock"], _ = listener.accept()

    t = threading.Thread(target=accept)
    t.start()
    client_conn = client_side.talk.connect(port)
    t.join(DEADLINE)
    listener.close()
    sock = RecordingSocket(got["sock"]) if record else got["sock"]
    for conn_sock in (got["sock"], client_conn.sock):
        conn_sock.settimeout(DEADLINE)
    return server_side.talk.Connection(sock), client_conn


class ServedClient:
    """A HeadlessClient of `side` driven from the test's own thread: every
    wait serves the server's calls until the wanted number of RefreshWindow
    frames has landed."""

    def __init__(self, side, conn):
        outer = self

        class _Client(side.client.HeadlessClient):
            def _on_refresh(self, w):
                outer.refreshes += 1

        self.c = _Client(conn)
        self.refreshes = 0

    def await_refresh(self, n: int = 1):
        target = self.refreshes + n
        while self.refreshes < target:
            if not self.c.handle_one():
                raise RuntimeError("the server closed the session")

    def drain(self):
        self.c.pump()

    def barrier(self, win):
        """Every earlier event is handled once this 2x2 paint has come back."""
        self.c.paint(win, 0, 0, 2, 2)
        self.await_refresh()
        self.drain()

    def finish(self):
        self.c.send_event("AppClose")
        while self.c.running and self.c.handle_one():
            pass


def in_thread(fn, *args):
    """Run fn(*args) in a thread; returns (thread, failures): an exception
    lands in the list instead of vanishing with the thread."""
    fail = []

    def body():
        try:
            fn(*args)
        except BaseException as e:  # noqa: BLE001 — surfaced by the test's thread
            fail.append(e)

    t = threading.Thread(target=body, daemon=True)
    t.start()
    return t, fail


def wait_for(holder: dict, key: str, fail: list):
    """holder[key], once the other thread has put it there (a constructor
    that ships its first frame returns after the client has it)."""
    deadline = time.monotonic() + DEADLINE
    while key not in holder:
        if fail:
            raise fail[0]
        if time.monotonic() > deadline:
            raise TimeoutError(f"{key} never appeared")
        time.sleep(0.005)
    return holder[key]


def crc(arr) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())
