"""Host-side control-plane networking: framed messages over TCP.

A copy of ``distkeras_tpu/parallel/networking.py`` (:42-188), which
imports no JAX; the port keeps its own so it imports nothing of the JAX
package. It carries the socket transport of the host parameter server
(``parameter_servers``, ``async_host``): every frame is a magic, a
format byte and a length, then the payload; numpy arrays ship as raw
``.npy`` buffers under the ``NPY`` tag, anything else is pickled
(trusted-cluster assumption, as in the reference dist-keras).

The JAX module's ``determine_host_address`` (a UDP socket pointed at a
public address to read the route's source address) is not copied: the
port's servers bind localhost unless given a host.
"""

from __future__ import annotations

import io
import pickle
import socket
import struct
import threading
import time
from typing import Any, Callable, Optional, Tuple

import numpy as np

MAGIC = b"DKT1"
_FMT_PICKLE = 0
_FMT_NPY = 1
_HEADER = struct.Struct("!4sBQ")  # magic, format, payload length


def connect(host: str, port: int, timeout: Optional[float] = None
            ) -> socket.socket:
    """TCP connect with Nagle disabled: control messages are small and
    latency-bound."""
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


def _encode(obj: Any) -> Tuple[int, bytes]:
    if isinstance(obj, np.ndarray) and obj.dtype != object:
        buf = io.BytesIO()
        np.save(buf, obj, allow_pickle=False)
        return _FMT_NPY, buf.getvalue()
    return _FMT_PICKLE, pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def send_data(sock: socket.socket, obj: Any) -> None:
    """Write one framed message."""
    fmt, payload = _encode(obj)
    sock.sendall(_HEADER.pack(MAGIC, fmt, len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("socket closed mid-frame")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def recv_data(sock: socket.socket) -> Any:
    """Read one framed message; a wrong magic raises ``ValueError``."""
    magic, fmt, length = _HEADER.unpack(_recv_exact(sock, _HEADER.size))
    if magic != MAGIC:
        raise ValueError(f"bad frame magic {magic!r}")
    payload = _recv_exact(sock, length)
    if fmt == _FMT_NPY:
        return np.load(io.BytesIO(payload), allow_pickle=False)
    return pickle.loads(payload)


class MessageServer:
    """Threaded request/response server over framed messages: an accept
    loop and one handler thread per connection. ``handler(msg) ->
    reply`` runs under no lock (handlers synchronize themselves); a
    handler exception becomes an ``{"error": ...}`` reply instead of
    killing the connection, and a bad frame drops that connection only.

    SECURITY: the payload format includes pickle, so a connected peer can
    execute code in this process. The default bind is therefore
    localhost; pass another ``host`` only on a trusted network.
    """

    def __init__(self, handler: Callable[[Any], Any],
                 host: str = "127.0.0.1", port: int = 0):
        self._handler = handler
        self._host, self._port = host, port
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._running = False

    @property
    def port(self) -> int:
        if self._listener is None:
            raise RuntimeError("server not started")
        return self._listener.getsockname()[1]

    def start(self) -> "MessageServer":
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self._host, self._port))
        self._listener.listen(128)
        self._running = True
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        return self

    def _accept_loop(self):
        while self._running:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                if not self._running:
                    return  # listener closed by stop()
                # a transient accept failure (ECONNABORTED, EMFILE):
                # keep serving rather than leave a bound, unserved port
                time.sleep(0.05)
                continue
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket):
        try:
            with conn:
                while True:
                    try:
                        msg = recv_data(conn)
                    except (ConnectionError, ValueError, OSError):
                        return
                    try:
                        reply = self._handler(msg)
                    except Exception as e:  # noqa: BLE001 (reply, don't die)
                        reply = {"error": f"{type(e).__name__}: {e}"}
                    send_data(conn, reply)
        except OSError:
            return

    def stop(self):
        self._running = False
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass


def request(sock: socket.socket, msg: Any) -> Any:
    """One round trip on an open connection."""
    send_data(sock, msg)
    return recv_data(sock)
