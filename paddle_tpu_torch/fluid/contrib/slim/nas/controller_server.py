"""Socket server wrapping a search controller
(ref contrib/slim/nas/controller_server.py:28 ControllerServer).

Wire protocol (kept byte-compatible with the reference so agents and
servers interoperate):

* request ``"next_tokens"``            -> reply ``"t0,t1,..."``
* request ``"<key>\\t<tokens>\\t<reward>"`` -> controller.update(...),
  reply with the controller's next proposal ``"t0,t1,..."``

Requests with the wrong key are logged and dropped, like the reference.
Differences from the reference (deliberate): the accept loop uses a
1-second socket timeout so ``close()`` actually terminates the thread
(the reference blocks in accept() forever), the worker thread is a
daemon, and per-connection errors are caught so one bad client can't
kill the server. There is nothing pserver/brpc-specific here — plain
host-side sockets work the same beside the card.

Port of paddle_tpu/fluid/contrib/slim/nas/controller_server.py.
"""
import logging
import socket
from threading import Thread

from ....log_helper import get_logger

__all__ = ["ControllerServer"]

_logger = get_logger(
    __name__, logging.INFO,
    fmt="ControllerServer-%(asctime)s-%(levelname)s: %(message)s")


class ControllerServer:
    def __init__(self, controller=None, address=("", 0),
                 max_client_num=100, search_steps=None, key=None):
        """controller: slim.searcher controller (next_tokens/update);
        address: (ip, port), port 0 -> pick a free one;
        search_steps: stop serving after this many controller updates
        (None = serve forever); key: shared secret identifying agents."""
        self._controller = controller
        self._address = address
        self._max_client_num = max_client_num
        self._search_steps = search_steps
        self._closed = False
        self._ip, self._port = address
        self._key = key
        self._socket_server = None
        self._thread = None

    def start(self):
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(self._address)
        srv.listen(self._max_client_num)
        srv.settimeout(1.0)    # lets the loop observe close()
        self._socket_server = srv
        self._ip, self._port = srv.getsockname()[:2]
        _logger.info("listen on: [%s:%s]" % (self._ip, self._port))
        self._thread = Thread(target=self.run, daemon=True)
        self._thread.start()
        return str(self._thread)

    def close(self):
        self._closed = True
        if self._thread is not None:
            self._thread.join(timeout=5)

    def port(self):
        return self._port

    def ip(self):
        return self._ip

    def _serving(self):
        if self._closed:
            return False
        return (self._search_steps is None
                or getattr(self._controller, "_iter", 0)
                < self._search_steps)

    def run(self):
        _logger.info("Controller Server run...")
        while self._serving():
            try:
                conn, addr = self._socket_server.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                with conn:
                    self._handle(conn, addr)
            except Exception as e:  # noqa: BLE001 — keep serving
                _logger.info("request from %s failed: %s" % (addr, e))
        self._socket_server.close()
        _logger.info("server closed!")

    @staticmethod
    def _recv_all(conn, timeout=0.5):
        """Accumulate the request until EOF (this package's agents shut down
        their write side) or a short idle timeout (reference agents
        don't, and their requests can exceed one 1024-byte recv for
        large token lists)."""
        conn.settimeout(timeout)
        chunks = []
        while True:
            try:
                chunk = conn.recv(4096)
            except socket.timeout:
                break
            if not chunk:
                break
            chunks.append(chunk)
        return b"".join(chunks).decode()

    def _handle(self, conn, addr):
        message = self._recv_all(conn)
        if message.strip("\n") == "next_tokens":
            conn.sendall(self._encode(self._controller.next_tokens()))
            return
        parts = message.strip("\n").split("\t")
        # compare string forms: the agent serializes its key with %s,
        # so default key=None on both sides must still match
        if len(parts) < 3 or parts[0] != str(self._key):
            _logger.info("recv noise from %s: [%s]" % (addr, message))
            return
        tokens = [int(t) for t in parts[1].split(",")]
        self._controller.update(tokens, float(parts[2]))
        reply = self._encode(self._controller.next_tokens())
        conn.sendall(reply)
        _logger.info("send message to %s: [%s]" % (addr, reply.decode()))

    @staticmethod
    def _encode(tokens):
        return ",".join(str(t) for t in tokens).encode()
