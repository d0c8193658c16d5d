"""Search agent: the client half of the controller-server protocol
(ref contrib/slim/nas/search_agent.py:25 SearchAgent). One TCP
connection per request, same wire format as the reference, so a
port's agent can talk to a reference server and vice versa. Port of
paddle_tpu/fluid/contrib/slim/nas/search_agent.py."""
import logging
import socket

from ....log_helper import get_logger

__all__ = ["SearchAgent"]

_logger = get_logger(
    __name__, logging.INFO, fmt="%(asctime)s-%(levelname)s: %(message)s")


class SearchAgent:
    def __init__(self, server_ip=None, server_port=None, key=None):
        self.server_ip = server_ip
        self.server_port = server_port
        self._key = key

    def _request(self, payload):
        client = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            client.connect((self.server_ip, self.server_port))
            client.sendall(payload.encode())
            # EOF-delimit the request so the server never truncates a
            # large token list at one recv
            client.shutdown(socket.SHUT_WR)
            chunks = []
            while True:
                chunk = client.recv(4096)
                if not chunk:
                    break
                chunks.append(chunk)
            reply = b"".join(chunks).decode()
        finally:
            client.close()
        if not reply.strip():
            raise RuntimeError(
                "controller server at %s:%s dropped the request (no "
                "reply) — agent/server key mismatch? (key=%r)"
                % (self.server_ip, self.server_port, self._key))
        return [int(t) for t in reply.strip("\n").split(",")]

    def update(self, tokens, reward):
        """Report (tokens, reward); returns the controller's next
        proposal."""
        tokens = ",".join(str(t) for t in tokens)
        return self._request("%s\t%s\t%s" % (self._key, tokens, reward))

    def next_tokens(self):
        return self._request("next_tokens")
