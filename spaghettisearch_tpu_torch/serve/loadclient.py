"""A closed-loop HTTP/1.1 load client: persistent connections driven by one
selector loop, each sending its next request as soon as its previous answer
is complete (the client of bench.py --mode serve and of the host
profilers in experiments/).

A response is framed by its Content-Length header. One without it (or with
a value that is not a number) cannot be framed on a persistent connection:
it is counted as a protocol error, its connection is closed, and a fresh
connection takes its place, so the load keeps its width.
"""

from __future__ import annotations

import json
import selectors
import socket
import time


def post_query(query: str) -> bytes:
    """One POST /query request for `query`, as the server's users send it."""
    body = json.dumps({"query": query}).encode()
    return (b"POST /query HTTP/1.1\r\nHost: b\r\nContent-Type: application/json\r\n"
            b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body)


def parse_head(head: bytes) -> tuple[bytes, int | None]:
    """(status code, Content-Length) of a response head (the bytes before
    the blank line); the length is None when the header is missing or is
    not a non-negative integer."""
    lines = head.split(b"\r\n")
    status = lines[0][9:12]
    for line in lines[1:]:
        name, sep, value = line.partition(b":")
        if sep and name.strip().lower() == b"content-length":
            value = value.strip()
            return status, int(value) if value.isdigit() else None
    return status, None


class _Conn:
    __slots__ = ("sock", "buf", "need", "qi", "t0", "kind", "status")


class LoadClient:
    """n_conns persistent connections to 127.0.0.1:port. Connection c sends
    payloads[c], payloads[c + n_conns], ... (cycling); `kinds` names each
    payload's route for per-route latencies. Counters since the last reset():
    `done` answers, `latencies` (seconds) per route, `non_200` answers whose
    status was not 200, `protocol_errors` answers that could not be framed."""

    def __init__(self, port: int, payloads: list[bytes], n_conns: int,
                 kinds: list[str] | None = None) -> None:
        self.port = port
        self.payloads = payloads
        self.kinds = kinds or ["all"] * len(payloads)
        self.n_conns = n_conns
        self.sel = selectors.DefaultSelector()
        self.reset()
        self.conns = [self._open(qi) for qi in range(n_conns)]

    def reset(self) -> None:
        self.done = 0
        self.non_200 = 0
        self.protocol_errors = 0
        self.latencies: dict[str, list[float]] = {k: [] for k in dict.fromkeys(self.kinds)}

    def _open(self, qi: int) -> _Conn:
        c = _Conn()
        c.sock = socket.create_connection(("127.0.0.1", self.port))
        c.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # blocking sockets: the selector gates recv (>= 1 byte ready) and a
        # small request always fits the send buffer
        c.buf, c.need, c.qi = b"", -1, qi
        self.sel.register(c.sock, selectors.EVENT_READ, c)
        self._send(c)
        return c

    def _send(self, c: _Conn) -> None:
        i = c.qi % len(self.payloads)
        c.t0 = time.perf_counter()
        c.kind = self.kinds[i]
        c.sock.sendall(self.payloads[i])
        c.qi += self.n_conns

    def _drop(self, c: _Conn) -> None:
        self.sel.unregister(c.sock)
        c.sock.close()

    def _feed(self, c: _Conn) -> None:
        data = c.sock.recv(1 << 18)
        if not data:
            raise RuntimeError("the server closed a connection")
        c.buf += data
        while True:
            if c.need < 0:
                he = c.buf.find(b"\r\n\r\n")
                if he < 0:
                    return
                c.status, length = parse_head(c.buf[:he])
                if length is None:
                    # unframeable: count it, and replace the connection
                    self.protocol_errors += 1
                    self._drop(c)
                    self.conns[self.conns.index(c)] = self._open(c.qi)
                    return
                c.need = he + 4 + length
            if len(c.buf) < c.need:
                return
            c.buf, c.need = c.buf[c.need:], -1
            self.latencies[c.kind].append(time.perf_counter() - c.t0)
            self.non_200 += c.status != b"200"
            self.done += 1
            self._send(c)

    def pump(self, seconds: float) -> float:
        """Drive the load for `seconds`. -> the wall seconds it ran."""
        t0 = time.perf_counter()
        until = time.monotonic() + seconds
        while time.monotonic() < until:
            for key, _ in self.sel.select(timeout=0.2):
                self._feed(key.data)
        return time.perf_counter() - t0

    def all_latencies(self) -> list[float]:
        return sorted(x for v in self.latencies.values() for x in v)

    def close(self) -> None:
        for c in self.conns:
            self._drop(c)
        self.sel.close()
