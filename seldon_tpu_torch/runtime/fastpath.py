"""Fast-path unit transport: length-prefixed proto over persistent sockets.

Port of seldon_tpu/runtime/fastpath.py, frame for frame. A call is a
5-byte header plus the SeldonMessage bytes over a persistent TCP socket:
one sendall and one recv, no HTTP/2 framing. It is an optional lane
between the orchestrator and native units (declared through
`Endpoint.fast_port` in the graph spec); the microservice serves it
beside REST and gRPC, and foreign-language units keep gRPC/REST. The
orchestrator's sync lane calls it through `FastClient` (per-thread
sockets), its asyncio lane through `AsyncFastClient` (a pool per loop).

Frame format (both directions):
  request:  [1 byte method id][4 bytes big-endian length][payload]
  response: [1 byte status: 0=ok 1=unit error][4 bytes length][payload]
payloads are serialized SeldonMessage, except method `aggregate`
(SeldonMessageList) and `send_feedback` (Feedback); an error response
carries the UTF-8 detail string.
"""

from __future__ import annotations

import logging
import socket
import socketserver
import threading
from typing import Any, Dict, Optional, Tuple

from seldon_tpu_torch.proto import prediction_pb2 as pb

logger = logging.getLogger(__name__)

# Both directions refuse frames beyond this (the gRPC lane's
# grpc.max_receive_message_length equivalent): the 4-byte length field is
# peer-controlled, and an unbounded read lets a misdialed/foreign peer
# drive a multi-GiB allocation.
MAX_FRAME_BYTES = 512 * 1024 * 1024

# Wire method ids — order is part of the protocol; append only.
METHODS = (
    "predict",
    "transform_input",
    "transform_output",
    "route",
    "aggregate",
    "send_feedback",
)
METHOD_ID = {name: i for i, name in enumerate(METHODS)}

_REQUEST_CLS = {
    "aggregate": pb.SeldonMessageList,
    "send_feedback": pb.Feedback,
}


class StaleConnection(ConnectionError):
    """Transport failure on a POOLED connection (peer likely restarted
    while it sat idle): retryable, but not evidence the lane is broken —
    callers must not count it toward the fast-lane write-off."""


def _close_raw(raw) -> None:
    """Release a dead-loop transport's fd. DETACH the fd from the
    underlying socket object first: the transport's __del__ will close
    its socket later at gc time, and closing a bare fd NUMBER here would
    let the kernel reuse it before that delayed close tears down
    whatever live connection got the number."""
    import os

    if raw is None:
        return
    try:
        sock = getattr(raw, "_sock", None)  # TransportSocket wrapper
        fd = sock.detach() if sock is not None else raw.fileno()
        if fd is not None and fd >= 0:
            os.close(fd)
    except (OSError, AttributeError):
        pass


def _build_frame(method: str, request) -> bytes:
    """Request frame: [method id][4-byte BE length][payload] — the one
    definition both client lanes share."""
    body = request.SerializeToString()
    return bytes([METHOD_ID[method]]) + len(body).to_bytes(4, "big") + body


def _read_exact(f, n: int) -> bytes:
    buf = f.read(n)
    if buf is None or len(buf) < n:
        raise ConnectionError("peer closed mid-frame")
    return buf


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        from seldon_tpu_torch.runtime import seldon_methods

        self.request.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        f = self.request.makefile("rb", 65536)
        user_obj = self.server.user_obj  # type: ignore[attr-defined]
        send = self.request.sendall
        try:
            while True:
                try:
                    hdr = _read_exact(f, 5)
                except ConnectionError:
                    return  # clean close between frames
                mid = hdr[0]
                n = int.from_bytes(hdr[1:5], "big")
                if n > MAX_FRAME_BYTES:
                    logger.warning("fastpath frame of %d bytes refused", n)
                    return  # close: peer is broken or not speaking this
                body = _read_exact(f, n)
                try:
                    name = METHODS[mid]
                    req = _REQUEST_CLS.get(name, pb.SeldonMessage)()
                    req.ParseFromString(body)
                    out = getattr(seldon_methods, name)(user_obj, req)
                    payload = out.SerializeToString()
                    status = 0
                except Exception as e:  # unit error -> framed, not fatal
                    payload = str(e).encode()
                    status = 1
                send(bytes([status]) + len(payload).to_bytes(4, "big")
                     + payload)
        except (ConnectionError, OSError):
            return


class _Server(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


def start_fast_server(
    user_obj: Any, host: str = "0.0.0.0", port: int = 0
) -> Tuple[_Server, int]:
    """Serve the fast-path protocol on a daemon thread; returns
    (server, bound_port). One OS thread per engine connection — the
    engine's sync lane holds a small pool of persistent sockets."""
    srv = _Server((host, port), _Handler)
    srv.user_obj = user_obj  # type: ignore[attr-defined]
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="seldon-fastpath")
    t.start()
    return srv, srv.server_address[1]


class FastClient:
    """Blocking fast-path client: one persistent socket per calling
    thread per endpoint (thread-local — no locks on the hot path)."""

    def __init__(self, timeout_s: float = 30.0):
        self.timeout_s = timeout_s
        self._local = threading.local()

    def _sock(self, addr: Tuple[str, int]) -> socket.socket:
        pool: Optional[Dict[Tuple[str, int], socket.socket]] = getattr(
            self._local, "pool", None)
        if pool is None:  # NOT falsy-or: an emptied pool must persist
            pool = self._local.pool = {}
        s = pool.get(addr)
        if s is None:
            s = socket.create_connection(addr, timeout=self.timeout_s)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            pool[addr] = s
        return s

    def _drop(self, addr: Tuple[str, int]) -> None:
        s = self._local.pool.pop(addr, None)
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def call(self, host: str, port: int, method: str, request,
             response_cls=pb.SeldonMessage):
        """One framed round trip. Raises ConnectionError on transport
        failure (caller retries / falls back) and RuntimeError with the
        unit's detail on a framed unit error."""
        addr = (host, port)
        frame = _build_frame(method, request)
        pool = getattr(self._local, "pool", None)
        fresh = pool is None or addr not in pool
        s = self._sock(addr)
        try:
            s.sendall(frame)
            hdr = _recv_exact(s, 5)
            n = int.from_bytes(hdr[1:5], "big")
            if n > MAX_FRAME_BYTES:
                # A foreign server's bytes misread as a frame header must
                # not drive an allocation; surface as a transport error
                # (the engine's fallback machinery handles it).
                raise ConnectionError(f"fastpath frame of {n} bytes refused")
            payload = _recv_exact(s, n)
        except TimeoutError:
            self._drop(addr)
            raise
        except (OSError, ConnectionError) as e:
            self._drop(addr)
            if not fresh:  # idle-pooled socket died: not a lane verdict
                raise StaleConnection(str(e)) from e
            raise
        if hdr[0] != 0:
            raise RuntimeError(payload.decode("utf-8", "replace"))
        out = response_cls()
        out.ParseFromString(payload)
        return out

    def close(self) -> None:
        pool: Optional[Dict] = getattr(self._local, "pool", None)
        if pool:
            for s in pool.values():
                try:
                    s.close()
                except OSError:
                    pass
            pool.clear()


def _recv_exact(s: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = s.recv(n - got)
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks) if len(chunks) != 1 else chunks[0]


class AsyncFastClient:
    """asyncio-native fast-path client: a small pool of persistent
    stream connections per (loop, endpoint) — concurrent callers each
    check one out, so a connection never interleaves two frames.

    Timeout policy matches the gRPC lane: a TIMED-OUT call raises
    TimeoutError (never retried upstream — the unit may already be doing
    the work) and its connection is dropped; only transport breaks
    (peer closed, refused) surface as retryable ConnectionError."""

    def __init__(self, timeout_s: float = 30.0):
        import collections

        self.timeout_s = timeout_s
        # {loop: {(host, port): deque[(reader, writer, raw_sock)]}} —
        # keyed by the loop OBJECT (an id() would be reusable after GC
        # and could hand a new loop a dead connection); closed loops are
        # pruned on the next call and their raw fds released directly
        # (writer.close() on a dead loop raises).
        self._pools: Dict[object, Dict[Tuple[str, int], object]] = {}
        self._deque = collections.deque

    def _pool(self, loop, addr):
        for lp in list(self._pools):
            if lp.is_closed() and lp is not loop:
                for dq in self._pools.pop(lp).values():
                    while dq:
                        _, _, raw = dq.pop()
                        _close_raw(raw)
        by_addr = self._pools.setdefault(loop, {})
        dq = by_addr.get(addr)
        if dq is None:
            dq = by_addr[addr] = self._deque()
        return dq

    async def call(self, host: str, port: int, method: str, request,
                   response_cls=pb.SeldonMessage):
        import asyncio

        pool = self._pool(asyncio.get_running_loop(), (host, port))
        frame = _build_frame(method, request)
        fresh = False
        reader = writer = raw = None
        # Skim dead pooled connections (unit restarted while they sat
        # idle: eof is already set once the loop saw the FIN).
        while pool:
            reader, writer, raw = pool.pop()
            if reader.at_eof():
                writer.close()
                reader = writer = raw = None
                continue
            break
        if reader is None:
            fresh = True
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, port), self.timeout_s)
            raw = writer.get_extra_info("socket")
            if raw is not None:
                raw.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            writer.write(frame)
            # drain() bounded too: a peer that stops reading must not
            # hang the request forever on a full transport buffer.
            await asyncio.wait_for(writer.drain(), self.timeout_s)
            hdr = await asyncio.wait_for(
                reader.readexactly(5), self.timeout_s)
            n = int.from_bytes(hdr[1:5], "big")
            if n > MAX_FRAME_BYTES:
                raise ConnectionError(
                    f"fastpath frame of {n} bytes refused")
            payload = await asyncio.wait_for(
                reader.readexactly(n), self.timeout_s)
        except asyncio.IncompleteReadError as e:
            writer.close()
            if not fresh:  # idle-pooled conn died: not a lane verdict
                raise StaleConnection(str(e)) from e
            raise ConnectionError(str(e)) from e
        except TimeoutError:  # mid-frame state: connection unusable,
            writer.close()    # but the CALL must not be retried
            raise
        except (ConnectionError, OSError) as e:
            writer.close()
            if not fresh:
                raise StaleConnection(str(e)) from e
            raise
        pool.append((reader, writer, raw))
        if hdr[0] != 0:
            raise RuntimeError(payload.decode("utf-8", "replace"))
        out = response_cls()
        out.ParseFromString(payload)
        return out

    async def close(self) -> None:
        for by_addr in self._pools.values():
            for dq in by_addr.values():
                while dq:
                    _, writer, raw = dq.pop()
                    try:
                        writer.close()
                    except RuntimeError:  # connection's loop closed
                        _close_raw(raw)
        self._pools.clear()
