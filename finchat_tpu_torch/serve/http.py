"""Minimal asyncio HTTP/1.1 server (own copy of the JAX package's
``serve/http.py``; stdlib only).

Request parsing, exact and prefix routing, JSON responses, and chunked
streaming for server-sent events: each chunk of a ``StreamingResponse`` is
flushed as it comes, since that is the token stream. No third-party
dependency and no ASGI layer in the token path.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field
from typing import AsyncIterator, Awaitable, Callable

from finchat_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_MAX_HEADER_BYTES = 64 * 1024
_MAX_BODY_BYTES = 16 * 1024 * 1024


@dataclass
class Request:
    method: str
    path: str
    headers: dict[str, str]
    body: bytes

    def json(self) -> dict:
        return json.loads(self.body.decode("utf-8"))


@dataclass
class Response:
    status: int = 200
    body: bytes = b""
    content_type: str = "application/json"
    headers: dict[str, str] = field(default_factory=dict)

    @classmethod
    def json(cls, payload: object, status: int = 200) -> "Response":
        return cls(status=status, body=json.dumps(payload).encode())

    @classmethod
    def text(cls, text: str, status: int = 200, content_type: str = "text/plain") -> "Response":
        return cls(status=status, body=text.encode(), content_type=content_type)


@dataclass
class StreamingResponse:
    """Chunked-transfer response; ``chunks`` yields byte chunks (e.g. SSE
    ``data:`` lines). Each chunk is flushed immediately — this is the token
    streaming path, so no buffering."""

    chunks: AsyncIterator[bytes]
    status: int = 200
    content_type: str = "text/event-stream"


Handler = Callable[[Request], Awaitable[Response | StreamingResponse]]

_STATUS_TEXT = {200: "OK", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed", 500: "Internal Server Error"}


class HTTPServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        self.host = host
        self.port = port
        self._routes: dict[tuple[str, str], Handler] = {}
        # (method, prefix) -> handler, matched after exact routes for
        # path-parameter endpoints like GET /debug/trace/<trace_id>
        self._prefix_routes: list[tuple[str, str, Handler]] = []
        self._server: asyncio.AbstractServer | None = None

    def route(self, method: str, path: str, handler: Handler) -> None:
        self._routes[(method.upper(), path)] = handler

    def route_prefix(self, method: str, prefix: str, handler: Handler) -> None:
        """Register a prefix-matched route; the handler reads the path
        suffix off ``request.path`` (longest prefix wins)."""
        self._prefix_routes.append((method.upper(), prefix, handler))
        self._prefix_routes.sort(key=lambda r: len(r[1]), reverse=True)

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]  # resolve port 0
        logger.info("HTTP server listening on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    # --- connection handling -------------------------------------------
    async def _read_request(self, reader: asyncio.StreamReader) -> Request | None:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            return None
        if len(head) > _MAX_HEADER_BYTES:
            return None
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, _version = lines[0].split(" ", 2)
        except ValueError:
            return None
        headers: dict[str, str] = {}
        for line in lines[1:]:
            if ":" in line:
                name, _, value = line.partition(":")
                headers[name.strip().lower()] = value.strip()
        length = int(headers.get("content-length", "0") or "0")
        if length > _MAX_BODY_BYTES:
            return None
        body = await reader.readexactly(length) if length else b""
        path = target.split("?", 1)[0]
        return Request(method=method.upper(), path=path, headers=headers, body=body)

    @staticmethod
    def _head(status: int, content_type: str, extra: dict[str, str] | None = None, chunked: bool = False, length: int | None = None) -> bytes:
        lines = [f"HTTP/1.1 {status} {_STATUS_TEXT.get(status, 'OK')}"]
        lines.append(f"Content-Type: {content_type}")
        if chunked:
            lines.append("Transfer-Encoding: chunked")
            lines.append("Cache-Control: no-cache")
        elif length is not None:
            lines.append(f"Content-Length: {length}")
        lines.append("Connection: close")
        for name, value in (extra or {}).items():
            lines.append(f"{name}: {value}")
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            request = await self._read_request(reader)
            if request is None:
                writer.write(self._head(400, "text/plain", length=0))
                return
            handler = self._routes.get((request.method, request.path))
            if handler is None:
                for method, prefix, h in self._prefix_routes:
                    if method == request.method and request.path.startswith(prefix):
                        handler = h
                        break
            if handler is None:
                if any(path == request.path for _, path in self._routes):
                    writer.write(self._head(405, "text/plain", length=0))
                else:
                    body = b'{"detail":"Not Found"}'
                    writer.write(self._head(404, "application/json", length=len(body)) + body)
                return

            try:
                result = await handler(request)
            except json.JSONDecodeError as e:
                body = json.dumps({"detail": f"invalid JSON body: {e}"}).encode()
                writer.write(self._head(400, "application/json", length=len(body)) + body)
                return
            except LookupError as e:
                # unknown conversation/context → client error, not a 500
                body = json.dumps({"detail": str(e)}).encode()
                writer.write(self._head(404, "application/json", length=len(body)) + body)
                return
            except Exception as e:
                logger.error("handler error on %s %s: %s", request.method, request.path, e, exc_info=True)
                body = json.dumps({"detail": "internal error"}).encode()
                writer.write(self._head(500, "application/json", length=len(body)) + body)
                return

            if isinstance(result, StreamingResponse):
                writer.write(self._head(result.status, result.content_type, chunked=True))
                await writer.drain()
                try:
                    async for chunk in result.chunks:
                        writer.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                        await writer.drain()  # flush per token chunk
                finally:
                    writer.write(b"0\r\n\r\n")
            else:
                writer.write(
                    self._head(result.status, result.content_type, extra=result.headers, length=len(result.body))
                    + result.body
                )
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass  # client went away mid-stream
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass


def sse_event(payload: dict) -> bytes:
    """Render one server-sent event carrying a JSON payload."""
    return f"data: {json.dumps(payload)}\n\n".encode()
