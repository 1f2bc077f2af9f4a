"""Minimal dependency-free HTTP surface for the serving gateway.

Stdlib ``asyncio.start_server`` only — the container has no aiohttp /
fastapi, and the protocol needs are tiny:

  * ``POST /v1/generate`` — JSON body ``{"prompt_len": int,
    "max_new_tokens": int, "slo_class"?: str, "session_id"?: str,
    "cached_prefix_len"?: int}``.  Streams the request's typed event
    stream as newline-delimited JSON (``application/x-ndjson``, one
    ``core.events`` event per line via ``event_to_json``) and closes
    after the terminal ``finished`` / ``rejected`` / ``cancelled`` line.
  * ``POST /v1/cancel``  — JSON body ``{"rid": int}``; cancels a live
    request (terminal ``cancelled`` line on its stream, engine slot and
    parked checkpoint freed).  Response says whether it was still live.
  * ``GET /healthz``  — gateway + worker states.
  * ``GET /metrics``  — ``fleet_summarize`` output (incl. event-loop
    ``clamped`` / ``peak_heap`` counters and the fault-tolerance
    counters: checkpoints, resumes, replayed_tokens, cancelled,
    fenced_beats).

Streaming backpressure composes with the gateway's channel watermarks:
the writer task only ``take()``s another event after
``await writer.drain()`` returns, so a slow client stops draining its
channel, the channel pauses, and the gateway evicts that one request
from its engine until the client catches up — other streams unaffected.
The port also writes an event the moment the gateway offers it (from
the channel's ``notify``), while the stream's transport holds less than
``WRITE_BUFFER`` bytes: a token then leaves in the engine callback that
produced it, not in a task step that would wait behind the engine's next
launch and hold up that launch's lane completion; the stream's task
wakes only for the events left to it and for the stream's end, not once
a token.

Robustness contract (pinned in tests/test_gateway.py): malformed bodies
and header junk are 400s, unexpected handler failures are 500s — never
an exception escaping the handler task — and a client that disconnects
mid-stream gets its request *cancelled* (slot + checkpoint freed
immediately) instead of generating into a dead socket until the
slow-consumer eviction path notices.
"""
from __future__ import annotations

import asyncio
import json
import socket
from typing import Optional, Tuple

from repro_torch.core.events import event_to_json
from repro_torch.core.request import Request


# the bytes a stream may hold unsent on the server side (the port's): a
# few NDJSON lines, so the gateway's channel (``stream_buffer``) is where
# a slow client's events wait, and its backpressure pause is what acts
WRITE_BUFFER = 512


class HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


_STATUS = {200: "OK", 400: "Bad Request", 404: "Not Found",
           405: "Method Not Allowed", 500: "Internal Server Error"}


def _response_head(status: int, ctype: str,
                   length: Optional[int] = None) -> bytes:
    lines = [f"HTTP/1.1 {status} {_STATUS.get(status, 'Unknown')}",
             f"Content-Type: {ctype}", "Connection: close"]
    if length is not None:
        lines.append(f"Content-Length: {length}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode()


async def _read_request(reader) -> Tuple[str, str, bytes]:
    """Parse method, path and body from one HTTP/1.1 request."""
    line = await reader.readline()
    if not line:
        raise HTTPError(400, "empty request")
    try:
        method, path, _ = line.decode("latin-1").split(None, 2)
    except ValueError:
        raise HTTPError(400, "malformed request line") from None
    length = 0
    while True:
        hdr = await reader.readline()
        if hdr in (b"\r\n", b"\n", b""):
            break
        name, _, value = hdr.decode("latin-1").partition(":")
        if name.strip().lower() == "content-length":
            try:
                length = int(value.strip())
            except ValueError:
                raise HTTPError(400, "bad Content-Length") from None
    if length < 0 or length > 1_000_000:
        raise HTTPError(400, "unreasonable Content-Length")
    body = await reader.readexactly(length) if length else b""
    return method.upper(), path, body


class GatewayHTTPServer:
    """Serves a ``Gateway`` built on a ``RealTimeClock`` over TCP.

    Three additions of the port:

      * ``prompts`` (default none): where the workers' executors read a
        request's prompt tokens (the body carries only ``prompt_len``).
        ``prompts.add(r)`` runs for each request before it is submitted;
        a ``ValueError`` from it refuses the request with a 400 that
        carries its message (``launch/serve.py``'s ``SeededPrompts``).
      * A stream holds at most ``WRITE_BUFFER`` bytes unsent, in its
        socket's send buffer and in asyncio's, before its writer waits.
        Unbounded, the OS and asyncio hold hundreds of KB on loopback,
        thousands of NDJSON lines, and a client that stops reading would
        fill its channel to ``stream_buffer`` only that much later.
      * An event is written when the gateway offers it, while the
        stream's transport takes more (the module docstring).

    ``port`` 0 takes an ephemeral port; ``start`` stores the one bound.
    """

    def __init__(self, gateway, host: str = "127.0.0.1", port: int = 8080,
                 prompts=None):
        self.gateway = gateway
        self.host = host
        self.port = port
        self.prompts = prompts
        self._server = None
        # fault injection (serving/faults.line_corruptor): bytes->bytes
        # hook applied to each outgoing NDJSON line
        self.line_hook = None

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        clock = self.gateway.clock
        if hasattr(clock, "bind"):
            clock.bind(loop)
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # -- request handling ---------------------------------------------------

    async def _handle(self, reader, writer) -> None:
        try:
            try:
                method, path, body = await _read_request(reader)
                if method == "POST" and path == "/v1/generate":
                    await self._generate(body, writer)
                elif method == "POST" and path == "/v1/cancel":
                    self._cancel(body, writer)
                elif method == "GET" and path == "/healthz":
                    self._send_json(writer, self.gateway.health())
                elif method == "GET" and path == "/metrics":
                    self._send_json(writer, self.gateway.metrics_summary())
                elif path in ("/v1/generate", "/v1/cancel", "/healthz",
                              "/metrics"):
                    raise HTTPError(405, f"{method} not allowed on {path}")
                else:
                    raise HTTPError(404, f"no route for {path}")
            except HTTPError as e:
                self._send_json(writer, {"error": e.message},
                                status=e.status)
            except (asyncio.IncompleteReadError, ConnectionError):
                return               # client went away; nothing to send
            except (ValueError, asyncio.LimitOverrunError) as e:
                # oversized/undecodable header lines etc. — client error
                self._send_json(writer, {"error": f"malformed request: {e}"},
                                status=400)
            except Exception as e:   # noqa: BLE001 — last-resort 500:
                # an exception must never escape the handler task (it
                # would be swallowed by asyncio and kill this stream)
                self._send_json(
                    writer,
                    {"error": f"internal error: {type(e).__name__}"},
                    status=500)
            try:
                await writer.drain()
            except ConnectionError:
                pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionError:
                pass

    @staticmethod
    def _send_json(writer, obj, status: int = 200) -> None:
        payload = json.dumps(obj).encode()
        writer.write(_response_head(status, "application/json",
                                    len(payload)))
        writer.write(payload)

    async def _generate(self, body: bytes, writer) -> None:
        try:
            spec = json.loads(body or b"{}")
        except json.JSONDecodeError:
            raise HTTPError(400, "body is not valid JSON") from None
        if not isinstance(spec, dict):
            raise HTTPError(400, "body must be a JSON object")
        try:
            prompt_len = int(spec["prompt_len"])
            max_new = int(spec["max_new_tokens"])
            prefix = int(spec.get("cached_prefix_len", 0))
        except (KeyError, TypeError, ValueError):
            raise HTTPError(
                400, "prompt_len, max_new_tokens (ints) required; "
                     "cached_prefix_len must be an int") from None
        if prompt_len < 1 or max_new < 1 or prefix < 0:
            raise HTTPError(400, "prompt_len and max_new_tokens must be "
                                 ">=1, cached_prefix_len >=0")
        session_id = spec.get("session_id")
        if session_id is not None and not isinstance(session_id, str):
            raise HTTPError(400, "session_id must be a string")
        gw = self.gateway
        r = Request(rid=gw.next_rid(), arrival=gw.clock.now,
                    prompt_len=prompt_len, max_new_tokens=max_new,
                    slo_class=str(spec.get("slo_class", "interactive")),
                    session_id=session_id,
                    cached_prefix_len=prefix)
        if self.prompts is not None:
            try:
                self.prompts.add(r)
            except ValueError as e:
                raise HTTPError(400, str(e)) from None
        writer.transport.set_write_buffer_limits(high=WRITE_BUFFER)
        writer.get_extra_info("socket").setsockopt(
            socket.SOL_SOCKET, socket.SO_SNDBUF, WRITE_BUFFER)
        wake = asyncio.Event()
        transport = writer.transport

        def line_of(ev) -> bytes:
            line = (event_to_json(ev) + "\n").encode()
            return line if self.line_hook is None else self.line_hook(line)

        def write_now() -> None:
            # the task is suspended whenever the gateway offers an event,
            # and every event it took is written: the channel's order holds
            while (started and channel.buf and not transport.is_closing()
                   and transport.get_write_buffer_size() < WRITE_BUFFER):
                writer.write(line_of(channel.take()))
            # the task wakes only for what is left to it: events this could
            # not write (before the head, or to a full or closing
            # transport) or the stream's end
            if not started or channel.buf or channel.closed:
                wake.set()

        started = False
        channel = gw.submit(r, notify=write_now)
        writer.write(_response_head(200, "application/x-ndjson"))
        started = True
        try:
            await writer.drain()
            while not channel.done:
                ev = channel.take()
                if ev is None:
                    wake.clear()
                    if channel.closed and not channel.buf:
                        break
                    await wake.wait()
                    continue
                writer.write(line_of(ev))
                # drain before taking the next event: a slow client parks
                # us here, the channel fills, and the gateway
                # backpressures this one request out of its engine
                await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            # mid-stream client abort: cancel instead of generating into
            # a dead socket (frees the engine slot + parked checkpoint)
            gw.cancel(r.rid, reason="disconnect")
            raise

    def _cancel(self, body: bytes, writer) -> None:
        try:
            spec = json.loads(body or b"{}")
            rid = int(spec["rid"])
        except (json.JSONDecodeError, KeyError, TypeError, ValueError):
            raise HTTPError(400, "body must be JSON with an int rid") \
                from None
        ok = self.gateway.cancel(rid, reason="client_cancel")
        self._send_json(writer, {"rid": rid, "cancelled": ok})


def run_http(gateway, host: str = "127.0.0.1", port: int = 8080,
             **server_kw) -> None:
    """Blocking entry point for ``launch/serve.py --serve http``;
    ``server_kw`` are ``GatewayHTTPServer``'s own (``prompts``)."""
    server = GatewayHTTPServer(gateway, host, port, **server_kw)

    async def main():
        await server.start()
        addrs = ", ".join(str(s.getsockname())
                          for s in server._server.sockets)
        print(f"gateway listening on {addrs}")
        await server.serve_forever()

    try:
        asyncio.run(main())
    except KeyboardInterrupt:
        pass
