"""Binary WebSocket streaming endpoint ``/stream`` of the port's server.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/serving/ws.py``, the
same wire: ``GET /stream`` upgrades the stdlib server (RFC 6455, no external
dependency) to a persistent full-duplex socket speaking raw bytes, instead of
one HTTP POST of base64 JPEG per webcam frame.

- client TEXT frame: JSON config, merged into the connection's options —
  ``{"prompt": ..., "steps": 2, "use_cfg": false, "cfg_scale": null,
  "negative_prompt": null, "seed": 42, "session": true,
  "pipeline": true, "quality": 90}``. Every TEXT frame is acknowledged
  with ``{"status": "ok", "session": "<sid>"}``; one sent mid-stream is the
  live prompt switch (the session re-freezes its prompt, keeps its latent).
- client BINARY frame: raw JPEG or PNG bytes, decoded by ``core/codec.py``
  to an array and handed to the engine with ``raw_response`` set, so no
  base64 exists anywhere on the path.
- server BINARY reply per frame: ``[4-byte big-endian meta length][meta
  JSON utf-8][JPEG bytes]``; meta is the /edit response minus the image.
- errors come back as TEXT JSON ``{"status": "error", "detail": ...,
  "code": 429|422|500|503}`` and the connection stays up.

``session: true`` (default) serves frames through the engine's stream
sessions (``pipeline: true``: lag-1 overlap; under ``--dynamic-batch``
concurrent sockets' frames batch as HTTP sessions do). ``session: false``
runs each binary frame as a sessionless edit.

``WSClient`` is the stdlib client (client frames masked, RFC 6455 §5.3)
used by the tests, ``chip_smoke.py`` and ``examples/ws_client.py``.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import socket
import struct
import threading
import uuid
from typing import Any, Dict, Optional, Tuple

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA

# A declared 64-bit length is honored by _read_exact, so without a cap a
# misbehaving peer can make the handler thread buffer arbitrary bytes
# (memory DoS). 32 MB comfortably fits any 1024² image frame; oversized
# messages close the socket with status 1009 (RFC 6455 §7.4.1).
MAX_MESSAGE_BYTES = int(os.environ.get("QIE_WS_MAX_MESSAGE",
                                       str(32 * 1024 * 1024)))


class MessageTooBig(ConnectionError):
    """Peer declared/assembled a message beyond MAX_MESSAGE_BYTES."""

# connection-level option keys a TEXT config frame may set; anything else
# in the JSON is rejected loudly (a typo like "promt" must not 200-ok)
_OPT_KEYS = frozenset({
    "prompt", "steps", "use_cfg", "cfg_scale", "negative_prompt", "seed",
    "session", "pipeline", "quality", "ref_image", "blend_ratio",
})


def accept_key(key: str) -> str:
    """Sec-WebSocket-Accept for a client key (RFC 6455 §4.2.2)."""
    digest = hashlib.sha1((key + _GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def _mask_bytes(data: bytes, mask: bytes) -> bytes:
    """XOR (un)masking. numpy vectorized — a Python byte loop costs ~50 ms
    on a 100 KB frame, which would eat the transport's whole win."""
    import numpy as np

    a = np.frombuffer(data, dtype=np.uint8)
    m = np.frombuffer((mask * ((len(data) + 3) // 4))[:len(data)],
                      dtype=np.uint8)
    return np.bitwise_xor(a, m).tobytes()


def _read_exact(rfile, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = rfile.read(n - len(buf))
        if not chunk:
            raise ConnectionError("websocket peer closed mid-frame")
        buf += chunk
    return buf


def read_frame(rfile) -> Tuple[int, bytes, bool]:
    """One raw frame → (opcode, payload, fin)."""
    h = _read_exact(rfile, 2)
    fin = bool(h[0] & 0x80)
    opcode = h[0] & 0x0F
    masked = bool(h[1] & 0x80)
    ln = h[1] & 0x7F
    if ln == 126:
        ln = struct.unpack("!H", _read_exact(rfile, 2))[0]
    elif ln == 127:
        ln = struct.unpack("!Q", _read_exact(rfile, 8))[0]
    if ln > MAX_MESSAGE_BYTES:
        raise MessageTooBig(
            f"frame declares {ln} bytes > cap {MAX_MESSAGE_BYTES}")
    mask = _read_exact(rfile, 4) if masked else None
    payload = _read_exact(rfile, ln) if ln else b""
    if mask:
        payload = _mask_bytes(payload, mask)
    return opcode, payload, fin


def write_frame(wfile, opcode: int, payload: bytes,
                mask: bool = False) -> None:
    """One frame. Servers send unmasked; clients MUST mask (RFC 6455
    §5.3 — pass mask=True from client code)."""
    b0 = 0x80 | opcode  # FIN always set: we never fragment sends
    ln = len(payload)
    mbit = 0x80 if mask else 0
    if ln < 126:
        header = struct.pack("!BB", b0, mbit | ln)
    elif ln < (1 << 16):
        header = struct.pack("!BBH", b0, mbit | 126, ln)
    else:
        header = struct.pack("!BBQ", b0, mbit | 127, ln)
    if mask:
        key = os.urandom(4)
        payload = _mask_bytes(payload, key)
        header += key
    wfile.write(header + payload)
    wfile.flush()


def read_message(rfile, wfile, mask_replies: bool = False,
                 write_lock: Optional[threading.Lock] = None,
                 ) -> Tuple[int, bytes]:
    """Next complete data message (OP_TEXT/OP_BINARY, defragmented) or
    OP_CLOSE. Pings are answered inline; pongs are swallowed — callers
    never see control frames except close.

    ``mask_replies`` must be True when the caller is a CLIENT (RFC 6455
    §5.3: client frames MUST be masked). ``write_lock`` serializes the
    inline PONG against a concurrent sender thread in full-duplex use —
    without it the two writes can interleave and corrupt the byte
    stream. Messages whose declared or reassembled size exceeds
    MAX_MESSAGE_BYTES raise :class:`MessageTooBig`."""
    buf = bytearray()
    first_op: Optional[int] = None
    while True:
        opcode, payload, fin = read_frame(rfile)
        if opcode == OP_PING:
            if write_lock is not None:
                with write_lock:
                    write_frame(wfile, OP_PONG, payload, mask=mask_replies)
            else:
                write_frame(wfile, OP_PONG, payload, mask=mask_replies)
            continue
        if opcode == OP_PONG:
            continue
        if opcode == OP_CLOSE:
            return OP_CLOSE, payload
        if opcode in (OP_TEXT, OP_BINARY):
            first_op = opcode
            buf += payload
        elif opcode == OP_CONT:
            if first_op is None:
                raise ConnectionError("continuation frame with no start")
            buf += payload
        else:
            raise ConnectionError(f"unsupported websocket opcode {opcode}")
        if len(buf) > MAX_MESSAGE_BYTES:
            raise MessageTooBig(
                f"reassembled message exceeds cap {MAX_MESSAGE_BYTES}")
        if fin:
            return first_op, bytes(buf)


# ---------------------------------------------------------------------------
# Server side
# ---------------------------------------------------------------------------

def is_upgrade(handler) -> bool:
    """True if this GET is a websocket upgrade request."""
    conn = handler.headers.get("Connection", "")
    return ("upgrade" in conn.lower()
            and handler.headers.get("Upgrade", "").lower() == "websocket")


def handle_connection(handler, engine) -> None:
    """Serve one websocket connection on an http.server handler whose
    request line + headers are already consumed. Returns when the peer
    closes (the caller's handler thread is dedicated to the socket —
    ThreadingHTTPServer gives every connection its own thread)."""
    key = handler.headers.get("Sec-WebSocket-Key")
    if not key:
        handler.send_response(400)
        handler.end_headers()
        return
    handler.send_response_only(101, "Switching Protocols")
    handler.send_header("Upgrade", "websocket")
    handler.send_header("Connection", "Upgrade")
    handler.send_header("Sec-WebSocket-Accept", accept_key(key))
    handler.end_headers()
    handler.close_connection = True  # our loop owns the socket from here
    # a stalled stream consumer must not hold the handler thread forever
    handler.connection.settimeout(
        float(os.environ.get("QIE_WS_TIMEOUT", "600")))

    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec

    rfile, wfile = handler.rfile, handler.wfile
    sid = f"ws-{uuid.uuid4().hex[:12]}"
    opts: Dict[str, Any] = {"session": True, "pipeline": True,
                            "quality": 90}

    def send_json(obj: Dict[str, Any]) -> None:
        write_frame(wfile, OP_TEXT, json.dumps(obj).encode())

    send_json({"status": "ready", "session": sid})
    try:
        while True:
            try:
                opcode, data = read_message(rfile, wfile)
            except MessageTooBig as e:
                # RFC 6455 1009 Message Too Big, then drop the socket
                # (the stream is unframed beyond this point anyway)
                try:
                    write_frame(wfile, OP_CLOSE,
                                struct.pack("!H", 1009) + str(e).encode())
                except OSError:
                    pass
                break
            if opcode == OP_CLOSE:
                try:
                    write_frame(wfile, OP_CLOSE, data[:2])
                except OSError:
                    pass
                break
            if opcode == OP_TEXT:
                try:
                    cfg = json.loads(data or b"{}")
                    bad = set(cfg) - _OPT_KEYS
                    if bad:
                        raise ValueError(
                            f"unknown option(s) {sorted(bad)}; "
                            f"allowed: {sorted(_OPT_KEYS)}")
                    opts.update(cfg)
                    send_json({"status": "ok", "session": sid})
                except (ValueError, TypeError) as e:
                    send_json({"status": "error", "code": 422,
                               "detail": str(e)})
                continue
            # binary frame: one image in, one edited image out.
            # Frame-level errors carry "frame": true so clients tracking
            # in-flight image sends (webui wsInflight) can release the
            # slot — config-ack errors don't consume a frame slot.
            try:
                img = codec.decode(data)
            except Exception as e:
                send_json({"status": "error", "code": 422, "frame": True,
                           "detail": f"undecodable image frame: {e}"})
                continue
            request: Dict[str, Any] = {
                "image": img,
                "raw_response": True,
            }
            for k in ("prompt", "steps", "use_cfg", "cfg_scale",
                      "negative_prompt", "seed", "ref_image",
                      "blend_ratio"):
                if opts.get(k) is not None:
                    request[k] = opts[k]
            if opts.get("session", True):
                request["stream_session"] = sid
                request["stream_pipeline"] = bool(opts.get("pipeline", True))
            try:
                resp = engine.edit(request)
            except Exception as e:
                # same taxonomy as the HTTP route, as a data-level error:
                # one dropped frame must not kill a live stream
                from qwen_image_edit_streamdiffusion_tpu_torch.runtime.engine \
                    import EngineBusy, InvalidRequest, ModelNotLoaded

                code = (503 if isinstance(e, ModelNotLoaded)
                        else 429 if isinstance(e, EngineBusy)
                        else 422 if isinstance(e, InvalidRequest) else 500)
                send_json({"status": "error", "code": code, "frame": True,
                           "detail": str(e)})
                continue
            out = resp.pop("image")
            jpeg = codec.encode_jpeg(out, int(opts.get("quality", 90)))
            meta = json.dumps(resp).encode()
            write_frame(wfile, OP_BINARY,
                        struct.pack("!I", len(meta)) + meta + jpeg)
    except (ConnectionError, OSError, socket.timeout):
        pass  # peer vanished / idle timeout; a reconnect with a fresh sid
        # simply re-anchors with a keyframe
    finally:
        engine.end_session(sid)  # the socket's session ends with it, on every rank


# ---------------------------------------------------------------------------
# Client side (stdlib; used by the tests, chip_smoke.py and examples/ws_client.py)
# ---------------------------------------------------------------------------

class WSClient:
    """Minimal blocking client for the `/stream` endpoint.

    ``send_config``/``send_image`` write; ``recv`` reads the next message
    (dicts for TEXT, ``(meta, jpeg_bytes)`` for BINARY). Full-duplex use
    (the point of the endpoint) drives send and recv from two threads —
    see examples/ws_client.py.
    """

    def __init__(self, host: str, port: int, path: str = "/stream",
                 timeout: float = 600.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.rfile = self.sock.makefile("rb")
        self.wfile = self.sock.makefile("wb")
        # serializes sender-thread writes against recv()'s inline PONG
        # replies in the documented two-thread full-duplex usage
        self._wlock = threading.Lock()
        key = base64.b64encode(os.urandom(16)).decode()
        self.wfile.write(
            (f"GET {path} HTTP/1.1\r\n"
             f"Host: {host}:{port}\r\n"
             "Upgrade: websocket\r\n"
             "Connection: Upgrade\r\n"
             f"Sec-WebSocket-Key: {key}\r\n"
             "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        self.wfile.flush()
        status = self.rfile.readline()
        if b"101" not in status:
            raise ConnectionError(f"upgrade refused: {status!r}")
        want = accept_key(key).encode()
        ok = False
        while True:  # drain headers, checking the accept echo
            line = self.rfile.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            if line.lower().startswith(b"sec-websocket-accept:"):
                ok = want in line
        if not ok:
            raise ConnectionError("bad Sec-WebSocket-Accept")

    def send_config(self, **cfg) -> None:
        with self._wlock:
            write_frame(self.wfile, OP_TEXT, json.dumps(cfg).encode(),
                        mask=True)

    def send_image(self, img, quality: int = 90) -> None:
        """An (H, W, 3) uint8 array (JPEG-encoded by ``core/codec.py``) or
        raw encoded bytes → one BINARY frame."""
        if not isinstance(img, (bytes, bytearray)):
            from qwen_image_edit_streamdiffusion_tpu_torch.core import codec

            img = codec.encode_jpeg(img, quality)
        with self._wlock:
            write_frame(self.wfile, OP_BINARY, bytes(img), mask=True)

    def recv(self):
        """Next message: dict (TEXT), (meta_dict, jpeg_bytes) (BINARY),
        or None (close)."""
        opcode, data = read_message(self.rfile, self.wfile,
                                    mask_replies=True,
                                    write_lock=self._wlock)
        if opcode == OP_CLOSE:
            return None
        if opcode == OP_TEXT:
            return json.loads(data)
        n = struct.unpack("!I", data[:4])[0]
        meta = json.loads(data[4:4 + n])
        return meta, data[4 + n:]

    def close(self) -> None:
        try:
            with self._wlock:
                write_frame(self.wfile, OP_CLOSE, b"", mask=True)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
