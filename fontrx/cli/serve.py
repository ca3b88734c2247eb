"""Live browser viewer for the interactive session.

The reference opens a GLFW window (``src/VulkanContext.zig:95-213``);
an accelerator host is display-less, so the live-viewing analog is a tiny
stdlib HTTP server: the browser shows PNG frames and forwards
scroll-to-zoom, drag-to-pan, resize, and the m/d/t toggle keys back to
the same ``InteractiveSession`` that powers the stdin protocol.

Endpoints (all GET):

- ``/``            the viewer page (canvas + event JS)
- ``/ws``          WebSocket push channel: events arrive as JSON text
                   frames, every applied event is answered with the
                   re-rendered page as one binary PNG frame — no
                   polling, one socket (RFC 6455 handshake + framing
                   hand-rolled on the stdlib handler)
- ``/frame``       current frame as PNG (pull fallback)
- ``/ev``          apply events: ``scroll=<amt>&cx=&cy=`` /
                   ``dx=&dy=`` (drag, NDC) / ``key=m|d|t`` /
                   ``w=&h=`` (resize) / ``type=<text>`` / ``back=<n>``
- ``/stats``       session stats JSON

The server is threading (a held-open ``/ws`` must not block ``/stats``)
but all session access serializes through one lock — one scene, one
event order, exactly like the reference's single window loop.
"""

from __future__ import annotations

import base64
import hashlib
import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from fontrx.utils.log import get_logger

log = get_logger("Serve")

_WS_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def ws_accept_key(client_key: str) -> str:
    """RFC 6455 §4.2.2 Sec-WebSocket-Accept for a client key."""
    digest = hashlib.sha1(client_key.encode() + _WS_GUID).digest()
    return base64.b64encode(digest).decode()


def ws_read_frame(rfile) -> tuple[int, bytes] | None:
    """Read one client frame -> (opcode, unmasked payload); ``None`` on
    EOF.  Client frames are always masked (RFC 6455 §5.3)."""
    hdr = rfile.read(2)
    if len(hdr) < 2:
        return None
    opcode = hdr[0] & 0x0F
    masked = bool(hdr[1] & 0x80)
    length = hdr[1] & 0x7F
    if length == 126:
        length = struct.unpack(">H", rfile.read(2))[0]
    elif length == 127:
        length = struct.unpack(">Q", rfile.read(8))[0]
    mask = rfile.read(4) if masked else b"\x00" * 4
    payload = rfile.read(length)
    if masked:
        payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    return opcode, payload


def ws_send_frame(wfile, payload: bytes, opcode: int = 2) -> None:
    """Write one unmasked server frame (FIN set; opcode 2 = binary)."""
    head = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([n])
    elif n < 1 << 16:
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    wfile.write(head + payload)
    wfile.flush()

_PAGE = """<!doctype html>
<title>fontrx</title>
<style>body{margin:0;background:#222;overflow:hidden}img{display:block}
#ui{position:fixed;top:8px;right:8px;background:#000a;color:#ddd;
font:12px monospace;padding:8px;border-radius:6px}
#ui input{vertical-align:middle;width:140px}
#ui button{font:inherit;margin-top:4px}</style>
<img id=v draggable=false>
<div id=ui></div>
<script>
const v = document.getElementById('v');
const ui = document.getElementById('ui');
function buildUI(axes, mode) {
  ui.innerHTML = '';
  for (const a of axes) {
    const row = document.createElement('div');
    const lab = document.createElement('span');
    lab.textContent = `${a.tag} ${a.value.toFixed(0)} `;
    const sl = document.createElement('input');
    sl.type = 'range'; sl.min = a.min; sl.max = a.max;
    sl.step = (a.max - a.min) / 200; sl.value = a.value;
    sl.oninput = () => {
      lab.textContent = `${a.tag} ${(+sl.value).toFixed(0)} `;
      ev({axis: a.tag, value: +sl.value},
         `axis=${a.tag}&value=${sl.value}`);
    };
    row.appendChild(lab); row.appendChild(sl); ui.appendChild(row);
  }
  const b = document.createElement('button');
  b.textContent = 'mode: ' + mode;
  b.onclick = () => ev({key: 'c'}, 'key=c');
  ui.appendChild(b);
}
fetch('/ui').then(r => r.json()).then(d => buildUI(d.axes, d.mode));
let n = 0, drag = null, ws = null, url = null;
// push channel: frames arrive as binary WS messages; events go out as
// JSON text frames.  Falls back to fetch-polling if WS is unavailable.
function connect() {
  try { ws = new WebSocket(`ws://${location.host}/ws`); }
  catch (_) { ws = null; return; }
  ws.binaryType = 'blob';
  ws.onmessage = m => {
    if (typeof m.data === 'string') return;       // stats reply
    if (url) URL.revokeObjectURL(url);
    url = URL.createObjectURL(m.data);
    v.src = url;
  };
  ws.onclose = ws.onerror = () => { ws = null; };
}
function refresh() { v.src = '/frame?n=' + (n++); }
function ev(o, q) {
  if (ws && ws.readyState === 1) ws.send(JSON.stringify(o));
  else fetch('/ev?' + q).then(refresh);
}
window.onwheel = e => {
  const cx = e.clientX / innerWidth * 2 - 1;
  const cy = 1 - e.clientY / innerHeight * 2;
  ev({scroll: -e.deltaY / 100, cx, cy},
     `scroll=${-e.deltaY / 100}&cx=${cx}&cy=${cy}`);
};
window.onmousedown = e => drag = [e.clientX, e.clientY];
window.onmouseup = () => drag = null;
window.onmousemove = e => {
  if (!drag) return;
  const dx = (e.clientX - drag[0]) / innerWidth * 2;
  const dy = -(e.clientY - drag[1]) / innerHeight * 2;
  drag = [e.clientX, e.clientY];
  ev({dx, dy}, `dx=${dx}&dy=${dy}`);
};
window.onkeydown = e => {
  if ('mdtc[]'.includes(e.key)) ev({key: e.key}, 'key=' + e.key);
  else if (e.key === 'Backspace') ev({back: 1}, 'back=1');
  else if (e.key.length === 1) ev({type: e.key},
                                  'type=' + encodeURIComponent(e.key));
};
function fit() {
  ev({w: innerWidth, h: innerHeight}, `w=${innerWidth}&h=${innerHeight}`);
}
window.onresize = fit;
connect();
fit();
</script>
"""


def make_handler(sess, lock: threading.Lock | None = None):
    from fontrx.io.png import encode as png_encode

    lock = lock or threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route to our logger
            log.debug(fmt, *args)

        def _send(self, code, ctype, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/ui"):
                import json as _json

                with (lock or threading.Lock()):
                    body = _json.dumps({
                        "axes": sess.axes_info(),
                        "mode": sess.mode,
                    }).encode()
                self._send(200, "application/json", body)
                return
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            if url.path == "/":
                self._send(200, "text/html", _PAGE.encode())
            elif url.path == "/ws":
                self._websocket()
            elif url.path == "/frame":
                with lock:
                    rgba = sess.display_frame()
                self._send(200, "image/png", png_encode(rgba))
            elif url.path == "/ev":
                with lock:
                    self._apply(q)
                self._send(204, "text/plain", b"")
            elif url.path == "/stats":
                with lock:
                    body = json.dumps(sess.stats()).encode()
                self._send(200, "application/json", body)
            else:
                self._send(404, "text/plain", b"not found")

        def _websocket(self):
            """Upgrade and run the push loop: every JSON event text
            frame is applied and answered with the re-rendered page as
            one binary PNG frame; an initial frame is pushed right
            after the handshake."""
            key = self.headers.get("Sec-WebSocket-Key")
            if (self.headers.get("Upgrade", "").lower() != "websocket"
                    or not key):
                self._send(400, "text/plain", b"websocket upgrade required")
                return
            self.send_response(101, "Switching Protocols")
            self.send_header("Upgrade", "websocket")
            self.send_header("Connection", "Upgrade")
            self.send_header("Sec-WebSocket-Accept", ws_accept_key(key))
            self.end_headers()
            self.close_connection = True
            self._push_frame()
            while True:
                frame = ws_read_frame(self.rfile)
                if frame is None:
                    return
                opcode, payload = frame
                if opcode == 8:          # close
                    ws_send_frame(self.wfile, payload, opcode=8)
                    return
                if opcode == 9:          # ping -> pong
                    ws_send_frame(self.wfile, payload, opcode=10)
                    continue
                if opcode != 1:          # only text frames carry events
                    continue
                try:
                    ev = json.loads(payload.decode())
                except ValueError:
                    continue
                if ev.get("op") == "stats":
                    with lock:
                        body = json.dumps(sess.stats()).encode()
                    ws_send_frame(self.wfile, body, opcode=1)
                    continue
                with lock:
                    self._apply({k: str(v) for k, v in ev.items()})
                self._push_frame()

        def _push_frame(self):
            with lock:
                rgba = sess.display_frame()
            ws_send_frame(self.wfile, png_encode(rgba), opcode=2)

        def _apply(self, q):
            if "scroll" in q:
                sess.scroll(
                    float(q["scroll"]),
                    (float(q.get("cx", 0)), float(q.get("cy", 0))),
                )
            if "dx" in q or "dy" in q:
                sess.drag(float(q.get("dx", 0)), float(q.get("dy", 0)))
            if "key" in q:
                sess.key(q["key"])
            if "w" in q and "h" in q:
                sess.resize(int(q["w"]), int(q["h"]))
            if "type" in q:
                sess.char_input(q["type"])
            if "back" in q:
                sess.backspace(int(float(q["back"])))
            if "axis" in q:
                sess.set_axis(str(q["axis"]), float(q["value"]))

    return Handler


def serve(sess, port: int, bind: str = "127.0.0.1") -> None:
    """Serve ``sess`` forever on ``bind:port`` (Ctrl-C to stop).
    Threading so a held-open ``/ws`` push connection doesn't block the
    plain HTTP endpoints; session access serializes on one lock."""
    httpd = ThreadingHTTPServer((bind, port), make_handler(sess))
    httpd.daemon_threads = True
    log.info("live viewer at http://%s:%d/", bind, httpd.server_port)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
