"""Remote evaluation on the standard library's HTTP: an agent served over HTTP
and the client-side agent that drives it (``streamspeech_tpu/eval/service.py``;
reference `SimulEval/simuleval/agents/service.py:15-40`, a tornado server
with PUT /input, GET /output and POST /reset, and `simuleval/evaluator/
remote.py`). The ``--standalone`` / ``--remote-eval`` surface of the CLI."""

from __future__ import annotations

import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from streamspeech_tpu_torch.agents.base import GenericAgent, Segment

# the agent service is addressed directly, never through a proxy of the
# environment's
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


class AgentService:
    """Serve one agent over HTTP: PUT /input pushes a segment, GET /output pops
    one, POST /reset resets the agent."""

    def __init__(self, agent: GenericAgent, host: str = "0.0.0.0", port: int = 7861):
        self.agent = agent
        self.host, self.port = host, port
        self.httpd: Optional[ThreadingHTTPServer] = None

    def handler(self):
        service = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code, body=b"", ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

            def do_PUT(self):
                if self.path != "/input":
                    return self._send(404)
                n = int(self.headers.get("Content-Length", 0))
                service.agent.push(Segment.from_json(self.rfile.read(n).decode()))
                self._send(200, b"{}")

            def do_GET(self):
                if self.path != "/output":
                    return self._send(404)
                self._send(200, service.agent.pop().json().encode())

            def do_POST(self):
                if self.path != "/reset":
                    return self._send(404)
                service.agent.reset()
                self._send(200, b"{}")

        return Handler

    def start(self, background: bool = True) -> int:
        """Bind (port 0: any free one) and serve, in a daemon thread with
        ``background``, else until stopped. Returns the bound port."""
        self.httpd = ThreadingHTTPServer((self.host, self.port), self.handler())
        port = self.httpd.server_address[1]
        if background:
            threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        else:
            self.httpd.serve_forever()
        return port

    def stop(self):
        if self.httpd:
            self.httpd.shutdown()
            self.httpd.server_close()


class RemoteAgent(GenericAgent):
    """A ``GenericAgent`` whose push and pop go over HTTP to an
    ``AgentService``, for the ``SentenceLevelEvaluator`` (remote evaluation)."""

    def __init__(self, url: str, source_type: str = "speech", target_type: str = "speech"):
        self.url = url.rstrip("/")
        self.source_type = source_type
        self.target_type = target_type
        super().__init__()

    def _call(self, path: str, data: Optional[bytes] = None, method: str = "GET",
              timeout: float = 600) -> bytes:
        req = urllib.request.Request(self.url + path, data=data, method=method)
        with _OPENER.open(req, timeout=timeout) as resp:
            return resp.read()

    def reset(self):
        super().reset()
        if hasattr(self, "url"):        # GenericAgent.__init__ resets before url is set
            self._call("/reset", b"", "POST", timeout=60)

    def push(self, segment: Segment) -> None:
        self.states.update_source(segment)
        self._call("/input", segment.json().encode(), "PUT")

    def pop(self) -> Segment:
        segment = Segment.from_json(self._call("/output").decode())
        self.states.update_target(segment)
        if segment.finished:
            self.states.target_finished = True
        return segment

    def policy(self):
        raise RuntimeError("RemoteAgent delegates its policy to the server")
