"""UPnP: XML/SOAP plumbing against a fake in-process gateway.

The port's copy of tests/test_upnp.py."""

import http.server
import threading

import torch

from dawnsearch_tpu_torch.net import upnp

torch.set_num_threads(2)

DESC_XML = """<?xml version="1.0"?>
<root><device><serviceList>
<service>
 <serviceType>urn:schemas-upnp-org:service:WANIPConnection:1</serviceType>
 <controlURL>/ctl/IPConn</controlURL>
</service>
</serviceList></device></root>"""


class FakeGateway(http.server.BaseHTTPRequestHandler):
    soap_bodies = []

    def log_message(self, *a):
        pass

    def _reply(self, body, code=200):
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        self._reply(DESC_XML if self.path == "/desc.xml" else "nope",
                    200 if self.path == "/desc.xml" else 404)

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        FakeGateway.soap_bodies.append(self.rfile.read(n).decode())
        self._reply("<ok/>")


def test_control_url_and_mapping(monkeypatch):
    server = http.server.HTTPServer(("127.0.0.1", 0), FakeGateway)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        ctrl = upnp._control_url(base + "/desc.xml")
        assert ctrl == (base + "/ctl/IPConn",
                        "urn:schemas-upnp-org:service:WANIPConnection:1")
        monkeypatch.setattr(upnp, "discover_gateway",
                            lambda timeout=2.0: base + "/desc.xml")
        # the local address toward the internet: fixed, so the test opens
        # no socket toward an outside host
        monkeypatch.setattr(upnp, "_local_ip_toward",
                            lambda host="8.8.8.8": "127.0.0.1")
        assert upnp.add_port_mapping(7231) is True
        body = FakeGateway.soap_bodies[-1]
        assert "<NewExternalPort>7231</NewExternalPort>" in body
        assert "<NewProtocol>UDP</NewProtocol>" in body
        assert "<NewInternalClient>127.0.0.1</NewInternalClient>" in body
    finally:
        server.shutdown()


def test_discovery_failure_is_graceful(monkeypatch):
    monkeypatch.setattr(upnp, "discover_gateway", lambda timeout=2.0: None)
    assert upnp.add_port_mapping(7231) is False
