"""Best-effort UPnP IGD port mapping (NAT traversal for home nodes).

Rebuild of the reference's update_upnp
(the reference's src/net/udp_service.rs:420-461), which uses the igd
crate to map the UDP listen port on the local gateway so peers behind
NAT are reachable. Same semantics here with stdlib only:

1. SSDP M-SEARCH multicast discover (239.255.255.250:1900)
2. fetch the device description XML, find the WANIPConnection control URL
3. SOAP AddPortMapping for the given UDP port

Every failure is swallowed and logged at debug level — exactly the
reference's posture (errors printed, never fatal,
udp_service.rs:347-349): a node without a cooperative gateway still
works, it's just not dialable from outside. Port of
dawnsearch_tpu/net/upnp.py; it runs only with `upnp = true`.
"""

from __future__ import annotations

import re
import socket
import urllib.request
from urllib.parse import urljoin

from dawnsearch_tpu_torch.utils.logging import service_logger

log = service_logger("Upnp")

SSDP_ADDR = ("239.255.255.250", 1900)
SSDP_MSEARCH = (
    "M-SEARCH * HTTP/1.1\r\n"
    f"HOST: {SSDP_ADDR[0]}:{SSDP_ADDR[1]}\r\n"
    'MAN: "ssdp:discover"\r\n'
    "MX: 2\r\n"
    "ST: urn:schemas-upnp-org:device:InternetGatewayDevice:1\r\n\r\n"
).encode()

_SERVICE_TYPES = (
    "urn:schemas-upnp-org:service:WANIPConnection:1",
    "urn:schemas-upnp-org:service:WANPPPConnection:1",
)


def discover_gateway(timeout: float = 2.0) -> str | None:
    """-> device description URL of the first IGD that answers."""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.settimeout(timeout)
        s.sendto(SSDP_MSEARCH, SSDP_ADDR)
        data, _ = s.recvfrom(65536)
        m = re.search(rb"(?im)^location:\s*(\S+)", data)
        return m.group(1).decode() if m else None
    except OSError as e:
        log.debug("SSDP discovery failed: %s", e)
        return None


def _control_url(desc_url: str, timeout: float = 3.0
                 ) -> tuple[str, str] | None:
    """-> (control URL, service type) for the WAN connection service."""
    try:
        with urllib.request.urlopen(desc_url, timeout=timeout) as r:
            xml = r.read().decode("utf-8", errors="ignore")
    except OSError as e:
        log.debug("IGD description fetch failed: %s", e)
        return None
    for svc_type in _SERVICE_TYPES:
        # serviceType ... controlURL within the same <service> block
        for block in re.findall(r"<service>(.*?)</service>", xml, re.S):
            if svc_type in block:
                m = re.search(r"<controlURL>(.*?)</controlURL>", block)
                if m:
                    return urljoin(desc_url, m.group(1).strip()), svc_type
    return None


def _local_ip_toward(host: str = "8.8.8.8") -> str:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect((host, 80))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


def add_port_mapping(port: int, protocol: str = "UDP",
                     description: str = "DawnSearch",
                     lease_seconds: int = 3600) -> bool:
    """Map external `port` -> this host's `port`. Returns success.
    Mirrors the reference's add_port call (udp_service.rs:443-457):
    same lease behavior — refreshed on every announce tick."""
    desc_url = discover_gateway()
    if not desc_url:
        return False
    ctrl = _control_url(desc_url)
    if not ctrl:
        return False
    control_url, svc_type = ctrl
    local_ip = _local_ip_toward()
    body = f"""<?xml version="1.0"?>
<s:Envelope xmlns:s="http://schemas.xmlsoap.org/soap/envelope/"
 s:encodingStyle="http://schemas.xmlsoap.org/soap/encoding/">
 <s:Body><u:AddPortMapping xmlns:u="{svc_type}">
  <NewRemoteHost></NewRemoteHost>
  <NewExternalPort>{port}</NewExternalPort>
  <NewProtocol>{protocol}</NewProtocol>
  <NewInternalPort>{port}</NewInternalPort>
  <NewInternalClient>{local_ip}</NewInternalClient>
  <NewEnabled>1</NewEnabled>
  <NewPortMappingDescription>{description}</NewPortMappingDescription>
  <NewLeaseDuration>{lease_seconds}</NewLeaseDuration>
 </u:AddPortMapping></s:Body></s:Envelope>"""
    req = urllib.request.Request(
        control_url, data=body.encode(),
        headers={
            "Content-Type": 'text/xml; charset="utf-8"',
            "SOAPAction": f'"{svc_type}#AddPortMapping"',
        })
    try:
        with urllib.request.urlopen(req, timeout=3.0) as r:
            ok = r.status == 200
            if ok:
                log.info("UPnP mapped %s port %d -> %s", protocol, port,
                         local_ip)
            return ok
    except OSError as e:
        log.debug("AddPortMapping failed: %s", e)
        return False
